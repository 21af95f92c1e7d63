"""Two-stream batch sampling for semi-supervised training (a copy of
`icl_tpu/data/sampler.py`, the reference `TwoStreamBatchSampler`):

  * an epoch is one pass over a fresh permutation of the labeled
    (primary) indices, in groups of `batch_size - secondary_batch_size`,
    the remainder dropped;
  * the unlabeled (secondary) stream is an endless chain of fresh
    permutations that carries over across epochs;
  * a batch is [labeled..., unlabeled...].

Randomness comes from one numpy Generator owned by the sampler.
"""
from __future__ import annotations

import itertools
from typing import Iterator, Sequence

import numpy as np


def _grouper(iterable, n):
    """Fixed-length chunks, the remainder dropped."""
    args = [iter(iterable)] * n
    return zip(*args)


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int], secondary_indices: Sequence[int],
                 batch_size: int, secondary_batch_size: int, seed: int | None = None):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        if not len(self.primary_indices) >= self.primary_batch_size > 0:
            raise ValueError(f"{len(self.primary_indices)} labeled cases for a labeled batch of "
                             f"{self.primary_batch_size}")
        if not len(self.secondary_indices) >= self.secondary_batch_size > 0:
            raise ValueError(f"{len(self.secondary_indices)} unlabeled cases for an unlabeled "
                             f"batch of {self.secondary_batch_size}")
        self._rng = np.random.default_rng(seed)
        self._secondary_iter = itertools.chain.from_iterable(self._shuffles(self.secondary_indices))

    def _shuffles(self, indices):
        while True:
            yield self._rng.permutation(indices)

    def __iter__(self) -> Iterator[list[int]]:
        primary_iter = iter(self._rng.permutation(self.primary_indices))
        return (list(p) + list(s) for p, s in zip(_grouper(primary_iter, self.primary_batch_size),
                                                  _grouper(self._secondary_iter,
                                                           self.secondary_batch_size)))

    def __len__(self) -> int:
        return len(self.primary_indices) // self.primary_batch_size


def two_stream_batches(primary_indices: Sequence[int], secondary_indices: Sequence[int],
                       batch_size: int, secondary_batch_size: int,
                       seed: int | None = None) -> Iterator[list[int]]:
    """Endless stream of two-stream batches, epochs chained."""
    sampler = TwoStreamBatchSampler(primary_indices, secondary_indices, batch_size,
                                    secondary_batch_size, seed)
    while True:
        yield from sampler
