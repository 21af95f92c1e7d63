"""ACDC training batches (counterpart of `acdc_train_batches`,
`acdc_raw_batches`, `supervised_batches` and `cta_batches`,
`icl_tpu/data/pipeline.py:22-116, 172-231`), channel-first, the
`Prefetcher` that makes every training CLI's batches on a thread of their
own (`icl_tpu/data/pipeline.py:117-148`), and `device_stream`, which also
copies them to the card there (:151-169)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from icl_tpu_torch.data.ctaugment import cta_apply
from icl_tpu_torch.data.device_augment import draw_augment_params
from icl_tpu_torch.data.sampler import two_stream_batches
from icl_tpu_torch.data.transforms import CTATransform, RandomGenerator, zoom_to


def acdc_train_batches(dataset, labeled_count: int, batch_size: int, labeled_bs: int, patch_size,
                       seed: int = 1337) -> Iterator[dict]:
    """Endless [labeled..., unlabeled...] batches of augmented slices:
    "image" [B, 1, H, W] f32 and "label" [B, H, W] uint8. `dataset` is
    anything indexable whose items hold "image" and "label" slices (an
    `ACDCDataset`, or a list of in-memory slices); indices below
    `labeled_count` are the labeled ones."""
    transform = RandomGenerator(patch_size)
    aug_rng = np.random.default_rng(seed + 1)
    for idxs in two_stream_batches(list(range(labeled_count)), list(range(labeled_count, len(dataset))),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        pairs = [transform(dataset[i]["image"], dataset[i]["label"], aug_rng) for i in idxs]
        yield {"image": np.stack([img for img, _ in pairs])[:, None],
               "label": np.stack([lab for _, lab in pairs])}


def acdc_raw_batches(dataset, labeled_count: int, batch_size: int, labeled_bs: int,
                     canon_size: int, seed: int = 1337) -> Iterator[dict]:
    """The device-augment input mode's batches: [labeled..., unlabeled...]
    slices, not augmented, order-0 resized on the host to one canonical
    square size: "image" [B, S, S] f32, "label" [B, S, S] uint8, and
    "augment", the step's draws (`draw_augment_params` from a generator
    seeded `seed + 1`)."""
    aug_rng = np.random.default_rng(seed + 1)
    canon = (canon_size, canon_size)
    for idxs in two_stream_batches(list(range(labeled_count)), list(range(labeled_count, len(dataset))),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        items = [dataset[i] for i in idxs]
        yield {"image": np.stack([zoom_to(it["image"].astype(np.float32), canon) for it in items]),
               "label": np.stack([zoom_to(it["label"].astype(np.uint8), canon) for it in items]),
               "augment": draw_augment_params(aug_rng, len(idxs))}


def supervised_batches(dataset, batch_size: int, patch_size, seed: int = 1337) -> Iterator[dict]:
    """Endless labeled-only batches of augmented slices (the fully
    supervised path): one fresh permutation of the whole dataset per epoch
    from `seed` (the remainder dropped), augmented from `seed + 1`; "image"
    [B, 1, H, W] f32 and "label" [B, H, W] uint8. Raises ValueError if the
    dataset holds fewer slices than one batch (the JAX package's loop then
    spins without yielding)."""
    n = len(dataset)
    if n < batch_size:
        raise ValueError(f"{n} slices cannot fill a batch of {batch_size}")
    transform = RandomGenerator(patch_size)
    rng = np.random.default_rng(seed)
    aug_rng = np.random.default_rng(seed + 1)
    while True:
        perm = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            pairs = [transform(dataset[int(i)]["image"], dataset[int(i)]["label"], aug_rng)
                     for i in perm[start:start + batch_size]]
            yield {"image": np.stack([img for img, _ in pairs])[:, None],
                   "label": np.stack([lab for _, lab in pairs])}


def cta_batches(dataset, labeled_count: int, batch_size: int, labeled_bs: int, patch_size, cta,
                seed: int = 1337) -> Iterator[dict]:
    """Endless FixMatch batches with CTAugment policies drawn from the live
    learner `cta` when each batch is made (so a rate update reaches the
    next batch drawn): per batch one weak and one strong policy for all its
    samples, then one probe, a labeled slice through a probe policy.
    "image_weak", "image_strong" [B, 1, H, W] f32, "label_aug" [B, H, W]
    int32, "probe_image" [1, 1, H, W] f32, "probe_label" [1, H, W] int32,
    and "probe_policy" (host only). Samples, policies and probes are the
    JAX package's for one seed: the two-stream sampler from `seed`, the
    probe slice from `seed + 2`; `cutout`'s centres come from a generator
    of their own, seeded `seed + 3` (the JAX op's are unseeded). Made on
    the caller's thread: a prefetch thread would change which rates each
    draw sees."""
    labeled_idxs = list(range(labeled_count))
    transform = CTATransform(patch_size, cta)
    probe_rng = np.random.default_rng(seed + 2)
    cutout_rng = np.random.default_rng(seed + 3)
    patch = tuple(patch_size)
    for idxs in two_stream_batches(labeled_idxs, list(range(labeled_count, len(dataset))),
                                   batch_size, batch_size - labeled_bs, seed=seed):
        ops_weak = cta.policy(probe=False, weak=True)
        ops_strong = cta.policy(probe=False, weak=False)
        samples = [transform(item["image"], item["label"], ops_weak, ops_strong, cutout_rng)
                   for item in (dataset[i] for i in idxs)]
        probe_policy = cta.policy(probe=True, weak=False)
        item = dataset[int(probe_rng.choice(labeled_idxs))]
        p_img = cta_apply(zoom_to(item["image"].astype(np.float32), patch), probe_policy)
        p_lab = cta_apply(zoom_to(item["label"].astype(np.float32) / 255.0, patch), probe_policy)
        yield {"image_weak": np.stack([s["image_weak"] for s in samples]).astype(np.float32),
               "image_strong": np.stack([s["image_strong"] for s in samples]).astype(np.float32),
               "label_aug": np.stack([s["label_aug"] for s in samples]).astype(np.int32),
               "probe_image": p_img.astype(np.float32)[None, None],
               "probe_label": np.round(255 * p_lab).astype(np.int32)[None],
               "probe_policy": probe_policy}


class Prefetcher:
    """Run a batch iterator on a daemon thread, up to `buffer_size` batches
    ahead, so that the host makes the next batch while the card runs the
    step. The batches come out in the iterator's order; an exception in the
    iterator is raised again in the consumer after the batches made before
    it. With `pin_memory` each batch's arrays become pinned CPU tensors on
    the thread, so that their copy to the card can be asynchronous
    (`Trainer.to_device`). `close()` (or leaving a `with` block) stops the
    thread."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[dict], buffer_size: int = 2, pin_memory: bool = False):
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._err: Exception | None = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    if pin_memory:
                        item = {k: torch.as_tensor(v).pin_memory() for k, v in item.items()}
                    self._q.put(item)
            except Exception as e:  # handed to the consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is self._SENTINEL:
            self._q.put(self._SENTINEL)  # a later next() ends too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the thread: it ends after the batch it is making."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _tree_map(fn, obj):
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return fn(obj)


class _DeviceStream:
    """The batches of a `Prefetcher` whose thread copied them to the card
    on its own stream; each `next` makes the caller's current stream wait
    for that copy's event, and hands the tensors to that stream."""

    def __init__(self, prefetcher: Prefetcher, device: torch.device):
        self._prefetcher, self._device = prefetcher, device

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch, event = next(self._prefetcher)
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(event)

        def hand_over(t):
            if torch.is_tensor(t) and t.is_cuda:
                t.record_stream(stream)
            return t

        return _tree_map(hand_over, batch)

    def close(self) -> None:
        self._prefetcher.close()

    def __enter__(self) -> "_DeviceStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def device_stream(batches: Iterator[dict], device, prefetch: int = 2):
    """The batches of `batches` made on a `Prefetcher` thread, which also
    copies their arrays to `device`: on a CUDA device from pinned memory,
    on a side stream of the thread's own, with an event that the
    consumer's stream waits on before it uses them (so that the copy
    overlaps the step before). Integer arrays become int64 tensors, the
    rest f32 (the step's dtypes); torch tensors already on the device
    pass through. On the CPU the thread makes the tensors. `close()` (or
    leaving a `with` block) stops the thread."""
    device = torch.device(device)

    def tensor(v):
        if torch.is_tensor(v) and v.device == device:
            return v
        t = torch.as_tensor(v)
        return t.long() if not t.is_floating_point() else t.float()

    if device.type != "cuda":
        return Prefetcher((_tree_map(tensor, b) for b in batches), buffer_size=prefetch)
    side = torch.cuda.Stream(device)

    def put(b):
        with torch.cuda.stream(side):
            out = _tree_map(lambda v: v if torch.is_tensor(v) and v.device == device
                            else tensor(v).pin_memory().to(device, non_blocking=True), b)
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    return _DeviceStream(Prefetcher((put(b) for b in batches), buffer_size=prefetch), device)
