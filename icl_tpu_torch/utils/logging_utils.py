"""The run log: {snapshot}/log.txt with '[%H:%M:%S.%ms] msg' lines, also
echoed to stderr, and the scalars under {snapshot}/log (counterpart of
`icl_tpu/utils/logging_utils.py`'s `setup_logging` and `ScalarWriter`)."""
from __future__ import annotations

import json
import logging
import os
import time


def setup_logging(snapshot_path: str) -> logging.Logger:
    os.makedirs(snapshot_path, exist_ok=True)
    logger = logging.getLogger("icl_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fh = logging.FileHandler(os.path.join(snapshot_path, "log.txt"))
    fh.setFormatter(logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s", datefmt="%H:%M:%S"))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    return logger


class ScalarWriter:
    """Scalars by tag and step, in the reference's TensorBoard schema
    (`Loss/*`, `Info/lr`, `metric_all/*`, `metric_class_{name}/*`): to a
    tensorboardX SummaryWriter in `logdir` when tensorboardX imports, and
    always as lines {"tag", "value", "step", "time"} of
    `logdir/scalars.jsonl`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": int(step),
                                      "time": time.time()}) + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class NullWriter:
    """A `ScalarWriter` that writes nothing: the writer of every rank but 0
    under data parallelism."""

    def add_scalar(self, tag: str, value, step: int) -> None:
        pass

    def close(self) -> None:
        pass
