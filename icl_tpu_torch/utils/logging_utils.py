"""The run log: {snapshot}/log.txt with '[%H:%M:%S.%ms] msg' lines, also
echoed to stderr (counterpart of `icl_tpu/utils/logging_utils.py`'s
`setup_logging`)."""
from __future__ import annotations

import logging
import os


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
