"""Split manifests (a copy of `icl_tpu/data/manifests.py`): a dataset
root's own list wins, else the copy the repo vendors under
`data/<dataset>/`, else the root's path (so open() names the path the
user asked for)."""
from __future__ import annotations

import os

VENDORED_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data")


def resolve_manifest(base_dir: str, filename: str, dataset: str) -> str:
    for path in (os.path.join(base_dir, filename), os.path.join(VENDORED_ROOT, dataset, filename)):
        if os.path.exists(path):
            return path
    return os.path.join(base_dir, filename)
