"""icl_tpu_torch (and chip_smoke.py, which drives it on the card, and the
card's kernel tests) stands alone: it imports neither JAX nor the icl_tpu
package, nor PIL (the card's machine has none: CTAugment's ops are numpy),
it reads no file of the JAX package (its C++ helper builds from its own
copy of the source), and its entry points refuse to fall back to the CPU."""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import icl_tpu_torch

PKG = pathlib.Path(icl_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent

_CHILD = r"""
import importlib, pkgutil, sys
import icl_tpu_torch, torch
for m in pkgutil.walk_packages(icl_tpu_torch.__path__, "icl_tpu_torch."):
    importlib.import_module(m.name)
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.eval.infer3d import make_patch_predictor
model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=12,
                    generator=torch.Generator().manual_seed(0))
x = torch.randn(1, 1, 32, 32, 32, generator=torch.Generator().manual_seed(1))
probs = make_patch_predictor(model)(x)
assert probs.shape == (1, 2, 32, 32, 32) and torch.isfinite(probs).all()
import numpy as np
from icl_tpu_torch.eval.infer2d import make_slice_predictor
from icl_tpu_torch.models.swin2d import SwinConfig
from icl_tpu_torch.scripts import test_2D_ACDC, train_inherent_consistent_swinunet_2D
cfg = SwinConfig(img_size=64, window_size=4, embed_dim=12)
model2d = net_factory("icl_swinunet", 1, 4, device="cpu", swin_cfg=cfg)
outs = model2d(torch.randn(2, 1, 64, 64), torch.randn(2, 1, 64, 64))
assert len(outs) == 5 and outs[0].shape == (2, 4, 64, 64)
labels = make_slice_predictor(model2d.eval(), (64, 64), "cpu")(np.zeros((3, 40, 40), np.float32))
assert labels.shape == (3, 40, 40)
from icl_tpu_torch.scripts import train_inherent_consistent_unet_2D
unet = net_factory("icl_unet", 1, 4, device="cpu", patch_size=64, fuse_sspa_pair=True)
outs = unet(torch.randn(2, 1, 64, 64), torch.randn(2, 1, 64, 64))
assert len(outs) == 5 and outs[0].shape == (2, 4, 64, 64) and outs[4][2].shape == (2, 4, 32, 32)
args = train_inherent_consistent_unet_2D.parse_args(["--fuse_icl_pair"])
assert args.model == "icl_unet" and args.fuse_icl_pair
unet3d = net_factory("unet_3D_icl", 1, 2, device="cpu", patch_size=32, remat=True)
outs = unet3d(torch.randn(2, 1, 32, 32, 32), torch.randn(2, 1, 32, 32, 32))
assert len(outs) == 5 and outs[0].shape == (2, 2, 32, 32, 32) and outs[4][2].shape == (2, 2, 8, 8, 8)
from icl_tpu_torch.scripts import (test_3D_AMOS, test_3D_BraTS, train_fully_supervised_unet_3D_AMOS22,
                                   train_fully_supervised_unet_3D_BraTS,
                                   train_inherent_consistent_unet_3D_AMOS22,
                                   train_inherent_consistent_unet_3D_BraTS)
assert train_inherent_consistent_unet_3D_BraTS.parse_args([]).model == "unet_3D_icl"
assert train_fully_supervised_unet_3D_BraTS.parse_args([]).model == "unet_3D"
assert train_inherent_consistent_unet_3D_AMOS22.parse_args([]).num_classes == 16
assert train_fully_supervised_unet_3D_AMOS22.parse_args([]).model == "unet_3D"
assert test_3D_AMOS.parse_args([]).model == "unet_3D_icl"
assert test_3D_BraTS.parse_args(["--model", "unet_3D_icl"]).model == "unet_3D_icl"
from icl_tpu_torch.scripts import (train_fully_supervised_swinunet_2D_ACDC,
                                   train_fully_supervised_swinunetr_3D_BraTS,
                                   train_fully_supervised_unet_2D_ACDC)
from icl_tpu_torch.utils import pretrained
assert train_fully_supervised_unet_2D_ACDC.parse_args([]).model == "unet"
assert train_fully_supervised_swinunet_2D_ACDC.parse_args([]).patch_size == [224, 224]
assert train_fully_supervised_swinunetr_3D_BraTS.parse_args([]).use_ssl_pretrained == 1
assert pretrained.ssl_swinvit_fixup({"module.swin_vit.layers1.0.blocks.0.mlp.fc1.weight": 0}) == {
    "layers1.0.blocks.0.mlp.linear1.weight": 0}
from icl_tpu_torch.scripts import train_fixmatch_cta_2D
from icl_tpu_torch.data.ctaugment import CTAugment, cta_apply
img = np.linspace(0, 1, 24 * 20, dtype=np.float32).reshape(24, 20)
out = cta_apply(img, [("rescale", [0.9, 0.1]), ("cutout", [0.5])], np.random.default_rng(0))
assert out.shape == img.shape and out.dtype == np.float32
assert len(CTAugment(seed=0).policy(probe=False, weak=True)) == 2
assert train_fixmatch_cta_2D.parse_args([]).conf_thresh == 0.95
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "icl_tpu", "PIL"))
print("LEAKED", bad)
"""


def test_port_imports_no_jax_and_no_icl_tpu():
    # one OpenMP thread: the child builds small models while other test
    # workers share the CPU (tests/_torch_threads.py)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, capture_output=True,
                          text=True, timeout=240, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "icl_tpu", "PIL")
_IMPORT_LINE = re.compile(r"^\s*(?:from|import)\s+(?:" + "|".join(_FORBIDDEN) + r")(?![\w])", re.M)


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                 ROOT / "tests" / "test_torch_window_attention_card.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_jax_or_icl_tpu_import(path):
    for name in _imported_modules(path):
        assert name.split(".")[0] not in _FORBIDDEN, f"{path}: imports {name}"
    # also imports inside strings handed to exec or a subprocess
    leak = _IMPORT_LINE.search(path.read_text())
    assert leak is None, f"{path}: {leak.group(0).strip()}"


_READS = r"""
import json, os, sys, tempfile
seen = []

def audit(event, args):
    if event in ("open", "ctypes.dlopen") and isinstance(args[0], (str, bytes, os.PathLike)):
        seen.append(os.fsdecode(args[0]))
    elif event == "subprocess.Popen":
        seen.extend(os.fsdecode(a) for a in args[1])

sys.addaudithook(audit)
import importlib, pathlib, pkgutil
import numpy as np
import icl_tpu_torch
for m in pkgutil.walk_packages(icl_tpu_torch.__path__, "icl_tpu_torch."):
    importlib.import_module(m.name)
from icl_tpu_torch import native
from icl_tpu_torch.data import transforms
from icl_tpu_torch.ops import build
with tempfile.TemporaryDirectory() as tmp:
    build.BUILD_ROOT = pathlib.Path(tmp)  # a fresh build: the compiler's command is seen
    image = np.linspace(0, 1, 40 * 36, dtype=np.float32).reshape(40, 36)
    for seed in range(12):
        transforms.RandomGenerator((32, 32))(image, (image * 3).astype(np.uint8),
                                             np.random.default_rng(seed))
    assert native.zoom_nearest.calls == 24 and native.rotate_nearest.calls == 2
print("SEEN", json.dumps(seen))
"""


def test_port_reads_no_file_of_the_jax_package():
    """Every file the port opens, loads or hands to a compiler while it is
    imported, builds its C++ helper anew and augments through it, as the
    interpreter's audit hooks see them: none under icl_tpu/ or the JAX
    package's native/ at the repo root."""
    proc = subprocess.run([sys.executable, "-c", _READS], cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    seen = [pathlib.Path(ROOT, p).resolve() for p in json.loads(proc.stdout.split("SEEN ", 1)[1])]
    for jax_side in (ROOT / "icl_tpu", ROOT / "native"):
        read = [str(p) for p in seen if p.is_relative_to(jax_side)]
        assert not read, f"the port read {read}"
    assert PKG / "native" / "augment.cpp" in seen, "the build was not seen"


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    import numpy as np

    from icl_tpu_torch.device import resolve_device
    from icl_tpu_torch.eval.infer3d import sliding_window_predict
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.scripts import test_3D_BraTS, train_fixmatch_cta_2D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        net_factory("swinunetr", 1, 2, feature_size=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sliding_window_predict(lambda x: x, np.zeros((8, 8, 8), np.float32), 2, (8, 8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_3D_BraTS.main(["--checkpoint", "unused.pth"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_fixmatch_cta_2D.main(["--root_path", "unused"])
    assert resolve_device("cpu") == torch.device("cpu")
