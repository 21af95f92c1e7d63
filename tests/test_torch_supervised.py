"""icl_tpu_torch's fully supervised baselines against the JAX package's:
`supervised_batches` array for array (and its refusal of a dataset
smaller than one batch, where the JAX loop spins); one supervised step
(seg_weight * (CE + Dice), metrics, gradients, new parameters and, for
the U-Net, the BatchNorm running stats) of the 2D U-Net, Swin-UNet and
SwinUNETR against the JAX `make_supervised_step`; both pretrained
loaders (ImageNet Swin-T into Swin-UNet, SSL SwinViT into SwinUNETR) on
synthetic reference-layout checkpoints against the JAX loaders: every
parameter equal after the load, and the same keys dropped for their
shape.

Small sizes: the U-Net at 64^2, batch 4, in f64 on both sides (the JAX
align-corners weights and one-hot kept in f64, as
`test_torch_train_unet2d.py` says why); Swin-UNet at embed 12, 64^2,
window 4, f32; SwinUNETR at feature size 12, 32^3 (as
`test_torch_train.py`), in f64 (its test says why); dropout and drop
path off on both sides.
Tolerances as those files: metrics 1e-4 relative; each gradient and each
parameter update within 1e-3 of its largest magnitude plus 1e-6; running
means 1e-5; running variances 1e-5 after the n / (n - 1) factor; the
batches and the loaded parameters equal. The three CLIs' runs are in
`test_torch_supervised_cli.py`.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.data.pipeline import supervised_batches as jax_supervised_batches
from icl_tpu.models import layers as jax_layers
from icl_tpu.models import swin2d as jax_swin2d
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.train.steps import make_supervised_step as jax_make_supervised_step
from icl_tpu.utils import torch_import as jax_torch_import
from icl_tpu.utils.torch_import import export_swinunet2d, export_swinunetr

from icl_tpu_torch.data.pipeline import supervised_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.models import swin2d
from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import SUPERVISED_METRIC_KEYS, make_supervised_step
from icl_tpu_torch.utils import convert
from icl_tpu_torch.utils.pretrained import load_pretrained_swinunet, load_pretrained_swinvit
from test_torch_icl import batch as swinunetr_batch
from test_torch_icl import draw_tree, no_drop_path, no_port_drop_path  # noqa: F401  (a fixture)
from test_torch_train_unet2d import _exact_align_corners_matrix
from test_torch_train_unet3d import _assert_step, _f64, _jax_step
from test_torch_unet2d import assert_running_stats, bn_batch_sizes
from test_torch_unet3d import no_stochastic_jax  # noqa: F401  (a fixture)
from _torch_native import native_on_both, scipy_on_both  # noqa: F401  (fixtures)
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

NCLS, BATCH, UNET_SIDE, SWIN_SIDE, SWIN_WINDOW, SWIN_EMBED, FS = 4, 4, 64, 64, 4, 12, 12
SWINUNETR_PATCH = 32
JAX_SWIN_CFG = jax_swin2d.SwinConfig(img_size=SWIN_SIDE, window_size=SWIN_WINDOW, embed_dim=SWIN_EMBED)
PORT_SWIN_CFG = swin2d.SwinConfig(img_size=SWIN_SIDE, window_size=SWIN_WINDOW, embed_dim=SWIN_EMBED)


@functools.cache
def _jax_shapes(kind: str):
    if kind == "unet":
        model, x = jax_net_factory("unet", 1, NCLS), jnp.zeros((BATCH, UNET_SIDE, UNET_SIDE, 1))
    elif kind == "swinunet":
        model = jax_net_factory("swinunet", 1, NCLS, swin_cfg=JAX_SWIN_CFG)
        x = jnp.zeros((BATCH, SWIN_SIDE, SWIN_SIDE, 1))
    else:
        model = jax_net_factory("swinunetr", 1, 2, feature_size=FS)
        x = jnp.zeros((BATCH,) + (SWINUNETR_PATCH,) * 3 + (1,))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, train=True))
    return model, shapes


def _jax_variables(kind: str, seed: int):
    model, shapes = _jax_shapes(kind)
    return (model, draw_tree(shapes["params"], seed),
            draw_tree(shapes.get("batch_stats", {}), seed + 1))


def _images(seed: int, spatial) -> tuple[np.ndarray, np.ndarray]:
    x = np.random.default_rng(seed).standard_normal((BATCH,) + spatial + (1,)).astype(np.float32)
    return x, np.moveaxis(x, -1, 1).copy()


def _labels(seed: int, spatial, classes: int = NCLS) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, classes, (BATCH,) + spatial).astype(np.int32)


def _slices():
    slices, _ = synthetic_acdc(10, 0, 40, 1, NCLS, seed=2)
    return slices


def test_supervised_batches_match_jax(scipy_on_both):
    """Three epochs' worth of batches over 10 slices (2 batches of 4 an
    epoch, the remainder dropped), both packages' transforms through
    scipy."""
    _assert_supervised_batches_match()


def test_supervised_batches_match_jax_on_the_native_path(native_on_both):
    """The same, each package's transforms through its own C++ helper."""
    _assert_supervised_batches_match()


def _assert_supervised_batches_match():
    got = supervised_batches(_slices(), BATCH, (48, 32), seed=5)
    want = jax_supervised_batches(_slices(), BATCH, (48, 32), seed=5)
    for _ in range(6):
        g, w = next(got), next(want)
        assert g["image"].shape == (BATCH, 1, 48, 32) and g["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"][:, 0], w["image"][..., 0])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["label"].dtype == w["label"].dtype == np.uint8
    with pytest.raises(ValueError, match="cannot fill a batch of 16"):
        next(supervised_batches(_slices(), 16, (48, 32)))


def test_unet_supervised_step_matches_jax(no_stochastic_jax, monkeypatch):
    """In f64 on both sides."""
    monkeypatch.setattr(jax_layers, "_align_corners_matrix", _exact_align_corners_matrix)
    jax_model, params, bs = _jax_variables("unet", 20)
    spatial = (UNET_SIDE, UNET_SIDE)
    x, xt = _images(21, spatial)
    y = _labels(22, spatial)
    grads, new_state, met_j = _jax_step(lambda tx: jax_make_supervised_step(jax_model, tx, NCLS),
                                        params, bs, x, y, np.float64)
    old = convert.unet2d_state_dict_from_jax(_f64(params), _f64(bs))
    model = net_factory("unet", 1, NCLS, device="cpu")
    model.load_state_dict(old, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model = model.double().train()
    sizes = bn_batch_sizes(model)
    opt = PolySGD(model.parameters(), 0.01, 10)
    met_p = make_supervised_step(model, opt, NCLS)(
        {"image": torch.from_numpy(xt).double(), "label": torch.from_numpy(y).long()})
    assert all(v.dtype == torch.float64 for v in met_p.values())
    new = convert.unet2d_state_dict_from_jax(new_state.params, new_state.batch_stats)
    _assert_step(model, old, convert.unet2d_state_dict_from_jax(grads, new_state.batch_stats), new,
                 met_p, met_j, SUPERVISED_METRIC_KEYS)
    assert_running_stats(model, sizes, old, new)


def test_swinunet_supervised_step_matches_jax(no_drop_path):
    jax_model, params, _ = _jax_variables("swinunet", 30)
    spatial = (SWIN_SIDE, SWIN_SIDE)
    x, xt = _images(31, spatial)
    y = _labels(32, spatial)
    grads, new_state, met_j = _jax_step(lambda tx: jax_make_supervised_step(jax_model, tx, NCLS),
                                        params, {}, x, y, np.float32)

    def sd(tree):
        return convert.swinunet2d_state_dict_from_jax(tree["swin_unet"], SWIN_SIDE, SWIN_WINDOW,
                                                      torch_prefix="swin_unet.")

    old = sd(params)
    model = net_factory("swinunet", 1, NCLS, device="cpu", swin_cfg=PORT_SWIN_CFG)
    model.load_state_dict(old, strict=True)
    model = no_port_drop_path(model).train()
    opt = PolySGD(model.parameters(), 0.01, 10)
    met_p = make_supervised_step(model, opt, NCLS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(y).long()})
    _assert_step(model, old, sd(grads), sd(new_state.params), met_p, met_j, SUPERVISED_METRIC_KEYS)


def test_swinunetr_supervised_step_matches_jax(no_drop_path):
    """In f64 on both sides: in f32 the gradients cancel (every encoder
    conv feeds an InstanceNorm), and f32 rounding alone put them up to 1%
    of their largest magnitude apart, where in f64 the two steps agree to
    5.4e-8 of it."""
    jax_model, params, _ = _jax_variables("swinunetr", 40)
    x, xt, y = swinunetr_batch(41)
    grads, new_state, met_j = _jax_step(lambda tx: jax_make_supervised_step(jax_model, tx, 2),
                                        params, {}, x, y, np.float64)
    old = convert.swinunetr_state_dict_from_jax(_f64(params))
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=FS)
    model.load_state_dict(old, strict=True)
    model = no_port_drop_path(model).double().train()
    opt = PolySGD(model.parameters(), 0.01, 10)
    met_p = make_supervised_step(model, opt, 2)(
        {"image": torch.from_numpy(xt).double(), "label": torch.from_numpy(y).long()})
    assert all(v.dtype == torch.float64 for v in met_p.values())
    _assert_step(model, old, convert.swinunetr_state_dict_from_jax(grads),
                 convert.swinunetr_state_dict_from_jax(new_state.params), met_p, met_j,
                 SUPERVISED_METRIC_KEYS)


class _State:
    """The one field of a JAX TrainState the pretrained loaders use."""

    def __init__(self, params):
        self.params = params

    def replace(self, params):
        return _State(params)


def _jax_dropped(monkeypatch) -> list:
    dropped = []
    monkeypatch.setattr(jax_torch_import, "_report_dropped",
                        lambda d, what: dropped.extend(path for path, _ in d))
    return dropped


def _flax_to_torch(table, flax_prefix: tuple, torch_prefix: str) -> dict:
    return {"/".join(flax_prefix + tuple(f)): torch_prefix + t for t, f, _ in table}


def _shape_drops(dropped) -> set:
    return {k for k, reason in dropped if reason.startswith("shape")}


def test_imagenet_swin_loader_matches_jax(tmp_path, monkeypatch, capsys):
    """A Swin-T layout checkpoint: the encoder keys of another draw, with
    each block's relative-position index, the classification head, and
    `layers.1.blocks.0.attn.qkv.weight` of the wrong shape (dropped twice:
    in the encoder and, mirrored, at `layers_up.2`)."""
    _, params, _ = _jax_variables("swinunet", 50)
    _, other, _ = _jax_variables("swinunet", 51)
    export = export_swinunet2d(other["swin_unet"], img_size=SWIN_SIDE, window=SWIN_WINDOW)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in export.items()
          if k.startswith(("patch_embed.", "layers.", "norm."))}
    sd["layers.1.blocks.0.attn.qkv.weight"] = torch.zeros(5, 7)
    sd["head.weight"], sd["head.bias"] = torch.ones(10, 8 * SWIN_EMBED), torch.ones(10)
    path = tmp_path / "swin_t.pth"
    torch.save({"model": sd}, path)

    dropped_j = _jax_dropped(monkeypatch)
    loaded_j = jax_torch_import.load_pretrained_swinunet(_State(params), str(path)).params
    model = net_factory("swinunet", 1, NCLS, device="cpu", swin_cfg=PORT_SWIN_CFG)

    def sd_of(tree):
        return convert.swinunet2d_state_dict_from_jax(tree["swin_unet"], SWIN_SIDE, SWIN_WINDOW,
                                                      torch_prefix="swin_unet.")

    model.load_state_dict(sd_of(params), strict=True)
    kept, dropped = load_pretrained_swinunet(model, str(path))
    want = sd_of(loaded_j)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    to_torch = _flax_to_torch(convert.swinunet2d_full_key_table(), ("swin_unet",), "swin_unet.")
    assert {to_torch[p] for p in dropped_j} == _shape_drops(dropped) == {
        "swin_unet.layers.1.blocks.0.attn.qkv.weight", "swin_unet.layers_up.2.blocks.0.attn.qkv.weight"}
    reasons = dict(dropped)
    assert reasons["head.weight"] == reasons["head.bias"] == "ImageNet classification head"
    assert reasons["swin_unet.layers.0.blocks.0.attn.relative_position_index"] == "no such parameter"
    assert "swin_unet.layers_up.3.blocks.1.mlp.fc2.bias" in kept
    out = capsys.readouterr().out
    assert "delete key swin_unet.layers.1.blocks.0.attn.qkv.weight" in out
    assert f"{len(kept)} keys loaded, {len(dropped) - 2} dropped" in out


def test_ssl_swinvit_loader_matches_jax(tmp_path, monkeypatch):
    """A MONAI SSL layout checkpoint (`module.swin_vit.` prefixes, MLPs as
    `linear1/linear2`) of another draw's encoder, plus a head the model
    lacks and `patch_embed.proj.weight` of the wrong shape."""
    _, params, _ = _jax_variables("swinunetr", 60)
    _, other, _ = _jax_variables("swinunetr", 61)
    sd = {f"module.swin_vit.{k[len('swinViT.'):]}": torch.from_numpy(np.array(v))
          for k, v in export_swinunetr(other).items() if k.startswith("swinViT.")}
    assert any(".mlp.linear1." in k for k in sd)
    sd["module.swin_vit.patch_embed.proj.weight"] = torch.zeros(FS, 1, 3, 3, 3)
    sd["module.contrastive_head.weight"] = torch.ones(4, 4)
    path = tmp_path / "model_swinvit.pt"
    torch.save({"state_dict": sd, "epoch": 3}, path)

    dropped_j = _jax_dropped(monkeypatch)
    loaded_j = jax_torch_import.load_pretrained_swinvit(_State(params), str(path)).params
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=FS)
    model.load_state_dict(convert.swinunetr_state_dict_from_jax(params), strict=True)
    kept, dropped = load_pretrained_swinvit(model, str(path))
    want = convert.swinunetr_state_dict_from_jax(loaded_j)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
        moved += name.startswith("swinViT.") and name in kept
    assert moved == len(kept) > 50
    assert dropped_j == ["swinViT/patch_embed_proj/Conv_0/kernel"]
    assert _shape_drops(dropped) == {"swinViT.patch_embed.proj.weight"}
    assert dict(dropped)["swinViT.contrastive_head.weight"] == "no such parameter"
