"""icl_tpu_torch's Swin-UNet 2D and Swin-UNet-ICL against the JAX package's:
the geometry helpers, the weight carry (`utils/convert.py` against
`export_swinunet2d`, buffers included, and the tokenized heads against
`export_icl_heads`), the whole Swin-UNet-ICL in train mode (its 5-tuple,
with the two `sspa` calls and with the fused pair, the latter also against
the port's two calls) and in inference mode (its logits), the BatchNorm running stats after a
train-mode forward, the yaml config, and the attention calls per forward.

Small size: embed 12, 96^2 input, window 12, 4 classes, batch 4 with 2
labeled. Stage 1 (24^2 tokens) then has 4 windows of N = 144 and shifts;
stage 2 (12^2) runs one unshifted window of 144; the rest is smaller.
The JAX side runs with ICL_TPU_PALLAS=1 and ICL_TPU_PALLAS_INTERPRET=1, so
its N = 144 blocks go through `_kernel_masked` (shifted) and `_kernel`
(unshifted) in Pallas interpret mode, and the smaller ones through its
einsum; the port sends every block through its fused op, which runs the
plain version on the CPU. Weights are drawn with numpy and carried across;
drop path is off on both sides (`no_drop_path`, as test_torch_icl.py).

Tolerances: f32 on both sides, JAX matmuls at "highest"; 1e-4 absolute
and relative on logits and maps, 1e-5 on the BatchNorm stats; the fused
pair against the two calls 2e-5 (tests/test_torch_unet2d.py's rule).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models import swin2d as jax_swin2d
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.models.swin_config import get_swin_config as jax_get_swin_config
from icl_tpu.utils.torch_import import export_icl_heads, export_swinunet2d

from icl_tpu_torch.models import swin2d
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swin_config import get_swin_config
from icl_tpu_torch.models.swinunetr_icl import strip_icl_heads
from icl_tpu_torch.ops import window_attention as wa
from icl_tpu_torch.utils.convert import icl_swinunet2d_state_dict_from_jax, swinunet2d_state_dict_from_jax
from test_torch_icl import cl2cf, draw_tree, expected_running_var, no_drop_path, no_port_drop_path  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

IMG, WINDOW, EMBED, NCLS, LABELED_BS = 96, 12, 12, 4, 2
ATOL = RTOL = 1e-4
JAX_CFG = jax_swin2d.SwinConfig(img_size=IMG, window_size=WINDOW, embed_dim=EMBED)
PORT_CFG = swin2d.SwinConfig(img_size=IMG, window_size=WINDOW, embed_dim=EMBED)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("ICL_TPU_PALLAS", "1")
    monkeypatch.setenv("ICL_TPU_PALLAS_INTERPRET", "1")


@functools.cache
def _jax_model_and_shapes(fuse: bool = False):
    model = jax_net_factory("icl_swinunet", 1, NCLS, swin_cfg=JAX_CFG, fuse_sspa_pair=fuse)
    x = jnp.zeros((LABELED_BS, IMG, IMG, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))
    return model, shapes


def jax_variables(seed: int, fuse: bool = False):
    """(JAX SwinUNetICL, params, batch_stats) drawn with numpy."""
    model, shapes = _jax_model_and_shapes(fuse)
    return model, draw_tree(shapes["params"], seed), draw_tree(shapes["batch_stats"], seed + 1)


def port_model(params, batch_stats, fuse: bool = False):
    model = net_factory("icl_swinunet", 1, NCLS, device="cpu", swin_cfg=PORT_CFG, fuse_sspa_pair=fuse)
    model.load_state_dict(icl_swinunet2d_state_dict_from_jax(params, batch_stats, IMG, WINDOW),
                          strict=True)
    return no_port_drop_path(model)


def images(seed: int, n: int = 2 * LABELED_BS):
    """A seeded batch: NHWC for JAX, NCHW for the port."""
    x = np.random.default_rng(seed).standard_normal((n, IMG, IMG, 1)).astype(np.float32)
    return x, np.moveaxis(x, -1, 1).copy()


@pytest.mark.parametrize("side,ws,shift", [(14, 7, 3), (24, 12, 6), (96, 12, 6)])
def test_geometry_helpers_match_jax(side, ws, shift):
    np.testing.assert_array_equal(swin2d.relative_position_index_2d(ws),
                                  jax_swin2d.relative_position_index_2d(ws))
    np.testing.assert_array_equal(swin2d.shifted_window_mask(side, side, ws, shift),
                                  jax_swin2d.shifted_window_mask(side, side, ws, shift))
    x = np.random.default_rng(side).standard_normal((2, side, side, 5)).astype(np.float32)
    win = swin2d.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jax_swin2d.window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(swin2d.window_reverse(win, ws, side, side).numpy(), x)


def test_convert_matches_export_with_buffers_and_loads_strict():
    """The backbone's state_dict equals `export_swinunet2d`, buffers
    included, and that export loads strictly into the port; the full
    model's loads strictly and, heads stripped, into SwinUnetWrapper."""
    _, params, bs = jax_variables(0)
    export = export_swinunet2d(params["swin_unet"], img_size=IMG, window=WINDOW)
    sd = swinunet2d_state_dict_from_jax(params["swin_unet"], IMG, WINDOW)
    assert set(sd) == set(export)
    assert any(k.endswith("attn_mask") for k in export)
    for key, value in export.items():
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
        assert sd[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
    backbone = swin2d.SwinUNet2D(NCLS, PORT_CFG)
    backbone.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in export.items()}, strict=True)

    full = icl_swinunet2d_state_dict_from_jax(params, bs, IMG, WINDOW)
    heads = {k: v for k, v in export_icl_heads(params, bs).items() if ".proj_layers." not in k
             and ".norm_layers." not in k}
    for key, value in heads.items():
        np.testing.assert_array_equal(full[key].numpy(), value, err_msg=key)
    model = net_factory("icl_swinunet", 1, NCLS, device="cpu", swin_cfg=PORT_CFG)
    assert set(model.state_dict()) == set(full)
    assert not any(".proj_layers." in k or ".norm_layers." in k for k in full)
    model.load_state_dict(full, strict=True)
    wrapper = net_factory("icl_swinunet", 1, NCLS, device="cpu", swin_cfg=PORT_CFG, inference=True)
    assert type(wrapper).__name__ == "SwinUnetWrapper"
    wrapper.load_state_dict(strip_icl_heads(full), strict=True)


def _train_forward_against_jax(fuse: bool):
    """The port's 5-tuple and model after one train-mode forward, held
    against the JAX model's with the same `fuse_sspa_pair`."""
    jax_model, params, bs = jax_variables(1, fuse)
    x, xt = images(2)
    outs_j, mut = jax.jit(lambda p, b, xl, xu: jax_model.apply(
        {"params": p, "batch_stats": b}, xl, xu, train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(params, bs, jnp.asarray(x[:LABELED_BS]),
                                                   jnp.asarray(x[LABELED_BS:]))
    model = port_model(params, bs, fuse).train()
    outs_p = model(torch.from_numpy(xt[:LABELED_BS]), torch.from_numpy(xt[LABELED_BS:]))
    assert len(outs_p) == 5
    for got, want in zip(outs_p[:2], outs_j[:2]):
        assert got.shape == (LABELED_BS, NCLS, IMG, IMG)
        np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    res = (6, 12, 24)
    for maps_p, maps_j in zip(outs_p[2:], outs_j[2:]):
        assert [m.shape[2:] for m in maps_p] == [(r, r) for r in res]
        for got, want in zip(maps_p, maps_j):
            np.testing.assert_allclose(got.detach().numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    sd = model.state_dict()
    for head, updates in (("sspa", 2), ("uscl", 1)):
        for i, r in enumerate(res):
            for bn in ("bn_depth", "bn_point"):
                node = mut["batch_stats"][head][f"attn_conv0_{i}"][bn]["BatchNorm_0"]
                old = bs[head][f"attn_conv0_{i}"][bn]["BatchNorm_0"]
                key = f"{head}.attn_convs0.{i}.block.{bn}"
                np.testing.assert_allclose(sd[f"{key}.running_mean"].numpy(), np.asarray(node["mean"]),
                                           atol=1e-5, rtol=1e-5)
                want_var = expected_running_var(np.asarray(old["var"]), np.asarray(node["var"]),
                                                n=LABELED_BS * NCLS * r * r, updates=updates)
                np.testing.assert_allclose(sd[f"{key}.running_var"].numpy(), want_var, atol=1e-5,
                                           rtol=1e-5)
    return outs_p, model, (params, bs, xt)


def test_swinunet_icl_train_forward_matches_jax(no_drop_path, pallas_interpret):
    """The 5-tuple of one train-mode forward, and the running stats of
    both heads after it: sspa runs twice (labeled, then unlabeled), uscl
    once."""
    _train_forward_against_jax(fuse=False)


def test_swinunet_icl_fused_pair_matches_jax_and_two_calls(no_drop_path, pallas_interpret):
    """`fuse_sspa_pair`: the 5-tuple and the running stats against the
    JAX model's fused pair, and against the port's two calls from the
    same weights (every output and every state entry, 2e-5)."""
    fused, model, (params, bs, xt) = _train_forward_against_jax(fuse=True)
    two = port_model(params, bs).train()
    want = two(torch.from_numpy(xt[:LABELED_BS]), torch.from_numpy(xt[LABELED_BS:]))
    for got, ref in zip(fused[:2], want[:2]):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=2e-5)
    for maps_f, maps_t in zip(fused[2:], want[2:]):
        for got, ref in zip(maps_f, maps_t):
            np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=2e-5)
    ref_sd = two.state_dict()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=2e-5, rtol=2e-5, err_msg=k)


def test_swinunet_icl_inference_logits_match_jax(pallas_interpret):
    """inference=True runs the backbone alone; so does the SwinUnetWrapper
    that the stripped checkpoint loads into."""
    jax_model, params, bs = jax_variables(3)
    x, xt = images(4, n=2)
    want = jax_model.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), train=False,
                           inference=True)
    model = port_model(params, bs).eval()
    wrapper = net_factory("swinunet", 1, NCLS, device="cpu", swin_cfg=PORT_CFG).eval()
    wrapper.load_state_dict(strip_icl_heads(model.state_dict()), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(xt), inference=True)
        assert torch.equal(got, model(torch.from_numpy(xt)))
        assert torch.equal(got, wrapper(torch.from_numpy(xt)))
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)


def test_swin_config_yaml_matches_jax(tmp_path):
    """The repo's yaml, and a window-12 384^2 copy of it as a `--cfg` of
    the training CLI would give it, map onto the same fields."""
    import dataclasses

    path = "configs/swin_tiny_patch4_window7_224_lite.yaml"
    w12 = tmp_path / "w12.yaml"
    w12.write_text(open(path).read().replace("WINDOW_SIZE: 7", "WINDOW_SIZE: 12"))
    for p in (path, str(w12)):
        got = dataclasses.asdict(get_swin_config(p, img_size=384))
        want = dataclasses.asdict(jax_get_swin_config(p, img_size=384))
        want.pop("remat")  # JAX only: block remat, which the 2D CLI never sets
        assert got == want
    assert get_swin_config(str(w12), img_size=384).window_size == 12
    assert get_swin_config() == swin2d.SwinConfig()


def test_every_block_calls_the_fused_op(monkeypatch):
    """One forward of the full-width backbone geometry (embed 12 here) at
    384^2, window 12: the attention of all 16 blocks goes through the
    fused op, the 6 shifted ones with their dense mask; 8 + 6 calls, the
    launches `chip_smoke.py` asserts per forward on the card."""
    calls = {"none": 0, "mask": 0}
    plain = wa.window_attention_plain

    def count(q, k, v, bias, region_ids=None, mask=None, *, scale):
        calls["mask" if mask is not None else "none"] += 1
        assert q.shape[2] == 144 and region_ids is None
        return plain(q, k, v, bias, region_ids, mask, scale=scale)

    monkeypatch.setattr(wa, "window_attention_plain", count)
    model = net_factory("swinunet", 1, NCLS, device="cpu",
                        swin_cfg=swin2d.SwinConfig(img_size=384, window_size=12, embed_dim=12))
    with torch.no_grad():
        out = model(torch.zeros(1, 1, 384, 384))
    assert out.shape == (1, NCLS, 384, 384)
    assert calls == {"none": 8, "mask": 6}
