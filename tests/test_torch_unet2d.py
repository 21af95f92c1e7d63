"""icl_tpu_torch's 2D U-Net and U-Net-ICL against the JAX package's: the
align-corners upsample and the max pool, the weight carry
(`utils/convert.py` against `export_unet2d` and `export_icl_unet2d`, key
for key and bit for bit), the U-Net's logits, the whole U-Net-ICL in train
mode (its 5-tuple, with and without the fused `sspa` pair) and in
inference mode (its logits), the BatchNorm running stats after a
train-mode forward, `sspa_paired` against the two `sspa` calls, and the
BatchNorms of a freshly built model.

Small size: the JAX default U-Net features (16, 32, 64, 128, 256), patch
64 (ICL scales 8^2, 16^2, 32^2: N = 1024 at scale 2), 4 classes, batch 2
labeled + 2 unlabeled, `zero_stochastic` on both sides (dropout and drop
path off, the BatchNorm updates kept). Weights are drawn with numpy
(`test_torch_icl.draw_tree`) and carried across.

Tolerances: f32 on both sides, JAX matmuls at "highest". The resize and
the pool: 1e-6 absolute (two f32 taps summed in another order; the pool
exact). Logits and ICL maps: 1e-4 absolute and relative (sums of up to
~10^4 terms in another order through ten conv layers). BatchNorm running
means: 1e-5 absolute; running variances: 1e-5 absolute once flax's value
is carried to torch's by the n / (n - 1) factor (torch updates with the
unbiased batch variance, flax with the biased one). The fused `sspa` pair
against the two calls: 2e-5 absolute and relative, as
`tests/test_icl_pair_fusion.py` holds the JAX pair (the same arithmetic
on twice the rows, which a CPU matmul may block differently).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models import layers as jax_layers
from icl_tpu.models.unet2d import UNet as JaxUNet
from icl_tpu.models.unet2d_icl import UNetICL as JaxUNetICL
from icl_tpu.utils.torch_import import export_icl_unet2d, export_unet2d

from icl_tpu_torch.models import layers
from icl_tpu_torch.models.icl import sspa_paired
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swinunetr_icl import strip_icl_heads
from icl_tpu_torch.models.unet2d import UNet
from icl_tpu_torch.utils.convert import icl_unet2d_state_dict_from_jax, unet2d_state_dict_from_jax
from test_torch_icl import cl2cf, draw_tree, expected_running_var
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

PATCH, NCLS, LABELED_BS = 64, 4, 2
ATOL = RTOL = 1e-4


@functools.cache
def _jax_model_and_shapes(fuse: bool = False):
    model = JaxUNetICL(1, NCLS, patch_size=PATCH, fuse_sspa_pair=fuse, zero_stochastic=True)
    x = jnp.zeros((LABELED_BS, PATCH, PATCH, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))
    return model, shapes


def jax_variables(seed: int, fuse: bool = False):
    """(JAX UNetICL with zero_stochastic, params, batch_stats) drawn with numpy."""
    model, shapes = _jax_model_and_shapes(fuse)
    return model, draw_tree(shapes["params"], seed), draw_tree(shapes["batch_stats"], seed + 1)


def port_model(params, batch_stats, fuse: bool = False):
    model = net_factory("icl_unet", 1, NCLS, device="cpu", patch_size=PATCH, fuse_sspa_pair=fuse,
                        zero_stochastic=True)
    model.load_state_dict(icl_unet2d_state_dict_from_jax(params, batch_stats), strict=True)
    return model


def images(seed: int, n: int = 2 * LABELED_BS):
    """A seeded batch: NHWC for JAX, NCHW for the port."""
    x = np.random.default_rng(seed).standard_normal((n, PATCH, PATCH, 1)).astype(np.float32)
    return x, np.moveaxis(x, -1, 1).copy()


def bn_batch_sizes(model: torch.nn.Module) -> dict:
    """{BatchNorm name: [values per channel of each call]}, filled by the
    model's next forwards."""
    sizes = {}
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
            sizes[name] = []
            m.register_forward_pre_hook(
                lambda mod, inp, lst=sizes[name]: lst.append(inp[0].numel() // inp[0].shape[1]))
    return sizes


def assert_running_stats(model, sizes, old, new_jax):
    """Each BatchNorm's running stats against flax's after the same passes."""
    sd = model.state_dict()
    for name, calls in sizes.items():
        assert calls and len(set(calls)) == 1, (name, calls)
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(),
                                   new_jax[f"{name}.running_mean"].numpy(), atol=1e-5, err_msg=name)
        want = expected_running_var(old[f"{name}.running_var"].numpy(),
                                    new_jax[f"{name}.running_var"].numpy(), calls[0], len(calls))
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), want, atol=1e-5, err_msg=name)
        assert int(sd[f"{name}.num_batches_tracked"]) == len(calls), name


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 8, 8, 8), (2, 1, 1, 3)])
def test_upsample_and_max_pool_match_jax(shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x)
    want = cl2cf(jax_layers.upsample_align_corners(jnp.asarray(np.moveaxis(x, 1, -1)), 2))
    got = layers.upsample_align_corners(xt, 2).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if shape[2] % 2 == 0 and shape[3] % 2 == 0:
        pool = torch.nn.MaxPool2d(2)  # DownBlock's pool
        want = cl2cf(jax_layers.max_pool(jnp.asarray(np.moveaxis(x, 1, -1))))
        np.testing.assert_array_equal(pool(xt).numpy(), want)


def test_convert_matches_export_and_loads_strict():
    _, params, bs = jax_variables(0)
    sd = icl_unet2d_state_dict_from_jax(params, bs)
    want = export_icl_unet2d(params, bs)
    counts = {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(sd) - counts == set(want)
    assert all(int(sd[k]) == 0 for k in counts)
    for key, value in want.items():
        assert sd[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(sd[key].numpy(), value, err_msg=key)
    backbone = unet2d_state_dict_from_jax(params, bs)
    assert set(backbone) - counts == set(export_unet2d(params, bs))
    model = net_factory("icl_unet", 1, NCLS, device="cpu", patch_size=PATCH)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd, strict=True)
    stripped = strip_icl_heads(sd)
    assert set(stripped) == set(backbone)
    assert all(torch.equal(stripped[k], backbone[k]) for k in backbone)
    net_factory("icl_unet", 1, NCLS, device="cpu", inference=True).load_state_dict(stripped, strict=True)


def test_unet_logits_match_jax():
    """The plain U-Net in eval mode (running stats), weights from
    `export_unet2d` loaded strictly as they are (it writes no batch
    counts, which torch's BatchNorm then sets to 0)."""
    _, params, bs = jax_variables(1)
    params = {k: params[k] for k in ("encoder", "decoder")}
    bs = {k: bs[k] for k in ("encoder", "decoder")}
    x, xt = images(2)
    want = jax.jit(lambda v, x: JaxUNet(1, NCLS).apply(v, x, train=False))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    model = net_factory("unet", 1, NCLS, device="cpu").eval()
    assert isinstance(model, UNet)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in export_unet2d(params, bs).items()},
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fuse", [False, True], ids=["two_calls", "fused_pair"])
def test_unet_icl_train_mode_and_batch_stats_match_jax(fuse):
    jax_model, params, bs = jax_variables(3, fuse)
    x, xt = images(4)
    outs_j, mut = jax.jit(lambda v, a, b: jax_model.apply(v, a, b, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x[:LABELED_BS]), jnp.asarray(x[LABELED_BS:]))
    model = port_model(params, bs, fuse).train()
    sizes = bn_batch_sizes(model)
    xt = torch.from_numpy(xt)
    with torch.no_grad():
        outs_p = model(xt[:LABELED_BS], xt[LABELED_BS:])
    assert len(outs_p) == 5
    for i in (0, 1):
        np.testing.assert_allclose(outs_p[i].numpy(), cl2cf(outs_j[i]), atol=ATOL, rtol=RTOL,
                                   err_msg=f"logits {i}")
    for i in (2, 3, 4):
        assert len(outs_p[i]) == 3
        for s, (got, want) in enumerate(zip(outs_p[i], outs_j[i])):
            np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL,
                                       err_msg=f"maps {i} scale {s}")
    new = icl_unet2d_state_dict_from_jax(params, mut["batch_stats"])
    assert_running_stats(model, sizes, icl_unet2d_state_dict_from_jax(params, bs), new)
    # each backbone BatchNorm saw both branches, the sspa heads' twice, the uscl heads' once
    assert {len(sizes[n]) for n in sizes if n.startswith(("encoder", "decoder", "sspa"))} == {2}
    assert {len(sizes[n]) for n in sizes if n.startswith("uscl")} == {1}


def test_unet_icl_inference_logits_match_jax():
    jax_model, params, bs = jax_variables(5)
    x, xt = images(6, n=3)
    want = jax.jit(lambda v, x: jax_model.apply(v, x, train=False, inference=True))(
        {"params": params, "batch_stats": bs}, jnp.asarray(x))
    model = port_model(params, bs).eval()
    xt = torch.from_numpy(xt)
    with torch.no_grad():
        got = model(xt, inference=True)
        alone = model(xt)
    np.testing.assert_allclose(got.numpy(), cl2cf(want), atol=ATOL, rtol=RTOL)
    assert torch.equal(got, alone)


def test_sspa_paired_matches_two_calls():
    """The port's fused pair against its own two calls (what
    `tests/test_icl_pair_fusion.py` checks on the JAX side): the same maps
    and labeled queries, the same running stats and batch counts after."""
    _, params, bs = jax_variables(7)
    model = port_model(params, bs).train()
    _, xt = images(8)
    with torch.no_grad():
        _, feats_lab = model.decoder(model.encoder(torch.from_numpy(xt[:LABELED_BS])))
        _, feats_unlab = model.decoder(model.encoder(torch.from_numpy(xt[LABELED_BS:])))
    start = {k: v.clone() for k, v in model.sspa.state_dict().items()}
    with torch.no_grad():
        fm_lab, q_lab = model.sspa(feats_lab, modal="labeled")
        fm_consis, _ = model.sspa(feats_unlab, modal="labeled")
        two_calls = {k: v.clone() for k, v in model.sspa.state_dict().items()}
        model.sspa.load_state_dict(start)
        fused = sspa_paired(model.sspa, feats_lab, feats_unlab)
    for got, want in zip(fused, (fm_lab, fm_consis, q_lab)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=2e-5)
    for k, v in model.sspa.state_dict().items():
        np.testing.assert_allclose(v.numpy(), two_calls[k].numpy(), atol=2e-5, rtol=2e-5, err_msg=k)
    with pytest.raises(ValueError, match="labeled mode only"):
        model.sspa(feats_unlab, q_lab, modal="unlabeled", pair_split=1)


@pytest.mark.parametrize("net_type", ["unet", "icl_unet"])
def test_fresh_model_batchnorms_are_initialised(net_type):
    """`build_model` makes the model on the meta device and then in empty
    CPU memory: every BatchNorm, the backbone's too, must come out as
    torch's nn.BatchNorm2d starts: weight 1, bias 0, mean 0, var 1, count 0."""
    model = net_factory(net_type, 1, NCLS, device="cpu", patch_size=32)
    norms = [(n, m) for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(norms) == (18 if net_type == "unet" else 30)
    for name, m in norms:
        assert torch.equal(m.weight, torch.ones_like(m.weight)), name
        assert torch.equal(m.bias, torch.zeros_like(m.bias)), name
        assert torch.equal(m.running_mean, torch.zeros_like(m.running_mean)), name
        assert torch.equal(m.running_var, torch.ones_like(m.running_var)), name
        assert int(m.num_batches_tracked) == 0, name
