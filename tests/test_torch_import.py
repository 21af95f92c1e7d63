"""Torch→Flax weight conversion: layout transforms verified against
torch.nn.functional, and the UNet2D converter checked structurally
against a real flax param tree."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from icl_tpu.utils import torch_import as ti
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def test_conv_transform_matches_torch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 3, 8, 8)).astype(np.float32)  # NCHW
    w = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), padding=1).numpy()
    x_f = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    got = jax.lax.conv_general_dilated(
        x_f, jnp.asarray(ti.t2f_conv(w)), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + jnp.asarray(b)
    np.testing.assert_allclose(
        np.transpose(np.asarray(got), (0, 3, 1, 2)), want, atol=2e-5
    )


def test_convtranspose_transform_matches_torch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 5, 5)).astype(np.float32)
    w = rng.normal(size=(4, 6, 2, 2)).astype(np.float32)  # (in, out, k, k)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), stride=2).numpy()

    class CT(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.ConvTranspose(6, (2, 2), strides=(2, 2), padding="VALID")(x)

    m = CT()
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 4)))
    v = {"params": {"ConvTranspose_0": {"kernel": jnp.asarray(ti.t2f_convT(w)),
                                        "bias": jnp.asarray(b)}}}
    got = m.apply(v, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    np.testing.assert_allclose(
        np.transpose(np.asarray(got), (0, 3, 1, 2)), want, atol=2e-5
    )


def test_linear_transform_matches_torch():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7)).astype(np.float32)
    w = rng.normal(size=(4, 7)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = F.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    got = np.asarray(jnp.asarray(x) @ jnp.asarray(ti.t2f_linear(w)) + b)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_unet2d_converter_structure():
    """Every path the converter emits must exist with the right shape in
    a freshly-initialized UNet tree (and cover all its conv/bn leaves)."""
    from icl_tpu.models.registry import net_factory

    m = net_factory("unet", 1, 4)
    v = m.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
               jnp.zeros((1, 16, 16, 1)), train=True)

    # Build a fake torch state_dict with shapes inverted from the flax tree
    table = ti.unet2d_key_table()
    flat_params = {}

    def flatten(tree, prefix=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                flatten(val, prefix + (k,))
            else:
                flat_params[prefix + (k,)] = np.asarray(val)

    flatten(v["params"])
    flat_bs = {}
    flatten_bs = v["batch_stats"]

    def flatten2(tree, prefix=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                flatten2(val, prefix + (k,))
            else:
                flat_bs[prefix + (k,)] = np.asarray(val)

    flatten2(flatten_bs)

    sd = {}
    for t_key, f_path, tf in table:
        if f_path[0] == "__bs__":
            ref = flat_bs[f_path[1:]]
            sd[t_key] = np.random.default_rng(0).normal(size=ref.shape).astype(np.float32)
        else:
            ref = flat_params[f_path]
            if tf is ti.t2f_conv:
                shape = (ref.shape[-1], ref.shape[-2]) + ref.shape[:-2]
            elif tf is ti.t2f_convT:
                shape = (ref.shape[-2], ref.shape[-1]) + ref.shape[:-2]
            elif tf is ti.t2f_linear:
                shape = ref.shape[::-1]
            else:
                shape = ref.shape
            sd[t_key] = np.random.default_rng(1).normal(size=shape).astype(np.float32)

    params, batch_stats, missing = ti.convert_unet2d(sd)
    assert not missing

    def check(sub, ref, prefix=()):
        for k, val in sub.items():
            assert k in ref, f"extra key {prefix + (k,)}"
            if isinstance(val, dict):
                check(val, ref[k], prefix + (k,))
            else:
                assert np.shape(val) == np.shape(ref[k]), prefix + (k,)

    check(params, v["params"])
    check(batch_stats, v["batch_stats"])
    # full coverage of params
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(batch_stats))
    n_ref = len(jax.tree.leaves(v["params"])) + len(jax.tree.leaves(v["batch_stats"]))
    assert n_leaves == n_ref


def test_export_roundtrip():
    """params -> torch dialect -> params is the identity."""
    from icl_tpu.models.registry import net_factory

    m = net_factory("unet", 1, 4)
    v = m.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
               jnp.zeros((1, 16, 16, 1)), train=True)
    sd = ti.export_unet2d(jax.device_get(v["params"]), jax.device_get(v["batch_stats"]))
    params2, bs2, missing = ti.convert_unet2d(sd)
    assert not missing

    def cmp(a, b):
        for k, val in a.items():
            if isinstance(val, dict):
                cmp(val, b[k])
            else:
                np.testing.assert_array_equal(np.asarray(val), np.asarray(b[k]))

    cmp(params2, v["params"])
    cmp(bs2, v["batch_stats"])


def test_imagenet_swin_remap():
    sd = {"layers.0.blocks.0.norm1.weight": np.ones(3), "head.weight": np.ones(2)}
    out = ti.imagenet_swin_remap(sd)
    assert "layers_up.3.blocks.0.norm1.weight" in out
    assert "head.weight" not in out


def test_prune_mismatched_reports_drops(caplog):
    import logging

    dst = {"a": {"w": np.zeros((3, 3)), "b": np.zeros(3)},
           "c": np.zeros(5)}
    src = {"a": {"w": np.zeros((3, 3)), "b": np.zeros(4)},  # shape mismatch
           "c": np.zeros(5),
           "ghost": np.zeros(1)}  # absent from model
    kept, dropped = ti.prune_mismatched(dst, src)
    assert set(kept) == {"a", "c"}
    assert set(kept["a"]) == {"w"}
    reasons = dict(dropped)
    assert "a/b" in reasons and "shape (4,)" in reasons["a/b"]
    assert reasons["ghost"] == "no such parameter"
    with caplog.at_level(logging.INFO):
        ti._report_dropped(dropped, "test ckpt")
    assert sum("delete key" in r.message for r in caplog.records) == 2
