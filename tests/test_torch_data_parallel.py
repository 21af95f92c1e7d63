"""icl_tpu_torch's data-parallel ICL step against the JAX package's
single-device step: two gloo ranks on the CPU, each with its share of
each branch of the global batch (`parallel.multihost.host_rows`), take the
step of the global batch, as `icl_tpu/train/steps.py:make_icl_step` takes
it on a batch sharded over the data axis (every BatchNorm's statistics,
the labeled query mean, the Dice sums and the CE and MSE means over the
global batch); the reductions alone against the one-process values on the
concatenated batch; and the 3D U-Net's upsample against F.interpolate.

Small sizes, f64 where a step is compared (`test_torch_train_unet2d.py`
says why): U-Net-ICL at 32^2, with and without the fused `sspa` pair, and
U-Net-ICL 3D at 16^3, batch 4 of which 2 labeled, `zero_stochastic` on
both sides. Tolerances as `test_torch_train_unet2d.py::test_icl_step_matches_jax`
against JAX (metrics 1e-4 relative; gradients and updates within 1e-3 of
their largest magnitude plus 1e-6; running stats 1e-5 absolute after the
n / (n - 1) factor, n the global count); against the port's own
one-process step and for the reductions, 1e-9 of the scale (f64 sums in
another order); the two ranks' states bit for bit, with an f64 and with a
bf16 train state.
"""
import functools

import flax.linen as flax_nn
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu.models import layers as jax_layers
from icl_tpu.models.unet2d_icl import UNetICL as JaxUNetICL
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

from icl_tpu_torch import losses
from icl_tpu_torch.models import layers
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.unet3d import UpBlock3D
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.utils.convert import icl_unet2d_state_dict_from_jax, icl_unet3d_state_dict_from_jax
from _torch_dp import run_ranks
from test_torch_icl import draw_tree, expected_running_var
from test_torch_train import _assert_close_to_scale, _capture_grads
from test_torch_train_unet2d import _exact_align_corners_matrix
from test_torch_unet2d import bn_batch_sizes
from test_torch_unet3d import jax_variables as jax_variables_3d
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

NCLS_2D, NCLS_3D, LABELED_BS, BATCH = 4, 2, 2, 4
PATCH_2D, PATCH_3D = 32, 16
BASE_LR, MAX_IT = 0.01, 10
CONSIS_2D, CONSIS_3D = 50.0, 10.0
CASES = {"two_calls": ("icl_unet", False), "fused_pair": ("icl_unet", True),
         "unet_3D_icl": ("unet_3D_icl", False)}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.cache
def _jax_unet2d(patch: int):
    model = JaxUNetICL(1, NCLS_2D, patch_size=patch, zero_stochastic=True)
    x = jnp.zeros((LABELED_BS, patch, patch, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, x, train=True))
    return model, shapes


def _jax_step(model, params, bs, x, y, spatial, ncls, consis):
    """One jitted JAX ICL step in f64 (its upsampling weights, loss maps and
    one-hot kept in f64, its dropout and drop path the identity): (grads,
    new state, metrics) on the host."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_align_corners_matrix", _exact_align_corners_matrix)
        mp.setattr(jax_losses, "_resize_maps", lambda fm, s: jax.image.resize(
            fm, (fm.shape[0], *s, fm.shape[-1]), method="linear"))
        mp.setattr(jax_losses, "one_hot", lambda labels, n: jax.nn.one_hot(labels, n, dtype=jnp.float64))
        mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax_layers.DropPath, "__call__", lambda self, x, train: x)
        tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
        step = jax_make_icl_step(model, tx, ncls, LABELED_BS, spatial, consis)
        new_state, metrics = jax.jit(step)(TrainState.create(_f64(params), _f64(bs), tx),
                                           {"image": jnp.asarray(x, jnp.float64),
                                            "label": jnp.asarray(y)}, jax.random.PRNGKey(0))
        new_state, metrics = jax.device_get((new_state, metrics))
    return new_state.opt_state[0], new_state, {k: float(v) for k, v in metrics.items()}


@functools.cache
def _case(kind: str):
    """(job case for the ranks, JAX reference (old, grads, new, metrics))."""
    rng = np.random.default_rng(7)
    if kind == "icl_unet":
        model, shapes = _jax_unet2d(PATCH_2D)
        params, bs = draw_tree(shapes["params"], 5), draw_tree(shapes["batch_stats"], 6)
        spatial, ncls, consis, convert = (PATCH_2D,) * 2, NCLS_2D, CONSIS_2D, icl_unet2d_state_dict_from_jax
    else:
        model, params, bs = jax_variables_3d(5, patch=PATCH_3D)
        spatial, ncls, consis, convert = (PATCH_3D,) * 3, NCLS_3D, CONSIS_3D, icl_unet3d_state_dict_from_jax
    x = rng.standard_normal((BATCH, *spatial, 1)).astype(np.float32)
    y = rng.integers(0, ncls, (BATCH, *spatial)).astype(np.int32)
    grads, new_state, metrics = _jax_step(model, params, bs, x, y, spatial, ncls, consis)
    old = convert(_f64(params), _f64(bs))
    new_bs = new_state.batch_stats
    job = {"model": kind, "classes": ncls, "patch": spatial[0], "dims": len(spatial),
           "labeled_bs": LABELED_BS, "consis": consis, "lr": BASE_LR, "max_it": MAX_IT, "old": old,
           "batch": {"image": torch.from_numpy(np.moveaxis(x, -1, 1).copy()).double(),
                     "label": torch.from_numpy(y).long()}}
    return job, (old, convert(grads, new_bs), convert(new_state.params, new_bs), metrics)


def _bf16_job():
    """A bf16-state U-Net-ICL Trainer at 32^2 for two steps (f32 forward)."""
    rng = np.random.default_rng(11)
    cfg = dict(model="icl_unet", num_classes=NCLS_2D, batch_size=BATCH, labeled_bs=LABELED_BS,
               patch_size=(PATCH_2D, PATCH_2D), max_iterations=MAX_IT, state_dtype="bfloat16",
               seed=3, model_kwargs={"zero_stochastic": True})
    batches = [{"image": rng.standard_normal((BATCH, 1, PATCH_2D, PATCH_2D)).astype(np.float32),
                "label": rng.integers(0, NCLS_2D, (BATCH, PATCH_2D, PATCH_2D))} for _ in range(2)]
    return {"cfg": cfg, "batches": batches}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Each case's JAX reference and both ranks' results, from one pair of
    worker processes."""
    refs, jobs = {}, {}
    for name, (kind, fuse) in CASES.items():
        job, refs[name] = _case(kind)
        jobs[name] = dict(job, fuse=fuse)
    ranks = run_ranks(tmp_path_factory.mktemp("steps"), "steps", {"cases": jobs, "bf16": _bf16_job()})
    return jobs, refs, ranks


def _one_rank_step(job):
    """The port's one-process step on the global batch, and the count of
    each BatchNorm call (the global n)."""
    model = net_factory(job["model"], 1, job["classes"], device="cpu", patch_size=job["patch"],
                        fuse_sspa_pair=job["fuse"], zero_stochastic=True)
    model.load_state_dict(job["old"], strict=True)
    model = model.double().train()
    sizes = bn_batch_sizes(model)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    metrics = make_icl_step(model, opt, job["classes"], LABELED_BS, (job["patch"],) * job["dims"],
                            job["consis"])(job["batch"])
    return model, opt, {k: float(v) for k, v in metrics.items()}, sizes


def _close(got: torch.Tensor, want: torch.Tensor, name: str, rtol: float = 1e-9):
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()) + 1e-12, f"{name}: max err {err:.3e}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_step_matches_jax(two_ranks, name):
    jobs, refs, ranks = two_ranks
    old, grads, new, met_j = refs[name]
    got = ranks[0][name]
    assert set(got["metrics"]) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got["metrics"][k], met_j[k], rtol=1e-4, err_msg=k)
    state = got["state"]
    for n, g in got["grads"].items():
        _assert_close_to_scale(g, grads[n], f"grad {n}")
        _assert_close_to_scale(state[n] - old[n], new[n] - old[n], f"update {n}")
    _, _, _, sizes = _one_rank_step(jobs[name])
    for bn, calls in sizes.items():
        assert calls and len(set(calls)) == 1, (bn, calls)
        np.testing.assert_allclose(state[f"{bn}.running_mean"].numpy(),
                                   new[f"{bn}.running_mean"].numpy(), atol=1e-5, err_msg=bn)
        want = expected_running_var(old[f"{bn}.running_var"].numpy(), new[f"{bn}.running_var"].numpy(),
                                    calls[0], len(calls))
        np.testing.assert_allclose(state[f"{bn}.running_var"].numpy(), want, atol=1e-5, err_msg=bn)
        assert int(state[f"{bn}.num_batches_tracked"]) == len(calls), bn


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_rank_step_matches_the_one_rank_step(two_ranks, name):
    jobs, _, ranks = two_ranks
    model, opt, metrics, _ = _one_rank_step(jobs[name])
    got = ranks[0][name]
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=1e-10, err_msg=k)
    for n, p in model.named_parameters():
        _close(got["grads"][n], p.grad, f"grad {n}")
    for k, v in model.state_dict().items():
        _close(got["state"][k].double(), v.double(), k)
    for i, buf in enumerate(opt.momentum_buffers):
        _close(got["momentum"][i], buf, f"momentum {i}")


@pytest.mark.parametrize("name", sorted(CASES) + ["bf16"])
def test_replicas_stay_bitwise_equal(two_ranks, name):
    _, _, (r0, r1) = two_ranks
    assert r0[name]["state"].keys() == r1[name]["state"].keys()
    for k, v in r0[name]["state"].items():
        assert torch.equal(v, r1[name]["state"][k]), k
    for a, b in zip(r0[name]["momentum"], r1[name]["momentum"]):
        assert torch.equal(a, b)
    if name == "bf16":
        assert any(v.dtype == torch.bfloat16 for v in r0[name]["state"].values())


@pytest.fixture(scope="module")
def reductions(tmp_path_factory):
    rng = np.random.default_rng(3)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape))  # noqa: E731
    job = {"x": t(4, 3, 5, 6), "weight": 1.0 + 0.1 * t(3), "bias": 0.1 * t(3),
           "labels": torch.from_numpy(rng.integers(0, 3, (4, 5, 6))), "q": t(4, 2, 8),
           "maps": (t(4, 3, 5, 6), t(4, 3, 5, 6))}
    return job, run_ranks(tmp_path_factory.mktemp("reductions"), "reductions", job)


def test_global_batch_norm_matches_the_concatenated_batch(reductions):
    """Output, running stats (unbiased with the global n = 60), and the
    gradients of a loss that takes the BatchNorm's output through the
    global Dice and CE sums: the input's gradient is W times the global
    loss's on every rank (every reduction's backward sums the ranks' seeds
    once, however many reductions a term passes), the affine gradients
    after `reduce_gradients` are the global loss's."""
    job, ranks = reductions
    x = job["x"].clone().requires_grad_(True)
    bn = layers.batch_norm(3, 2).double()
    with torch.no_grad():
        bn.weight.copy_(job["weight"])
        bn.bias.copy_(job["bias"])
    y = bn(x)
    loss = (losses.multiclass_dice_loss(y, job["labels"], 3, softmax=True)
            + losses.cross_entropy_loss(y, job["labels"]))
    loss.backward()
    for r, got in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        _close(got["y"], y[rows].detach(), "output")
        _close(got["loss"], loss.detach(), "loss")
        _close(got["x_grad"] / 2, x.grad[rows], "input grad / W")
        _close(got["weight_grad"], bn.weight.grad, "weight grad")
        _close(got["bias_grad"], bn.bias.grad, "bias grad")
        _close(got["running_mean"], bn.running_mean, "running_mean")
        _close(got["running_var"], bn.running_var, "running_var")
    want_var = 0.9 + 0.1 * job["x"].var(dim=(0, 2, 3), correction=1)
    _close(ranks[0]["running_var"], want_var, "running_var, unbiased over n = 60")


def test_global_query_mean_dice_ce_and_mse_match_the_concatenated_batch(reductions):
    job, ranks = reductions
    a, b = job["maps"]
    want = {"query_mean": job["q"].mean(0, keepdim=True),
            "dice": losses.multiclass_dice_loss(a, job["labels"], 3, softmax=True),
            "soft_dice": losses.softmax_dice_loss(a, b), "ce": losses.cross_entropy_loss(a, job["labels"]),
            "mse": losses.softmax_mse_loss([a], [b])}
    for got in ranks:
        for k, v in want.items():
            _close(got[k], v, k)
    # a one-rank share alone is another value: the sums are global
    assert abs(float(losses.multiclass_dice_loss(a[:2], job["labels"][:2], 3, softmax=True))
               - float(want["dice"])) > 1e-6


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 2, 3, 1, 2)])
def test_3d_upsample_matches_trilinear_interpolate(shape):
    """`UpBlock3D`'s upsample (`resize_linear`, half-pixel grid) against
    F.interpolate's trilinear mode, in f64, values and gradients."""
    x = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(shape)).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape[:2] + tuple(2 * n for n in shape[2:])))
    got = layers.resize_linear(x, [2 * n for n in shape[2:]], align_corners=False)
    (dx_got,) = torch.autograd.grad(got, x, g)
    want = F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)
    (dx_want,) = torch.autograd.grad(want, x, g)
    assert float((got - want).abs().max()) <= 1e-12
    assert float((dx_got - dx_want).abs().max()) <= 1e-12
    names = UpBlock3D.forward.__code__.co_names
    assert "resize_linear" in names and "interpolate" not in names
