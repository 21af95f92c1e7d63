"""icl_tpu_torch's tensor-parallel ICL steps against the JAX package's
single-device step, the step JAX's own dp x tp test holds its sharded step
to (`tests/test_dp_tp_equivalence.py`), on the CPU in f64 with
`zero_stochastic` on both sides:

  * U-Net-ICL 2D over dp2 x tp2 (4 gloo processes), with and without the
    fused `sspa` pair, at 16^2, batch 8 of which 4 labeled;
  * SwinUNETR-ICL over tp=2 (2 processes) at feature size 12, window 4,
    32^3, batch 4 of which 2 labeled (`dryrun_multichip`'s configuration),
    in `test_torch_tensor_parallel_swin.py`, which takes this file's
    reference and checks;

every loss term, every parameter and its momentum gathered in the
one-process layout, and the BatchNorm running stats, with the tolerances
of `test_torch_data_parallel.py` (metrics 1e-4 relative; parameters'
updates and momentum within 1e-3 of their largest magnitude plus 1e-6;
running stats 1e-5 after the n / (n - 1) factor). Besides: after 2
Trainer steps over dp2 x tp2 with dropout and drop path on, every
replicated leaf bit for bit equal across the ranks; `create_mesh`'s
refusals in the 4 processes; the sliding window of a sharded SwinUNETR
over the data group against one process.
"""
import functools

import flax.linen as flax_nn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu.models import layers as jax_layers
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

import _torch_tp
from _torch_dp import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from icl_tpu_torch.eval.infer3d import make_fused_sliding_window
from icl_tpu_torch.models.layers import build_model
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL
from icl_tpu_torch.train.steps import METRIC_KEYS
from icl_tpu_torch.utils.convert import icl_unet2d_state_dict_from_jax, swinunetr_icl_state_dict_from_jax
from test_torch_icl import draw_tree, expected_running_var
from test_torch_train import _assert_close_to_scale, _capture_grads
from test_torch_train_unet2d import _exact_align_corners_matrix
from test_torch_unet2d import bn_batch_sizes

BASE_LR, MAX_IT, WD = 0.01, 10, 1e-4
UNET = dict(kind="icl_unet", classes=4, patch=16, dims=2, batch=8, labeled_bs=4, consis=50.0)
SWIN = dict(kind="swinunetr_icl", classes=2, patch=32, dims=3, batch=4, labeled_bs=2, consis=10.0,
            feature_size=12, window=4)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_model(case: dict):
    if case["kind"] == "icl_unet":
        return jax_net_factory("icl_unet", 1, case["classes"], patch_size=case["patch"],
                               zero_stochastic=True)
    return jax_net_factory("swinunetr_icl", 1, case["classes"], patch_size=case["patch"],
                           feature_size=case["feature_size"], window_size=(case["window"],) * 3)


def jax_icl_step_f64(model, case: dict, params, bs, x, y):
    """One ICL step of the JAX `model` in f64 (its align-corners weights,
    map resizes and one-hot labels kept in f64, dropout and drop path
    off) from `params`, `bs` on the image batch `x` (channels last) and
    labels `y`: (new state, metrics) on the host; the new state's optimizer
    state holds the gradients first."""
    spatial = (case["patch"],) * case["dims"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_align_corners_matrix", _exact_align_corners_matrix)
        mp.setattr(jax_losses, "_resize_maps", lambda fm, s: jax.image.resize(
            fm, (fm.shape[0], *s, fm.shape[-1]), method="linear"))
        mp.setattr(jax_losses, "one_hot", lambda labels, n: jax.nn.one_hot(labels, n, dtype=jnp.float64))
        mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax_layers.DropPath, "__call__", lambda self, x, train: x)
        tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
        step = jax_make_icl_step(model, tx, case["classes"], case["labeled_bs"], spatial,
                                 case["consis"])
        new_state, metrics = jax.jit(step)(TrainState.create(_f64(params), _f64(bs), tx),
                                           {"image": jnp.asarray(x, jnp.float64),
                                            "label": jnp.asarray(y)}, jax.random.PRNGKey(0))
        return jax.device_get((new_state, metrics))


@functools.cache
def _reference(name: str):
    """(the ranks' job case, the JAX step's (old, grads, new state, metrics)
    in the port's layout)."""
    case = dict(UNET if name != "swinunetr_icl" else SWIN)
    model = _jax_model(case)
    spatial = (case["patch"],) * case["dims"]
    x0 = jnp.zeros((case["labeled_bs"], *spatial, 1))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x0, x0, train=True))
    params, bs = draw_tree(shapes["params"], 5), draw_tree(shapes["batch_stats"], 6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((case["batch"], *spatial, 1)).astype(np.float32)
    y = rng.integers(0, case["classes"], (case["batch"], *spatial)).astype(np.int32)
    new_state, metrics = jax_icl_step_f64(model, case, params, bs, x, y)
    convert = (icl_unet2d_state_dict_from_jax if case["kind"] == "icl_unet"
               else swinunetr_icl_state_dict_from_jax)
    new_bs = new_state.batch_stats
    old = convert(_f64(params), _f64(bs))
    job = dict(case, old=old, lr=BASE_LR, max_it=MAX_IT, fuse=name == "fused_pair",
               batch={"image": torch.from_numpy(np.moveaxis(x, -1, 1).copy()).double(),
                      "label": torch.from_numpy(y).long()})
    return job, (old, convert(new_state.opt_state[0], new_bs), convert(new_state.params, new_bs),
                 {k: float(v) for k, v in metrics.items()})


def _replicas_job():
    rng = np.random.default_rng(11)
    n, p = UNET["batch"], UNET["patch"]
    cfg = dict(model="icl_unet", num_classes=4, batch_size=n, labeled_bs=UNET["labeled_bs"],
               patch_size=(p, p), max_iterations=MAX_IT, seed=3)
    return {"cfg": cfg, "batches": [{"image": rng.standard_normal((n, 1, p, p)).astype(np.float32),
                                     "label": rng.integers(0, 4, (n, p, p))} for _ in range(2)]}


SLIDING = {"feature_size": 12, "patch": (32,) * 3, "sw_batch": 2, "stride": 16,
           "volume": np.random.default_rng(0).standard_normal((48, 40, 36)).astype(np.float32)}


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory):
    job = {"model": 2, "cases": {name: _reference(name)[0] for name in ("two_calls", "fused_pair")},
           "replicas": _replicas_job(), "sliding_window": SLIDING}
    return run_ranks(tmp_path_factory.mktemp("dp2_tp2"), "steps", job, world=4,
                     script=_torch_tp.__file__)


def _bn_calls(job: dict) -> dict:
    """Each BatchNorm's values per channel of each call in the one-process
    forward of the global batch (the global n), by a forward of the port's
    model."""
    if job["kind"] == "icl_unet":
        model = net_factory("icl_unet", 1, job["classes"], device="cpu", patch_size=job["patch"],
                            zero_stochastic=True)
    else:
        model = build_model(SwinUNETRICL, 1, job["classes"], img_size=job["patch"],
                            feature_size=job["feature_size"], window_size=(job["window"],) * 3,
                            device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(job["old"], strict=True)
    model = model.double().train()
    sizes = bn_batch_sizes(model)
    x = job["batch"]["image"]
    with torch.no_grad():
        model(x[:job["labeled_bs"]], x[job["labeled_bs"]:])
    return sizes


def _check_against_jax(name: str, ranks: list, reference: str | None = None):
    """The ranks' case `name` against the JAX step of case `reference`
    (default `name`)."""
    job, (old, grads, new, met_j) = _reference(reference or name)
    first = ranks[0][name]
    for r in ranks[1:]:  # every rank holds the same whole state
        for k, v in first["state"].items():
            assert torch.equal(r[name]["state"][k], v), k
    assert set(first["metrics"]) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(first["metrics"][k], met_j[k], rtol=1e-4, err_msg=k)
    state = first["state"]
    assert len(first["momentum"]) > 100
    for n, mom in first["momentum"].items():
        _assert_close_to_scale(state[n] - old[n], new[n] - old[n], f"update {n}")
        _assert_close_to_scale(mom, grads[n] + WD * old[n], f"momentum {n}")
    for bn, calls in _bn_calls(job).items():
        assert calls and len(set(calls)) == 1, (bn, calls)
        np.testing.assert_allclose(state[f"{bn}.running_mean"].numpy(),
                                   new[f"{bn}.running_mean"].numpy(), atol=1e-5, err_msg=bn)
        want = expected_running_var(old[f"{bn}.running_var"].numpy(), new[f"{bn}.running_var"].numpy(),
                                    calls[0], len(calls))
        np.testing.assert_allclose(state[f"{bn}.running_var"].numpy(), want, atol=1e-5, err_msg=bn)
        assert int(state[f"{bn}.num_batches_tracked"]) == len(calls), bn
    assert len(first["sharded"]) > 60


@pytest.mark.parametrize("name", ["two_calls", "fused_pair"])
def test_dp2_tp2_flagship_step_matches_the_jax_single_device_step(dp2_tp2, name):
    assert [r["mesh"] for r in dp2_tp2] == [(0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]
    _check_against_jax(name, dp2_tp2)


def test_replicated_leaves_stay_bitwise_equal_with_dropout_on(dp2_tp2):
    """Two Trainer steps over dp2 x tp2 with the U-Net's dropout and the
    heads' drop path on: masks seeded by the data rank, so the ranks of a
    model group draw the same ones; every replicated leaf (parameters,
    running stats, counters) is equal bit for bit on all four ranks."""
    first = dp2_tp2[0]["replicas"]
    assert len(first) > 100
    for r in dp2_tp2[1:]:
        assert set(r["replicas"]) == set(first)
        for k, v in first.items():
            assert torch.equal(r["replicas"][k], v), k


def test_create_mesh_refuses_grids_of_four_processes(dp2_tp2):
    for r in dp2_tp2:
        assert r["refused"] == ["data=3 x model=1 is not the 4 processes",
                                "model=3 does not divide the 4 processes",
                                "data=4 x model=2 is not the 4 processes"]


def test_sliding_window_of_a_sharded_model_over_the_data_group(dp2_tp2):
    """The label map of a SwinUNETR sharded over tp=2, its patches split
    over the two data ranks, against one process's."""
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=SLIDING["feature_size"],
                        generator=torch.Generator().manual_seed(0)).eval()
    want = make_fused_sliding_window(model, 2, SLIDING["patch"], sw_batch=SLIDING["sw_batch"],
                                     device="cpu")(SLIDING["volume"], SLIDING["stride"], SLIDING["stride"])
    assert len(np.unique(want)) == 2
    for r in dp2_tp2:
        np.testing.assert_array_equal(r["label_map"], want)
