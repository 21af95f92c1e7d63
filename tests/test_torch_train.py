"""icl_tpu_torch's training path against the JAX package's: one ICL train
step (metrics, gradients, new parameters, BatchNorm stats), the poly LR
and the SGD update, the BraTS batches, the sampler and the synthetic
cases; then the attention launches a step makes with recompute on, and a
tiny training run through the CLI on the CPU whose stripped best
checkpoint reproduces the validation dice through the eval CLI.

Small size as `test_torch_icl.py`: feature_size 12, patch 32^3, batch 4
with 2 labeled, drop path off on both sides, f32, JAX matmuls at
"highest". Tolerances: metrics 1e-4 relative; each gradient and each
parameter update within 1e-3 of its largest magnitude plus 1e-6 (the
step sums over ~10^5 voxels through two deep passes in another order);
running means 1e-5.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.data.brats import brats_train_batches as jax_brats_train_batches
from icl_tpu.data.sampler import two_stream_batches as jax_two_stream_batches
from icl_tpu.data.synth import make_synthetic_brats
from icl_tpu.train.optim import make_sgd, poly_lr_schedule as jax_poly_lr
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_icl_step as jax_make_icl_step

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.data.brats import brats_train_batches
from icl_tpu_torch.data.sampler import two_stream_batches
from icl_tpu_torch.data.synth import synthetic_brats_cases
from icl_tpu_torch.ops import window_attention as wa
from icl_tpu_torch.train.optim import PolySGD, poly_lr_schedule
from icl_tpu_torch.train.steps import METRIC_KEYS, make_icl_step
from icl_tpu_torch.utils.convert import swinunetr_icl_state_dict_from_jax
from test_torch_icl import (  # noqa: F401  (no_drop_path is a fixture)
    LABELED_BS, NCLS, PATCH, batch, expected_running_var, jax_icl_variables, no_drop_path,
    port_icl_model)
from _torch_dp import assert_takes_multi_process_flags
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

BASE_LR, MAX_IT, CONSIS = 0.01, 10, 10.0


def _capture_grads() -> optax.GradientTransformation:
    """An optax stage that passes the gradients on and keeps them as its
    state, so the jitted JAX step hands them back."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, state, params=None: (g, g))


def _assert_close_to_scale(got: torch.Tensor, want: torch.Tensor, name: str):
    err = float((got - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()) + 1e-6, f"{name}: max err {err:.3e}"


def test_icl_step_matches_jax(no_drop_path):
    jax_model, params, bs = jax_icl_variables(5)
    x, xt, y = batch(6)
    tx = optax.chain(_capture_grads(), make_sgd(BASE_LR, MAX_IT))
    step = jax_make_icl_step(jax_model, tx, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)
    new_state, met_j = jax.jit(step)(TrainState.create(params, bs, tx),
                                     {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                                     jax.random.PRNGKey(0))

    model = port_icl_model(params, bs).train()
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    met_p = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(y).long()})

    assert set(met_p) == set(met_j) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(met_p[k]), float(met_j[k]), rtol=1e-4, err_msg=k)
    new_bs = new_state.batch_stats
    grads = swinunetr_icl_state_dict_from_jax(new_state.opt_state[0], new_bs)
    new = swinunetr_icl_state_dict_from_jax(new_state.params, new_bs)
    old = swinunetr_icl_state_dict_from_jax(params, bs)
    for name, p in model.named_parameters():
        _assert_close_to_scale(p.grad, grads[name], f"grad {name}")
        _assert_close_to_scale(p.detach() - old[name], new[name] - old[name], f"update {name}")
    sd = model.state_dict()
    for name in sd:
        if name.endswith("running_mean"):
            np.testing.assert_allclose(sd[name].numpy(), new[name].numpy(), atol=1e-5, err_msg=name)
        elif name.endswith("running_var"):
            res = int(name.split("attn_convs0.")[1].split(".")[0])
            n = LABELED_BS * NCLS * (2 * 2**res) ** 3
            updates = 2 if name.startswith("sspa.") else 1
            want = expected_running_var(old[name].numpy(), new[name].numpy(), n, updates)
            np.testing.assert_allclose(sd[name].numpy(), want, atol=1e-5, err_msg=name)


def test_poly_lr_and_sgd_updates_match_optax():
    """Five updates of one parameter with the same gradients: the LR of
    update k is lr(k - 1), weight decay goes in before momentum, and the
    new values agree with optax's chain."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [rng.standard_normal(7).astype(np.float32) for _ in range(5)]
    sched_j = jax_poly_lr(BASE_LR, 5)
    sched_p = poly_lr_schedule(BASE_LR, 5)
    for count in range(6):
        np.testing.assert_allclose(sched_p(count), float(sched_j(count)), rtol=1e-6)

    tx = make_sgd(BASE_LR, 5)
    pj, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = PolySGD([param], BASE_LR, 5)
    for k, g in enumerate(grads):
        updates, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.zero_grad()
        param.grad = torch.from_numpy(g.copy())
        assert opt.step() == sched_p(k)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(pj), atol=1e-7, rtol=1e-6)
    assert opt.count == 5


def test_optimizer_moves_parameters_without_gradient_by_weight_decay():
    param = torch.nn.Parameter(torch.ones(3))
    opt = PolySGD([param], 0.1, 10, weight_decay=0.5)
    opt.zero_grad()
    opt.step()
    torch.testing.assert_close(param.detach(), torch.full((3,), 0.95))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_attention_calls_forward_and_backward(remat, monkeypatch):
    """The attention calls of one step, counted on the CPU path: 8 Swin
    blocks per backbone pass and two passes give 16 forward and 16
    backward calls; recompute runs each block's forward once more in the
    backward, so 32 forward calls. `chip_smoke.py` asserts the same
    numbers for the kernels' launches at 96^3."""
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = wa.window_attention_plain, wa.window_attention_plain_bwd

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(wa, "window_attention_plain", count("fwd", plain_fwd))
    monkeypatch.setattr(wa, "window_attention_plain_bwd", count("bwd", plain_bwd))
    _, params, bs = jax_icl_variables(7)
    model = port_icl_model(params, bs, remat=remat).train()
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT)
    _, xt, y = batch(8)
    metrics = make_icl_step(model, opt, NCLS, LABELED_BS, (PATCH,) * 3, CONSIS)(
        {"image": torch.from_numpy(xt), "label": torch.from_numpy(y).long()})
    assert all(torch.isfinite(v) for v in metrics.values())
    assert calls == {"fwd": 32 if remat else 16, "bwd": 16}


def test_synthetic_cases_match_the_jax_fixture(tmp_path):
    h5py = pytest.importorskip("h5py")
    make_synthetic_brats(str(tmp_path), num_cases=3, size=24, seed=4)
    for case in synthetic_brats_cases(3, 24, seed=4):
        with h5py.File(tmp_path / "data" / f"{case['case']}.h5", "r") as f:
            np.testing.assert_array_equal(case["image"], f["image"][:])
            np.testing.assert_array_equal(case["label"], f["label"][:])


def test_brats_batches_and_sampler_match_jax():
    cases = synthetic_brats_cases(6, 30, seed=1)
    kw = dict(labeled_count=2, total_count=6, batch_size=4, labeled_bs=2, patch_size=(24, 20, 16),
              seed=3)
    got, want = brats_train_batches(cases, **kw), jax_brats_train_batches(cases, **kw)
    for _ in range(3):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["image"], np.moveaxis(w["image"], -1, 1))
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["image"].shape == (4, 1, 24, 20, 16) and g["image"].dtype == np.float32
    s_p = two_stream_batches(range(3), range(3, 9), 4, 2, seed=5)
    s_j = jax_two_stream_batches(range(3), range(3, 9), 4, 2, seed=5)
    assert [next(s_p) for _ in range(7)] == [list(map(int, next(s_j))) for _ in range(7)]


def test_config_checks_labeled_bs():
    assert ExperimentConfig(batch_size=4).labeled_bs == 4
    assert ExperimentConfig(batch_size=16).labeled_bs == 8
    for bad in (0, 5):
        with pytest.raises(ValueError, match="labeled_bs"):
            ExperimentConfig(batch_size=4, labeled_bs=bad)


def test_cli_refuses_unported_flags_and_needs_cuda(monkeypatch):
    from icl_tpu_torch.scripts import train_inherent_consistent_swinunetr_3D_BraTS as cli

    args = cli.parse_args(["--scan_steps", "1", "--dispatch_depth", "1"])
    assert (args.scan_steps, args.dispatch_depth) == (1, 1)
    assert (cli.parse_args(["--scan_steps", "4"]).scan_steps, cli.parse_args([]).dispatch_depth) == (4, 1)
    args = cli.parse_args([])
    assert (args.use_ssl_pretrained, args.ssl_ckpt) == (0, "../pretrained_models/model_swinvit.pt")
    args = cli.parse_args(["--use_ssl_pretrained", "1", "--ssl_ckpt", "ssl.pt"])
    assert (args.use_ssl_pretrained, args.ssl_ckpt) == (1, "ssl.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--root_path", "unused"])
    assert_takes_multi_process_flags(cli)


def test_cli_trains_on_cpu_and_eval_cli_reproduces_val_dice(tmp_path, monkeypatch):
    """Two steps at fs12, 32^3, batch 4 (2 labeled), f32, validation at
    step 2 on two held-out 40^3 cases; the stripped best checkpoint then
    loads strictly into SwinUNETR through the eval CLI and gives the same
    mean dice, exactly."""
    pytest.importorskip("h5py")
    from icl_tpu_torch.scripts import test_3D_BraTS
    from icl_tpu_torch.scripts import train_inherent_consistent_swinunetr_3D_BraTS as cli

    root = tmp_path / "BraTS"
    make_synthetic_brats(str(root), num_cases=6, size=40, seed=0)
    monkeypatch.chdir(tmp_path / "BraTS")  # snapshots land in ../experiments
    common = ["--root_path", str(root), "--exp", "BraTS/ICL", "--labeled_num", "2",
              "--num_tries", "t", "--patch_size", "32", "32", "32", "--feature_size", "12",
              "--device", "cpu"]
    result = cli.main(common + ["--max_iterations", "2", "--val_interval", "2", "--total_num", "4",
                                "--precision", "float32", "--seed", "3"])
    assert [r["iteration"] for r in result["log"]] == [1, 2]
    assert all(np.isfinite(r[k]) for r in result["log"] for k in METRIC_KEYS)
    assert result["best_mean_dice"] > 0 and result["best_path"] is not None
    snapshot = tmp_path / "experiments" / "BraTS" / "ICL_2_labeled" / "swinunetr_icl_exp_t"
    assert (snapshot / "log.txt").exists() and (snapshot / "model" / "model_best.pth").exists()
    total = test_3D_BraTS.main([a for a in common if a not in ("--total_num",)]
                               + ["--stride_xy", "64", "--stride_z", "64"])
    assert total[0] == result["vals"][-1]["mean_dice"]
