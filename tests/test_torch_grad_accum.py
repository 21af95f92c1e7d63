"""icl_tpu_torch's gradient accumulation (`cfg.grad_accum`, `PolySGD`'s
accumulator) against the JAX package's `optax.MultiSteps`
(`icl_tpu/train/trainer.py:76-79`): k = 2 micro-steps per update on
different seeded batches against the JAX supervised step under
MultiSteps; k micro-steps on one batch against one k = 1 update, twice;
the parameters frozen inside a window; the gradient reduction over the
ranks in the optimizer alone, once per update; a resume in the middle of a
window;
the bf16 refusal; the ACDC config presets; `fit`'s step groups; 2 gloo
ranks against one process; and the logged LR beside the JAX trainer's.

Small sizes: the 2D U-Net at 32^2, batch 4, in f64 on both sides against
JAX (the JAX align-corners weights and one-hot kept in f64, as
`test_torch_train_unet2d.py` says why), dropout off on both sides;
U-Net-ICL at 32^2 with `zero_stochastic` for the trainer and the ranks.
Tolerances: against JAX, parameters and momentum within 1e-9 (f64 sums in
another order) and the running stats within 1e-9 after torch's
n / (n - 1) factor on the variance (ROADMAP queue 3); 2 ranks against 1
process within 1e-9; everything else bit for bit.
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu import losses as jax_losses
from icl_tpu.config import ExperimentConfig as JaxConfig
from icl_tpu.models import layers as jax_layers
from icl_tpu.models.registry import net_factory as jax_net_factory
from icl_tpu.train.optim import make_sgd
from icl_tpu.train.optim import poly_lr_schedule as jax_poly_lr_schedule
from icl_tpu.train.state import TrainState
from icl_tpu.train.steps import make_supervised_step as jax_make_supervised_step
from icl_tpu.train.trainer import Trainer as JaxTrainer

from icl_tpu_torch.config import ExperimentConfig
from icl_tpu_torch.models.layers import Dropout
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.train.steps import make_supervised_step
from icl_tpu_torch.train.trainer import Trainer
from icl_tpu_torch.utils import checkpoint as ckpt
from icl_tpu_torch.utils.convert import icl_unet2d_state_dict_from_jax, unet2d_state_dict_from_jax
from _torch_dp import run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_data_parallel import _jax_unet2d
from test_torch_icl import draw_tree, expected_running_var
from test_torch_train_unet2d import _exact_align_corners_matrix
from test_torch_unet2d import bn_batch_sizes
from test_torch_unet3d import no_stochastic_jax  # noqa: F401  (a fixture)

K, NCLS, BATCH, LABELED_BS, SIDE = 2, 4, 4, 2, 32
BASE_LR, MAX_IT = 0.01, 10
TOL = 1e-9


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _batches(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((BATCH, SIDE, SIDE, 1)),
             "label": rng.integers(0, NCLS, (BATCH, SIDE, SIDE)).astype(np.int32)} for _ in range(n)]


def _torch_batch(b: dict, dtype=torch.float64) -> dict:
    return {"image": torch.from_numpy(np.moveaxis(b["image"], -1, 1).copy()).to(dtype),
            "label": torch.from_numpy(b["label"]).long()}


def _jax_multisteps(params, bs, batches):
    """The JAX supervised U-Net step under optax.MultiSteps(k = K) in f64:
    the parameters, momentum and batch stats after each micro-step."""
    model = jax_net_factory("unet", 1, NCLS)
    out = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "_align_corners_matrix", _exact_align_corners_matrix)
        mp.setattr(jax_losses, "one_hot", lambda labels, n: jax.nn.one_hot(labels, n, dtype=jnp.float64))
        f64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        tx = optax.MultiSteps(make_sgd(BASE_LR, MAX_IT), every_k_schedule=K)
        state = TrainState.create(f64(params), f64(bs), tx)
        step = jax.jit(jax_make_supervised_step(model, tx, NCLS))
        for b in batches:
            state, _ = step(state, {"image": jnp.asarray(b["image"], jnp.float64),
                                    "label": jnp.asarray(b["label"])}, jax.random.PRNGKey(0))
            host = jax.device_get(state)
            out.append({"params": host.params, "batch_stats": host.batch_stats,
                        "trace": host.opt_state.inner_opt_state[1].trace})
    return out


def test_micro_steps_match_jax_multisteps(no_stochastic_jax):
    """4 micro-steps (2 updates) on 4 different batches: after each, every
    parameter, momentum buffer and running stat against JAX's."""
    model_j = jax_net_factory("unet", 1, NCLS)
    shapes = jax.eval_shape(lambda: model_j.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((BATCH, SIDE, SIDE, 1)), train=True))
    params, bs = draw_tree(shapes["params"], 31), draw_tree(shapes["batch_stats"], 32)
    batches = _batches(33, 2 * K)
    want = _jax_multisteps(params, bs, batches)

    old = unet2d_state_dict_from_jax(_f64(params),
                                     _f64(bs))
    model = net_factory("unet", 1, NCLS, device="cpu")
    model.load_state_dict(old, strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    model = model.double().train()
    sizes = bn_batch_sizes(model)
    opt = PolySGD(model.parameters(), BASE_LR, MAX_IT, grad_accum=K)
    step = make_supervised_step(model, opt, NCLS)
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (b, w) in enumerate(zip(batches, want)):
        step(_torch_batch(b))
        new = unet2d_state_dict_from_jax(w["params"], w["batch_stats"])
        trace = unet2d_state_dict_from_jax(w["trace"], w["batch_stats"])
        for n, p in model.named_parameters():
            err = float((p.detach() - new[n]).abs().max())
            assert err <= TOL, (i, n, err)
        for n, buf in zip(names, opt.momentum_buffers):
            assert float((buf - trace[n]).abs().max()) <= TOL, (i, n)
        if i % K < K - 1:  # inside a window: nothing moved
            assert all(torch.equal(p, before[n]) for n, p in model.named_parameters()), i
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        sd = model.state_dict()
        for name, calls in sizes.items():
            np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(),
                                       new[f"{name}.running_mean"].numpy(), atol=TOL, rtol=0)
            var = expected_running_var(old[f"{name}.running_var"].numpy(),
                                       new[f"{name}.running_var"].numpy(), calls[0], len(calls))
            np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(), var, atol=TOL, rtol=0)
    assert opt.count == 2 and opt.micro == 0


def _cfg(tmp_path, **kw):
    base = dict(root_path="unused", exp="accum", model="icl_unet", num_classes=NCLS,
                batch_size=BATCH, labeled_bs=LABELED_BS, patch_size=(SIDE, SIDE),
                max_iterations=MAX_IT, seed=0, val_interval=0, log_flops=False,
                experiments_dir=str(tmp_path), model_kwargs={"zero_stochastic": True})
    base.update(kw)
    return ExperimentConfig(**base)


def _port_batches(seed: int, n: int) -> list:
    return [_torch_batch(b, torch.float32) for b in _batches(seed, n)]


def _params(trainer) -> dict:
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def test_k_micro_steps_on_one_batch_equal_one_update_twice(tmp_path):
    """U-Net-ICL: K micro-steps on one batch give the parameters and
    momentum of one K = 1 update, bit for bit, across two updates; the
    parameters do not move inside a window; the LR of the second update is
    lr(1)."""
    (batch,) = _port_batches(40, 1)
    acc = Trainer(_cfg(tmp_path, grad_accum=K), device="cpu")
    ref = Trainer(_cfg(tmp_path), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_params(acc).values(), _params(ref).values()))
    for update in range(2):
        start = _params(acc)
        for micro in range(K - 1):
            acc.train_step(batch)
            assert all(torch.equal(p, start[n]) for n, p in _params(acc).items()), (update, micro)
        acc.train_step(batch)
        ref.train_step(batch)
        for (n, p), q in zip(_params(acc).items(), _params(ref).values()):
            assert torch.equal(p, q), (update, n)
        for a, b in zip(acc.optimizer.momentum_buffers, ref.optimizer.momentum_buffers):
            assert torch.equal(a, b)
        assert not all(torch.equal(p, start[n]) for n, p in _params(acc).items())
        assert acc.optimizer.count == ref.optimizer.count == update + 1
        assert float(acc.optimizer.lr) == float(ref.optimizer.lr) == np.float32(
            BASE_LR * (1 - update / MAX_IT) ** 0.9)
    # the accumulator is cleared at each update
    assert all(not a.any() for a in acc.optimizer.accumulators)


@pytest.mark.parametrize("grad_accum", [1, K])
def test_the_optimizer_is_the_one_place_that_reduces(tmp_path, monkeypatch, grad_accum):
    """U-Net-ICL: over 2K steps the gradient reduction over the ranks
    (`reduce_mean_`, nothing with one process) runs once per update, inside
    `PolySGD.step` and only at an update: on every parameter's gradient
    with grad_accum 1 (a zero gradient for a parameter that got none), on
    the accumulators with grad_accum > 1. Nothing reduces the gradients
    through `reduce_gradients`."""
    import icl_tpu_torch.parallel.collectives as collectives
    import icl_tpu_torch.train.optim as optim

    def refuse(*args, **kwargs):
        raise AssertionError("the step reduced the gradients outside the optimizer")

    trainer = Trainer(_cfg(tmp_path, grad_accum=grad_accum), device="cpu")
    opt = trainer.optimizer
    calls = []

    def record(tensors, group=None):
        calls.append((opt.count, opt.micro, list(tensors)))

    monkeypatch.setattr(optim, "reduce_mean_", record)
    monkeypatch.setattr(collectives, "reduce_gradients", refuse)
    for step, batch in enumerate(_port_batches(47, 2 * K)):
        before = len(calls)
        trainer.train_step(batch)
        assert len(calls) - before == int((step + 1) % grad_accum == 0), step
    assert [(c, m) for c, m, _ in calls] == [(u, grad_accum - 1) for u in range(2 * K // grad_accum)]
    want = opt.accumulators if grad_accum > 1 else [p.grad for p in opt.params]
    assert len(want) == len(opt.params)
    assert all(t is w for t, w in zip(calls[-1][2], want))


@pytest.mark.parametrize("through", ["memory", "file"])
def test_resume_in_the_middle_of_a_window_is_bitwise(tmp_path, through):
    """3 steps (a window and a half), the train state saved, a new trainer
    restored from it takes a 4th: bit for bit the state of 4 steps in one
    run; the saved state holds the accumulators and the micro-step."""
    batches = _port_batches(41, 4)
    run = Trainer(_cfg(tmp_path, grad_accum=K, num_tries="a"), device="cpu")
    for b in batches:
        run.train_step(b)
    first = Trainer(_cfg(tmp_path, grad_accum=K, num_tries="b"), device="cpu")
    for b in batches[:3]:
        first.train_step(b)
    state = first.train_state()
    assert state["optimizer"]["micro"] == 1 and len(state["optimizer"]["accumulators"]) == len(
        first.optimizer.params)
    assert any(a.any() for a in state["optimizer"]["accumulators"])
    resumed = Trainer(_cfg(tmp_path, grad_accum=K, num_tries="b"), device="cpu")
    if through == "file":
        ckpt.save_train_state(first.cfg.snapshot_path, state, "last")
        assert resumed.restore_state() == 3
    else:
        resumed.load_train_state(ckpt.host_copy(state))
    assert (resumed.optimizer.micro, resumed.optimizer.count, resumed.iteration) == (1, 1, 3)
    resumed.train_step(batches[3])
    for (n, p), q in zip(_params(resumed).items(), _params(run).values()):
        assert torch.equal(p, q), n
    for a, b in zip(resumed.optimizer.momentum_buffers, run.optimizer.momentum_buffers):
        assert torch.equal(a, b)
    for a, b in zip(resumed.model.buffers(), run.model.buffers()):
        assert torch.equal(a, b)
    # a window in progress does not load into another grad_accum
    other = Trainer(_cfg(tmp_path, grad_accum=3, num_tries="c"), device="cpu")
    with pytest.raises(ValueError, match="micro-steps into a window of 2"):
        other.load_train_state(ckpt.host_copy(state))


def test_bf16_state_and_bad_counts_are_refused_as_jax_refuses_them(tmp_path):
    for cls in (ExperimentConfig, JaxConfig):
        with pytest.raises(ValueError, match="state_dtype='bfloat16' requires grad_accum=1"):
            cls(state_dtype="bfloat16", grad_accum=2)
        with pytest.raises(ValueError, match="grad_accum"):
            cls(grad_accum=0)
        assert cls(state_dtype="bfloat16").grad_accum == 1
    p = torch.nn.Parameter(torch.zeros(3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="requires grad_accum=1"):
        PolySGD([p], BASE_LR, MAX_IT, state_dtype="bfloat16", grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum 0"):
        PolySGD([torch.nn.Parameter(torch.zeros(3))], BASE_LR, MAX_IT, grad_accum=0)


@pytest.mark.parametrize("preset", ["acdc_icl_config", "acdc_supervised_config"])
def test_acdc_presets_match_jax(preset):
    """The two ACDC presets give the JAX ones' values on every field both
    configs have, with and without overrides."""
    import dataclasses

    from icl_tpu import config as jax_config
    from icl_tpu_torch import config as port_config

    for overrides in ({}, {"batch_size": 8, "labeled_bs": 4, "grad_accum": 2, "exp": "x"}):
        got = getattr(port_config, preset)(**overrides)
        want = getattr(jax_config, preset)(**overrides)
        shared = {f.name for f in dataclasses.fields(got)} & {f.name for f in dataclasses.fields(want)}
        assert len(shared) > 30
        assert {k: getattr(got, k) for k in shared} == {k: getattr(want, k) for k in shared}
    assert port_config.acdc_supervised_config().replace(seed=1).seed == 1


def _fit(tmp_path, tries: str, scan_steps: int, steps: int = 8):
    cfg = _cfg(tmp_path, grad_accum=K, scan_steps=scan_steps, max_iterations=steps,
               num_tries=tries, checkpoint_interval=3)
    trainer = Trainer(cfg, device="cpu")
    return trainer, trainer.fit(iter(_port_batches(42, steps)))


def test_fit_groups_of_four_equal_single_steps_and_log_each_updates_lr(tmp_path):
    """`fit` with scan_steps 4 (groups cut at the checkpoint every 3 steps)
    against scan_steps 1, 8 micro-steps: the same parameters, momentum and
    log, bit for bit; each logged LR is that of the update its step belongs
    to, lr((it - 1) // K)."""
    one, res_one = _fit(tmp_path, "one", 1)
    four, res_four = _fit(tmp_path, "four", 4)
    for (n, p), q in zip(_params(one).items(), _params(four).values()):
        assert torch.equal(p, q), n
    assert [r["loss"] for r in res_one["log"]] == [r["loss"] for r in res_four["log"]]
    sched = one.optimizer.schedule
    assert [r["lr"] for r in res_four["log"]] == [sched((it - 1) // K) for it in range(1, 9)]
    assert one.optimizer.count == 4 and one.optimizer.micro == 0
    # the saves at steps 3 and 6 are in the middle of a window
    assert [s["iteration"] for s in res_four["saves"]] == [3, 6, 8]


def test_logged_lr_beside_the_jax_trainers(tmp_path):
    """The JAX trainer logs Info/lr = lr(iteration - 1) at each micro-step
    (`icl_tpu/train/trainer.py:313`), an LR its MultiSteps update does not
    use (the update of steps 3-4 runs at lr(1)); the port logs lr((it - 1)
    // K), the LR its update runs at (ROADMAP queue 3)."""
    steps = 4
    cfg = JaxConfig(model="unet", num_classes=NCLS, batch_size=BATCH, labeled_bs=LABELED_BS,
                    patch_size=(16, 16), max_iterations=MAX_IT, grad_accum=K, val_interval=0,
                    log_flops=False, compile_cache_dir="", experiments_dir=str(tmp_path / "jax"))
    jax_trainer = JaxTrainer(cfg)
    state = jax_trainer.init_state(jax.random.PRNGKey(0))
    jax_batches = [{"image": b["image"][:, :16, :16].astype(np.float32), "label": b["label"][:, :16, :16]}
                   for b in _batches(43, steps)]
    jax_trainer.fit(state, iter(jax_batches))
    with open(os.path.join(cfg.snapshot_path, "log", "scalars.jsonl")) as f:
        jax_lr = [r["value"] for r in map(json.loads, f) if r["tag"] == "Info/lr"]
    sched = jax_poly_lr_schedule(BASE_LR, MAX_IT)
    np.testing.assert_allclose(jax_lr, [float(sched(it - 1)) for it in range(1, steps + 1)], rtol=1e-6)

    trainer = Trainer(_cfg(tmp_path / "port", grad_accum=K), device="cpu")  # stops with the batches
    port_lr = [r["lr"] for r in trainer.fit(iter(_port_batches(43, steps)))["log"]]
    np.testing.assert_allclose(port_lr, [float(sched((it - 1) // K)) for it in range(1, steps + 1)],
                               rtol=1e-6)
    assert port_lr[1] != jax_lr[1] and port_lr[3] != jax_lr[3]
    # the step that closed the second window updated at lr(1): the optimizer's LR tensor
    assert float(trainer.optimizer.lr) == pytest.approx(float(sched(1)), rel=1e-6)


def test_two_gloo_ranks_accumulate_as_one_process(tmp_path):
    """U-Net-ICL, f64, K = 2, 4 micro-steps: each rank on its rows of the
    global batches (its mean reduced once a window) against one process on
    the whole batches, after every micro-step; the ranks bit for bit."""
    model, shapes = _jax_unet2d(SIDE)
    old = icl_unet2d_state_dict_from_jax(
        _f64(draw_tree(shapes["params"], 44)),
        _f64(draw_tree(shapes["batch_stats"], 45)))
    batches = [_torch_batch(b) for b in _batches(46, 2 * K)]
    job = {"classes": NCLS, "patch": SIDE, "labeled_bs": LABELED_BS, "consis": 50.0, "lr": BASE_LR,
           "max_it": MAX_IT, "grad_accum": K, "old": old, "batches": batches}
    ranks = run_ranks(tmp_path, "accum", job)
    from _torch_dp import task_accum

    one = task_accum(job, 0, 1)
    assert ranks[0]["count"] == one["count"] == 2 and ranks[0]["micro"] == one["micro"] == 0
    for i, (r0, r1, want) in enumerate(zip(ranks[0]["states"], ranks[1]["states"], one["states"])):
        for n in want["params"]:
            assert torch.equal(r0["params"][n], r1["params"][n]), (i, n)
            err = float((r0["params"][n] - want["params"][n]).abs().max())
            assert err <= TOL * max(1.0, float(want["params"][n].abs().max())), (i, n, err)
        for a, b in zip(r0["momentum"], want["momentum"]):
            assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max())), i
