"""icl_tpu_torch's LR schedules (`train/schedulers.py`) and ramps
(`utils/ramps.py`) against the JAX package's: every schedule at every
update count from 0 up to and past each of its boundaries (warm-up end,
milestones, the last step), within 1e-6 of the JAX schedule's f32 value;
the three ramps at every count of their lengths; and one
`PolySGD(schedule=...)` step against the JAX `sgd_with_schedule` chain,
whose LR is that schedule at the update count.
"""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.train import schedulers as jax_schedulers
from icl_tpu.utils import ramps as jax_ramps

from icl_tpu_torch.train import schedulers
from icl_tpu_torch.train.optim import PolySGD
from icl_tpu_torch.utils import ramps
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

TOL = 1e-6

# (name, args, the last count to check): each past its last boundary
CASES = {
    "poly": ("poly_lr_schedule", (0.01, 30), 34),
    "warmup_cosine": ("warmup_cosine_schedule", (0.01, 5, 30), 34),
    "warmup_cosine_cycles": ("warmup_cosine_schedule", (0.05, 3, 20, 1.5), 24),
    "linear_warmup_cosine": ("linear_warmup_cosine_annealing", (0.01, 4, 25), 29),
    "linear_warmup_cosine_from": ("linear_warmup_cosine_annealing", (0.02, 4, 25, 1e-3, 1e-4), 29),
    "warmup_poly": ("warmup_poly_schedule", (0.01, 30, 6), 34),
    "warmup_poly_factor": ("warmup_poly_schedule", (0.01, 30, 6, 0.1, 2.0), 34),
    "multistep": ("warmup_multistep_schedule", (0.01, (8, 15, 22)), 26),
    "multistep_warmup": ("warmup_multistep_schedule", (0.01, (15, 8), 0.5, 5, 0.01), 20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_jax_at_every_count(case):
    name, args, last = CASES[case]
    got = getattr(schedulers, name)(*args)
    want = jax.jit(getattr(jax_schedulers, name)(*args))
    counts = np.arange(last + 1)
    want_values = np.asarray(jax.vmap(want)(jnp.asarray(counts, jnp.int32)))
    got_values = np.asarray([got(int(c)) for c in counts])
    assert all(isinstance(got(int(c)), float) for c in counts[:3])
    np.testing.assert_allclose(got_values, want_values, atol=TOL, rtol=0)
    assert len(set(np.round(got_values, 9))) > 2  # the schedule moves over the range


def test_ramps_match_jax():
    for length in (0, 1, 7, 40):
        for current in np.arange(-2, length + 3, 0.5):
            assert ramps.sigmoid_rampup(current, length) == pytest.approx(
                jax_ramps.sigmoid_rampup(current, length), abs=1e-12)
            assert ramps.linear_rampup(current, length) == pytest.approx(
                jax_ramps.linear_rampup(current, length), abs=1e-12)
            if length and 0 <= current <= length:
                assert ramps.cosine_rampdown(current, length) == pytest.approx(
                    jax_ramps.cosine_rampdown(current, length), abs=1e-12)
    with pytest.raises(ValueError, match="outside"):
        ramps.cosine_rampdown(5, 4)
    with pytest.raises(AssertionError):
        jax_ramps.cosine_rampdown(5, 4)


@pytest.mark.parametrize("updates", [1, 3])
def test_polysgd_with_a_schedule_matches_sgd_with_schedule(updates):
    """Torch-order SGD at a warm-up-cosine LR: `updates` updates of two
    parameters on fixed gradients, f64, against the JAX chain; the LR
    tensor holds the schedule at the last update's count."""
    rng = np.random.default_rng(updates)
    p0 = [rng.standard_normal((3, 4)), rng.standard_normal(5)]
    grads = [[rng.standard_normal(p.shape) for p in p0] for _ in range(updates)]
    args = (0.1, 2, 10)
    with jax.enable_x64(True):
        tx = jax_schedulers.sgd_with_schedule(jax_schedulers.warmup_cosine_schedule(*args),
                                              momentum=0.9, weight_decay=1e-4)
        params = [jnp.asarray(p) for p in p0]
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
            params = optax.apply_updates(params, upd)
        want = [np.asarray(p) for p in params]
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = schedulers.sgd_with_schedule(ps, schedulers.warmup_cosine_schedule(*args))
    assert isinstance(opt, PolySGD)
    for g in grads:
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x.copy())
        lr = opt.step()
    for p, w in zip(ps, want):
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-12, rtol=0)
    assert lr == schedulers.warmup_cosine_schedule(*args)(updates - 1)
    assert float(opt.lr) == pytest.approx(lr, rel=1e-6) and opt.count == updates
