"""icl_tpu_torch's bf16 train state against the JAX package's
(`icl_tpu/train/optim.py:44-143`): the stochastic rounding's properties
(as `tests/test_optim_bf16.py` holds the JAX one), one bf16 SGD update
element by element against `make_sgd(state_dtype="bfloat16")`, the poly
LR, and the dither: Philox4x32-10 against Random123's known answers, a
pure function of (seed, count, leaf, stream, index).

The JAX package's dither comes from `rng_bit_generator`, which is
implementation-defined, so the two packages agree on the rounding rule and
not on its bits: from the same bf16 p, buf and g, each new element is
one of the two bf16 neighbours of the f32 value on both sides, so the two
are equal or one bf16 ulp apart, and equal wherever that f32 value is
bf16-representable. Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icl_tpu.train.optim import SGDBf16State, make_sgd

from icl_tpu_torch.ops.sgd_bf16 import (dither_bits, philox4x32_10, sgd_bf16_plain,
                                        stochastic_round_bf16)
from icl_tpu_torch.train.optim import PolySGD
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def _bf16_up(x: float) -> float:
    """The next bf16 value above x > 0."""
    return float(torch.nextafter(torch.tensor(x, dtype=torch.bfloat16),
                                 torch.tensor(2 * x + 1, dtype=torch.bfloat16)))


def _dither(n: int, seed: int = 0, count: int = 0, leaf: int = 0, stream: int = 1):
    return dither_bits(n, seed, count, leaf)[stream]


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    out = philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert [int(o) for o in out] == list(want)


def test_dither_is_a_pure_function_of_its_inputs():
    first = dither_bits(1001, seed=5, count=3, leaf=2)
    again = dither_bits(1001, seed=5, count=3, leaf=2)
    for a, b in zip(first, again):
        assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 1 << 16
    for other in (dither_bits(1001, 6, 3, 2), dither_bits(1001, 5, 4, 2), dither_bits(1001, 5, 3, 3)):
        assert not torch.equal(first[0], other[0]) and not torch.equal(first[1], other[1])
    assert not torch.equal(first[0], first[1])  # the two streams
    # a prefix of a longer leaf draws the same bits
    assert torch.equal(dither_bits(37, 5, 3, 2)[1], first[1][:37])

    rng = np.random.default_rng(0)
    p, g, buf = (torch.from_numpy(rng.normal(0, s, 77).astype(np.float32)).to(torch.bfloat16)
                 for s in (0.05, 0.01, 0.01))
    outs = []
    for _ in range(2):
        pc, bc = p.clone(), buf.clone()
        sgd_bf16_plain(pc, g, bc, torch.tensor(0.01), torch.tensor(9), 0.9, 1e-4, 1, 4)
        outs.append((pc, bc))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_stochastic_round_exact_on_representable():
    x = torch.tensor([0.5, -1.25, 3.0, 0.0])
    out = stochastic_round_bf16(x, _dither(4))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), x)


def test_stochastic_round_unbiased():
    lo, hi = 1.0, _bf16_up(1.0)
    x = torch.full((4096,), (lo + hi) / 2.0)
    vals = stochastic_round_bf16(x, _dither(4096, seed=1)).float().numpy()
    assert set(np.unique(vals)) <= {lo, hi}
    frac_hi = float((vals == hi).mean())
    assert 0.4 < frac_hi < 0.6, frac_hi
    assert abs(vals.mean() - (lo + hi) / 2.0) < (hi - lo) * 0.05


def test_stochastic_round_accumulates_subquantum_updates():
    p = torch.ones(8192, dtype=torch.bfloat16)
    delta = (_bf16_up(1.0) - 1.0) / 16.0
    for i in range(32):
        p = stochastic_round_bf16(p.float() + delta, _dither(8192, count=i))
    drift = float(p.float().mean()) - 1.0
    expect = 32 * delta
    assert 0.5 * expect < drift < 1.5 * expect, (drift, expect)


def test_bf16_sgd_tracks_f32_reference():
    """20 updates of the bf16 state land within a few bf16 ulps of the f32
    torch-order SGD (the JAX package's f32 chain) from the same start."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(0, 0.05, 64).astype(np.float32)
    grads = [rng.normal(0, 0.01, 64).astype(np.float32) for _ in range(20)]
    tx32 = make_sgd(0.01, 100)
    pj, state = jnp.asarray(p0), tx32.init(jnp.asarray(p0))
    for g in grads:
        updates, state = tx32.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)

    param = torch.nn.Parameter(torch.from_numpy(p0).to(torch.bfloat16))
    opt = PolySGD([param], 0.01, 100, state_dtype="bfloat16")
    for g in grads:
        opt.zero_grad()
        param.grad = torch.from_numpy(g).to(torch.bfloat16)
        opt.step()
    assert param.dtype == opt.momentum_buffers[0].dtype == torch.bfloat16
    np.testing.assert_allclose(param.detach().float().numpy(), np.asarray(pj), atol=3e-3, rtol=2e-2)


def test_bf16_sgd_poly_schedule_decays():
    param = torch.nn.Parameter(torch.zeros(4, dtype=torch.bfloat16))
    opt = PolySGD([param], 0.01, 10, momentum=0.0, weight_decay=0.0, state_dtype="bfloat16")
    moves = []
    for _ in range(2):
        before = param.detach().float().clone()
        param.grad = torch.ones(4, dtype=torch.bfloat16)
        lr = opt.step()
        moves.append((lr, float((param.detach().float() - before).abs().mean())))
    assert moves[0][0] == pytest.approx(0.01) and moves[0][1] == pytest.approx(0.01, rel=0.01)
    assert moves[1][0] < moves[0][0] and moves[1][1] < moves[0][1]


def _jax_update(p, g, buf, count, base_lr, momentum, wd):
    tx = make_sgd(base_lr, 100, momentum, wd, state_dtype="bfloat16")
    pj = {"w": jnp.asarray(p, jnp.bfloat16)}
    state = SGDBf16State(count=jnp.asarray(count, jnp.int32), key=jax.random.PRNGKey(0),
                         trace={"w": jnp.asarray(buf, jnp.bfloat16)})
    updates, new_state = tx.update({"w": jnp.asarray(g, jnp.bfloat16)}, state, pj)
    new_p = optax.apply_updates(pj, updates)["w"]
    return (np.asarray(new_p.astype(jnp.float32)), np.asarray(new_state.trace["w"].astype(jnp.float32)))


@pytest.mark.parametrize("case", ["random", "representable"])
def test_one_update_matches_jax_within_its_two_neighbours(case):
    """One update from the same bf16 p, buf and g: the port and
    JAX round the same f32 values to one of their two bf16 neighbours each:
    equal or one bf16 ulp apart, and equal where the f32 value is
    representable (the "representable" case: momentum 0, weight decay 0,
    p - lr * g and g exact in bf16)."""
    rng = np.random.default_rng(3)
    n = 4099
    if case == "random":
        base_lr, momentum, wd = 0.01, 0.9, 1e-4
        p = rng.normal(0, 0.05, n).astype(np.float32)
        g = rng.normal(0, 0.01, n).astype(np.float32)
        buf = rng.normal(0, 0.01, n).astype(np.float32)
        p[:50] = g[:50] = buf[:50] = 0.0  # a zero update: 0 on both sides
    else:
        base_lr, momentum, wd = 0.5, 0.0, 0.0
        p = rng.integers(-64, 64, n).astype(np.float32) / 8.0
        g = rng.integers(-64, 64, n).astype(np.float32) / 8.0
        buf = rng.normal(0, 0.01, n).astype(np.float32)
    p, g, buf = (torch.from_numpy(a).to(torch.bfloat16) for a in (p, g, buf))
    count = 3 if case == "random" else 0  # lr(0) = base_lr, exact

    param = torch.nn.Parameter(p.clone())
    opt = PolySGD([param], base_lr, 100, momentum, wd, state_dtype="bfloat16")
    opt.momentum_buffers[0].copy_(buf)
    opt.count = count
    param.grad = g.clone()
    lr = opt.step()
    got_p, got_b = param.detach().float().numpy(), opt.momentum_buffers[0].float().numpy()
    want_p, want_b = _jax_update(p.float().numpy(), g.float().numpy(), buf.float().numpy(), count,
                                 base_lr, momentum, wd)

    # the f32 values both sides round, computed as the port computes them
    lr_t = torch.tensor(lr, dtype=torch.float32)
    b32 = torch.tensor(momentum, dtype=torch.float32) * buf.float() + (
        g.float() + torch.tensor(wd, dtype=torch.float32) * p.float())
    p32 = p.float() - lr_t * b32
    for name, got, want, f32 in (("p", got_p, want_p, p32), ("buf", got_b, want_b, b32)):
        bits = f32.numpy().view(np.uint32).astype(np.int64)
        lower = bits >> 16  # truncation; the upper neighbour is one bf16 step further from 0
        exact = (bits & 0xFFFF) == 0
        upper = np.where(exact, lower, lower + 1)
        for side in (got, want):
            hi16 = side.astype(np.float32).view(np.uint32).astype(np.int64) >> 16
            assert np.all((hi16 == lower) | (hi16 == upper)), f"{name}: not a neighbour of f32"
        assert np.array_equal(got[exact], want[exact]), f"{name}: representable values differ"
        if case == "representable":
            assert exact.all()
        else:
            assert exact.sum() >= 50 and (got != want).any()  # the zeros; the dithers differ
