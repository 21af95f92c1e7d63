"""The saved-LSE route of icl_tpu_torch's fused window attention (head dims
above 32, where the backward kernel is the tile-64 one) against the JAX
package: `window_attention_plain`'s row log-sum-exp against a log-sum-exp
of the JAX reference's scores; `window_attention_plain_bwd_lse`, the plain
version of the tile-64 kernel's arithmetic (p from the forward's lse, u =
rowsum(dO o O) from its output), against `jax.vjp` of
`window_attention_fused` (Pallas forward in interpret mode, its custom_vjp
backward) and against the port's `window_attention_plain_bwd`, which
recomputes the softmax; `torch.autograd.gradcheck` of `WindowAttentionFn`
in f64 through that route; and which route `WindowAttentionFn` takes.

Head dims 33, 40 and 64 (SwinUNETR fs99, fs120, fs192; the forward and
its lse also at 63, fs189), no mask, region
ids (the JAX side given the same ids) and a dense mask N(0, 3^2) on both
sides, N = 16 and 49. Tolerance 2e-5 absolute in f32 (the JAX package's
own attention tolerance, tests/test_pallas_attention.py) on the lse, dq,
dk and dv, and 1e-4 on dbias, which sums the windows' dS in another order.
The CUDA kernels are held against these plain versions on the card, in
`test_torch_window_attention_card.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.ops.pallas.window_attention import window_attention_fused

from icl_tpu_torch.models.swinunetr import window_region_ids_3d
from icl_tpu_torch.ops import window_attention as wa
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

H = 3
# N -> (padded dims, window, shift) of a shifted stage with N tokens per window
GEOMETRY = {
    16: ((4, 4, 8), (2, 2, 4), (1, 1, 2)),
    49: ((14, 14, 1), (7, 7, 1), (3, 3, 0)),
}
CASES = [(d, mode, N) for d in (33, 40, 64) for mode in ("none", "region", "mask") for N in sorted(GEOMETRY)]
# the forward alone also at head dim 63 (fs189): every column of the tile
# but one, not a multiple of 4
FORWARD_CASES = CASES + [(63, mode, N) for mode in ("none", "region", "mask") for N in sorted(GEOMETRY)]


def _inputs(N, d, mode, seed, batch=2):
    """q, k, v, dO, bias as numpy f32, and (port keywords, JAX keywords)
    for the mode: region ids [nW, N] to both, or one dense mask."""
    ids = window_region_ids_3d(*GEOMETRY[N])
    rng = np.random.default_rng(seed)
    B = batch * ids.shape[0]
    q, k, v, g = (rng.standard_normal((B, H, N, d)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((H, N, N)).astype(np.float32)
    port, jx = {}, {}
    if mode == "region":
        port, jx = {"region_ids": torch.from_numpy(ids)}, {"region_ids": jnp.asarray(ids)}
    elif mode == "mask":
        mask = (3.0 * rng.standard_normal((ids.shape[0], N, N))).astype(np.float32)
        port, jx = {"mask": torch.from_numpy(mask)}, {"mask": jnp.asarray(mask)}
    return (q, k, v, g, bias), port, jx


def _jax_scores(q, k, bias, jx, scale):
    """The logits of `window_attention_reference`, with the mask the fused
    op builds from region ids (-100 where a key's id differs from the
    query's)."""
    s = jnp.einsum("bhnd,bhmd->bhnm", jnp.asarray(q) * scale, jnp.asarray(k)) + jnp.asarray(bias)[None]
    if jx:
        mask = jx.get("mask")
        if mask is None:
            ids = jx["region_ids"]
            mask = jnp.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)
        B, _, N, _ = s.shape
        nW = mask.shape[0]
        s = (s.reshape(B // nW, nW, H, N, N) + mask[None, :, None]).reshape(B, H, N, N)
    return s


@pytest.mark.parametrize("d,mode,N", FORWARD_CASES)
def test_plain_lse_matches_jax_log_sum_exp(d, mode, N):
    (q, k, v, _, bias), port, jx = _inputs(N, d, mode, seed=N + d + len(mode))
    scale = d**-0.5
    out, lse = wa.window_attention_plain(*map(torch.from_numpy, (q, k, v, bias)), scale=scale, return_lse=True,
                                         **port)
    want = np.asarray(jax.nn.logsumexp(_jax_scores(q, k, bias, jx, scale), axis=-1))
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5)
    fused = np.asarray(window_attention_fused(*map(jnp.asarray, (q, k, v, bias)), scale=scale, interpret=True, **jx))
    np.testing.assert_allclose(out.numpy(), fused, atol=2e-5)


@pytest.mark.parametrize("d,mode,N", CASES)
def test_plain_lse_backward_matches_jax_vjp(d, mode, N):
    """dq, dk, dv, dbias from the forward's out and lse against JAX's
    custom_vjp and against the port's recomputing plain backward."""
    (q, k, v, g, bias), port, jx = _inputs(N, d, mode, seed=2 * N + d + len(mode))
    scale = d**-0.5
    tq, tk, tv, tg, tbias = map(torch.from_numpy, (q, k, v, g, bias))
    out, lse = wa.window_attention_plain(tq, tk, tv, tbias, scale=scale, return_lse=True, **port)
    ids, mask = port.get("region_ids"), port.get("mask")
    got = wa.window_attention_plain_bwd_lse(tq, tk, tv, tbias, ids, out, lse, tg, scale=scale, mask=mask)
    recomputed = wa.window_attention_plain_bwd(tq, tk, tv, tbias, ids, tg, scale=scale, mask=mask)
    _, vjp = jax.vjp(lambda *a: window_attention_fused(*a, scale=scale, interpret=True, **jx),
                     *map(jnp.asarray, (q, k, v, bias)))
    fused = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    for name, x, f, r in zip(("dq", "dk", "dv", "dbias"), got, fused, recomputed):
        atol = 1e-4 if name == "dbias" else 2e-5
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), f, atol=atol, err_msg=f"{name} vs JAX's vjp")
        np.testing.assert_allclose(x.numpy(), r.numpy(), atol=atol, err_msg=f"{name} vs the recomputing plain")


@pytest.mark.parametrize("mode", ["none", "region", "mask"])
def test_function_gradcheck_f64_through_saved_lse(mode, monkeypatch):
    """Finite differences of the forward against the saved-LSE backward,
    f64, head dim 40 (fast mode); the route is the saved one."""
    (q, k, v, _, bias), port, _ = _inputs(16, 40, mode, seed=11, batch=1)
    port = {n: t.double() if n == "mask" else t for n, t in port.items()}
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v, bias)]
    calls = []
    route = wa.window_attention_plain_bwd_lse
    monkeypatch.setattr(wa, "window_attention_plain_bwd_lse", lambda *a, **kw: calls.append(1) or route(*a, **kw))
    assert torch.autograd.gradcheck(lambda *a: wa.window_attention(*a, scale=40**-0.5, **port), args,
                                    fast_mode=True)
    assert calls, "the backward did not take the saved log-sum-exp"


@pytest.mark.parametrize("d", [32, 33])
def test_function_saves_lse_above_head_dim_32_and_only_for_a_gradient(d, monkeypatch):
    """WindowAttentionFn asks the forward for the lse at head dims above
    32 when an input needs a gradient, and its backward then takes it; at
    32 and below, and under no_grad, it asks for none."""
    (q, k, v, g, bias), port, _ = _inputs(16, d, "region", seed=d)
    asked, routes = [], []
    fwd, bwd = wa.window_attention_fwd, wa.window_attention_bwd
    monkeypatch.setattr(wa, "window_attention_fwd",
                        lambda *a, return_lse=False, **kw: asked.append(return_lse) or fwd(*a, return_lse=return_lse,
                                                                                           **kw))
    monkeypatch.setattr(wa, "window_attention_bwd",
                        lambda *a, out=None, lse=None, **kw: routes.append(lse is not None) or bwd(*a, out=out, lse=lse,
                                                                                                   **kw))
    tq = torch.from_numpy(q).requires_grad_(True)
    out = wa.window_attention(tq, *map(torch.from_numpy, (k, v, bias)), scale=d**-0.5, **port)
    out.backward(torch.from_numpy(g))
    with torch.no_grad():
        wa.window_attention(tq, *map(torch.from_numpy, (k, v, bias)), scale=d**-0.5, **port)
    assert asked == [d > 32, False] and routes == [d > 32]
    want = wa.window_attention_plain_bwd(tq.detach(), *map(torch.from_numpy, (k, v, bias)), port["region_ids"],
                                         torch.from_numpy(g), scale=d**-0.5)[0]
    torch.testing.assert_close(tq.grad, want, atol=2e-5, rtol=0)


def test_lse_backward_on_cpu_counts_no_launch():
    """On CPU tensors the wrapper takes the saved-LSE plain version, and
    counts no kernel launch."""
    (q, k, v, g, bias), port, _ = _inputs(16, 40, "region", seed=5)
    tq, tk, tv, tg, tbias = map(torch.from_numpy, (q, k, v, g, bias))
    wa.reset_launch_counts()
    out, lse = wa.window_attention_fwd(tq, tk, tv, tbias, scale=0.2, return_lse=True, **port)
    got = wa.window_attention_bwd(tq, tk, tv, tbias, port["region_ids"], tg, scale=0.2, out=out, lse=lse)
    want = wa.window_attention_plain_bwd_lse(tq, tk, tv, tbias, port["region_ids"], out, lse, tg, scale=0.2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert wa.window_attention.launches == wa.window_attention_bwd.launches == 0


@pytest.mark.parametrize("mode", ["none", "region", "mask"])
def test_plain_lse_backward_takes_u_from_the_scores_for_a_bf16_output(mode):
    """With bf16 inputs the output is rounded to bf16, and u from it would
    move dbias by about 2e-3 of its size: the plain version, as the kernel,
    takes u = rowsum(p * dp) in f32 there, so it agrees with the
    recomputing plain backward on the same bf16 inputs to f32 rounding
    (1e-5 of each gradient's largest magnitude), dbias included."""
    (q, k, v, g, bias), port, _ = _inputs(49, 40, mode, seed=21)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    tbias = torch.from_numpy(bias)
    ids, mask = port.get("region_ids"), port.get("mask")
    out, lse = wa.window_attention_plain(tq, tk, tv, tbias, scale=40**-0.5, return_lse=True, **port)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = wa.window_attention_plain_bwd_lse(tq, tk, tv, tbias, ids, out, lse, tg, scale=40**-0.5, mask=mask)
    want = wa.window_attention_plain_bwd(tq, tk, tv, tbias, ids, tg, scale=40**-0.5, mask=mask)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        # dq, dk and dv are rounded to bf16 once on both sides: at most one ulp apart
        assert err <= (1e-5 if name == "dbias" else 8e-3), (name, err)
