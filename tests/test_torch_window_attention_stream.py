"""The streamed window-attention kernels' rules in icl_tpu_torch, on the
CPU: every head dim and window a kernel takes, through the chunked tile-64
kernels where their tiles fit a CTA and through the streamed kernels
(`csrc/window_attention_stream.cu`, `window_attention_bwd_stream.cu`)
where they do not.

Covered: the route rule (`_route`) against the rule the wrapper had before
the streamed kernels (every shape it took keeps its kernel; every shape it
refused takes "stream"), over head dims 1-700 at the Swin paths' windows
and beyond; `_check` refusing no head dim >= 1 at those windows in either
direction or type; the streamed layouts' bytes, the same at every head
dim and window and within a CTA's shared memory; the streamed grids; and
a forward asked for its log-sum-exp at head dims up to 32 and a backward
whose tiles 16 or 32 do not fit taking the streamed kernels (and
`WindowAttentionFn` saving the log-sum-exp for them); the Swin 2D
`WindowAttention` module at dim 192 with one head and at dim
288 with two (head dims 192 and 144: the streamed kernels' in f32) against
the JAX module with the same weights, unshifted and with the shift mask,
the JAX side through `window_attention_fused` in interpret mode (N = 144),
1e-5 absolute. The plain versions at head dims 144, 192 and 256 against
the Pallas kernel and its vjp are in `test_torch_window_attention_wide.py`;
the kernels themselves in `test_torch_window_attention_card.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl_tpu.models import swin2d as jax_swin2d

from icl_tpu_torch.models import swin2d
from icl_tpu_torch.ops import window_attention as wa
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

# the windows of the port's Swin paths (2 x 2, 7 x 7, 12 x 12, 6^3, 7^3)
# and two larger ones
PATH_WINDOWS = (4, 49, 144, 216, 343)
WINDOWS = PATH_WINDOWS + (450, 1000)
HEAD_DIMS = tuple(range(1, 701))


def _rule_before(N: int, D: int, bf16: bool, backward: bool, region: bool):
    """The kernel the wrapper took before the streamed kernels, None
    where it refused: the forward's `_fwd_fits`; the backward's tile-64
    shared memory, and at tiles 16 and 32 the one their geometry refused
    on the card: q, k, v and dO [Np, tile] and four rows [Np] in f32
    (`smem_bytes` in csrc/window_attention_bwd.cu)."""
    if backward:
        Np = -(-N // 16) * 16
        tile = 16 if D <= 16 else 32
        fits = (4 * Np * (4 * tile + 4) if D <= 32 else wa._bwd64_smem_bytes(N, D, bf16, region)) <= wa._MAX_SMEM_BYTES
    else:
        fits = wa._fwd_smem_bytes(N, D, bf16) <= wa._MAX_SMEM_BYTES and wa._fwd_fits(N, D, bf16)
    return None if not fits else "wide" if D > 64 else "tile"


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("N", WINDOWS)
def test_route_keeps_every_shape_that_ran_and_streams_the_rest(N, bf16, backward):
    """Every (N, D) the wrapper took before keeps its kernel; every one it
    refused goes to the streamed kernels, in both modes of the backward's
    shared memory (with and without the region ids)."""
    for region in (False, True):
        for D in HEAD_DIMS:
            before = _rule_before(N, D, bf16, backward, region)
            assert wa._route(N, D, bf16, backward, region) == (before or "stream"), (N, D, bf16, backward, region)


def test_route_at_the_swin_paths_head_dims():
    """The head dims of the paths: SwinUNETR fs24-fs384 (8-128) and the 2D
    Swin-T (32) on their own kernels; fs432 (144) and a Swin-UNet at 192 a
    head streamed in f32; bf16 keeps the chunked forward up to 640 and its
    backward up to 128 at N = 343, 448 at N = 49."""
    for D in (8, 16, 32, 64):
        assert {wa._route(N, D, bf16, bwd) for N in PATH_WINDOWS for bf16 in (False, True)
                for bwd in (False, True)} == {"tile"}
    for D in (80, 128):
        assert {wa._route(N, D, bf16, bwd) for N in PATH_WINDOWS for bf16 in (False, True)
                for bwd in (False, True)} == {"wide"}
    for D in (144, 192):
        assert {wa._route(N, D, False, bwd) for N in PATH_WINDOWS for bwd in (False, True)} == {"stream"}
        assert wa._route(343, D, True) == "wide" and wa._route(343, D, True, True) == "stream"
    assert wa._route(144, 192, True, True) == "wide"  # bf16's window of 3 chunks fits at N = 144
    assert (wa._route(343, 640, True), wa._route(343, 641, True)) == ("wide", "stream")
    assert (wa._route(49, 448, True, True), wa._route(49, 449, True, True)) == ("wide", "stream")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", PATH_WINDOWS)
def test_check_refuses_no_head_dim_from_1(N, dtype):
    """`_check` takes every head dim from 1 at the paths' windows, forward
    and backward, with and without region ids, and names its route;
    head dim 0 is refused, naming it."""
    ids = torch.zeros(1, N)
    bias = torch.zeros(1, N, N)
    for D in HEAD_DIMS[::7] + (64, 65, 128, 129, 640, 641, 700):
        q = torch.zeros(1, 1, N, D, dtype=dtype)
        for region in (None, ids):
            assert wa._check(q, q, q, bias, region, None) in wa.ROUTES
            assert wa._check(q, q, q, bias, region, None, q) in wa.ROUTES
    q = torch.zeros(1, 1, N, 0, dtype=dtype)
    with pytest.raises(ValueError, match="head dim 0"):
        wa._check(q, q, q, bias, None, None)


@pytest.mark.parametrize("N", WINDOWS)
def test_forward_asked_for_its_lse_streams_at_head_dims_up_to_32(N):
    """The tiles 16 and 32 store no log-sum-exp: a forward asked for it
    there takes the streamed kernel, where it fits or not; above 32 the
    log-sum-exp changes no route."""
    for bf16 in (False, True):
        for D in (1, 8, 16, 17, 32):
            assert wa._route(N, D, bf16, lse=True) == "stream"
            assert wa._route(N, D, bf16) == ("tile" if wa._fwd_fits(N, D, bf16) else "stream")
        for D in (33, 64, 65, 128, 129, 640, 641):
            assert wa._route(N, D, bf16, lse=True) == wa._route(N, D, bf16)


def test_function_saves_lse_wherever_the_backward_streams():
    """`WindowAttentionFn` saves the output and log-sum-exp above head dim
    32 and wherever the backward streams: at head dims up to 32 the windows
    whose tiles do not fit a CTA (Np (4 tile + 4) floats: from N 433 at
    tile 32, from N 849 at tile 16), nowhere at the paths' windows."""
    for N in PATH_WINDOWS:
        assert not any(wa._saves_lse(N, D, bf16, region) for D in range(1, 33) for bf16 in (False, True)
                       for region in (False, True))
    assert [wa._saves_lse(N, 32, False, True) for N in (432, 433)] == [False, True]
    assert [wa._saves_lse(N, 16, True, False) for N in (848, 849)] == [False, True]
    assert wa._bwd_tile_smem_bytes(450, 32) == 244_992 and wa._bwd_tile_smem_bytes(432, 32) <= wa._MAX_SMEM_BYTES
    assert all(wa._saves_lse(4, D, False, False) for D in (33, 129, 700))
    assert not wa._saves_lse(4, 0, False, False)


@pytest.mark.parametrize("N", WINDOWS)
def test_stream_layout_bytes_do_not_grow_with_the_head_dim_or_window(N):
    """The streamed kernels' shared memory: a ring of two buffers, each a
    [64, 64] f32 tile beside a [32, 64] one (the forward and the dQ
    kernel, 48 KB) or a [16, 64] one (the dK/dV kernel, 40 KB), the same
    at every chunk count, window and mode, and within a CTA's shared
    memory at least four times over (four CTAs could share an SM)."""
    assert wa._stream_smem_bytes() == wa._STREAM_SMEM_BYTES["fwd"] == 2 * (64 + 32) * 64 * 4 == 49_152
    assert wa._STREAM_SMEM_BYTES["dkdv"] == 2 * (64 + 16) * 64 * 4 == 40_960
    assert wa._stream_smem_bytes(backward=True) == 49_152
    assert 4 * max(wa._STREAM_SMEM_BYTES.values()) <= wa._MAX_SMEM_BYTES
    # what the chunked kernels would need at the same shapes grows with C until it does not fit
    f32_fwd = [wa._fwd_wide_bytes(C, False, 2, 2) for C in (2, 3, 4, 10)]
    assert f32_fwd == sorted(f32_fwd) and f32_fwd[1] > wa._MAX_SMEM_BYTES
    assert wa._bwd64_smem_bytes(N, 129) > wa._MAX_SMEM_BYTES


# (B, H, N, D, slots): fs432's inference and training stage 1, the 2D
# stage 1 at 192 a head, head dim 648 (11 chunks) at N 49, a 2 x 2 window,
# and fewer slots than CTAs
STREAM_GRIDS = [(1372, 3, 343, 144, 396), (686, 3, 343, 144, 396), (512, 1, 144, 192, 396),
                (128, 3, 49, 648, 396), (1024, 8, 4, 192, 264), (7, 3, 343, 256, 5)]


@pytest.mark.parametrize("B,H,N,D,slots", STREAM_GRIDS)
def test_stream_grids_have_a_cta_per_block_and_pair_of_chunks(B, H, N, D, slots):
    """Both streamed directions' grid: a CTA per (block of 64 rows or
    keys, pair of 64-column output chunks, head) a window group, every
    window once, no group empty, groups balanced as the chunked kernels'
    (`_balanced_groups`)."""
    per_cta, groups = wa._stream_grid_of(B, H, N, D, slots)
    ctas = H * -(-N // 64) * -(-wa.head_dim_chunks(D) // wa._STREAM_PAIR)
    assert groups * per_cta >= B > (groups - 1) * per_cta
    assert (per_cta, groups) == wa._balanced_groups(B, ctas, slots)
    if (B, H, N, D) == (512, 1, 144, 192):  # 3 blocks x 2 pairs a window
        assert ctas == 6


def _module_pair(dim: int, heads: int, seed: int):
    """The JAX `WindowAttention` (window 12) and the port's with the same
    weights drawn with numpy: the bias table, qkv and proj."""
    ws = 12
    jax_mod = jax_swin2d.WindowAttention(dim=dim, window_size=ws, num_heads=heads)
    shapes = jax.eval_shape(lambda: jax_mod.init(jax.random.PRNGKey(0), jnp.zeros((1, ws * ws, dim))))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32),
                                    shapes["params"])
    port = swin2d.WindowAttention(dim, ws, heads)
    with torch.no_grad():
        port.relative_position_bias_table.copy_(torch.from_numpy(params["relative_position_bias_table"]))
        for name in ("qkv", "proj"):
            dense = params[name]["Dense_0"]
            getattr(port, name).weight.copy_(torch.from_numpy(np.asarray(dense["kernel"]).T.copy()))
            getattr(port, name).bias.copy_(torch.from_numpy(np.asarray(dense["bias"])))
    return jax_mod, params, port


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dim,heads", [(192, 1), (288, 2)])
def test_swin2d_window_attention_at_streamed_head_dims_matches_jax(dim, heads, shifted, monkeypatch):
    """A 24 x 24 grid's four 12 x 12 windows of two images (N = 144), the
    JAX module through its fused kernel in interpret mode, the port's
    through its wrapper (the plain version on the CPU); the shifted block
    adds the shift mask; head dims dim / heads = 192 and 144."""
    monkeypatch.setenv("ICL_TPU_PALLAS", "1")
    monkeypatch.setenv("ICL_TPU_PALLAS_INTERPRET", "1")
    jax_mod, params, port = _module_pair(dim, heads, seed=dim + heads)
    x = np.random.default_rng(dim).standard_normal((8, 144, dim)).astype(np.float32)
    mask = swin2d.shifted_window_mask(24, 24, 12, 6) if shifted else None
    want = jax_mod.apply({"params": params}, jnp.asarray(x), mask)
    seen = []

    def attention(q, *args, **kw):
        seen.append((tuple(q.shape), wa._route(q.shape[2], q.shape[3])))
        return wa.window_attention(q, *args, **kw)

    port.attention = attention
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert seen == [((8, heads, 144, dim // heads), "stream")]
