// Fused window attention backward for Hopper (sm_90a), on tensor cores.
//
// Replaces the backward of the custom_vjp around the Pallas kernels of
// icl_tpu/ops/pallas/window_attention.py: _fused_attention_bwd (:290-349),
// which recomputes the softmax from q, k, bias (+ mask) and forms
//
//   dV = P^T.dO            dP = dO.V^T
//   dS = P o (dP - rowsum(dO o O))      (rowsum(dO o O) = rowsum(P o dP))
//   dQ = scale * dS.K      dK = scale * dS^T.Q
//   dbias[h] = sum over all B windows of dS[b, h]
//
// for every (window, head). Three variants, as the forward: NONE, REGION
// (M = -100 where the shift-region ids of key and query differ, built here
// from ids [nW, N]) and MASK (any dense additive mask [nW, N, N], the
// branch at :331-332); window index = b % nW. Head dim d = 1 .. 64, run by
// the instance of its tile DT = 16 (d <= 16) or 32 (d <= 32) of the kernel
// below, or by the tile-64 kernels further down (d <= 64, "The tile-64
// backward"), the operands staged at width DT with zero columns past d
// (mma_tf32.cuh):
// those add nothing to S or dP, and the padded columns of dq, dk and dv are
// never stored. f32 or bf16 q, k, v, dO; f32 math; dq, dk, dv in the input
// type; dbias in f32. The mask and the ids get no gradient.
//
// Layout: q, k, v, dO, dq, dk, dv [B, H, N, D] contiguous; bias [H, N, N];
// region ids [nW, N] f32; mask [nW, N, N] f32.
//
// What bounds it: five N x N x D products per (window, head), 10 * B * H *
// N^2 * D flops, against 7 * B * H * N * D values of q, k, v, dO, dq, dk,
// dv: about 40 flops per byte at D = 32 in f32, so the products bound it,
// not the memory. Outside the tensor cores f32 runs at 67 TFLOP/s, and a
// kernel that reads its operands from shared memory one float at a time
// stays well below even that. The tensor cores take f32 only as TF32 (10
// mantissa bits), which alone misses the port's f32 tolerance (1e-5 of each
// gradient's largest magnitude) by about 50x.
//
// Design of the tile-16 and tile-32 kernel (the building blocks are in
// mma_tf32.cuh, shared with the forward and the tile-64 kernels):
//   * Every product runs on the tensor cores as mma.sync m16n8k8 TF32 with
//     f32 accumulators, in the 3xTF32 split: x = hi + lo with hi = tf32(x)
//     and lo = tf32(x - hi), a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which
//     keeps f32 accuracy at three times the TF32 work (495 / 3 = 165
//     TFLOP/s, above the f32 rate). A bf16 input is exact in TF32, so its lo
//     is zero and those products are skipped. mma.sync, not wgmma: three of
//     the five products read an operand transposed, and with mma.sync each
//     thread loads its own fragment elements, so one layout in shared
//     memory serves all five.
//   * The tensor cores do not round each addition of an accumulation as an
//     f32 sum does; over N = 343 keys that alone cost 4e-6 of dq. So the
//     products over keys or rows (dQ, dK, dV) sum each 8-term MMA from zero
//     and add it to the accumulator in f32.
//   * One CTA per (group of windows, head), walking its windows in order.
//     q, k, v and dO of a window are staged once in shared memory as f32
//     (cp.async for f32 inputs whose d is a multiple of 4), N padded with
//     zero rows to Np, a multiple of 16, d with zero columns to DT, in
//     4-float chunks permuted by an XOR (sidx) so that both fragment
//     patterns hit 32 banks without padding.
//   * Row pass, one warp per 16-row tile, its Q and dO fragments split once
//     and held in registers: sweep 1 forms S = Q.K^T and dP = dO.V^T per
//     8-key tile and keeps the online row max, row sum and rowsum(P o dP),
//     merged over the four lanes of a quad with xor shuffles; sweep 2 forms
//     them again, dS, the dbias partial and dQ.
//   * Column pass, one warp per 16-key tile, its K and V fragments in
//     registers: S^T = K.Q^T and dP^T = V.dO^T per 8-row tile, P^T and
//     dS^T from the row statistics, then dV and dK.
//   * A C fragment becomes an A fragment in registers: the k index of the
//     next product is permuted so that lane (g, t) holds its k = t and
//     k = t + 4 in columns 2t and 2t + 1, and the B fragment is read from
//     shared memory in the same order. No tile goes through memory.
//   * The bias, the mask and the dbias partial are read straight from
//     device memory (L2-resident) in both orientations, one tile ahead of
//     their use; no transposed copies. Padded keys score -inf; padded rows
//     get P = dS = 0 and are never stored.
//   * dbias: each CTA owns the slice [group, h] of a scratch buffer
//     [G, H, N, N]; its first window writes it, the others add to it in
//     window order; a second kernel sums the G partials in order g = 0 ..
//     G-1. Every output element has one owner and a fixed order of sums:
//     no atomics, so two runs on the same inputs are bitwise equal.
//   * Occupancy: at tile 16, 8 warps and 128 registers a thread, two CTAs
//     an SM (96 KB of shared memory each at N = 343); at tile 32 the split
//     fragments need more, so at most 5 warps at up to 204 registers, two
//     CTAs an SM (N = 144 has 9 tiles: two rounds of 5 warps). The warps
//     and the shared memory are chosen here from N and D; the caller sizes
//     the grid from icl_window_attention_bwd_geometry's resident CTAs.
//   What still binds it (times in PERF.md): latency more than any unit's
//   rate, among it the bias and mask reads of the three sweeps and the
//   per-window read-modify-write of the dbias partial.

#include <algorithm>
#include <type_traits>

#include "mma_tf32.cuh"

namespace {

// Warps per CTA at most, and CTAs an SM at least: the launch bounds. At
// tile DT = 32 the fragments held in registers need more than 128 a thread;
// 5 warps at up to 204 registers keep two CTAs on an SM, which is what N =
// 144 (9 tiles) can use.
__host__ __device__ constexpr int max_warps(int DT) { return DT == 32 ? 5 : 8; }
constexpr int kMinCtas = 2;

// q, k, v and dO of a window, each [Np, DT]
constexpr int kOperands = 4;

// The dbias partial of the four (row, key) a lane holds in the row pass,
// rows rows[e / 2] at keys key0 + e % 2: what the earlier windows of the
// group left there, 0 for the first window or outside N. Read one tile
// ahead, as the terms.
__device__ __forceinline__ void load_part(float (&old)[4], const float* part, const int (&rows)[2], int key0,
                                          int N, bool first) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = rows[e >> 1];
    const int key = key0 + (e & 1);
    old[e] = !first && row < N && key < N ? part[static_cast<size_t>(row) * N + key] : 0.f;
  }
}

template <typename T, int DT, int MODE>
__global__ void __launch_bounds__(max_warps(DT) * 32, kMinCtas)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ bias, const float* __restrict__ region_ids,
                            const float* __restrict__ mask, T* __restrict__ dq,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ dbias_part, int B, int H, int N, int d, int nW,
                            int windows_per_cta, float scale) {
  static_assert(DT == 16 || DT == 32, "tile 64 runs the kernels below");
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  constexpr int KD = DT / 8;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  // [Np, DT] each, see sidx
  float* qs = smem;
  float* ks = qs + Np * DT;
  float* vs = ks + Np * DT;
  float* gs = vs + Np * DT;  // dO
  float* row_max = smem + kOperands * Np * DT;  // [Np]
  float* row_inv = row_max + Np;   // [Np], 1 / row sum
  float* row_dlt = row_inv + Np;   // [Np], rowsum(P o dP)
  float* ids = row_dlt + Np;       // [Np], kRegion only

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int group = blockIdx.x;
  const int h = blockIdx.y;
  const int tiles = Np / 16;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  float* part = dbias_part + (static_cast<size_t>(group) * H + h) * N * N;
  const int b_begin = group * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);

  // the padded rows and columns stay zero for every window
  for (int op = 0; op < kOperands; ++op) zero_pad<DT>(smem + op * Np * DT, N, Np, d);

  for (int b = b_begin; b < b_end; ++b) {
    const bool first = b == b_begin;
    const size_t base = (static_cast<size_t>(b) * H + h) * N * d;
    __syncthreads();  // the previous window is done with shared memory
    stage_rows<DT>(qs, q + base, N, d);
    stage_rows<DT>(ks, k + base, N, d);
    stage_rows<DT>(vs, v + base, N, d);
    stage_rows<DT>(gs, dout + base, N, d);
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(b % nW) * N * N : nullptr;
    if (MODE == kRegion) {
      const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
      for (int i = threadIdx.x; i < N; i += blockDim.x) ids[i] = w_ids[i];
    }
    cp_async_wait_all();
    __syncthreads();

    // Row pass: warp per 16-row tile; lane (g, t) holds rows i0 + g and
    // i0 + g + 8 (e = 0, 1 and e = 2, 3) at keys j0 + 2t and j0 + 2t + 1.
    for (int tile = warp; tile < tiles; tile += warps) {
      const int i0 = 16 * tile;
      FragA qa[KD], ga[KD];
      load_a_split<DT, kExact>(qa, qs, i0, g, t);
      load_a_split<DT, kExact>(ga, gs, i0, g, t);
      const int rows[2] = {i0 + g, i0 + g + 8};
      const float id_row[2] = {id_of<MODE>(ids, rows[0]), id_of<MODE>(ids, rows[1])};

      // Sweep 1: row max m, row sum l and u = sum_j e^(s_j - m) dp_j.
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};
      float u[2] = {0.f, 0.f};
      float term[4];
      load_terms<MODE, false>(term, rows, 2 * t, N, bias_h, mask_w);
      for (int j0 = 0; j0 < Np; j0 += 8) {
        float next[4];
        load_terms<MODE, false>(next, rows, j0 + 8 + 2 * t, N, bias_h, mask_w);
        float s[4], dp[4];
        product_nt<DT, kExact>(s, qa, ks, j0, g, t);
        product_nt<DT, kExact>(dp, ga, vs, j0, g, t);
        const float2 id_key = id_pair<MODE>(ids, j0 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = logit<MODE>(s[e], term[e], rows[e >> 1] < N && j0 + 2 * t + (e & 1) < N, id_row[e >> 1],
                             (e & 1) ? id_key.y : id_key.x, scale);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], fmaxf(s[2 * r], s[2 * r + 1]));
          const float m_ref = finite_or_zero(m_new);
          const float corr = __expf(m[r] - m_ref);
          const float p0 = __expf(s[2 * r] - m_ref);
          const float p1 = __expf(s[2 * r + 1] - m_ref);
          l[r] = fmaf(l[r], corr, p0 + p1);
          u[r] = fmaf(u[r], corr, fmaf(p0, dp[2 * r], p1 * dp[2 * r + 1]));
          m[r] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) term[e] = next[e];
      }
      float inv[2], dlt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // merge the quad; every lane ends with the same bits
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float m_o = __shfl_xor_sync(kFullMask, m[r], off);
          const float l_o = __shfl_xor_sync(kFullMask, l[r], off);
          const float u_o = __shfl_xor_sync(kFullMask, u[r], off);
          const float m_new = fmaxf(m[r], m_o);
          const float m_ref = finite_or_zero(m_new);
          const float c_s = __expf(m[r] - m_ref);
          const float c_o = __expf(m_o - m_ref);
          l[r] = l[r] * c_s + l_o * c_o;
          u[r] = u[r] * c_s + u_o * c_o;
          m[r] = m_new;
        }
        inv[r] = 1.f / l[r];
        dlt[r] = u[r] * inv[r];
        if (t == 0) {
          row_max[rows[r]] = m[r];
          row_inv[rows[r]] = inv[r];
          row_dlt[rows[r]] = dlt[r];
        }
      }

      // Sweep 2: dS, the dbias partial and dQ = dS.K.
      float acc[KD][4];
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
      load_terms<MODE, false>(term, rows, 2 * t, N, bias_h, mask_w);
      float old[4];
      load_part(old, part, rows, 2 * t, N, first);
      for (int j0 = 0; j0 < Np; j0 += 8) {
        float next[4], old_next[4];
        load_terms<MODE, false>(next, rows, j0 + 8 + 2 * t, N, bias_h, mask_w);
        load_part(old_next, part, rows, j0 + 8 + 2 * t, N, first);
        float s[4], dp[4];
        product_nt<DT, kExact>(s, qa, ks, j0, g, t);
        product_nt<DT, kExact>(dp, ga, vs, j0, g, t);
        float ds[4];
        const float2 id_key = id_pair<MODE>(ids, j0 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = j0 + 2 * t + (e & 1);
          const float sc = logit<MODE>(s[e], term[e], rows[r] < N && key < N, id_row[r],
                                       (e & 1) ? id_key.y : id_key.x, scale);
          const float p = __expf(sc - m[r]) * inv[r];
          ds[e] = p * (dp[e] - dlt[r]);
          // (row, key) has one owner thread; 0 + ds = ds for the first window
          if (rows[r] < N && key < N) part[static_cast<size_t>(rows[r]) * N + key] = old[e] + ds[e];
        }
        product_cn<DT, kExact>(acc, ds, ks, j0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          term[e] = next[e];
          old[e] = old_next[e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        T* out = dq + base + static_cast<size_t>(rows[r]) * d;
#pragma unroll
        for (int nn = 0; nn < KD; ++nn)
          store_cols<T>(out, 8 * nn + 2 * t, d, acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale);
      }
    }
    __syncthreads();  // row statistics visible to every warp

    // Column pass: warp per 16-key tile; lane (g, t) holds keys j0 + g and
    // j0 + g + 8 (e = 0, 1 and e = 2, 3) at rows i0 + 2t and i0 + 2t + 1.
    for (int tile = warp; tile < tiles; tile += warps) {
      const int j0 = 16 * tile;
      FragA ka[KD], va[KD];
      load_a_split<DT, kExact>(ka, ks, j0, g, t);
      load_a_split<DT, kExact>(va, vs, j0, g, t);
      const int keys[2] = {j0 + g, j0 + g + 8};
      const float id_key[2] = {id_of<MODE>(ids, keys[0]), id_of<MODE>(ids, keys[1])};
      float dka[KD][4], dva[KD][4];
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        dka[nn][0] = dka[nn][1] = dka[nn][2] = dka[nn][3] = 0.f;
        dva[nn][0] = dva[nn][1] = dva[nn][2] = dva[nn][3] = 0.f;
      }
      float term[4];
      load_terms<MODE, true>(term, keys, 2 * t, N, bias_h, mask_w);
      for (int i0 = 0; i0 < Np; i0 += 8) {
        float next[4];
        load_terms<MODE, true>(next, keys, i0 + 8 + 2 * t, N, bias_h, mask_w);
        float s[4], dp[4];
        product_nt<DT, kExact>(s, ka, qs, i0, g, t);
        product_nt<DT, kExact>(dp, va, gs, i0, g, t);
        const int r0 = i0 + 2 * t;
        const float2 mx = *reinterpret_cast<const float2*>(row_max + r0);
        const float2 iv = *reinterpret_cast<const float2*>(row_inv + r0);
        const float2 dl = *reinterpret_cast<const float2*>(row_dlt + r0);
        const float2 id_row = id_pair<MODE>(ids, r0);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e & 1);
          const float sc = logit<MODE>(s[e], term[e], row < N && keys[e >> 1] < N, (e & 1) ? id_row.y : id_row.x,
                                       id_key[e >> 1], scale);
          // a padded key has p = 0 already; a padded row is zeroed here
          p[e] = row < N ? __expf(sc - ((e & 1) ? mx.y : mx.x)) * ((e & 1) ? iv.y : iv.x) : 0.f;
          ds[e] = p[e] * (dp[e] - ((e & 1) ? dl.y : dl.x));
        }
        product_cn<DT, kExact>(dva, p, gs, i0, g, t);
        product_cn<DT, kExact>(dka, ds, qs, i0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) term[e] = next[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (keys[r] >= N) continue;
        const size_t row = base + static_cast<size_t>(keys[r]) * d;
#pragma unroll
        for (int nn = 0; nn < KD; ++nn) {
          const int c = 8 * nn + 2 * t;
          store_cols<T>(dk + row, c, d, dka[nn][2 * r] * scale, dka[nn][2 * r + 1] * scale);
          store_cols<T>(dv + row, c, d, dva[nn][2 * r], dva[nn][2 * r + 1]);
        }
      }
    }
  }
}

// dbias[i] = sum_g part[g, i] in the order g = 0 .. G-1.
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                    int groups, size_t hnn) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < hnn;
       i += stride) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[static_cast<size_t>(g) * hnn + i];
    dbias[i] = s;
  }
}

// ---------------------------------------------------------------------------
// The tile-64 backward (head dims 33 .. 64), designed for Hopper. The same
// function as the kernel above, from the forward's saved output O and row
// log-sum-exp lse (f32 [B, H, N]):
//
//   P = e^(S - lse)          S = scale Q.K^T + bias[h] (+ mask)
//   u = rowsum(P o dP)       f32: rowsum(dO o O), a prologue kernel
//   dS = P o (dP - u)
//
// so in f32 no sweep over the keys finds the row statistics: 7 N x N x 64
// products per (window, head) where the kernel above needs 9. In bf16 O is
// rounded, and u from it would move every dS by P u_err, dbias by about
// 2e-3 of its size (its tolerance is f32's): there the dQ kernel sweeps the
// keys once more for u in f32, 9 products, as the kernel above.
//
// What bounds it: 10 B H N^2 D flops of the five products the function
// needs, against 165 TFLOP/s in f32 (3xTF32 on the tensor cores) or 989 in
// bf16; the bytes (q, k, v, dO, O read, dq, dk, dv written once) are 10x
// fewer at N = 343. Measured (PERF.md), both kernels are bound by latency
// and issue, not by a unit's rate: with 8 warps an SM, per-step staging
// (copies, split, barrier) took a third of the f32 time, and copies issued
// two steps ahead were no faster than one.
//
// Two roles, two kernels, 4 warps a CTA, a warp owning 16 rows or keys:
//   * dQ (window_attention_bwd64_dq_kernel): a CTA per (64-row block, head,
//     group of windows), walking its windows in order. Each warp holds its
//     16 rows of Q and dO as A fragments split once a window (f32: their
//     hi halves in registers, the lo halves in place of the raw rows in
//     shared memory; all in registers spilled). f32 streams K and V
//     through a ring of two slots of 16 keys, copied with cp.async a step
//     ahead and split into hi and lo once by the thread that copied them;
//     bf16 keeps the window's K and V resident (90 KB at N = 343), so its
//     steps need no barrier. Per step: S and dP, dS, its add to the group's
//     dbias partial, dQ += dS.K.
//   * dK and dV (window_attention_bwd64_dkdv_kernel): f32: a CTA per
//     (window, 64-key block, head); K and V of the block staged once, split;
//     Q, dO, lse and u through the ring 16 rows a step; S^T and dP^T one
//     8-row n-tile at a time (both at once spilled at 255 registers). bf16:
//     a CTA per (window, head) walking the key blocks, the window's Q, dO,
//     lse and u resident. Per step: S^T, dP^T, P^T, dS^T, dV += P^T.dO, dK
//     += dS^T.Q.
//   * bias (+ the mask of each window) is written once per call into an
//     aligned term array [T, H, Np, Np] (a prologue kernel), so that f32's
//     ring stages a (row block, key step) tile of it in 16-byte cp.async
//     chunks, swizzled onto 32 banks for the orientation each role reads
//     (term_at), and bf16 reads it from L2 in pairs.
//   * f32 products: mma.sync m16n8k8 TF32 in the 3xTF32 split, the small
//     terms first into the one accumulator; dQ, dK and dV sum each 8-term
//     product from zero and add it in f32 (the kernel above's rule: 4e-6 of
//     dq at N = 343 without it). bf16 products: mma.sync m16n8k16 bf16,
//     the work of two TF32 MMAs in one; the A side of dQ, dK and dV (P or
//     dS, not bf16) split into bf16 hi and lo, 16 bits of mantissa, far
//     inside bf16's tolerance; each 16-term product summed from zero.
//   * Kept from the kernel above: padded keys score -inf, padded rows get P
//     = dS = 0, padded columns are never stored; d not a multiple of 4 (or a
//     row off a chunk boundary) is staged value by value; no atomics: every
//     output element has one owner and a fixed order of sums (the dbias
//     partial [G, H, N, Np] is owned by the dQ CTAs, written by a group's
//     first window and added to by the others in order, then summed over
//     the G groups in order), so two runs are bitwise equal.
//   * mma.sync, not wgmma: wgmma's tf32 takes no transposed operand, and
//     dV = P^T.dO, dK = dS^T.Q, dQ = dS.K would need K-major copies staged
//     beside each tile; mma.sync reads both orientations from one swizzled
//     tile.

constexpr int kWarps64 = 4;
constexpr int kBlock64 = 64;  // rows of a dQ CTA, keys of a dK/dV CTA
constexpr int kStep64 = 16;   // keys a dQ step, rows a dK/dV step
// f32's ring: each step's copies issued one step ahead (a third slot, two
// steps ahead, measured no faster: the copies' latency is hidden already)
constexpr int kSlots = 2;

// Shared memory of the dQ kernel, in floats: the block's raw Q and dO
// [64][64] (type T; in f32 their lo halves replace them, the hi halves
// stay in registers), then f32: two ring slots, each K and V hi and lo
// [16][64] (f32 lands in hi and is split in place) and the term tile
// [64][16]; bf16: the window's K and V [Np][64], resident; then the
// window's ids [Np] (REGION).
struct DqLayout {
  int qraw, graw, slots, slot, khi, klo, vhi, vlo, term, kw, vw, ids, total;
  __host__ __device__ DqLayout(int Np, bool bf16, int mode) {
    const int raw64 = bf16 ? 64 * 32 : 64 * 64;
    const int tile = kStep64 * 64;
    qraw = 0;
    graw = raw64;
    slots = 2 * raw64;
    khi = klo = vhi = vlo = term = slot = 0;
    kw = vw = slots;
    if (bf16) {
      vw = kw + Np * 32;
      ids = vw + Np * 32;
    } else {
      int o = 0;
      khi = o, o += tile;
      klo = o, o += tile;
      vhi = o, o += tile;
      vlo = o, o += tile;
      term = o, o += kBlock64 * kStep64;
      slot = o;
      ids = slots + kSlots * slot;
    }
    total = ids + (mode == kRegion ? Np : 0);
  }
};

// Shared memory of the dK/dV kernel, in floats: f32: the block's K and V
// hi and lo [64][64] (each lands in hi and is split in place; K's
// fragments held in registers as well spilled), two ring slots, each Q and
// dO hi and lo [16][64], the term tile [16][64], lse and u [16]; bf16: the
// block's raw K and V [64][64] (K's fragments held in registers), the
// window's Q and dO [Np][64], lse and u [Np], resident; then the window's
// ids [Np] (REGION).
struct DkdvLayout {
  int kraw, klo, vhi, vlo, vraw, slots, slot, qhi, qlo, ghi, glo, term, lse, dlt, qw, gw, ids, total;
  __host__ __device__ DkdvLayout(int Np, bool bf16, int mode) {
    const int raw64 = bf16 ? 64 * 32 : 64 * 64;
    const int tile = kStep64 * 64;
    kraw = 0;
    klo = vhi = vlo = vraw = slots = slot = qhi = qlo = ghi = glo = term = qw = gw = 0;
    if (bf16) {
      vraw = raw64;
      qw = vraw + raw64;
      gw = qw + Np * 32;
      lse = gw + Np * 32;
      dlt = lse + Np;
      ids = dlt + Np;
    } else {
      klo = raw64;
      vhi = klo + 64 * 64;
      vlo = vhi + 64 * 64;
      slots = vlo + 64 * 64;
      int o = 0;
      qhi = o, o += tile;
      qlo = o, o += tile;
      ghi = o, o += tile;
      glo = o, o += tile;
      term = o, o += kStep64 * 64;
      lse = o, o += kStep64;
      dlt = o, o += kStep64;
      slot = o;
      ids = slots + kSlots * slot;
    }
    total = ids + (mode == kRegion ? Np : 0);
  }
};

// u[row] = sum_c dO[row][c] O[row][c] over the B H N rows, one warp a row,
// f32: the prologue of f32 calls (bf16's u comes from the dQ kernel).
template <typename T>
__global__ void __launch_bounds__(256)
window_attention_bwd64_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                    float* __restrict__ delta, size_t rows, int d) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_float(o[c]), to_float(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  if (lane == 0) delta[row] = s;
}

// A term tile of rows r0 .. r0 + RT - 1 and keys k0 .. k0 + KT - 1 of one
// [Np, Np] plane of the term array (KT 16 or 64), 16-byte chunks; zeros
// past Np. Chunk c of row r lands at r KT + 4 (c ^ swz(r)), swz(r) keeping
// the lanes' reads on 32 banks (term_at): the dQ role's float2 pairs of
// rows g and g + 8 (KT 16), the dK/dV role's rows 2t, 2t + 1 at keys g, g +
// 8 (KT 64).
template <int KT>
__device__ __forceinline__ int term_at(int r, int c) {
  const int swz = KT == 16 ? ((r >> 1) & 1) << 1 : ((r >> 1) & 3) << 1;
  return r * KT + (((c >> 2) ^ swz) << 2) + (c & 3);
}
template <int RT, int KT>
__device__ __forceinline__ void issue_terms(float* tile, const float* plane, int r0, int k0, int Np) {
  constexpr int kChunks = KT / 4;
  for (int i = threadIdx.x; i < RT * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    const bool in = r0 + r < Np && k0 + c < Np;
    cp_async<16>(tile + term_at<KT>(r, c), plane + (in ? static_cast<size_t>(r0 + r) * Np + k0 + c : 0),
                 in ? 16 : 0);
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kWarps64 * 32, 2)
window_attention_bwd64_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                 const T* __restrict__ dout, const float* __restrict__ lse,
                                 float* __restrict__ delta, const float* __restrict__ terms,
                                 const float* __restrict__ region_ids, T* __restrict__ dq,
                                 float* __restrict__ dbias_part, int B, int H, int N, int d, int nW,
                                 int windows_per_cta, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  // bf16 walks a window's keys twice: a sweep for u, then the products; it
  // keeps the window's K and V resident (half f32's bytes, no split)
  constexpr int kPasses = kExact ? 2 : 1;
  constexpr bool kWhole = kExact;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int steps = Np / kStep64;
  const DqLayout L(Np, kExact, MODE);
  T* qraw = reinterpret_cast<T*>(smem + L.qraw);
  T* graw = reinterpret_cast<T*>(smem + L.graw);
  float* qlo = smem + L.qraw;  // f32: the lo halves, in place
  float* glo = smem + L.graw;
  T* kw = reinterpret_cast<T*>(smem + L.kw);  // bf16: the window's K and V
  T* vw = reinterpret_cast<T*>(smem + L.vw);
  float* ids = smem + L.ids;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.x * kBlock64;  // the CTA's rows
  const int h = blockIdx.y;
  const int group = blockIdx.z;
  const int i0 = r0 + 16 * warp;  // the warp's rows
  const bool busy = i0 < N;       // i0 + 16 <= Np then
  const int rows[2] = {i0 + g, i0 + g + 8};
  const int b_begin = group * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);
  if (b_begin >= b_end) return;
  float* part = dbias_part + (static_cast<size_t>(group) * H + h) * N * Np;  // [N][Np]

  auto slot_at = [&](int s, int field) { return smem + L.slots + (s % kSlots) * L.slot + field; };
  auto base_of = [&](int b) { return (static_cast<size_t>(b) * H + h) * N * d; };
  auto plane_of = [&](int b) {
    return terms + (static_cast<size_t>(MODE == kMask ? b % nW : 0) * H + h) * Np * Np;
  };
  // Q and dO of the block of window b, its ids, and (bf16) its K and V
  auto issue_window = [&](int b) {
    const size_t base = base_of(b);
    issue_rows<T>(qraw, q + base, r0, kBlock64, N, d, chunked(q + base, d));
    issue_rows<T>(graw, dout + base, r0, kBlock64, N, d, chunked(dout + base, d));
    if (kWhole) {
      issue_rows<T>(kw, k + base, 0, Np, N, d, chunked(k + base, d));
      issue_rows<T>(vw, v + base, 0, Np, N, d, chunked(v + base, d));
    }
    if (MODE == kRegion) {
      const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
      for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async<4>(ids + i, w_ids + i);
    }
  };
  auto fill_window = [&](int b) {
    const size_t base = base_of(b);
    fill_rows<T>(qraw, q + base, r0, kBlock64, N, d, chunked(q + base, d));
    fill_rows<T>(graw, dout + base, r0, kBlock64, N, d, chunked(dout + base, d));
    if (kWhole) {
      fill_rows<T>(kw, k + base, 0, Np, N, d, chunked(k + base, d));
      fill_rows<T>(vw, v + base, 0, Np, N, d, chunked(v + base, d));
    }
  };
  // f32: K and V of keys 16 j .. 16 j + 15 of window b, and the term tile, into slot s
  auto issue_step = [&](int b, int j, int s) {
    const size_t base = base_of(b);
    issue_rows<T>(reinterpret_cast<T*>(slot_at(s, L.khi)), k + base, kStep64 * j, kStep64, N, d, chunked(k + base, d));
    issue_rows<T>(reinterpret_cast<T*>(slot_at(s, L.vhi)), v + base, kStep64 * j, kStep64, N, d, chunked(v + base, d));
    issue_terms<kBlock64, kStep64>(slot_at(s, L.term), plane_of(b), r0, kStep64 * j, Np);
  };
  auto finish_step = [&](int b, int j, int s) {
    const size_t base = base_of(b);
    split_rows<T>(slot_at(s, L.khi), slot_at(s, L.klo), reinterpret_cast<const T*>(slot_at(s, L.khi)), k + base,
                  kStep64 * j, kStep64, N, d, chunked(k + base, d));
    split_rows<T>(slot_at(s, L.vhi), slot_at(s, L.vlo), reinterpret_cast<const T*>(slot_at(s, L.vhi)), v + base,
                  kStep64 * j, kStep64, N, d, chunked(v + base, d));
  };
  // f32: step f of the CTA's walk (window b_begin + f / steps, key step f %
  // steps) into slot f % kSlots, if the walk has it; one commit group a step,
  // empty past the walk's end, so that a wait counts steps
  auto issue_flat = [&](int f) {
    if (b_begin + f / steps < b_end) issue_step(b_begin + f / steps, f % steps, f);
    cp_async_commit();
  };
  auto finish_flat = [&](int f) {
    if (b_begin + f / steps < b_end) finish_step(b_begin + f / steps, f % steps, f);
  };
  uint32_t qh[8][4], gh[8][4];  // f32: Q's and dO's hi halves, their lo halves in qlo, glo
  uint32_t qa[4][4], ga[4][4];  // bf16: Q's and dO's m16n8k16 fragments

  issue_window(b_begin);
  if constexpr (kWhole) {
    cp_async_commit();
    cp_async_wait_all();
  } else {
#pragma unroll
    for (int f = 0; f < kSlots - 1; ++f) issue_flat(f);  // the first group holds the window too
    cp_async_wait_group<kSlots - 2>();
  }
  fill_window(b_begin);
  if (!kWhole) finish_flat(0);
  __syncthreads();

  int s = 0;  // steps walked: the ring slot is s % 2
  for (int b = b_begin; b < b_end; ++b) {
    const size_t base = base_of(b);
    const bool first = b == b_begin;
    const float* plane = plane_of(b);
    float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f}, id_row[2] = {0.f, 0.f};
    float u[2] = {0.f, 0.f};  // bf16: this lane's share of rowsum(P o dP), the sweep's
    float acc[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
    if (busy) {  // this warp's rows of Q and dO, split once (f32: the lo halves replace the raw values)
      if constexpr (kWhole) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          frag_bf16(qa[kk], qraw, 16 * warp, kk, g, t);
          frag_bf16(ga[kk], graw, 16 * warp, kk, g, t);
        }
      } else {
        load_frags_hi<T, kExact>(qh, qlo, qraw, 16 * warp, g, t);
        load_frags_hi<T, kExact>(gh, glo, graw, 16 * warp, g, t);
      }
      const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
          lse_r[r] = __ldg(lse + row_base + rows[r]);
          if (!kExact) dlt_r[r] = __ldg(delta + row_base + rows[r]);
        }
        id_row[r] = id_of<MODE>(ids, rows[r]);
      }
    }
    for (int jj = 0; jj < kPasses * steps; ++jj, ++s) {
      const int j = jj < steps ? jj : jj - steps;  // the key step
      const bool last = jj + 1 == kPasses * steps;
      if (!kWhole) issue_flat(s + kSlots - 1);
      const int j0 = kStep64 * j;
      if (busy) {
        const bool sweep = kExact && jj < steps;  // bf16's sweep: u = rowsum(P o dP) in f32
        // the terms of rows g, g + 8 at the lane's key pairs, from the ring
        // slot's tile or (bf16) the term array in L2, read before the products
        float2 tm[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int c = 8 * nt + 2 * t;
            tm[nt][r] = kWhole ? __ldg(reinterpret_cast<const float2*>(plane + static_cast<size_t>(rows[r]) * Np + j0 + c))
                               : *reinterpret_cast<const float2*>(slot_at(s, L.term) +
                                                                  term_at<kStep64>(16 * warp + g + 8 * r, c));
          }
        // the dbias partial this step adds to, read before the products
        float2 old[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            old[nt][r] = !sweep && !first && rows[r] < N
                             ? *reinterpret_cast<const float2*>(part + static_cast<size_t>(rows[r]) * Np + j0 +
                                                                8 * nt + 2 * t)
                             : make_float2(0.f, 0.f);
        float sc[2][4] = {}, dp[2][4] = {};
        if constexpr (kWhole) {
          product_nt_bf16<2>(sc, qa, kw, j0, g, t);
          product_nt_bf16<2>(dp, ga, vw, j0, g, t);
        } else {
          product_nt_hilo<2, kExact>(sc, qh, qlo, 16 * warp, slot_at(s, L.khi), slot_at(s, L.klo), 0, g, t);
          product_nt_hilo<2, kExact>(dp, gh, glo, 16 * warp, slot_at(s, L.vhi), slot_at(s, L.vlo), 0, g, t);
        }
        float ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = 8 * nt + 2 * t;  // the lane's keys j0 + c, j0 + c + 1
          const float2 id_key = id_pair<MODE>(ids, j0 + c);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool real = rows[r] < N && j0 + c + e < N;
              const float x = logit<MODE>(sc[nt][2 * r + e], e ? tm[nt][r].y : tm[nt][r].x, real, id_row[r],
                                          e ? id_key.y : id_key.x, scale);
              const float p = real ? __expf(x - lse_r[r]) : 0.f;
              if (sweep)
                u[r] = fmaf(p, dp[nt][2 * r + e], u[r]);
              else
                ds[nt][2 * r + e] = p * (dp[nt][2 * r + e] - dlt_r[r]);
            }
            // (row, key pair) has one owner lane; 0 + ds = ds for the first window
            if (!sweep && rows[r] < N)
              *reinterpret_cast<float2*>(part + static_cast<size_t>(rows[r]) * Np + j0 + c) =
                  make_float2(old[nt][r].x + ds[nt][2 * r], old[nt][r].y + ds[nt][2 * r + 1]);
          }
          if constexpr (!kWhole) product_cn_tile<kExact>(acc, ds[nt], slot_at(s, L.khi), slot_at(s, L.klo), 8 * nt, g, t);
        }
        if constexpr (kWhole) {
          if (!sweep) product_cn_bf16(acc, ds[0], ds[1], kw, j0, g, t);
        }
        if (sweep && jj == steps - 1) {  // the quad's keys: every lane ends with the same bits
          const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            u[r] += __shfl_xor_sync(kFullMask, u[r], 1);
            u[r] += __shfl_xor_sync(kFullMask, u[r], 2);
            dlt_r[r] = u[r];
            if (t == 0 && rows[r] < N) delta[row_base + rows[r]] = u[r];  // for the dK/dV kernel
          }
        }
      }
      if constexpr (!kWhole) {
        if (last && b + 1 < b_end) {  // the next window's Q, dO and ids: their tiles are free only now
          __syncthreads();
          issue_window(b + 1);
          cp_async_commit();
          cp_async_wait_all();
          fill_window(b + 1);
        } else {
          cp_async_wait_group<kSlots - 2>();  // step s + 1's copies
        }
        finish_flat(s + 1);
        __syncthreads();
      }
    }
    if (busy) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        T* o = dq + base + static_cast<size_t>(rows[r]) * d;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          store_cols<T>(o, 8 * nn + 2 * t, d, acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale);
      }
    }
    if (kWhole && b + 1 < b_end) {  // the next window, once every warp is done with this one
      __syncthreads();
      issue_window(b + 1);
      cp_async_commit();
      cp_async_wait_all();
      fill_window(b + 1);
      __syncthreads();
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kWarps64 * 32, 2)
window_attention_bwd64_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                   const T* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, const float* __restrict__ terms,
                                   const float* __restrict__ region_ids, T* __restrict__ dk, T* __restrict__ dv,
                                   int B, int H, int N, int d, int nW, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  // bf16: the window's Q and dO resident, one CTA walking the window's key
  // blocks; f32: one CTA a key block, Q and dO through the ring
  constexpr bool kWhole = kExact;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int steps = Np / kStep64;
  const int blocks = (N + kBlock64 - 1) / kBlock64;
  const DkdvLayout L(Np, kExact, MODE);
  T* kraw = reinterpret_cast<T*>(smem + L.kraw);
  float* khi = smem + L.kraw;  // f32: K lands in hi and is split in place
  float* klo = smem + L.klo;
  float* vhi = smem + L.vhi;  // f32
  float* vlo = smem + L.vlo;
  T* vraw = kWhole ? reinterpret_cast<T*>(smem + L.vraw) : reinterpret_cast<T*>(vhi);
  T* qw = reinterpret_cast<T*>(smem + L.qw);  // bf16
  T* gw = reinterpret_cast<T*>(smem + L.gw);
  float* ids = smem + L.ids;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = kWhole ? blockIdx.x : blockIdx.x / blocks;
  const int kb_begin = kWhole ? 0 : blockIdx.x - b * blocks;  // the CTA's key blocks
  const int kb_end = kWhole ? blocks : kb_begin + 1;
  const int h = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * H + h) * N * d;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
  const float* plane = terms + (static_cast<size_t>(MODE == kMask ? b % nW : 0) * H + h) * Np * Np;
  const bool q_chunks = chunked(q + base, d);
  const bool g_chunks = chunked(dout + base, d);
  const bool k_chunks = chunked(k + base, d);
  const bool v_chunks = chunked(v + base, d);
  int k0 = kBlock64 * kb_begin;  // the block's keys

  auto slot_at = [&](int s, int field) { return smem + L.slots + (s % kSlots) * L.slot + field; };
  // f32: Q, dO, lse and u of rows 16 i .. 16 i + 15, and the term tile, into slot i % 2
  auto issue_step = [&](int i) {
    const int i0 = kStep64 * i;
    issue_rows<T>(reinterpret_cast<T*>(slot_at(i, L.qhi)), q + base, i0, kStep64, N, d, q_chunks);
    issue_rows<T>(reinterpret_cast<T*>(slot_at(i, L.ghi)), dout + base, i0, kStep64, N, d, g_chunks);
    if (threadIdx.x < 2 * kStep64) {
      const int r = threadIdx.x % kStep64;
      const bool real = i0 + r < N;
      const float* src = threadIdx.x < kStep64 ? lse : delta;
      float* dst = slot_at(i, threadIdx.x < kStep64 ? L.lse : L.dlt);
      cp_async<4>(dst + r, src + row_base + (real ? i0 + r : 0), real ? 4 : 0);
    }
    issue_terms<kStep64, kBlock64>(slot_at(i, L.term), plane, i0, k0, Np);
  };
  // f32: step i's copies, if the block has step i; one commit group a step
  auto issue_flat = [&](int i) {
    if (i < steps) issue_step(i);
    cp_async_commit();
  };
  auto finish_step = [&](int i) {
    split_rows<T>(slot_at(i, L.qhi), slot_at(i, L.qlo), reinterpret_cast<const T*>(slot_at(i, L.qhi)), q + base,
                  kStep64 * i, kStep64, N, d, q_chunks);
    split_rows<T>(slot_at(i, L.ghi), slot_at(i, L.glo), reinterpret_cast<const T*>(slot_at(i, L.ghi)), dout + base,
                  kStep64 * i, kStep64, N, d, g_chunks);
  };

  // the window's ids, and (bf16) its Q, dO, lse and u
  if (MODE == kRegion) {
    const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async<4>(ids + i, w_ids + i);
  }
  if constexpr (kWhole) {
    issue_rows<T>(qw, q + base, 0, Np, N, d, q_chunks);
    issue_rows<T>(gw, dout + base, 0, Np, N, d, g_chunks);
    for (int i = threadIdx.x; i < 2 * Np; i += blockDim.x) {
      const int r = i < Np ? i : i - Np;
      const bool real = r < N;
      cp_async<4>(smem + (i < Np ? L.lse : L.dlt) + r, (i < Np ? lse : delta) + row_base + (real ? r : 0),
                  real ? 4 : 0);
    }
  }
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    k0 = kBlock64 * kb;
    const int j0 = k0 + 16 * warp;  // the warp's keys
    const bool busy = j0 < N;
    const int keys[2] = {j0 + g, j0 + g + 8};
    if (kb > kb_begin) __syncthreads();  // every warp is done with the block before
    issue_rows<T>(kraw, k + base, k0, kBlock64, N, d, k_chunks);
    issue_rows<T>(vraw, v + base, k0, kBlock64, N, d, v_chunks);
    if constexpr (kWhole) {
      cp_async_commit();
      cp_async_wait_all();
    } else {
#pragma unroll
      for (int i = 0; i < kSlots - 1; ++i) issue_flat(i);  // the first group holds K and V too
      cp_async_wait_group<kSlots - 2>();
    }
    if constexpr (kWhole) {
      fill_rows<T>(kraw, k + base, k0, kBlock64, N, d, k_chunks);
      fill_rows<T>(vraw, v + base, k0, kBlock64, N, d, v_chunks);
      if (kb == kb_begin) {
        fill_rows<T>(qw, q + base, 0, Np, N, d, q_chunks);
        fill_rows<T>(gw, dout + base, 0, Np, N, d, g_chunks);
      }
    } else {
      split_rows<T>(khi, klo, kraw, k + base, k0, kBlock64, N, d, k_chunks);
      split_rows<T>(vhi, vlo, vraw, v + base, k0, kBlock64, N, d, v_chunks);
      finish_step(0);
    }
    __syncthreads();

    uint32_t ka[4][4];  // bf16: K's m16n8k16 fragments
    float id_key[2] = {0.f, 0.f};
    if (busy) {
      if constexpr (kWhole) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_bf16(ka[kk], kraw, 16 * warp, kk, g, t);
      }
      id_key[0] = id_of<MODE>(ids, keys[0]);
      id_key[1] = id_of<MODE>(ids, keys[1]);
    }
    float dka[8][4], dva[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      dka[nn][0] = dka[nn][1] = dka[nn][2] = dka[nn][3] = 0.f;
      dva[nn][0] = dva[nn][1] = dva[nn][2] = dva[nn][3] = 0.f;
    }
    // One step over rows 16 i .. 16 i + 15: Q and dO rows c0 .. c0 + 15 of
    // qs, gs (a ring slot, or the resident window), lse and u at ls_at, dl_at.
    auto step = [&](int i, const auto* qs, const float* ql, const auto* gs, const float* gl, int c0,
                    const float* ls_at, const float* dl_at) {
      // the term of the lane's row 8 nt + 2t + e % 2 at key g + 8 (e / 2): bf16
      // reads the term array in L2 before the products, f32 the ring slot's
      // tile at its use (registers)
      auto term = [&](int nt, int e) {
        const int row = 8 * nt + 2 * t + (e & 1);
        const int key = 16 * warp + g + 8 * (e >> 1);
        return kWhole ? __ldg(plane + static_cast<size_t>(kStep64 * i + row) * Np + k0 + key)
                      : slot_at(i, L.term)[term_at<kBlock64>(row, key)];
      };
      float tm[2][4];
      if constexpr (kWhole) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tm[nt][e] = term(nt, e);
      }
      // S^T = K.Q^T, dP^T = V.dO^T: keys (C rows) g, g + 8, rows (C columns) 8 nt + 2t, + 1
      // (f32 one 8-row n-tile at a time: both at once spilled at 255 registers)
      float st[2][4] = {}, dpt[2][4] = {};
      if constexpr (kWhole) {
        product_nt_bf16<2>(st, ka, qs, c0, g, t);
        product_nt_bf16<2>(dpt, vraw, 16 * warp, gs, c0, g, t);
      }
      float p[2][4], ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if constexpr (!kWhole) {
          float st1[1][4] = {}, dpt1[1][4] = {};
          product_nt_tiles<1, kExact>(st1, khi, klo, 16 * warp, qs, ql, c0 + 8 * nt, g, t);
          product_nt_tiles<1, kExact>(dpt1, vhi, vlo, 16 * warp, gs, gl, c0 + 8 * nt, g, t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[nt][e] = st1[0][e];
            dpt[nt][e] = dpt1[0][e];
          }
        }
        const int c = 8 * nt + 2 * t;  // the lane's rows 16 i + c, + 1
        const int row0 = kStep64 * i + c;
        const float2 ls = *reinterpret_cast<const float2*>(ls_at + c);
        const float2 dl = *reinterpret_cast<const float2*>(dl_at + c);
        const float2 id_row = id_pair<MODE>(ids, row0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = e >> 1;  // key g or g + 8
          const int rr = e & 1;   // row c or c + 1
          const bool real = row0 + rr < N && keys[kr] < N;
          const float x = logit<MODE>(st[nt][e], kWhole ? tm[nt][e] : term(nt, e), real, rr ? id_row.y : id_row.x,
                                      id_key[kr], scale);
          p[nt][e] = real ? __expf(x - (rr ? ls.y : ls.x)) : 0.f;
          ds[nt][e] = p[nt][e] * (dpt[nt][e] - (rr ? dl.y : dl.x));
        }
        if constexpr (!kWhole) {
          product_cn_tile<kExact>(dva, p[nt], gs, gl, c0 + 8 * nt, g, t);
          product_cn_tile<kExact>(dka, ds[nt], qs, ql, c0 + 8 * nt, g, t);
        }
      }
      if constexpr (kWhole) {
        product_cn_bf16(dva, p[0], p[1], gs, c0, g, t);
        product_cn_bf16(dka, ds[0], ds[1], qs, c0, g, t);
      }
    };
    for (int i = 0; i < steps; ++i) {
      if constexpr (kWhole) {
        if (busy)
          step(i, qw, nullptr, gw, nullptr, kStep64 * i, smem + L.lse + kStep64 * i, smem + L.dlt + kStep64 * i);
      } else {
        issue_flat(i + kSlots - 1);
        if (busy)
          step(i, slot_at(i, L.qhi), slot_at(i, L.qlo), slot_at(i, L.ghi), slot_at(i, L.glo), 0, slot_at(i, L.lse),
               slot_at(i, L.dlt));
        cp_async_wait_group<kSlots - 2>();  // step i + 1's copies
        if (i + 1 < steps) finish_step(i + 1);
        __syncthreads();
      }
    }
    if (busy) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (keys[r] >= N) continue;
        const size_t row = base + static_cast<size_t>(keys[r]) * d;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int c = 8 * nn + 2 * t;
          store_cols<T>(dk + row, c, d, dka[nn][2 * r] * scale, dka[nn][2 * r + 1] * scale);
          store_cols<T>(dv + row, c, d, dva[nn][2 * r], dva[nn][2 * r + 1]);
        }
      }
    }
  }
}

// dbias[h, i, j] = sum_g part[g, h, i, j] in the order g = 0 .. G-1, the
// partial's rows Np apart.
__global__ void dbias_reduce64_kernel(const float* __restrict__ part, float* __restrict__ dbias, int groups,
                                      int H, int N, int Np) {
  const size_t hnn = static_cast<size_t>(H) * N * N;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < hnn; i += stride) {
    const size_t row = i / N;  // h * N + row
    const size_t at = row * Np + (i - row * N);
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[static_cast<size_t>(g) * H * N * Np + at];
    dbias[i] = s;
  }
}

// The pointers and sizes of one backward call.
struct Args {
  const void *q, *k, *v, *dout, *out;
  const float *lse, *bias, *region_ids, *mask;
  void *dq, *dk, *dv;
  float *delta, *terms, *dbias_part, *dbias;
  int B, H, N, d, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

// Warps per CTA: a warp owns a 16-row (then a 16-key) tile, so a CTA has as
// few warps as the fewest rounds over the Np / 16 tiles allow, at most the
// launch bounds at tile DT; at tile 64 four (64 rows or keys a CTA).
int cta_warps(int N, int DT) { return DT == 64 ? kWarps64 : tile_warps(N, max_warps(DT)); }

// operands [Np, DT] x 4, then row max, 1 / row sum, rowsum(P o dP), ids
// [Np] each; at tile 64 the larger of the two kernels' (DqLayout,
// DkdvLayout)
size_t smem_bytes(int N, int DT, bool bf16, int mode) {
  const int Np = (N + 15) / 16 * 16;
  if (DT == 64)
    return static_cast<size_t>(std::max(DqLayout(Np, bf16, mode).total, DkdvLayout(Np, bf16, mode).total)) *
           sizeof(float);
  return static_cast<size_t>(Np) * (kOperands * DT + 4) * sizeof(float);
}

// Allow `kernel` `smem` bytes of shared memory, and report how many of its
// CTAs of `threads` fit one SM (0 when `smem` exceeds a CTA's limit).
template <typename K>
cudaError_t fit(K kernel, size_t smem, int threads, int* ctas) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) {
    if (ctas != nullptr) *ctas = 0;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return ctas == nullptr ? cudaSuccess : cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads, smem);
}

// CTAs that fit one SM, from the compiled kernel's registers and the
// window's shared memory; 0 when the shared memory exceeds a CTA's limit.
// At tile 64 the dQ kernel's, whose grid the caller sizes from it (the
// dK/dV kernel's grid is one CTA a window, key block and head), or 0 where
// either kernel does not fit.
template <typename T, int DT, int MODE>
cudaError_t occupancy(int N, int* ctas) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (DT == 64) {
    const int Np = (N + 15) / 16 * 16;
    int dq = 0, dkdv = 0;
    cudaError_t err = fit(window_attention_bwd64_dq_kernel<T, MODE>,
                          DqLayout(Np, kBf16, MODE).total * sizeof(float), kWarps64 * 32, &dq);
    if (err == cudaSuccess)
      err = fit(window_attention_bwd64_dkdv_kernel<T, MODE>, DkdvLayout(Np, kBf16, MODE).total * sizeof(float),
                kWarps64 * 32, &dkdv);
    *ctas = dkdv > 0 ? dq : 0;
    return err;
  } else {
    return fit(window_attention_bwd_kernel<T, DT, MODE>, smem_bytes(N, DT, kBf16, MODE), cta_warps(N, DT) * 32,
               ctas);
  }
}

template <typename T, int DT>
cudaError_t occupancy_mode(int N, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, DT, kRegion>(N, ctas);
  if (has_mask) return occupancy<T, DT, kMask>(N, ctas);
  return occupancy<T, DT, kNone>(N, ctas);
}

// dbias from the partial of `groups` window groups, in order.
cudaError_t reduce_dbias(const Args& a, int groups, bool padded) {
  const size_t hnn = static_cast<size_t>(a.H) * a.N * a.N;
  const int threads = 256;
  size_t blocks = (hnn + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (padded)
    dbias_reduce64_kernel<<<static_cast<unsigned>(blocks), threads, 0, a.stream>>>(
        a.dbias_part, a.dbias, groups, a.H, a.N, (a.N + 15) / 16 * 16);
  else
    dbias_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, a.stream>>>(a.dbias_part, a.dbias, groups,
                                                                                  hnn);
  return cudaGetLastError();
}

template <typename T, int DT, int MODE>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.N, DT, false, MODE);
  auto kernel = window_attention_bwd_kernel<T, DT, MODE>;
  cudaError_t err = fit(kernel, smem, 0, nullptr);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  kernel<<<dim3(groups, a.H), cta_warps(a.N, DT) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.bias, a.region_ids, a.mask, static_cast<T*>(a.dq),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dbias_part, a.B, a.H, a.N, a.d, a.nW,
      a.windows_per_cta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_dbias(a, groups, false);
}

// Tile 64: the prologues (the term array; f32: u = rowsum(dO o O)), the dQ
// kernel (the dbias partial; bf16: u), the dK/dV kernel, the dbias
// reduction, in stream order.
template <typename T, int MODE>
cudaError_t launch64(const Args& a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int Np = (a.N + 15) / 16 * 16;
  const int blocks = (a.N + kBlock64 - 1) / kBlock64;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  const size_t dq_smem = DqLayout(Np, kBf16, MODE).total * sizeof(float);
  const size_t kv_smem = DkdvLayout(Np, kBf16, MODE).total * sizeof(float);
  auto dq_kernel = window_attention_bwd64_dq_kernel<T, MODE>;
  auto kv_kernel = window_attention_bwd64_dkdv_kernel<T, MODE>;
  cudaError_t err = fit(dq_kernel, dq_smem, 0, nullptr);
  if (err == cudaSuccess) err = fit(kv_kernel, kv_smem, 0, nullptr);
  if (err != cudaSuccess) return err;
  err = launch_terms(a.bias, MODE == kMask ? a.mask : nullptr, a.terms, MODE == kMask ? a.nW : 1, a.H, a.N, Np, Np,
                     false, a.stream);
  if (err != cudaSuccess) return err;
  if (!kBf16) {  // bf16's u comes from the dQ kernel's sweep, not from the rounded O
    const size_t rows = static_cast<size_t>(a.B) * a.H * a.N;
    window_attention_bwd64_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
        static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta, rows, a.d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_kernel<<<dim3(blocks, a.H, groups), kWarps64 * 32, dq_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.terms, a.region_ids, static_cast<T*>(a.dq),
      a.dbias_part, a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3(kBf16 ? a.B : a.B * blocks, a.H), kWarps64 * 32, kv_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.terms, a.region_ids, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.B, a.H, a.N, a.d, a.nW, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_dbias(a, groups, true);
}

template <typename T, int DT>
cudaError_t launch_mode(const Args& a) {
  if constexpr (DT == 64) {
    if (a.region_ids != nullptr) return launch64<T, kRegion>(a);
    if (a.mask != nullptr) return launch64<T, kMask>(a);
    return launch64<T, kNone>(a);
  } else {
    if (a.region_ids != nullptr) return launch<T, DT, kRegion>(a);
    if (a.mask != nullptr) return launch<T, DT, kMask>(a);
    return launch<T, DT, kNone>(a);
  }
}

template <int DT>
cudaError_t launch_type(const Args& a, int is_bf16) {
  return is_bf16 ? launch_mode<__nv_bfloat16, DT>(a) : launch_mode<float, DT>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when every launch was accepted. `region_ids`
// set selects REGION, else `mask` set selects MASK, else NONE; `is_bf16`
// the input type. The head dim D is any of 1 .. 64, run by the instance of
// its tile (head_dim_tile). Tiles 16 and 32 recompute the softmax: `out`,
// `lse` and `delta` are not read, and the scratch `dbias_part` holds
// ceil(B / windows_per_cta) * H * N * N floats. Tile 64 takes the forward's
// output `out` and row log-sum-exp `lse` [B, H, N] f32 (required; a bf16
// `out` is not read), and three scratch buffers: `delta` [B, H, N] f32 for
// rowsum(dO o O), `terms` [T, H, Np, Np] f32 (T = nW in MASK, else 1; Np =
// N padded to a multiple of 16) for bias (+ mask) in aligned rows, and
// `dbias_part` of ceil(B / windows_per_cta) * H * N * Np floats,
// windows_per_cta being the dQ kernel's. The CTA's width and shared memory
// are those icl_window_attention_bwd_geometry reports.
int icl_window_attention_bwd(const void* q, const void* k, const void* v, const void* dout, const void* out,
                             const void* lse, const void* bias, const void* region_ids, const void* mask, void* dq,
                             void* dk, void* dv, void* delta, void* terms, void* dbias_part, void* dbias, int B,
                             int H, int N, int D, int nW, int windows_per_cta, float scale, int is_bf16,
                             void* stream) {
  if (windows_per_cta < 1 || N < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, out,
               static_cast<const float*>(lse), static_cast<const float*>(bias),
               static_cast<const float*>(region_ids), static_cast<const float*>(mask), dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(terms), static_cast<float*>(dbias_part),
               static_cast<float*>(dbias), B, H, N, D, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  const int tile = head_dim_tile(D);
  if (tile == 16) return launch_type<16>(a, is_bf16);
  if (tile == 32) return launch_type<32>(a, is_bf16);
  if (tile == 64) {
    if (out == nullptr || lse == nullptr || delta == nullptr || terms == nullptr) return cudaErrorInvalidValue;
    return launch_type<64>(a, is_bf16);
  }
  return cudaErrorInvalidValue;
}

// The launch geometry at windows of N tokens and head dim D (its tile's
// instance), in the mode that `has_ids` (REGION), else `has_mask` (MASK),
// else neither (NONE) selects: the warps of a CTA, its shared memory in
// bytes, and how many such CTAs one SM of the current device holds, 0 when
// the window does not fit. At tile 64, where two kernels run, the larger
// shared memory and the dQ kernel's CTAs. Returns a cudaError_t.
int icl_window_attention_bwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                      int* smem, int* ctas) {
  const int tile = head_dim_tile(D);
  if (N < 1 || tile == 0) return cudaErrorInvalidValue;
  const int mode = has_ids ? kRegion : has_mask ? kMask : kNone;
  *warps = cta_warps(N, tile);
  *smem = static_cast<int>(smem_bytes(N, tile, is_bf16 != 0, mode));
  if (tile == 16)
    return is_bf16 ? occupancy_mode<__nv_bfloat16, 16>(N, has_ids, has_mask, ctas)
                   : occupancy_mode<float, 16>(N, has_ids, has_mask, ctas);
  if (tile == 32)
    return is_bf16 ? occupancy_mode<__nv_bfloat16, 32>(N, has_ids, has_mask, ctas)
                   : occupancy_mode<float, 32>(N, has_ids, has_mask, ctas);
  return is_bf16 ? occupancy_mode<__nv_bfloat16, 64>(N, has_ids, has_mask, ctas)
                 : occupancy_mode<float, 64>(N, has_ids, has_mask, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
