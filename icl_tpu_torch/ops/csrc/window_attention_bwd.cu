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
// branch at :331-332); window index = b % nW. Head dim D = 16 or 32. f32
// or bf16 q, k, v, dO; f32 math; dq, dk, dv in the input type; dbias in
// f32. The mask and the ids get no gradient.
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
// Design (the building blocks are in mma_tf32.cuh, shared with the
// forward):
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
//     (cp.async for f32 inputs), N padded with zero rows to Np, a multiple
//     of 16, in 4-float chunks permuted by an XOR (sidx) so that both
//     fragment patterns hit 32 banks without padding.
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
//   * Occupancy: at D = 16, 8 warps and 128 registers a thread, two CTAs
//     an SM (96 KB of shared memory each at N = 343); at D = 32 the split
//     fragments need more, so at most 5 warps at up to 204 registers, two
//     CTAs an SM (N = 144 has 9 tiles: two rounds of 5 warps). The warps
//     and the shared memory are chosen here from N and D; the caller sizes
//     the grid from icl_window_attention_bwd_geometry's resident CTAs.
//   What still binds it (times in PERF.md): latency more than any unit's
//   rate, with 10-16 warps an SM, among it the bias and mask reads of the
//   three sweeps and the per-window read-modify-write of the dbias partial.

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

// Warps per CTA at most: the launch bounds. At D = 32 the fragments held in
// registers need more than 128 a thread; 5 warps at up to 204 registers
// keep two CTAs on an SM, which is what N = 144 (9 tiles) can use.
__host__ __device__ constexpr int max_warps(int D) { return D == 32 ? 5 : 8; }

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

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(max_warps(D) * 32, 2)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ bias, const float* __restrict__ region_ids,
                            const float* __restrict__ mask, T* __restrict__ dq,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ dbias_part, int B, int H, int N, int nW,
                            int windows_per_cta, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  constexpr int KD = D / 8;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  float* qs = smem;                // [Np, D], see sidx
  float* ks = qs + Np * D;
  float* vs = ks + Np * D;
  float* gs = vs + Np * D;         // dO
  float* row_max = gs + Np * D;    // [Np]
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

  // the padded rows stay zero for every window
  for (int i = threadIdx.x; i < (Np - N) * D / 4; i += blockDim.x) {
    const int at = sidx<D>(N + i / (D / 4), (i % (D / 4)) * 4);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + at) = zero;
    *reinterpret_cast<float4*>(ks + at) = zero;
    *reinterpret_cast<float4*>(vs + at) = zero;
    *reinterpret_cast<float4*>(gs + at) = zero;
  }

  for (int b = b_begin; b < b_end; ++b) {
    const bool first = b == b_begin;
    const size_t base = (static_cast<size_t>(b) * H + h) * N * D;
    __syncthreads();  // the previous window is done with shared memory
    stage_rows<D>(qs, q + base, N);
    stage_rows<D>(ks, k + base, N);
    stage_rows<D>(vs, v + base, N);
    stage_rows<D>(gs, dout + base, N);
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
      load_a_split<D, kExact>(qa, qs, i0, g, t);
      load_a_split<D, kExact>(ga, gs, i0, g, t);
      const int rows[2] = {i0 + g, i0 + g + 8};

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
        product_nt<D, kExact>(s, qa, ks, j0, g, t);
        product_nt<D, kExact>(dp, ga, vs, j0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = logit<MODE>(s[e], term[e], rows[e >> 1], j0 + 2 * t + (e & 1), N, scale, ids);
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
        product_nt<D, kExact>(s, qa, ks, j0, g, t);
        product_nt<D, kExact>(dp, ga, vs, j0, g, t);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = j0 + 2 * t + (e & 1);
          const float p = __expf(logit<MODE>(s[e], term[e], rows[r], key, N, scale, ids) - m[r]) * inv[r];
          ds[e] = p * (dp[e] - dlt[r]);
          // (row, key) has one owner thread; 0 + ds = ds for the first window
          if (rows[r] < N && key < N) part[static_cast<size_t>(rows[r]) * N + key] = old[e] + ds[e];
        }
        product_cn<D, kExact>(acc, ds, ks, j0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          term[e] = next[e];
          old[e] = old_next[e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        T* out = dq + base + static_cast<size_t>(rows[r]) * D + 2 * t;
#pragma unroll
        for (int nn = 0; nn < KD; ++nn)
          store2<T>(out + 8 * nn, acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale);
      }
    }
    __syncthreads();  // row statistics visible to every warp

    // Column pass: warp per 16-key tile; lane (g, t) holds keys j0 + g and
    // j0 + g + 8 (e = 0, 1 and e = 2, 3) at rows i0 + 2t and i0 + 2t + 1.
    for (int tile = warp; tile < tiles; tile += warps) {
      const int j0 = 16 * tile;
      FragA ka[KD], va[KD];
      load_a_split<D, kExact>(ka, ks, j0, g, t);
      load_a_split<D, kExact>(va, vs, j0, g, t);
      const int keys[2] = {j0 + g, j0 + g + 8};
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
        product_nt<D, kExact>(s, ka, qs, i0, g, t);
        product_nt<D, kExact>(dp, va, gs, i0, g, t);
        const int r0 = i0 + 2 * t;
        const float2 mx = *reinterpret_cast<const float2*>(row_max + r0);
        const float2 iv = *reinterpret_cast<const float2*>(row_inv + r0);
        const float2 dl = *reinterpret_cast<const float2*>(row_dlt + r0);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e & 1);
          const float sc = logit<MODE>(s[e], term[e], row, keys[e >> 1], N, scale, ids);
          // a padded key has p = 0 already; a padded row is zeroed here
          p[e] = row < N ? __expf(sc - ((e & 1) ? mx.y : mx.x)) * ((e & 1) ? iv.y : iv.x) : 0.f;
          ds[e] = p[e] * (dp[e] - ((e & 1) ? dl.y : dl.x));
        }
        product_cn<D, kExact>(dva, p, gs, i0, g, t);
        product_cn<D, kExact>(dka, ds, qs, i0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) term[e] = next[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (keys[r] >= N) continue;
        const size_t row = base + static_cast<size_t>(keys[r]) * D + 2 * t;
#pragma unroll
        for (int nn = 0; nn < KD; ++nn) {
          store2<T>(dk + row + 8 * nn, dka[nn][2 * r] * scale, dka[nn][2 * r + 1] * scale);
          store2<T>(dv + row + 8 * nn, dva[nn][2 * r], dva[nn][2 * r + 1]);
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

// The pointers and sizes of one backward call.
struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *region_ids, *mask;
  void *dq, *dk, *dv;
  float *dbias_part, *dbias;
  int B, H, N, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

// Warps per CTA: a warp owns a 16-row (then a 16-key) tile, so a CTA has as
// few warps as the fewest rounds over the Np / 16 tiles allow, at most the
// launch bounds at head dim D.
int cta_warps(int N, int D) { return tile_warps(N, max_warps(D)); }

// operands [Np, D] x 4, then row max, 1 / row sum, rowsum(P o dP), ids [Np] each
size_t smem_bytes(int N, int D) {
  return 4 * static_cast<size_t>((N + 15) / 16 * 16) * (D + 1) * sizeof(float);
}

template <typename T, int D, int MODE>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(window_attention_bwd_kernel<T, D, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// CTAs that fit one SM, from the compiled kernel's registers and the
// window's shared memory; 0 when the shared memory exceeds a CTA's limit.
template <typename T, int D, int MODE>
cudaError_t occupancy(int N, int* ctas) {
  const size_t smem = smem_bytes(N, D);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) {
    *ctas = 0;
    return cudaSuccess;
  }
  err = prepare<T, D, MODE>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, window_attention_bwd_kernel<T, D, MODE>,
                                                       cta_warps(N, D) * 32, smem);
}

template <typename T, int D>
cudaError_t occupancy_mode(int N, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, D, kRegion>(N, ctas);
  if (has_mask) return occupancy<T, D, kMask>(N, ctas);
  return occupancy<T, D, kNone>(N, ctas);
}

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.N, D);
  auto kernel = window_attention_bwd_kernel<T, D, MODE>;
  cudaError_t err = prepare<T, D, MODE>(smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  kernel<<<dim3(groups, a.H), cta_warps(a.N, D) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.bias, a.region_ids, a.mask, static_cast<T*>(a.dq),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dbias_part, a.B, a.H, a.N, a.nW,
      a.windows_per_cta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t hnn = static_cast<size_t>(a.H) * a.N * a.N;
  const int threads = 256;
  size_t blocks = (hnn + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  dbias_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, a.stream>>>(a.dbias_part,
                                                                               a.dbias, groups, hnn);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, D, kRegion>(a);
  if (a.mask != nullptr) return launch<T, D, kMask>(a);
  return launch<T, D, kNone>(a);
}

template <int D>
cudaError_t launch_type(const Args& a, int is_bf16) {
  return is_bf16 ? launch_mode<__nv_bfloat16, D>(a) : launch_mode<float, D>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when both launches were accepted. `region_ids`
// set selects REGION, else `mask` set selects MASK, else NONE; `is_bf16`
// the input type. The scratch `dbias_part` holds ceil(B / windows_per_cta)
// * H * N * N floats. The head dim D must be 16 (SwinUNETR fs48) or 32
// (Swin-UNet 2D, embed 96). The CTA's width and shared memory are those
// icl_window_attention_bwd_geometry reports.
int icl_window_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* bias, const void* region_ids, const void* mask, void* dq,
                             void* dk, void* dv, void* dbias_part, void* dbias, int B, int H, int N,
                             int D, int nW, int windows_per_cta, float scale, int is_bf16, void* stream) {
  if (windows_per_cta < 1 || N < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(bias), static_cast<const float*>(region_ids),
               static_cast<const float*>(mask), dq, dk, dv,
               static_cast<float*>(dbias_part), static_cast<float*>(dbias),
               B, H, N, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  if (D == 16) return launch_type<16>(a, is_bf16);
  if (D == 32) return launch_type<32>(a, is_bf16);
  return cudaErrorInvalidValue;
}

// The launch geometry at windows of N tokens and head dim D, in the mode
// that `has_ids` (REGION), else `has_mask` (MASK), else neither (NONE)
// selects: the warps of a CTA, its shared memory in bytes, and how many
// such CTAs one SM of the current device holds, 0 when the window does not
// fit. Returns a cudaError_t.
int icl_window_attention_bwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                      int* smem, int* ctas) {
  if (N < 1 || (D != 16 && D != 32)) return cudaErrorInvalidValue;
  *warps = cta_warps(N, D);
  *smem = static_cast<int>(smem_bytes(N, D));
  if (D == 16)
    return is_bf16 ? occupancy_mode<__nv_bfloat16, 16>(N, has_ids, has_mask, ctas)
                   : occupancy_mode<float, 16>(N, has_ids, has_mask, ctas);
  return is_bf16 ? occupancy_mode<__nv_bfloat16, 32>(N, has_ids, has_mask, ctas)
                 : occupancy_mode<float, 32>(N, has_ids, has_mask, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
