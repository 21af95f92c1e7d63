// Fused window attention backward for Hopper (sm_90a).
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
// Layout: q, k, v, dO, dq, dk, dv [B, H, N, D] contiguous; bias [H, N, N]
// and its transpose bias_t [H, N, N] (bias_t[h, m, n] = bias[h, n, m], so
// that the key-major pass reads it coalesced); region ids [nW, N] f32;
// mask [nW, N, N] f32 and its transpose mask_t (mask_t[w, m, n] =
// mask[w, n, m]), for the same reason.
//
// Design (simple and right first, CUDA cores, f32):
//   * One CTA per (group of windows, head). It walks its windows in order;
//     q, k, v and dO of one window sit in shared memory as f32 with a
//     padded row stride (D + 1), about 99 KB at N = 343, D = 16, and
//     78 KB at N = 144, D = 32.
//   * Row pass, one warp per query row n, lanes over keys: a first sweep
//     gives the row max, 1 / row sum and rowsum(P o dP) (an online
//     softmax merged over the warp with xor shuffles; kept in shared
//     memory), a second sweep recomputes P, forms dS, sums dQ_n over the
//     keys and adds dS[n, :] into the CTA's dbias partial.
//   * Column pass, one warp per key m, lanes over rows: recomputes P and
//     dS from the row statistics and sums dK_m and dV_m over the rows.
//   Every sum has one owner and a fixed order: no atomics, so two runs on
//   the same inputs give bitwise-equal outputs.
//   * dbias: each CTA owns the slice [group, h] of a scratch buffer
//     [G, H, N, N] (allocated by the caller); the first window of the
//     group writes it, the others add to it. A second kernel sums the G
//     partials in order g = 0 .. G-1.
//   * Ragged N (343, 216): loop bounds on rows and keys, as the forward.
//
// What bounds it: the least work is five N x N x D products per (window,
// head), 10 * B * H * N^2 * D flops, about 23 flops per byte of q, k, v,
// dO, dq, dk, dv in f32 at N = 343 -- above the card's f32 ridge, so the
// f32 rate bounds it. This version recomputes the scores three times and
// reads its operands from shared memory one float at a time, so it issues
// about 144 FMAs and 96 shared loads per (row, key) pair; the dbias
// partials add a read and a write of N^2 floats per (window, head).
// Keeping the forward's log-sum-exp, wgmma with TMA-fed tiles, and
// wider shared loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum of a D-wide per-lane vector over the warp; every lane gets the total.
template <int D>
__device__ __forceinline__ void warp_sum(float (&acc)[D]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] += __shfl_xor_sync(kFullMask, acc[d], off);
  }
}

// mask modes
constexpr int kNone = 0;
constexpr int kRegion = 1;
constexpr int kMask = 2;

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ bias, const float* __restrict__ bias_t,
                            const float* __restrict__ region_ids, const float* __restrict__ mask,
                            const float* __restrict__ mask_t, T* __restrict__ dq,
                            T* __restrict__ dk, T* __restrict__ dv,
                            float* __restrict__ dbias_part, int B, int H, int N, int nW,
                            int windows_per_cta, float scale) {
  static_assert(D <= 32, "lane d writes dq column d");
  extern __shared__ float smem[];
  constexpr int S = D + 1;
  float* qs = smem;             // [N, D + 1]
  float* ks = qs + N * S;       // [N, D + 1]
  float* vs = ks + N * S;       // [N, D + 1]
  float* gs = vs + N * S;       // [N, D + 1], dO
  float* row_max = gs + N * S;  // [N]
  float* row_inv = row_max + N;  // [N], 1 / row sum
  float* row_dlt = row_inv + N;  // [N], rowsum(P o dP)
  float* ids = row_dlt + N;     // [N], kRegion only

  const int group = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const float* bias_t_h = bias_t + static_cast<size_t>(h) * N * N;
  float* part = dbias_part + (static_cast<size_t>(group) * H + h) * N * N;
  const int b_begin = group * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);

  for (int b = b_begin; b < b_end; ++b) {
    const bool first = b == b_begin;
    const size_t base = (static_cast<size_t>(b) * H + h) * N * D;
    __syncthreads();  // the previous window is done with shared memory
    for (int i = threadIdx.x; i < N * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      qs[r * S + c] = to_float(q[base + i]);
      ks[r * S + c] = to_float(k[base + i]);
      vs[r * S + c] = to_float(v[base + i]);
      gs[r * S + c] = to_float(dout[base + i]);
    }
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(b % nW) * N * N : nullptr;
    const float* mask_t_w = MODE == kMask ? mask_t + static_cast<size_t>(b % nW) * N * N : nullptr;
    if (MODE == kRegion) {
      const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
      for (int i = threadIdx.x; i < N; i += kThreads) ids[i] = w_ids[i];
    }
    __syncthreads();

    // Row pass: warp per query row n, lanes over keys j.
    for (int n = warp; n < N; n += kWarps) {
      float qr[D], gr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = qs[n * S + d];
        gr[d] = gs[n * S + d];
      }
      const float id_n = MODE == kRegion ? ids[n] : 0.f;
      const float* brow = bias_h + static_cast<size_t>(n) * N;
      const float* mrow = MODE == kMask ? mask_w + static_cast<size_t>(n) * N : nullptr;

      // Sweep 1: row max m, row sum l and t = sum_j e^(s_j - m) dp_j.
      float m = -INFINITY;
      float l = 0.f;
      float t = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float* kj = ks + j * S;
        const float* vj = vs + j * S;
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kj[d], s);
          dp = fmaf(gr[d], vj[d], dp);
        }
        s = s * scale + brow[j];
        if (MODE == kRegion && ids[j] != id_n) s += -100.f;
        if (MODE == kMask) s += mrow[j];
        const float m_new = fmaxf(m, s);
        const float corr = __expf(m - m_new);  // 0 on the first key (m = -inf)
        const float p = __expf(s - m_new);
        l = fmaf(l, corr, p);
        t = fmaf(t, corr, p * dp);
        m = m_new;
      }
      // Merge the lanes; a lane that saw no key (N < 32) has weight 0.
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m_o = __shfl_xor_sync(kFullMask, m, off);
        const float l_o = __shfl_xor_sync(kFullMask, l, off);
        const float t_o = __shfl_xor_sync(kFullMask, t, off);
        const float m_new = fmaxf(m, m_o);
        const float c_s = (m == -INFINITY) ? 0.f : __expf(m - m_new);
        const float c_o = (m_o == -INFINITY) ? 0.f : __expf(m_o - m_new);
        l = l * c_s + l_o * c_o;
        t = t * c_s + t_o * c_o;
        m = m_new;
      }
      const float inv_l = 1.f / l;
      const float delta = t * inv_l;
      if (lane == 0) {
        row_max[n] = m;
        row_inv[n] = inv_l;
        row_dlt[n] = delta;
      }

      // Sweep 2: dS[n, j], dQ_n and the dbias partial.
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      float* prow = part + static_cast<size_t>(n) * N;
      for (int j = lane; j < N; j += 32) {
        const float* kj = ks + j * S;
        const float* vj = vs + j * S;
        float kr[D];
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          kr[d] = kj[d];
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(gr[d], vj[d], dp);
        }
        s = s * scale + brow[j];
        if (MODE == kRegion && ids[j] != id_n) s += -100.f;
        if (MODE == kMask) s += mrow[j];
        const float p = __expf(s - m) * inv_l;
        const float ds = p * (dp - delta);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
        prow[j] = first ? ds : prow[j] + ds;  // (n, j) has one owner thread
      }
      warp_sum<D>(acc);
      float o = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) o = (lane == d) ? acc[d] : o;
      if (lane < D) dq[base + static_cast<size_t>(n) * D + lane] = from_float<T>(o * scale);
    }
    __syncthreads();  // row statistics visible to every warp

    // Column pass: warp per key m, lanes over query rows i.
    for (int mk = warp; mk < N; mk += kWarps) {
      float kr[D], vr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        kr[d] = ks[mk * S + d];
        vr[d] = vs[mk * S + d];
      }
      const float id_m = MODE == kRegion ? ids[mk] : 0.f;
      const float* bcol = bias_t_h + static_cast<size_t>(mk) * N;  // bias[h, :, mk]
      const float* mcol = MODE == kMask ? mask_t_w + static_cast<size_t>(mk) * N : nullptr;
      float dk_acc[D], dv_acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk_acc[d] = 0.f;
        dv_acc[d] = 0.f;
      }
      for (int i = lane; i < N; i += 32) {
        const float* qi = qs + i * S;
        const float* gi = gs + i * S;
        float qv[D], gv[D];
        float s = 0.f;
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          qv[d] = qi[d];
          gv[d] = gi[d];
          s = fmaf(qv[d], kr[d], s);
          dp = fmaf(gv[d], vr[d], dp);
        }
        s = s * scale + bcol[i];
        if (MODE == kRegion && ids[i] != id_m) s += -100.f;
        if (MODE == kMask) s += mcol[i];
        const float p = __expf(s - row_max[i]) * row_inv[i];
        const float ds = p * (dp - row_dlt[i]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv_acc[d] = fmaf(p, gv[d], dv_acc[d]);
          dk_acc[d] = fmaf(ds, qv[d], dk_acc[d]);
        }
      }
      warp_sum<D>(dk_acc);
      warp_sum<D>(dv_acc);
      // column c = lane + 32 r of [dK_m, dV_m]: c < D is dK, the rest dV
      const size_t row = base + static_cast<size_t>(mk) * D;
#pragma unroll
      for (int r = 0; r < (2 * D + 31) / 32; ++r) {
        const int c = lane + 32 * r;
        float o = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          o = (c == d) ? dk_acc[d] * scale : o;
          o = (c == D + d) ? dv_acc[d] : o;
        }
        if (c < D) dk[row + c] = from_float<T>(o);
        else if (c < 2 * D) dv[row + c - D] = from_float<T>(o);
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
  const float *bias, *bias_t, *region_ids, *mask, *mask_t;
  void *dq, *dk, *dv;
  float *dbias_part, *dbias;
  int B, H, N, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a) {
  const size_t smem =
      (4 * static_cast<size_t>(a.N) * (D + 1) + 3 * a.N + (MODE == kRegion ? a.N : 0)) *
      sizeof(float);
  auto kernel = window_attention_bwd_kernel<T, D, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  kernel<<<dim3(groups, a.H), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.bias, a.bias_t, a.region_ids, a.mask, a.mask_t,
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dbias_part, a.B,
      a.H, a.N, a.nW, a.windows_per_cta, a.scale);
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
// set selects REGION, else `mask` set (with `mask_t`) selects MASK, else
// NONE; `is_bf16` the input type. The scratch `dbias_part` holds
// ceil(B / windows_per_cta) * H * N * N floats. The head dim D must be 16
// (SwinUNETR fs48) or 32 (Swin-UNet 2D, embed 96).
int icl_window_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* bias, const void* bias_t, const void* region_ids,
                             const void* mask, const void* mask_t, void* dq, void* dk, void* dv,
                             void* dbias_part, void* dbias, int B, int H, int N, int D, int nW,
                             int windows_per_cta, float scale, int is_bf16, void* stream) {
  if (windows_per_cta < 1 || (mask != nullptr && mask_t == nullptr)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(bias), static_cast<const float*>(bias_t),
               static_cast<const float*>(region_ids), static_cast<const float*>(mask),
               static_cast<const float*>(mask_t), dq, dk, dv,
               static_cast<float*>(dbias_part), static_cast<float*>(dbias),
               B, H, N, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  if (D == 16) return launch_type<16>(a, is_bf16);
  if (D == 32) return launch_type<32>(a, is_bf16);
  return cudaErrorInvalidValue;
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
