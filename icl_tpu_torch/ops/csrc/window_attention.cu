// Fused window attention forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of icl_tpu/ops/pallas/window_attention.py:
//   _kernel         (:44)  out = softmax(q.k^T * scale + bias[h]) . v
//   _kernel_region  (:60)  the same plus M, where M = -100 if the shift-region
//                          id of the key differs from the query's, else 0.
//                          M is built here from the ids [nW, N]; the dense
//                          [nW, N, N] mask never exists in device memory.
// One template, MODE = NONE or REGION, input type float or bf16, f32
// accumulation, output in the input type.
//
// Layout (the same as window_attention_fused): q, k, v, out [B, H, N, D]
// contiguous with B = batch * nW; bias [H, N, N] f32; region ids [nW, N]
// f32; window index = b % nW.
//
// Design (simple and right first): one CTA per (window, head). K and V of
// the window are converted to f32 into shared memory with a padded row
// stride (D + 1) so that lane j reading row j hits distinct banks. Each
// warp takes query rows; each lane takes keys j = lane, lane + 32, ... and
// keeps an online softmax (running max, sum and D-wide P.V accumulator);
// the 32 lanes are merged with xor shuffles. The ragged edge (N = 343 and
// 216 are not multiples of 32) is handled by the key and row loop bounds.
// The bias row bias[h, n, :] is read from global memory, coalesced across
// lanes; it is H * N * N * 4 bytes and stays resident in L2.
//
// What bounds it: at the SwinUNETR shapes (D = 16, N = 343) it does
// 4 * N * D flops per (row, head) against 4 * D * 4 bytes of q, k, v, out,
// about 86 flops per byte in f32, above the card's f32 ridge, so the bound
// is the f32 rate. This version runs both products on CUDA cores from
// shared memory, not on the tensor cores; wgmma with TMA-fed tiles and bias
// tiles shared across the windows of a head are later work.

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

template <typename T, int D, bool REGION>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ region_ids, T* __restrict__ out,
                        int H, int N, int nW, float scale) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;
  float* ks = smem;            // [N, D + 1]
  float* vs = ks + N * KS;     // [N, D + 1]
  float* ids = vs + N * KS;    // [N], REGION only

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t base = static_cast<size_t>(bh) * N * D;

  for (int i = threadIdx.x; i < N * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    ks[r * KS + c] = to_float(k[base + i]);
    vs[r * KS + c] = to_float(v[base + i]);
  }
  if (REGION) {
    const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
    for (int i = threadIdx.x; i < N; i += kThreads) ids[i] = w_ids[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;

  for (int n = warp; n < N; n += kWarps) {
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_float(q[base + static_cast<size_t>(n) * D + d]);
    const float id_n = REGION ? ids[n] : 0.f;
    const float* brow = bias_h + static_cast<size_t>(n) * N;

    float m = -INFINITY;
    float l = 0.f;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;

    for (int j = lane; j < N; j += 32) {
      const float* kj = ks + j * KS;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kj[d], s);
      s = s * scale + brow[j];
      if (REGION && ids[j] != id_n) s += -100.f;
      const float m_new = fmaxf(m, s);
      const float corr = __expf(m - m_new);  // 0 on the first key (m = -inf)
      const float p = __expf(s - m_new);
      l = fmaf(l, corr, p);
      const float* vj = vs + j * KS;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vj[d], acc[d] * corr);
      m = m_new;
    }

    // Merge the lanes' partial softmaxes. A lane that saw no key (N < 32)
    // holds m = -inf, l = 0, acc = 0 and gets weight 0.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m_o = __shfl_xor_sync(kFullMask, m, off);
      const float l_o = __shfl_xor_sync(kFullMask, l, off);
      const float m_new = fmaxf(m, m_o);
      const float c_s = (m == -INFINITY) ? 0.f : __expf(m - m_new);
      const float c_o = (m_o == -INFINITY) ? 0.f : __expf(m_o - m_new);
      l = l * c_s + l_o * c_o;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float a_o = __shfl_xor_sync(kFullMask, acc[d], off);
        acc[d] = acc[d] * c_s + a_o * c_o;
      }
      m = m_new;
    }

    // Every lane now holds the merged row; lane d writes column d.
    float o = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) o = (lane == d) ? acc[d] : o;
    if (lane < D) out[base + static_cast<size_t>(n) * D + lane] = from_float<T>(o / l);
  }
}

template <typename T, int D, bool REGION>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* region_ids, void* out, int B, int H, int N, int nW,
                   float scale, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(N) * (D + 1) + (REGION ? N : 0)) * sizeof(float);
  auto kernel = window_attention_kernel<T, D, REGION>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(B) * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      region_ids, static_cast<T*>(out), H, N, nW, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mode(const void* q, const void* k, const void* v, const float* bias,
                        const float* region_ids, void* out, int B, int H, int N, int nW,
                        float scale, cudaStream_t stream) {
  if (region_ids != nullptr)
    return launch<T, D, true>(q, k, v, bias, region_ids, out, B, H, N, nW, scale, stream);
  return launch<T, D, false>(q, k, v, bias, nullptr, out, B, H, N, nW, scale, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `region_ids` null
// selects the no-mask variant. `is_bf16` selects the input type. The head
// dim D must be 16 (SwinUNETR fs48: 48/3 = 96/6 = 192/12 = 384/24).
int icl_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* region_ids, void* out, int B, int H, int N, int D,
                             int nW, float scale, int is_bf16, void* stream) {
  if (D != 16) return cudaErrorInvalidValue;
  const float* bias_f = static_cast<const float*>(bias);
  const float* ids_f = static_cast<const float*>(region_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mode<__nv_bfloat16, 16>(q, k, v, bias_f, ids_f, out, B, H, N, nW, scale, s);
  return launch_mode<float, 16>(q, k, v, bias_f, ids_f, out, B, H, N, nW, scale, s);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
