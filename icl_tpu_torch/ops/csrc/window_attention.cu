// Fused window attention forward for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of icl_tpu/ops/pallas/window_attention.py:
//   _kernel         (:44)  out = softmax(q.k^T * scale + bias[h]) . v
//   _kernel_masked  (:28)  the same plus mask[b % nW], any dense additive
//                          mask [nW, N, N] (Swin-UNet 2D's shift mask)
//   _kernel_region  (:60)  the same plus M, where M = -100 if the shift-region
//                          id of the key differs from the query's, else 0.
//                          M is built here from the ids [nW, N]; the dense
//                          [nW, N, N] mask never exists in device memory.
// One template, MODE = NONE, REGION or MASK, head dim D = 16 or 32, input
// type float or bf16, f32 accumulation, output in the input type.
//
// Layout (the same as window_attention_fused): q, k, v, out [B, H, N, D]
// contiguous with B = batch * nW; bias [H, N, N] f32; region ids [nW, N]
// f32; mask [nW, N, N] f32; window index = b % nW.
//
// Design (simple and right first): one CTA per (window, head). K and V of
// the window are converted to f32 into shared memory with a padded row
// stride (D + 1) so that lane j reading row j hits distinct banks. Each
// warp takes query rows; each lane takes keys j = lane, lane + 32, ... and
// keeps an online softmax (running max, sum and D-wide P.V accumulator);
// the 32 lanes are merged with xor shuffles. The ragged edge (N = 343 and
// 216 are not multiples of 32) is handled by the key and row loop bounds.
// The bias row bias[h, n, :] is read from global memory, coalesced across
// lanes; it is H * N * N * 4 bytes and stays resident in L2. In MASK mode
// the mask row mask[b % nW, n, :] is read the same way beside it (nW * N *
// N * 4 bytes, shared by the batch's windows at one position and by every
// head, so it too is read from L2 after the first touch). Lane d writes
// column d of the output row, which needs D <= 32.
//
// What bounds it: at the SwinUNETR shapes (D = 16, N = 343) it does
// 4 * N * D flops per (row, head) against 4 * D * 4 bytes of q, k, v, out,
// about 86 flops per byte in f32 (36 at the Swin-UNet 2D shapes, D = 32,
// N = 144), above the card's f32 ridge of 20, so the bound is the f32
// rate. This version runs both products on CUDA cores from shared memory,
// not on the tensor cores; wgmma with TMA-fed tiles and bias and mask
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

// mask modes
constexpr int kNone = 0;
constexpr int kRegion = 1;
constexpr int kMask = 2;

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ region_ids, const float* __restrict__ mask,
                        T* __restrict__ out, int H, int N, int nW, float scale) {
  static_assert(D <= 32, "lane d writes output column d");
  extern __shared__ float smem[];
  constexpr int KS = D + 1;
  float* ks = smem;            // [N, D + 1]
  float* vs = ks + N * KS;     // [N, D + 1]
  float* ids = vs + N * KS;    // [N], kRegion only

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
  if (MODE == kRegion) {
    const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
    for (int i = threadIdx.x; i < N; i += kThreads) ids[i] = w_ids[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(b % nW) * N * N : nullptr;

  for (int n = warp; n < N; n += kWarps) {
    float qr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = to_float(q[base + static_cast<size_t>(n) * D + d]);
    const float id_n = MODE == kRegion ? ids[n] : 0.f;
    const float* brow = bias_h + static_cast<size_t>(n) * N;
    const float* mrow = MODE == kMask ? mask_w + static_cast<size_t>(n) * N : nullptr;

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
      if (MODE == kRegion && ids[j] != id_n) s += -100.f;
      if (MODE == kMask) s += mrow[j];
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

template <typename T, int D, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* region_ids, const float* mask, void* out, int B, int H, int N,
                   int nW, float scale, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(N) * (D + 1) + (MODE == kRegion ? N : 0)) * sizeof(float);
  auto kernel = window_attention_kernel<T, D, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(B) * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      region_ids, mask, static_cast<T*>(out), H, N, nW, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mode(const void* q, const void* k, const void* v, const float* bias,
                        const float* region_ids, const float* mask, void* out, int B, int H,
                        int N, int nW, float scale, cudaStream_t stream) {
  if (region_ids != nullptr)
    return launch<T, D, kRegion>(q, k, v, bias, region_ids, nullptr, out, B, H, N, nW, scale,
                                 stream);
  if (mask != nullptr)
    return launch<T, D, kMask>(q, k, v, bias, nullptr, mask, out, B, H, N, nW, scale, stream);
  return launch<T, D, kNone>(q, k, v, bias, nullptr, nullptr, out, B, H, N, nW, scale, stream);
}

template <int D>
cudaError_t launch_type(const void* q, const void* k, const void* v, const float* bias,
                        const float* region_ids, const float* mask, void* out, int B, int H,
                        int N, int nW, float scale, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_mode<__nv_bfloat16, D>(q, k, v, bias, region_ids, mask, out, B, H, N, nW, scale,
                                         stream);
  return launch_mode<float, D>(q, k, v, bias, region_ids, mask, out, B, H, N, nW, scale, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `region_ids` set
// selects REGION, else `mask` set selects MASK, else NONE (at most one of
// the two is set). `is_bf16` selects the input type. The head dim D must
// be 16 (SwinUNETR fs48: 48/3 = 96/6 = 192/12 = 384/24) or 32 (Swin-UNet
// 2D, embed 96: 96/3 = 192/6 = 384/12 = 768/24).
int icl_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* region_ids, const void* mask, void* out, int B, int H,
                             int N, int D, int nW, float scale, int is_bf16, void* stream) {
  const float* bias_f = static_cast<const float*>(bias);
  const float* ids_f = static_cast<const float*>(region_ids);
  const float* mask_f = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16)
    return launch_type<16>(q, k, v, bias_f, ids_f, mask_f, out, B, H, N, nW, scale, is_bf16, s);
  if (D == 32)
    return launch_type<32>(q, k, v, bias_f, ids_f, mask_f, out, B, H, N, nW, scale, is_bf16, s);
  return cudaErrorInvalidValue;
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
