// Fused window attention forward for Hopper (sm_90a) at every head dim and
// window, streaming the head dim's 64-column chunks: the forward where
// window_attention.cu and window_attention_wide.cu refuse (f32 above head
// dim 128, bf16 above 640; any window whose tiles do not fit a CTA).
//
// Replaces the same three Pallas TPU kernels of
// icl_tpu/ops/pallas/window_attention.py as window_attention.cu (_kernel
// :44, _kernel_masked :28, _kernel_region :60), which take any head dim:
// out = softmax(q.k^T * scale + bias[h] (+ mask)) . v per (window, head),
// f32 math, output in the input type, and the row log-sum-exp where asked
// (the backward's), in NONE, REGION or MASK. Layout as window_attention.cu's:
// q, k, v, out [B, H, N, d], bias [H, N, N], region ids [nW, N] or a dense
// mask [nW, N, N], the window of b being b % nW.
//
// What bounds it: the function's 4 B H N^2 d flops at the card's
// f32-accurate rate (3xTF32 on mma.sync, 165 TFLOP/s) or bf16's. This
// first design is simple and right first: it forms S once a pair of output
// chunks (C / 2 times where the function needs once), re-reads Q from L2
// every key step, and runs mma.sync with one copy in flight; how far it is
// from the bound is in PERF.md.
//
// Design (stream_tiles.cuh):
//   * A CTA of 4 warps per (block of 64 rows, pair of output chunks p,
//     head, group of windows); warp w owns 16 rows. Over each window, in
//     steps of 32 keys: S = sum over the C chunks of Q_c.K_c^T, the pair
//     (Q_c [64][64], K_c [32][64]) of each chunk staged in turn through a
//     ring of two buffers; then the logits (bias and mask from device
//     memory, padded keys at -inf), the online softmax, and P.V into the
//     accumulators of output chunks 2p and 2p + 1 alone, V of those chunks
//     staged as the step's last tile. Neither shared memory (48 KB) nor a
//     thread's registers grow with C or N, so every d >= 1 and every N run.
//   * The accumulators hold 16 rows x 128 columns a warp; P.V of each
//     8-key tile is summed from zero and added in f32 (product_cn).
//   * Only pair 0's CTAs store the log-sum-exp. No atomics: bitwise
//     repeatable.
// The kernel reports its warps and shared memory through
// icl_window_attention_stream_fwd_geometry with its resident CTAs an SM.

#include <math.h>

#include <type_traits>

#include "stream_tiles.cuh"

namespace {

constexpr int kKeys = 32;  // keys a step
// a buffer of the ring: Q_c [64][64] and K_c [32][64]; or V of the pair [32][64] x 2
constexpr int kFwdBuffer = kStreamTile + kKeys * kStreamChunk;
constexpr size_t kFwdSmemBytes = 2 * kFwdBuffer * sizeof(float);

template <typename T, int MODE, bool LSE>
__global__ void __launch_bounds__(kStreamThreads)
window_attention_stream_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                   const float* __restrict__ bias, const float* __restrict__ region_ids,
                                   const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                                   int B, int H, int N, int d, int nW, int windows_per_cta, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const int C = head_dim_chunks(d);
  const int blocks = (N + kStreamBlock - 1) / kStreamBlock;
  const int rb = blockIdx.x % blocks, pair = blockIdx.x / blocks;
  const int h = blockIdx.y;
  const int b0 = blockIdx.z * windows_per_cta;
  const int b1 = min(B, b0 + windows_per_cta);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int nkb = (N + kKeys - 1) / kKeys;
  const int per_window = nkb * (C + 1);  // C tiles of (Q_c, K_c), then V of the pair, a step
  const bool second = kStreamPair * pair + 1 < C;
  const bool vq = chunked(q, d), vk = chunked(k, d), vv = chunked(v, d);
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const int rows[2] = {rb * kStreamBlock + 16 * warp + g, rb * kStreamBlock + 16 * warp + g + 8};

  float s[4][4];
  float o[kStreamPair][8][4];
  float m[2], l[2];
  auto reset = [&]() {
#pragma unroll
    for (int j = 0; j < kStreamPair; ++j)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][nn][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  };
  reset();

  auto issue = [&](int st, float* buf) {
    const int wi = st / per_window, rem = st - wi * per_window;
    const int kb = rem / (C + 1), part = rem - kb * (C + 1);
    const size_t base = (static_cast<size_t>(b0 + wi) * H + h) * N * d;
    if (part < C) {
      stage_chunk<kStreamBlock>(buf, q + base, rb * kStreamBlock, N, d, part, vq);
      stage_chunk<kKeys>(buf + kStreamTile, k + base, kb * kKeys, N, d, part, vk);
    } else {
      stage_chunk<kKeys>(buf, v + base, kb * kKeys, N, d, kStreamPair * pair, vv);
      if (second)
        stage_chunk<kKeys>(buf + kKeys * kStreamChunk, v + base, kb * kKeys, N, d, kStreamPair * pair + 1, vv);
    }
  };

  auto compute = [&](int st, const float* buf) {
    const int wi = st / per_window, rem = st - wi * per_window;
    const int kb = rem / (C + 1), part = rem - kb * (C + 1);
    if (part == 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    if (part < C) {
      product_nt_tile<4, kExact>(s, buf, 16 * warp, buf + kStreamTile, g, t);
      return;
    }
    const int b = b0 + wi, w = b % nW;
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(w) * N * N : nullptr;
    const float* ids_w = MODE == kRegion ? region_ids + static_cast<size_t>(w) * N : nullptr;
    // the logits of the step, padded keys at -inf; rows past N (zero q) keep x scale
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1], key = kb * kKeys + 8 * n + 2 * t + (e & 1);
        s[n][e] = key >= N ? -INFINITY
                           : row < N ? stream_logit<MODE>(s[n][e], scale, bias_h, mask_w, ids_w, N, row, key)
                                     : s[n][e] * scale;
      }
    // the online softmax: each row's running max over the quad's keys
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < kStreamPair; ++j)
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          o[j][nn][2 * r] *= alpha;
          o[j][nn][2 * r + 1] *= alpha;
        }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    // P.V into the pair's accumulators
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      product_cn<64, kExact>(o[0], s[n], buf, 8 * n, g, t);
      if (second) product_cn<64, kExact>(o[1], s[n], buf + kKeys * kStreamChunk, 8 * n, g, t);
    }
    if (kb + 1 < nkb) return;
    // the window's last step: the rows' sums over the quad, the output, the log-sum-exp
    const size_t base = (static_cast<size_t>(b) * H + h) * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
      l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
      if (rows[r] >= N) continue;
      const float inv = 1.f / l[r];
      T* row_out = out + (base + rows[r]) * d;
#pragma unroll
      for (int j = 0; j < kStreamPair; ++j) {
        const int c0 = (kStreamPair * pair + j) * kStreamChunk;
        if (j == 1 && !second) break;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          store_cols<T>(row_out, c0 + 8 * nn + 2 * t, d, o[j][nn][2 * r] * inv, o[j][nn][2 * r + 1] * inv);
      }
      if (LSE && pair == 0 && t == 0) lse[base + rows[r]] = m[r] + logf(l[r]);
    }
    reset();
  };

  if (b0 < B) stream_ring(smem, kFwdBuffer, (b1 - b0) * per_window, issue, compute);
}

template <typename T, int MODE, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, const float* ids,
                   const float* mask, void* out, float* lse, int B, int H, int N, int d, int nW,
                   int windows_per_cta, float scale, cudaStream_t stream) {
  auto kernel = window_attention_stream_fwd_kernel<T, MODE, LSE>;
  cudaError_t err = stream_fit(kernel, kFwdSmemBytes, nullptr);
  if (err != cudaSuccess) return err;
  const int groups = (B + windows_per_cta - 1) / windows_per_cta;
  const int blocks = (N + kStreamBlock - 1) / kStreamBlock;
  kernel<<<dim3(blocks * stream_pairs(head_dim_chunks(d)), H, groups), kStreamThreads, kFwdSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, ids, mask,
      static_cast<T*>(out), lse, B, H, N, d, nW, windows_per_cta, scale);
  return cudaGetLastError();
}

template <typename T, bool LSE>
cudaError_t launch_mode(const void* q, const void* k, const void* v, const float* bias, const float* ids,
                        const float* mask, void* out, float* lse, int B, int H, int N, int d, int nW,
                        int windows_per_cta, float scale, cudaStream_t stream) {
  if (ids != nullptr)
    return launch<T, kRegion, LSE>(q, k, v, bias, ids, mask, out, lse, B, H, N, d, nW, windows_per_cta, scale,
                                   stream);
  if (mask != nullptr)
    return launch<T, kMask, LSE>(q, k, v, bias, ids, mask, out, lse, B, H, N, d, nW, windows_per_cta, scale,
                                 stream);
  return launch<T, kNone, LSE>(q, k, v, bias, ids, mask, out, lse, B, H, N, d, nW, windows_per_cta, scale, stream);
}

template <typename T>
cudaError_t occupancy(bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return stream_fit(window_attention_stream_fwd_kernel<T, kRegion, false>, kFwdSmemBytes, ctas);
  if (has_mask) return stream_fit(window_attention_stream_fwd_kernel<T, kMask, false>, kFwdSmemBytes, ctas);
  return stream_fit(window_attention_stream_fwd_kernel<T, kNone, false>, kFwdSmemBytes, ctas);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. As
// icl_window_attention_fwd (window_attention.cu) for any head dim D >= 1 and
// window of N >= 1 tokens: `region_ids` set selects REGION, else `mask`
// set selects MASK, else NONE; `is_bf16` the input type; where `lse` is
// set the row log-sum-exp [B, H, N] f32 of the logits is stored there. A
// CTA takes `windows_per_cta` windows of one block of 64 rows and one pair
// of 64-column chunks of the output of one head; its width and shared
// memory are those icl_window_attention_stream_fwd_geometry reports.
int icl_window_attention_stream_fwd(const void* q, const void* k, const void* v, const void* bias,
                                    const void* region_ids, const void* mask, void* out, void* lse, int B, int H,
                                    int N, int D, int nW, int windows_per_cta, float scale, int is_bf16,
                                    void* stream) {
  if (windows_per_cta < 1 || N < 1 || D < 1 || B < 1 || H < 1 || nW < 1) return cudaErrorInvalidValue;
  const auto* b = static_cast<const float*>(bias);
  const auto* ids = static_cast<const float*>(region_ids);
  const auto* mk = static_cast<const float*>(mask);
  auto* ls = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  if (ls != nullptr)
    return is_bf16 ? launch_mode<__nv_bfloat16, true>(q, k, v, b, ids, mk, out, ls, B, H, N, D, nW, windows_per_cta,
                                                      scale, s)
                   : launch_mode<float, true>(q, k, v, b, ids, mk, out, ls, B, H, N, D, nW, windows_per_cta, scale,
                                              s);
  return is_bf16 ? launch_mode<__nv_bfloat16, false>(q, k, v, b, ids, mk, out, ls, B, H, N, D, nW, windows_per_cta,
                                                     scale, s)
                 : launch_mode<float, false>(q, k, v, b, ids, mk, out, ls, B, H, N, D, nW, windows_per_cta, scale, s);
}

// The launch geometry at windows of N tokens and head dim D (both >= 1;
// neither changes it), in the mode that `has_ids` (REGION), else
// `has_mask` (MASK), else neither (NONE) selects, and the type `is_bf16`
// selects: the warps of a CTA, its shared memory in bytes, and how many
// such CTAs one SM of the current device holds. Returns a cudaError_t.
int icl_window_attention_stream_fwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                             int* smem, int* ctas) {
  if (N < 1 || D < 1) return cudaErrorInvalidValue;
  *warps = kStreamWarps;
  *smem = static_cast<int>(kFwdSmemBytes);
  return is_bf16 ? occupancy<__nv_bfloat16>(has_ids != 0, has_mask != 0, ctas)
                 : occupancy<float>(has_ids != 0, has_mask != 0, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
