// Building blocks of the streamed window-attention kernels
// (window_attention_stream.cu, window_attention_bwd_stream.cu), which take
// any head dim d >= 1 and any window of N tokens in a CTA whose shared
// memory and registers do not grow with d or N.
//
//   * A head dim of d is C = head_dim_chunks(d) chunks of 64 columns. An
//     operand [N, d] of one (window, head), rows d values apart in device
//     memory, is staged one tile at a time: rows [r0, r0 + R) of one chunk,
//     as f32 in a [R][64] tile at sidx<64>, zero past N and past d
//     (stage_chunk), in one pass over the tile's 4-value chunks with the
//     chunked kernels' primitives of mma_tf32.cuh: f32 rows of whole
//     16-byte chunks come in with cp.async (cp_async<16>, zero-filled past
//     the edges), bf16 ones as 8-byte loads widened to f32 (raw_chunk), any
//     other d value by value (chunk_values). Not issue_rows and fill_rows:
//     their two passes, strided by blockDim.x, made both kernels 15-19%
//     slower on an H100.
//   * Tiles pass through a ring of two buffers: the CTA stages tile s + 1
//     while it computes on tile s (stream_ring).
//   * Products on mma.sync m16n8k8 TF32 in the 3xTF32 split of
//     mma_tf32.cuh (a bf16 operand is exact in TF32: no lo term), C
//     fragments of a product used as the next product's A fragment
//     (product_cn).
//   * The logit's additive terms (bias, + dense mask or -100 from the
//     region ids) read from device memory where they are used.

#pragma once

#include "mma_tf32.cuh"

namespace {

constexpr int kStreamChunk = 64;                  // columns of a chunk of the head dim
constexpr int kStreamWarps = 4;                   // warps of a CTA, 16 rows (keys) each
constexpr int kStreamThreads = 32 * kStreamWarps;
constexpr int kStreamBlock = 16 * kStreamWarps;   // rows (keys) of a CTA: 64
constexpr int kStreamPair = 2;                    // output chunks of a CTA
constexpr int kStreamTile = kStreamBlock * kStreamChunk;  // floats of a [64][64] tile

__host__ __device__ inline int stream_pairs(int chunks) { return (chunks + kStreamPair - 1) / kStreamPair; }

// Rows [r0, r0 + R) of chunk c of the [N, d] operand `src` (f32 or bf16)
// into the tile `dst` [R][64] at sidx<64>, as f32; zero at rows >= N and
// columns >= d. `vec` (`chunked(src, d)`): whole 4-value chunks, f32 with
// cp.async, which the caller commits and waits for, bf16 as 8-byte loads;
// else value by value. The f32 copies take a loop of their own: one loop
// for both forms made the f32 forward 3-9% slower on an H100.
template <int R, typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src, int r0, int N, int d, int c, bool vec) {
  const int col0 = c * kStreamChunk;
  if (std::is_same<T, float>::value && vec) {
    for (int i = threadIdx.x; i < R * 16; i += kStreamThreads) {
      const int r = i >> 4, col = (i & 15) << 2;
      const bool in = r0 + r < N && col0 + col < d;
      cp_async<16>(dst + sidx<64>(r, col), in ? src + static_cast<size_t>(r0 + r) * d + col0 + col : src,
                   in ? 16 : 0);
    }
    return;
  }
  for (int i = threadIdx.x; i < R * 16; i += kStreamThreads) {
    const int r = i >> 4, col = (i & 15) << 2;
    float v[4];
    if (vec && r0 + r < N && col0 + col < d)
      raw_chunk(v, src + static_cast<size_t>(r0 + r) * d + col0 + col, 0);
    else
      chunk_values(v, src, src, r0 + r, r, col, N, d, false, col0);
    *reinterpret_cast<float4*>(dst + sidx<64>(r, col)) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The ring of two buffers of `floats` each in dynamic shared memory: the
// CTA issues stage s + 1 (into buffer (s + 1) % 2) before it computes on
// stage s, whose copies it waits for here. `issue(s, buffer)` stages stage
// s; `compute(s, buffer)` reads it. Every thread runs every stage.
template <typename Issue, typename Compute>
__device__ __forceinline__ void stream_ring(float* smem, int floats, int stages, Issue issue, Compute compute) {
  if (stages <= 0) return;
  issue(0, smem);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) issue(s + 1, smem + ((s + 1) & 1) * floats);
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();
    compute(s, smem + (s & 1) * floats);
    __syncthreads();
  }
}

// acc[n] += X[r0 .. r0 + 15] . Y[8 n .. 8 n + 7]^T over a tile's 64
// columns, n < NT: X and Y staged tiles at sidx<64>, 3xTF32 (EXACT: both
// sides bf16, one product). The chunk's product is summed from zero, its
// a_hi.b_hi terms and its two small terms apart (as product_nt), and then
// added to acc in f32: a tensor core's f32 accumulation rounds less
// exactly than an f32 add, so one accumulator chained over every chunk
// put the f32 forward's error vs an f64 reference at 1.5-1.8e-5 at head
// dim 648 (the plain f32 version's 2.5-4.3e-6).
template <int NT, bool EXACT>
__device__ __forceinline__ void product_nt_tile(float (&acc)[NT][4], const float* xs, int r0, const float* ys,
                                                int g, int t) {
  float hi[NT][4], small[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[n][e] = small[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = 8 * kk + t;
    const FragA a = split_a<EXACT>(xs[sidx<64>(r0 + g, c)], xs[sidx<64>(r0 + g + 8, c)],
                                   xs[sidx<64>(r0 + g, c + 4)], xs[sidx<64>(r0 + g + 8, c + 4)]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const FragB b = split_b<EXACT>(ys[sidx<64>(8 * n + g, c)], ys[sidx<64>(8 * n + g, c + 4)]);
      if (!EXACT) {
        mma(small[n], a.lo, b.hi);
        mma(small[n], a.hi, b.lo);
      }
      mma(hi[n], a.hi, b.hi);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += EXACT ? hi[n][e] : hi[n][e] + small[n][e];
}

// The logit of (row, key) from the product `x` of its q and k: (x scale +
// bias[row][key]) + the window's term (dense mask, or -100 where the
// region ids of key and row differ), the plain version's order of sums.
template <int MODE>
__device__ __forceinline__ float stream_logit(float x, float scale, const float* bias_h, const float* mask_w,
                                              const float* ids_w, int N, int row, int key) {
  float s = x * scale + __ldg(bias_h + static_cast<size_t>(row) * N + key);
  if (MODE == kMask) s += __ldg(mask_w + static_cast<size_t>(row) * N + key);
  if (MODE == kRegion) s += __ldg(ids_w + row) != __ldg(ids_w + key) ? -100.f : 0.f;
  return s;
}

// Allow `kernel` `smem` bytes of shared memory, and report how many of its
// CTAs of kStreamThreads fit one SM (where `ctas` is set).
template <typename K>
cudaError_t stream_fit(K kernel, size_t smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess || ctas == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kStreamThreads, smem);
}

}  // namespace
