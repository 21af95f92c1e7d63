// Fused window attention backward for Hopper (sm_90a) at every head dim and
// window, streaming the head dim's 64-column chunks: the backward where
// window_attention_bwd.cu and window_attention_bwd_wide.cu refuse (f32 above
// head dim 128; bf16 where the window of every chunk does not fit a CTA,
// above 128 at N = 343, above 448 at N = 49).
//
// Replaces the backward of the custom_vjp around the Pallas kernels of
// icl_tpu/ops/pallas/window_attention.py (_fused_attention_bwd :290-349),
// which takes any head dim, from the forward's saved output O and row
// log-sum-exp lse (window_attention_stream.cu stores them): P = e^(S -
// lse), u = rowsum(dO o O) in f32 (a prologue kernel) or rowsum(P o dP) in
// bf16 (the dQ kernel's sweep, as window_attention_plain_bwd_lse), dS =
// P o (dP - u), dV = P^T.dO, dQ = scale dS.K, dK = scale dS^T.Q, dbias[h] =
// sum over the windows of dS; NONE, REGION, MASK; f32 or bf16 q, k, v, dO,
// f32 math, dbias in f32.
//
// What bounds it: the function's 10 B H N^2 d flops at the card's
// f32-accurate rate (3xTF32 on mma.sync, 165 TFLOP/s) or bf16's. As the
// streamed forward, this first design is simple and right first: each
// kernel forms S and dP once a pair of output chunks, re-reads its tiles
// from L2 every step and runs mma.sync with one copy in flight; how far it
// is from the bound is in PERF.md.
//
// Design (stream_tiles.cuh; a CTA of 4 warps, shared memory 48 KB and
// registers independent of C and N):
//   * dQ kernel, a CTA per (block of 64 rows, pair of output chunks p,
//     head, group of windows), warp w on 16 rows: over each window in steps
//     of 32 keys, S = sum_c Q_c.K_c^T and dP = sum_c dO_c.V_c^T, the tiles
//     (Q_c, K_c) then (dO_c, V_c) of each chunk staged in turn through a
//     ring of two buffers; then P, dS, and dS.K of output chunks 2p and
//     2p + 1 alone, K of those chunks staged as the step's last tile. bf16
//     runs a sweep of the same steps first for u (stored by pair 0's CTAs
//     for the dK/dV kernel). Pair 0's CTAs add dS into the dbias partial
//     of their window group [G, H, N, N], one owner an element, in window
//     order.
//   * dK/dV kernel, a CTA per (block of 64 keys, pair, head, group), warp
//     w on 16 keys: over each window in steps of 16 rows, S^T = sum_c
//     K_c.Q_c^T and dP^T = sum_c V_c.dO_c^T; then P^T, dS^T, and P^T.dO,
//     dS^T.Q of the pair's chunks, Q and dO of those chunks the step's
//     last tile.
//   * The dbias partials are reduced in group order. No atomics: bitwise
//     repeatable.
// The kernels report their warps and shared memory through
// icl_window_attention_stream_bwd_geometry with the dQ kernel's resident
// CTAs an SM.

#include <math.h>

#include <type_traits>

#include "stream_tiles.cuh"

namespace {

constexpr int kKeys = 32;  // keys a dQ step
constexpr int kRows = 16;  // rows a dK/dV step
// a dQ buffer: Q_c (dO_c) [64][64] and K_c (V_c) [32][64]; or K of the pair [32][64] x 2
constexpr int kDqBuffer = kStreamTile + kKeys * kStreamChunk;
// a dK/dV buffer: K_c (V_c) [64][64] and Q_c (dO_c) [16][64]; or Q, dO of the pair [16][64] x 4
constexpr int kDkdvBuffer = kStreamTile + kRows * kStreamChunk;
constexpr size_t kDqSmemBytes = 2 * kDqBuffer * sizeof(float);
constexpr size_t kDkdvSmemBytes = 2 * kDkdvBuffer * sizeof(float);
static_assert(4 * kRows * kStreamChunk <= kDkdvBuffer && 2 * kKeys * kStreamChunk <= kDqBuffer,
              "the pair's tiles fit a buffer");

// u[row] = sum_c dO[row][c] O[row][c] over the B H N rows, one warp a row,
// f32: the prologue of f32 calls (bf16's u comes from the dQ kernel).
__global__ void __launch_bounds__(256)
window_attention_stream_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                                     float* __restrict__ delta, size_t rows, int d) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const float* o = out + row * d;
  const float* g = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(o[c], g[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kStreamThreads)
window_attention_stream_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                  const T* __restrict__ dout, const float* __restrict__ lse,
                                  float* __restrict__ delta, const float* __restrict__ bias,
                                  const float* __restrict__ region_ids, const float* __restrict__ mask,
                                  T* __restrict__ dq, float* __restrict__ dbias_part, int B, int H, int N, int d,
                                  int nW, int windows_per_cta, float scale) {
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
  // bf16: a sweep of 2 C tiles a step for u, then 2 C + 1 a step (the last K of the pair)
  const int sweep = kExact ? nkb * 2 * C : 0;
  const int per_window = sweep + nkb * (2 * C + 1);
  const bool second = kStreamPair * pair + 1 < C;
  const bool vq = chunked(q, d), vk = chunked(k, d), vv = chunked(v, d), vg = chunked(dout, d);
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  float* part_gh = dbias_part + (static_cast<size_t>(blockIdx.z) * H + h) * N * N;
  const int rows[2] = {rb * kStreamBlock + 16 * warp + g, rb * kStreamBlock + 16 * warp + g + 8};

  float s[4][4], dp[4][4];
  float acc[kStreamPair][8][4];
  float lse_r[2], u[2];
  auto reset = [&]() {
#pragma unroll
    for (int j = 0; j < kStreamPair; ++j)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][nn][e] = 0.f;
  };
  reset();

  // the stage's window, step, tile (0 .. C - 1: Q_c, K_c; C .. 2 C - 1: dO_c, V_c; 2 C: K of the pair), sweep
  auto decode = [&](int st, int& wi, int& kb, int& part, bool& sweeping) {
    wi = st / per_window;
    int rem = st - wi * per_window;
    sweeping = rem < sweep;
    if (!sweeping) rem -= sweep;
    const int per_step = sweeping ? 2 * C : 2 * C + 1;
    kb = rem / per_step;
    part = rem - kb * per_step;
  };

  auto issue = [&](int st, float* buf) {
    int wi, kb, part;
    bool sweeping;
    decode(st, wi, kb, part, sweeping);
    const size_t base = (static_cast<size_t>(b0 + wi) * H + h) * N * d;
    if (part < C) {
      stage_chunk<kStreamBlock>(buf, q + base, rb * kStreamBlock, N, d, part, vq);
      stage_chunk<kKeys>(buf + kStreamTile, k + base, kb * kKeys, N, d, part, vk);
    } else if (part < 2 * C) {
      stage_chunk<kStreamBlock>(buf, dout + base, rb * kStreamBlock, N, d, part - C, vg);
      stage_chunk<kKeys>(buf + kStreamTile, v + base, kb * kKeys, N, d, part - C, vv);
    } else {
      stage_chunk<kKeys>(buf, k + base, kb * kKeys, N, d, kStreamPair * pair, vk);
      if (second)
        stage_chunk<kKeys>(buf + kKeys * kStreamChunk, k + base, kb * kKeys, N, d, kStreamPair * pair + 1, vk);
    }
  };

  // P of the step in place of S (0 at padded keys and rows)
  auto softmax = [&](int b, int kb) {
    const int w = b % nW;
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(w) * N * N : nullptr;
    const float* ids_w = MODE == kRegion ? region_ids + static_cast<size_t>(w) * N : nullptr;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1], key = kb * kKeys + 8 * n + 2 * t + (e & 1);
        s[n][e] = key < N && row < N
                      ? expf(stream_logit<MODE>(s[n][e], scale, bias_h, mask_w, ids_w, N, row, key) - lse_r[e >> 1])
                      : 0.f;
      }
  };

  auto compute = [&](int st, const float* buf) {
    int wi, kb, part;
    bool sweeping;
    decode(st, wi, kb, part, sweeping);
    const int b = b0 + wi;
    const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
    if (part == 0) {
      if (kb == 0 && (sweeping || !kExact)) {  // the window's first step: its rows' lse (f32: u)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse_r[r] = rows[r] < N ? __ldg(lse + row_base + rows[r]) : 0.f;
          u[r] = !kExact && rows[r] < N ? delta[row_base + rows[r]] : 0.f;
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (part < C) {
      product_nt_tile<4, kExact>(s, buf, 16 * warp, buf + kStreamTile, g, t);
      return;
    }
    if (part < 2 * C) {
      product_nt_tile<4, kExact>(dp, buf, 16 * warp, buf + kStreamTile, g, t);
      if (!sweeping || part + 1 < 2 * C) return;
      // the sweep's step: u += rowsum(P o dP); at the window's last step the sum over the quad
      softmax(b, kb);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e >> 1] = fmaf(s[n][e], dp[n][e], u[e >> 1]);
      if (kb + 1 < nkb) return;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        u[r] += __shfl_xor_sync(kFullMask, u[r], 1);
        u[r] += __shfl_xor_sync(kFullMask, u[r], 2);
        if (pair == 0 && t == 0 && rows[r] < N) delta[row_base + rows[r]] = u[r];  // for the dK/dV kernel
      }
      return;
    }
    // the step's last tile: P, dS, the dbias partial (pair 0), dS.K of the pair
    softmax(b, kb);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= dp[n][e] - u[e >> 1];
        const int row = rows[e >> 1], key = kb * kKeys + 8 * n + 2 * t + (e & 1);
        if (pair == 0 && row < N && key < N) {
          float* p = part_gh + static_cast<size_t>(row) * N + key;
          *p = wi == 0 ? s[n][e] : *p + s[n][e];
        }
      }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      product_cn<64, kExact>(acc[0], s[n], buf, 8 * n, g, t);
      if (second) product_cn<64, kExact>(acc[1], s[n], buf + kKeys * kStreamChunk, 8 * n, g, t);
    }
    if (kb + 1 < nkb) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= N) continue;
      T* row_out = dq + (row_base + rows[r]) * d;
#pragma unroll
      for (int j = 0; j < kStreamPair; ++j) {
        if (j == 1 && !second) break;
        const int c0 = (kStreamPair * pair + j) * kStreamChunk;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          store_cols<T>(row_out, c0 + 8 * nn + 2 * t, d, acc[j][nn][2 * r] * scale, acc[j][nn][2 * r + 1] * scale);
      }
    }
    reset();
  };

  if (b0 < B) stream_ring(smem, kDqBuffer, (b1 - b0) * per_window, issue, compute);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kStreamThreads)
window_attention_stream_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                    const T* __restrict__ dout, const float* __restrict__ lse,
                                    const float* __restrict__ delta, const float* __restrict__ bias,
                                    const float* __restrict__ region_ids, const float* __restrict__ mask,
                                    T* __restrict__ dk, T* __restrict__ dv, int B, int H, int N, int d, int nW,
                                    int windows_per_cta, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  const int C = head_dim_chunks(d);
  const int blocks = (N + kStreamBlock - 1) / kStreamBlock;
  const int kbk = blockIdx.x % blocks, pair = blockIdx.x / blocks;
  const int h = blockIdx.y;
  const int b0 = blockIdx.z * windows_per_cta;
  const int b1 = min(B, b0 + windows_per_cta);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int nrs = (N + kRows - 1) / kRows;
  const int per_window = nrs * (2 * C + 1);
  const bool second = kStreamPair * pair + 1 < C;
  const bool vq = chunked(q, d), vk = chunked(k, d), vv = chunked(v, d), vg = chunked(dout, d);
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const int keys[2] = {kbk * kStreamBlock + 16 * warp + g, kbk * kStreamBlock + 16 * warp + g + 8};

  float s[2][4], dp[2][4];  // S^T and dP^T: 16 keys x 16 rows a warp
  float ak[kStreamPair][8][4], av[kStreamPair][8][4];
  auto reset = [&]() {
#pragma unroll
    for (int j = 0; j < kStreamPair; ++j)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) ak[j][nn][e] = av[j][nn][e] = 0.f;
  };
  reset();

  auto issue = [&](int st, float* buf) {
    const int wi = st / per_window, rem = st - wi * per_window;
    const int rs = rem / (2 * C + 1), part = rem - rs * (2 * C + 1);
    const size_t base = (static_cast<size_t>(b0 + wi) * H + h) * N * d;
    if (part < C) {
      stage_chunk<kStreamBlock>(buf, k + base, kbk * kStreamBlock, N, d, part, vk);
      stage_chunk<kRows>(buf + kStreamTile, q + base, rs * kRows, N, d, part, vq);
    } else if (part < 2 * C) {
      stage_chunk<kStreamBlock>(buf, v + base, kbk * kStreamBlock, N, d, part - C, vv);
      stage_chunk<kRows>(buf + kStreamTile, dout + base, rs * kRows, N, d, part - C, vg);
    } else {  // Q of the pair, then dO of the pair, [16][64] each
      for (int j = 0; j < kStreamPair; ++j) {
        if (j == 1 && !second) break;
        stage_chunk<kRows>(buf + j * kRows * kStreamChunk, q + base, rs * kRows, N, d, kStreamPair * pair + j, vq);
        stage_chunk<kRows>(buf + (2 + j) * kRows * kStreamChunk, dout + base, rs * kRows, N, d,
                           kStreamPair * pair + j, vg);
      }
    }
  };

  auto compute = [&](int st, const float* buf) {
    const int wi = st / per_window, rem = st - wi * per_window;
    const int rs = rem / (2 * C + 1), part = rem - rs * (2 * C + 1);
    if (part == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (part < C) {
      product_nt_tile<2, kExact>(s, buf, 16 * warp, buf + kStreamTile, g, t);
      return;
    }
    if (part < 2 * C) {
      product_nt_tile<2, kExact>(dp, buf, 16 * warp, buf + kStreamTile, g, t);
      return;
    }
    // the step's last tile: P^T and dS^T of the warp's keys and the step's rows, then the pair's dV, dK
    const int b = b0 + wi, w = b % nW;
    const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(w) * N * N : nullptr;
    const float* ids_w = MODE == kRegion ? region_ids + static_cast<size_t>(w) * N : nullptr;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // the fragment's columns 2t + e: rows
        const int row = rs * kRows + 8 * n + 2 * t + e;
        const float lse_r = row < N ? __ldg(lse + row_base + row) : 0.f;
        const float u_r = row < N ? delta[row_base + row] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // the fragment's rows g, g + 8: keys
          const int key = keys[half];
          float& x = s[n][2 * half + e];
          const float p = key < N && row < N
                              ? expf(stream_logit<MODE>(x, scale, bias_h, mask_w, ids_w, N, row, key) - lse_r)
                              : 0.f;
          x = p;
          dp[n][2 * half + e] = p * (dp[n][2 * half + e] - u_r);
        }
      }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      product_cn<64, kExact>(av[0], s[n], buf + 2 * kRows * kStreamChunk, 8 * n, g, t);
      product_cn<64, kExact>(ak[0], dp[n], buf, 8 * n, g, t);
      if (second) {
        product_cn<64, kExact>(av[1], s[n], buf + 3 * kRows * kStreamChunk, 8 * n, g, t);
        product_cn<64, kExact>(ak[1], dp[n], buf + kRows * kStreamChunk, 8 * n, g, t);
      }
    }
    if (rs + 1 < nrs) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (keys[half] >= N) continue;
      T* k_out = dk + (row_base + keys[half]) * d;
      T* v_out = dv + (row_base + keys[half]) * d;
#pragma unroll
      for (int j = 0; j < kStreamPair; ++j) {
        if (j == 1 && !second) break;
        const int c0 = (kStreamPair * pair + j) * kStreamChunk;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          store_cols<T>(k_out, c0 + 8 * nn + 2 * t, d, ak[j][nn][2 * half] * scale, ak[j][nn][2 * half + 1] * scale);
          store_cols<T>(v_out, c0 + 8 * nn + 2 * t, d, av[j][nn][2 * half], av[j][nn][2 * half + 1]);
        }
      }
    }
    reset();
  };

  if (b0 < B) stream_ring(smem, kDkdvBuffer, (b1 - b0) * per_window, issue, compute);
}

// dbias[h, i, j] = sum_g part[g, h, i, j] in the order g = 0 .. G - 1.
__global__ void window_attention_stream_dbias_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                                     int groups, size_t hnn) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < hnn; i += stride) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[static_cast<size_t>(g) * hnn + i];
    dbias[i] = s;
  }
}

// The pointers and sizes of one backward call.
struct Args {
  const void *q, *k, *v, *dout, *out;
  const float *lse, *bias, *region_ids, *mask;
  void *dq, *dk, *dv;
  float *delta, *dbias_part, *dbias;
  int B, H, N, d, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

// f32: the prologue u = rowsum(dO o O); the dQ kernel (the dbias partial;
// bf16: u), the dK/dV kernel, the dbias reduction, in stream order.
template <typename T, int MODE>
cudaError_t launch(const Args& a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  auto dq_kernel = window_attention_stream_dq_kernel<T, MODE>;
  auto kv_kernel = window_attention_stream_dkdv_kernel<T, MODE>;
  cudaError_t err = stream_fit(dq_kernel, kDqSmemBytes, nullptr);
  if (err == cudaSuccess) err = stream_fit(kv_kernel, kDkdvSmemBytes, nullptr);
  if (err != cudaSuccess) return err;
  if (!kBf16) {
    const size_t rows = static_cast<size_t>(a.B) * a.H * a.N;
    window_attention_stream_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
        static_cast<const float*>(a.out), static_cast<const float*>(a.dout), a.delta, rows, a.d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  const int blocks = (a.N + kStreamBlock - 1) / kStreamBlock;
  const dim3 grid(blocks * stream_pairs(head_dim_chunks(a.d)), a.H, groups);
  dq_kernel<<<grid, kStreamThreads, kDqSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.bias, a.region_ids, a.mask, static_cast<T*>(a.dq),
      a.dbias_part, a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<grid, kStreamThreads, kDkdvSmemBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.bias, a.region_ids, a.mask, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t hnn = static_cast<size_t>(a.H) * a.N * a.N;
  size_t reduce_blocks = (hnn + 255) / 256;
  if (reduce_blocks > 4096) reduce_blocks = 4096;
  window_attention_stream_dbias_kernel<<<static_cast<unsigned>(reduce_blocks), 256, 0, a.stream>>>(
      a.dbias_part, a.dbias, groups, hnn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, kRegion>(a);
  if (a.mask != nullptr) return launch<T, kMask>(a);
  return launch<T, kNone>(a);
}

// CTAs of the dQ kernel that fit one SM, whose grid the caller sizes from it.
template <typename T>
cudaError_t occupancy(bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return stream_fit(window_attention_stream_dq_kernel<T, kRegion>, kDqSmemBytes, ctas);
  if (has_mask) return stream_fit(window_attention_stream_dq_kernel<T, kMask>, kDqSmemBytes, ctas);
  return stream_fit(window_attention_stream_dq_kernel<T, kNone>, kDqSmemBytes, ctas);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when every launch was accepted. As
// icl_window_attention_bwd (window_attention_bwd.cu) at tile 64, for any
// head dim D >= 1 and window of N >= 1 tokens: the forward's output `out`
// and row log-sum-exp `lse` [B, H, N] f32 (required; a bf16 `out` is not
// read), scratch `delta` [B, H, N] f32 and `dbias_part` of
// ceil(B / windows_per_cta) * H * N * N floats. Both kernels' CTAs take
// `windows_per_cta` windows; their width and shared memory are those
// icl_window_attention_stream_bwd_geometry reports.
int icl_window_attention_stream_bwd(const void* q, const void* k, const void* v, const void* dout,
                                    const void* out, const void* lse, const void* bias, const void* region_ids,
                                    const void* mask, void* dq, void* dk, void* dv, void* delta, void* dbias_part,
                                    void* dbias, int B, int H, int N, int D, int nW, int windows_per_cta,
                                    float scale, int is_bf16, void* stream) {
  if (windows_per_cta < 1 || N < 1 || D < 1 || B < 1 || H < 1 || nW < 1) return cudaErrorInvalidValue;
  if (out == nullptr || lse == nullptr || delta == nullptr || dbias_part == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, out,
               static_cast<const float*>(lse), static_cast<const float*>(bias),
               static_cast<const float*>(region_ids), static_cast<const float*>(mask), dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(dbias_part), static_cast<float*>(dbias),
               B, H, N, D, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_mode<__nv_bfloat16>(a) : launch_mode<float>(a);
}

// The launch geometry at windows of N tokens and head dim D (both >= 1;
// neither changes it), in the mode that `has_ids` (REGION), else
// `has_mask` (MASK), else neither (NONE) selects: the warps of a CTA, the
// larger of the two kernels' shared memory in bytes, and how many dQ CTAs
// one SM of the current device holds. Returns a cudaError_t.
int icl_window_attention_stream_bwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                             int* smem, int* ctas) {
  if (N < 1 || D < 1) return cudaErrorInvalidValue;
  *warps = kStreamWarps;
  *smem = static_cast<int>(kDqSmemBytes > kDkdvSmemBytes ? kDqSmemBytes : kDkdvSmemBytes);
  return is_bf16 ? occupancy<__nv_bfloat16>(has_ids != 0, has_mask != 0, ctas)
                 : occupancy<float>(has_ids != 0, has_mask != 0, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
