// Building blocks of the window-attention kernels on Hopper's tensor cores,
// shared by window_attention.cu (forward) and window_attention_bwd.cu
// (backward).
//
//   * mma.sync m16n8k8 TF32 with f32 accumulators, in the 3xTF32 split:
//     x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
//     a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, which keeps f32 accuracy.
//     A bf16 input is exact in TF32 (EXACT): its lo is zero and the terms
//     with it are skipped.
//   * An operand [N, d] (head dim d, rows d values apart in device memory)
//     staged in shared memory as f32 at the tile width D >= d (16, 32 or 64),
//     columns d .. D - 1 and rows N .. Np - 1 zero (zero_pad), in 4-float
//     chunks permuted by an XOR (sidx) so that both fragment patterns hit
//     32 banks. f32 rows of whole aligned 16-byte chunks come in with
//     cp.async, bf16 ones as 8-byte loads, any other d value by value. The
//     zero columns add nothing to q.k^T and give zero columns of P.v, so
//     every d of a tile runs the tile's code.
//   * A C fragment used as the next product's A fragment in registers,
//     through a permuted k index (product_cn).
//   * The additive terms of a logit (bias, + dense mask, or -100 from the
//     region ids) read from device memory one tile ahead of their use.
//   * The tile-64 kernels' term array of bias (+ mask) in aligned rows
//     (window_attention64_terms_kernel).
//   * For the tile-64 backward: tiles staged once with cp.async and split
//     once into hi and lo arrays in shared memory (issue_rows, split_rows),
//     and the products that read them (product_nt_hilo, product_nt_tiles,
//     product_cn_tile); for bf16 inputs m16n8k16 bf16 products
//     (product_nt_bf16, and product_cn_bf16 with P or dS split into bf16 hi
//     and lo).
//
// Fragment layout of m16n8k8 (lane = 4 g + t): A rows g and g + 8 at
// columns t and t + 4; B column g at rows t and t + 4; C rows g and g + 8
// at columns 2t and 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// mask modes
constexpr int kNone = 0;
constexpr int kRegion = 1;
constexpr int kMask = 2;

// The tile of head dim d: the width its operands are staged at and the
// compiled instance that runs it, 16 for 1 <= d <= 16, 32 for 16 < d <= 32,
// 64 for 32 < d <= 64, 0 for any other d.
inline int head_dim_tile(int d) { return d < 1 ? 0 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 0; }

// Shared memory a CTA can opt into on Hopper (sm_90a): 227 KB.
constexpr int kMaxSmemBytes = 232448;

// Warps of a CTA whose warps each own a 16-row tile of a window of N
// tokens: as few as the fewest rounds over the tiles allow, at most
// `max_warps`.
inline int tile_warps(int N, int max_warps) {
  const int tiles = (N + 15) / 16;
  const int rounds = (tiles + max_warps - 1) / max_warps;
  return (tiles + rounds - 1) / rounds;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ void store1(T* p, float a);
template <>
__device__ __forceinline__ void store1<float>(float* p, float a) {
  *p = a;
}
template <>
__device__ __forceinline__ void store1<__nv_bfloat16>(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// Columns c and c + 1 (c even) of a row of d values in device memory, only
// those below d: as one pair where d is even (the pair is then aligned,
// given an aligned row 0), else value by value.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int c, int d, float a, float b) {
  if ((d & 1) == 0) {
    if (c < d) store2<T>(row + c, a, b);
  } else {
    if (c < d) store1<T>(row + c, a);
    if (c + 1 < d) store1<T>(row + c + 1, b);
  }
}

// x rounded to nearest TF32, as an f32 bit pattern with 13 low bits zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32. EXACT: x is TF32 already (a bf16 input), lo = 0.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

template <bool EXACT>
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  FragA f;
  split<EXACT>(a0, f.hi[0], f.lo[0]);
  split<EXACT>(a1, f.hi[1], f.lo[1]);
  split<EXACT>(a2, f.hi[2], f.lo[2]);
  split<EXACT>(a3, f.hi[3], f.lo[3]);
  return f;
}

template <bool EXACT>
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split<EXACT>(b0, f.hi[0], f.lo[0]);
  split<EXACT>(b1, f.hi[1], f.lo[1]);
  return f;
}

// c += a.b, one m16n8k8 TF32 product with f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in 3xTF32, the small terms first; an exact side has no lo term.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  if (!A_EXACT) mma(c, a.lo, b.hi);
  if (!B_EXACT) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// The copies this thread issued since the last commit form one group.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Index of (row, col) of a staged [Np, D] operand (D the tile), f32 without padding,
// 4-float chunks permuted by an XOR so that both fragment patterns (rows
// r0 + g at columns c + t, and rows r0 + 2t, r0 + 2t + 1 at columns c + g)
// hit 32 banks. D = 32 or 64: a row is one or two 32-float lines, chunk ^=
// row % 8 (the low three bits of the chunk, so a row keeps its own). D = 16:
// rows 2l and 2l + 1 share a line of 8 chunks, chunk ^= 2 (l % 4) + (l % 4) / 2.
// For r0 a multiple of 8, sidx(r0 + r, col) = r0 * D + sidx(r, col).
template <int D>
__device__ __forceinline__ int sidx(int row, int col) {
  static_assert(D == 16 || D == 32 || D == 64, "head dim 16, 32 or 64");
  const int chunk = col >> 2;
  if (D != 16) return row * D + ((chunk ^ (row & 7)) << 2) + (col & 3);
  const int l = (row >> 1) & 3;
  return (row >> 1) * 32 + ((((row & 1) << 2 | chunk) ^ (2 * l + (l >> 1))) << 2) + (col & 3);
}

// Rows [0, N) of a [N, d] operand (rows d values apart) into shared memory
// as f32 at width D: whole 16-byte chunks with cp.async where d % 4 == 0
// and the rows start 16-byte aligned, else value by value. Writes columns
// < d only; zero_pad keeps the rest zero.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int N, int d) {
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = d >> 2;
    for (int i = threadIdx.x; i < N * chunks; i += blockDim.x) {
      const int r = i / chunks;
      cp_async16(dst + sidx<D>(r, (i - r * chunks) * 4), src + 4 * i);
    }
  } else {
    for (int i = threadIdx.x; i < N * d; i += blockDim.x) {
      const int r = i / d;
      dst[sidx<D>(r, i - r * d)] = src[i];
    }
  }
}

// The same from bf16: 8-byte loads of 4 values where d % 4 == 0 and the rows
// start 8-byte aligned, else value by value.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* src, int N, int d) {
  if ((d & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const int chunks = d >> 2;
    for (int i = threadIdx.x; i < N * chunks; i += blockDim.x) {
      const int r = i / chunks;
      const uint2 raw = *reinterpret_cast<const uint2*>(src + 4 * i);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      *reinterpret_cast<float4*>(dst + sidx<D>(r, (i - r * chunks) * 4)) = make_float4(a.x, a.y, b.x, b.y);
    }
  } else {
    for (int i = threadIdx.x; i < N * d; i += blockDim.x) {
      const int r = i / d;
      dst[sidx<D>(r, i - r * d)] = __bfloat162float(src[i]);
    }
  }
}

// Zero what stage_rows never writes in a staged [Np, D] operand: rows
// N .. Np - 1 (whole 4-float chunks), and columns d .. D - 1 of the rows
// below N (none at the tile's own head dim). Once per CTA: those entries
// stay zero for every window, and no staging copy touches them, so this
// needs no barrier before the first stage.
template <int D>
__device__ __forceinline__ void zero_pad(float* dst, int N, int Np, int d) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < (Np - N) * kChunks; i += blockDim.x)
    *reinterpret_cast<float4*>(dst + sidx<D>(N + i / kChunks, (i % kChunks) * 4)) = make_float4(0.f, 0.f, 0.f, 0.f);
  const int w = D - d;
  for (int i = threadIdx.x; i < N * w; i += blockDim.x) {
    const int r = i / w;
    dst[sidx<D>(r, d + i - r * w)] = 0.f;
  }
}

// The A fragments (raw f32) of rows r0 .. r0 + 15 of a staged operand, one
// per 8-column step over D: a0 = X[r0 + g][c + t], a1 = X[r0 + g + 8][c + t],
// a2, a3 the same at column c + t + 4.
template <int D>
__device__ __forceinline__ void load_a(float (&a)[D / 8][4], const float* xs, int r0, int g, int t) {
  const float* lo = xs + r0 * D;
  const float* hi = xs + (r0 + 8) * D;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    a[kk][0] = lo[sidx<D>(g, 8 * kk + t)];
    a[kk][1] = hi[sidx<D>(g, 8 * kk + t)];
    a[kk][2] = lo[sidx<D>(g, 8 * kk + t + 4)];
    a[kk][3] = hi[sidx<D>(g, 8 * kk + t + 4)];
  }
}

// load_a, split once into hi and lo: the A side of every product over D
// stays in registers across a warp's sweep.
template <int D, bool EXACT>
__device__ __forceinline__ void load_a_split(FragA (&a)[D / 8], const float* xs, int r0, int g, int t) {
  float raw[D / 8][4];
  load_a<D>(raw, xs, r0, g, t);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) a[kk] = split_a<EXACT>(raw[kk][0], raw[kk][1], raw[kk][2], raw[kk][3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The A fragments (raw f32) of rows r0 .. r0 + 15 of a [N, d] operand in
// device memory at tile width D, load_a's pattern; 0 past N and past d.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float (&a)[D / 8][4], const T* x, int r0, int N, int d, int g,
                                          int t) {
  const int lo = r0 + g;
  const int hi = r0 + g + 8;
  auto at = [&](int row, int c) { return row < N && c < d ? to_float(x[row * d + c]) : 0.f; };
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    a[kk][0] = at(lo, c);
    a[kk][1] = at(hi, c);
    a[kk][2] = at(lo, c + 4);
    a[kk][3] = at(hi, c + 4);
  }
}

// An A fragment as hi and lo, held split already.
template <bool EXACT>
__device__ __forceinline__ const FragA& as_split(const FragA& a) {
  return a;
}

// acc[16 x 8] = X[r0 .. r0+15] . Y[c0 .. c0+7]^T over D, 3xTF32: the A side
// in registers (FragA, split once), the B side b0 = Y[c0 + g][d + t], b1 =
// ...[d + t + 4], split here.
// The two small terms and a_hi.b_hi sum apart: three short chains of
// dependent MMAs instead of one long one.
template <int D, bool EXACT, typename A>
__device__ __forceinline__ void product_nt(float (&acc)[4], const A (&xa)[D / 8], const float* ys,
                                           int c0, int g, int t) {
  const float* y = ys + c0 * D;
  float small[4] = {0.f, 0.f, 0.f, 0.f};
  float small2[4] = {0.f, 0.f, 0.f, 0.f};
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragB b = split_b<EXACT>(y[sidx<D>(g, 8 * kk + t)], y[sidx<D>(g, 8 * kk + t + 4)]);
    const FragA& a = as_split<EXACT>(xa[kk]);
    if (!EXACT) {
      mma(small, a.lo, b.hi);
      mma(small2, a.hi, b.lo);
    }
    mma(acc, a.hi, b.hi);
  }
  if (!EXACT) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += small[e] + small2[e];
  }
}

// out[16 x D] += C . Y[r0 .. r0+7], C the C fragment of a 16 x 8 tile over
// rows r0 .. r0+7 of Y, used as the A fragment with k = t at row r0 + 2t
// and k = t + 4 at row r0 + 2t + 1; b0 = Y[r0 + 2t][n + g], b1 = Y[r0 + 2t + 1][n + g].
// Each call's 8-term product starts from zero and is added to `out` in
// f32: a chain of at most three MMAs, and a sum over N terms rounded at
// every step as an f32 sum is.
template <int D, bool Y_EXACT>
__device__ __forceinline__ void product_cn(float (&out)[D / 8][4], const float (&c)[4], const float* ys,
                                           int r0, int g, int t) {
  const float* y = ys + r0 * D;
  const FragA a = split_a<false>(c[0], c[2], c[1], c[3]);
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma3<false, Y_EXACT>(part, a, split_b<Y_EXACT>(y[sidx<D>(2 * t, 8 * nn + g)],
                                                   y[sidx<D>(2 * t + 1, 8 * nn + g)]));
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nn][e] += part[e];
  }
}

// ---------------------------------------------------------------------------
// Staged tiles (the tile-64 backward): an operand tile [R][64] at sidx<64>,
// copied once with cp.async. f32 lands in a hi array and is split there, by
// the thread that copied it once its own copies landed (cp.async.wait_all
// and wait_group make them visible to it), into hi = tf32(x) and lo =
// tf32(x - hi): one __syncthreads then publishes the split tile, and no
// fragment is split at its use. bf16 stays raw (fill_rows): exact in TF32,
// and read as bf16 pairs by the m16n8k16 products. Rows past N and columns
// past d are written as zeros by that pass, so a slot never holds a stale
// row.

// cp.async of BYTES (4, 8 or 16) into shared memory; `src_bytes` 0 reads
// nothing and fills the destination with zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes = BYTES) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(s), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

// Rows of a [N, d] operand come in whole 4-value chunks where d % 4 == 0 and
// its row 0 is aligned to a chunk (16 bytes in f32, 8 in bf16); else value
// by value.
template <typename T>
__device__ __forceinline__ bool chunked(const T* x, int d) {
  return (d & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
}

// This thread's chunks of a [R][64] tile (R rows): i = threadIdx.x, +
// blockDim.x, ... over R * 16 chunks, row i / 16, column 4 (i % 16). issue_rows, fill_rows
// and split_rows walk the same chunks, so the thread that copies a chunk is
// the one that finishes it.
//
// cp.async of the chunks of rows r0 .. r0 + R - 1 of x [N, d] (rows below N,
// columns below d) into `raw` (T at sidx<64>); nothing where !chunks.
template <typename T>
__device__ __forceinline__ void issue_rows(T* raw, const T* x, int r0, int R, int N, int d, bool chunks) {
  if (!chunks) return;
  for (int i = threadIdx.x; i < R * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) << 2;
    if (r0 + r < N && c < d)
      cp_async<static_cast<int>(4 * sizeof(T))>(raw + sidx<64>(r, c), x + static_cast<size_t>(r0 + r) * d + c);
  }
}

// The four values of chunk (r, c) of such a tile as f32: from `raw` where it
// was copied, from x value by value where !chunks, 0 past N and d.
__device__ __forceinline__ void raw_chunk(float (&v)[4], const float* raw, int at) {
  const float4 x = *reinterpret_cast<const float4*>(raw + at);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void raw_chunk(float (&v)[4], const __nv_bfloat16* raw, int at) {
  const uint2 x = *reinterpret_cast<const uint2*>(raw + at);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void chunk_values(float (&v)[4], const T* raw, const T* x, int row, int r, int c,
                                             int N, int d, bool chunks) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (row >= N || c >= d) return;
  if (chunks) {
    raw_chunk(v, raw, sidx<64>(r, c));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) v[e] = to_float(x[static_cast<size_t>(row) * d + c + e]);
  }
}

// Finish a raw tile kept raw (its fragments are split once in registers):
// the chunks issue_rows did not copy, value by value or zero.
template <typename T>
__device__ __forceinline__ void fill_rows(T* raw, const T* x, int r0, int R, int N, int d, bool chunks) {
  for (int i = threadIdx.x; i < R * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) << 2;
    if (chunks && r0 + r < N && c < d) continue;  // copied
    float v[4];
    chunk_values(v, raw, x, r0 + r, r, c, N, d, chunks);
    T* at = raw + sidx<64>(r, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) store1<T>(at + e, v[e]);
  }
}

// Finish a pre-split tile: this thread's chunks as hi (and lo unless the
// type is bf16, exact in TF32) at sidx<64>. For f32 `raw` is `hi` itself.
template <typename T>
__device__ __forceinline__ void split_rows(float* hi, float* lo, const T* raw, const T* x, int r0, int R, int N,
                                           int d, bool chunks) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  for (int i = threadIdx.x; i < R * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) << 2;
    float v[4];
    chunk_values(v, raw, x, r0 + r, r, c, N, d, chunks);
    const int at = sidx<64>(r, c);
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<kExact>(v[e], h[e], l[e]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    if (!kExact) *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The chunked tile-64 kernels (head dims above 64: window_attention_wide.cu,
// window_attention_bwd_wide.cu) stage a head dim of d in head_dim_chunks(d)
// chunks of 64 columns: the overloads below take the chunk's first column
// of x, `col0` (a multiple of 64), the tile's column c being x's column
// col0 + c, the rows d values apart as above.
__host__ __device__ inline int head_dim_chunks(int d) { return d <= 64 ? 1 : (d + 63) / 64; }

template <typename T>
__device__ __forceinline__ void issue_rows(T* raw, const T* x, int r0, int R, int N, int d, bool chunks, int col0) {
  if (!chunks) return;
  for (int i = threadIdx.x; i < R * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) << 2;
    if (r0 + r < N && col0 + c < d)
      cp_async<static_cast<int>(4 * sizeof(T))>(raw + sidx<64>(r, c),
                                                x + static_cast<size_t>(r0 + r) * d + col0 + c);
  }
}

template <typename T>
__device__ __forceinline__ void chunk_values(float (&v)[4], const T* raw, const T* x, int row, int r, int c,
                                             int N, int d, bool chunks, int col0) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (row >= N || col0 + c >= d) return;
  if (chunks) {
    raw_chunk(v, raw, sidx<64>(r, c));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col0 + c + e < d) v[e] = to_float(x[static_cast<size_t>(row) * d + col0 + c + e]);
  }
}

template <typename T>
__device__ __forceinline__ void fill_rows(T* raw, const T* x, int r0, int R, int N, int d, bool chunks, int col0) {
  for (int i = threadIdx.x; i < R * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) << 2;
    if (chunks && r0 + r < N && col0 + c < d) continue;  // copied
    float v[4];
    chunk_values(v, raw, x, r0 + r, r, c, N, d, chunks, col0);
    T* at = raw + sidx<64>(r, c);
#pragma unroll
    for (int e = 0; e < 4; ++e) store1<T>(at + e, v[e]);
  }
}

template <typename T>
__device__ __forceinline__ void split_rows(float* hi, float* lo, const T* raw, const T* x, int r0, int R, int N,
                                           int d, bool chunks, int col0) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  for (int i = threadIdx.x; i < R * 16; i += blockDim.x) {
    const int r = i >> 4;
    const int c = (i & 15) << 2;
    float v[4];
    chunk_values(v, raw, x, r0 + r, r, c, N, d, chunks, col0);
    const int at = sidx<64>(r, c);
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<kExact>(v[e], h[e], l[e]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    if (!kExact) *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The A fragments of rows r0 .. r0 + 15 (r0 a multiple of 8) of a raw tile
// [*][64], split once: the hi halves into registers and the lo halves
// (unless EXACT) into `lo` at the tile's own places: `lo` may be the raw tile itself, each
// lane writing only the values it read.
template <typename T, bool EXACT>
__device__ __forceinline__ void load_frags_hi(uint32_t (&hi)[8][4], float* lo, const T* raw, int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int at[4] = {sidx<64>(r0 + g, 8 * kk + t), sidx<64>(r0 + g + 8, 8 * kk + t), sidx<64>(r0 + g, 8 * kk + t + 4),
                       sidx<64>(r0 + g + 8, 8 * kk + t + 4)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t l;
      split<EXACT>(to_float(raw[at[e]]), hi[kk][e], l);
      if (!EXACT) lo[at[e]] = __uint_as_float(l);
    }
  }
  __syncwarp();
}

// The lo halves of the A fragment of rows r0 .. r0 + 15 at columns 8 kk ..
// 8 kk + 7 of a pre-split tile (0 when EXACT).
template <bool EXACT>
__device__ __forceinline__ void frag_lo(uint32_t (&lo)[4], const float* xlo, int r0, int kk, int g, int t) {
  const int at[4] = {sidx<64>(r0 + g, 8 * kk + t), sidx<64>(r0 + g + 8, 8 * kk + t), sidx<64>(r0 + g, 8 * kk + t + 4),
                     sidx<64>(r0 + g + 8, 8 * kk + t + 4)};
#pragma unroll
  for (int e = 0; e < 4; ++e) lo[e] = EXACT ? 0u : __float_as_uint(xlo[at[e]]);
}

// The A fragment of rows r0 .. r0 + 15 at columns 8 kk .. 8 kk + 7 of a
// pre-split tile.
template <bool EXACT>
__device__ __forceinline__ FragA frag_a(const float* xhi, const float* xlo, int r0, int kk, int g, int t) {
  FragA a;
  const int at[4] = {sidx<64>(r0 + g, 8 * kk + t), sidx<64>(r0 + g + 8, 8 * kk + t), sidx<64>(r0 + g, 8 * kk + t + 4),
                     sidx<64>(r0 + g + 8, 8 * kk + t + 4)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a.hi[e] = __float_as_uint(xhi[at[e]]);
    a.lo[e] = EXACT ? 0u : __float_as_uint(xlo[at[e]]);
  }
  return a;
}

// acc[nt] += A . Y[c0 + 8 nt .. c0 + 8 nt + 7]^T over columns 8 kk .. 8 kk +
// 7, Y pre-split: b0 = Y[c0 + 8 nt + g][8 kk + t], b1 = ...[8 kk + t + 4].
// 3xTF32 into the one accumulator, the small terms first (as CUTLASS's
// 3xTF32 GEMMs sum them; a chain of their own measured no faster on the
// tile-64 backward and cost registers).
template <int NT, bool EXACT>
__device__ __forceinline__ void mma_nt_step(float (&acc)[NT][4], const FragA& a, const float* yhi, const float* ylo,
                                            int c0, int kk, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int at0 = sidx<64>(c0 + 8 * nt + g, 8 * kk + t);
    const int at1 = sidx<64>(c0 + 8 * nt + g, 8 * kk + t + 4);
    const uint32_t bh[2] = {__float_as_uint(yhi[at0]), __float_as_uint(yhi[at1])};
    if (!EXACT) {
      const uint32_t bl[2] = {__float_as_uint(ylo[at0]), __float_as_uint(ylo[at1])};
      mma(acc[nt], a.lo, bh);
      mma(acc[nt], a.hi, bl);
    }
    mma(acc[nt], a.hi, bh);
  }
}

// acc[NT][16 x 8] = X . Y^T over 64 columns, X's rows x0 .. x0 + 15 with
// their hi halves in registers (load_frags_hi) and their lo halves in the
// pre-split tile xlo, Y's rows c0 .. c0 + 8 NT - 1 pre-split.
template <int NT, bool EXACT>
__device__ __forceinline__ void product_nt_hilo(float (&acc)[NT][4], const uint32_t (&xh)[8][4], const float* xlo,
                                                int x0, const float* yhi, const float* ylo, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    FragA a;
#pragma unroll
    for (int e = 0; e < 4; ++e) a.hi[e] = xh[kk][e];
    frag_lo<EXACT>(a.lo, xlo, x0, kk, g, t);
    mma_nt_step<NT, EXACT>(acc, a, yhi, ylo, c0, kk, g, t);
  }
}

// The same with X's rows x0 .. x0 + 15 read from a pre-split tile.
template <int NT, bool EXACT>
__device__ __forceinline__ void product_nt_tiles(float (&acc)[NT][4], const float* xhi, const float* xlo, int x0,
                                                 const float* yhi, const float* ylo, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) mma_nt_step<NT, EXACT>(acc, frag_a<EXACT>(xhi, xlo, x0, kk, g, t), yhi, ylo, c0, kk, g, t);
}

// bf16 x bf16 products, exact in f32, as mma.sync m16n8k16: the work of
// two m16n8k8 TF32 products in one. Fragments (lane = 4 g + t): A rows g
// and g + 8 at columns (2t, 2t + 1) and (2t + 8, 2t + 9), two bf16 a
// register; B column g at rows (2t, 2t + 1) and (2t + 8, 2t + 9); C as
// m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two adjacent bf16 of a tile at sidx<64>(row, col), col even: one word.
__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* x, int row, int col) {
  return *reinterpret_cast<const uint32_t*>(x + sidx<64>(row, col));
}

// The m16n8k16 A fragment of rows r0 .. r0 + 15 (r0 a multiple of 8) at
// columns 16 kk .. 16 kk + 15 of a bf16 tile [*][64].
__device__ __forceinline__ void frag_bf16(uint32_t (&a)[4], const __nv_bfloat16* x, int r0, int kk, int g, int t) {
  a[0] = bf16_pair(x, r0 + g, 16 * kk + 2 * t);
  a[1] = bf16_pair(x, r0 + g + 8, 16 * kk + 2 * t);
  a[2] = bf16_pair(x, r0 + g, 16 * kk + 2 * t + 8);
  a[3] = bf16_pair(x, r0 + g + 8, 16 * kk + 2 * t + 8);
}

// acc[NT][16 x 8] += X . Y^T over 64 columns in m16n8k16 bf16 products: X's
// rows x0 .. x0 + 15 as A fragments held in registers (xa, frag_bf16 at kk
// = 0 .. 3) or read from a bf16 tile (x), Y's rows c0 .. c0 + 8 NT - 1 a
// bf16 tile.
template <int NT>
__device__ __forceinline__ void mma_nt_bf16_step(float (&acc)[NT][4], const uint32_t (&a)[4], const __nv_bfloat16* y,
                                                 int c0, int kk, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint32_t b[2] = {bf16_pair(y, c0 + 8 * nt + g, 16 * kk + 2 * t), bf16_pair(y, c0 + 8 * nt + g, 16 * kk + 2 * t + 8)};
    mma_bf16(acc[nt], a, b);
  }
}
template <int NT>
__device__ __forceinline__ void product_nt_bf16(float (&acc)[NT][4], const uint32_t (&xa)[4][4],
                                                const __nv_bfloat16* y, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_nt_bf16_step<NT>(acc, xa[kk], y, c0, kk, g, t);
}
template <int NT>
__device__ __forceinline__ void product_nt_bf16(float (&acc)[NT][4], const __nv_bfloat16* x, int x0,
                                                const __nv_bfloat16* y, int c0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    frag_bf16(a, x, x0, kk, g, t);
    mma_nt_bf16_step<NT>(acc, a, y, c0, kk, g, t);
  }
}

// x as bf16 hi + lo (16 mantissa bits), for the A side of a bf16 product.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Two bf16 of rows r and r + 1 at column c of a bf16 tile, as one word.
__device__ __forceinline__ uint32_t bf16_rows(const __nv_bfloat16* y, int r, int c) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(y + sidx<64>(r, c));
  const uint32_t b = *reinterpret_cast<const uint16_t*>(y + sidx<64>(r + 1, c));
  return a | (b << 16);
}

// out[16 x 64] += C . Y[r0 .. r0 + 15] over 16 k in m16n8k16 bf16 products,
// Y a bf16 tile: the C fragments c0 and c1 of two 16 x 8 tiles (k 0 .. 7 and
// 8 .. 15) are the A fragment, split into bf16 hi and lo (P and dS are not
// bf16); b0 = Y[r0 + 2t, r0 + 2t + 1][8 nn + g], b1 = the same 8 rows on.
// Each 16-term product starts from zero and is added to `out` in f32.
__device__ __forceinline__ void product_cn_bf16(float (&out)[8][4], const float (&c0)[4], const float (&c1)[4],
                                                const __nv_bfloat16* y, int r0, int g, int t) {
  uint32_t hi[4], lo[4];
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    const uint32_t b[2] = {bf16_rows(y, r0 + 2 * t, 8 * nn + g), bf16_rows(y, r0 + 2 * t + 8, 8 * nn + g)};
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(part, lo, b);
    mma_bf16(part, hi, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nn][e] += part[e];
  }
}

// out[16 x 64] += C . Y[r0 .. r0 + 7] with Y a pre-split tile: product_cn's
// permuted k (C the C fragment of a 16 x 8 tile, split here: P and dS are
// not TF32), b0 = Y[r0 + 2t][8 nn + g], b1 = Y[r0 + 2t + 1][8 nn + g]. Each
// 8-term product starts from zero and is added to `out` in f32.
template <bool Y_EXACT>
__device__ __forceinline__ void product_cn_tile(float (&out)[8][4], const float (&c)[4], const float* yhi,
                                                const float* ylo, int r0, int g, int t) {
  const FragA a = split_a<false>(c[0], c[2], c[1], c[3]);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    const int at0 = sidx<64>(r0 + 2 * t, 8 * nn + g);
    const int at1 = sidx<64>(r0 + 2 * t + 1, 8 * nn + g);
    FragB b;
    b.hi[0] = __float_as_uint(yhi[at0]);
    b.hi[1] = __float_as_uint(yhi[at1]);
    b.lo[0] = Y_EXACT ? 0u : __float_as_uint(ylo[at0]);
    b.lo[1] = Y_EXACT ? 0u : __float_as_uint(ylo[at1]);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma3<false, Y_EXACT>(part, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nn][e] += part[e];
  }
}

// The additive terms of the four logits a lane holds, bias (+ mask): row
// pass, rows a[e / 2] at keys b0 + e % 2; column pass (TRANSPOSED), rows
// b0 + e % 2 at keys a[e / 2]. -inf at a padded key, 0 at a padded row.
// Read one tile ahead of their use, so that the L2 latency hides.
template <int MODE, bool TRANSPOSED>
__device__ __forceinline__ void load_terms(float (&term)[4], const int (&a)[2], int b0, int N,
                                           const float* bias_h, const float* mask_w) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = TRANSPOSED ? b0 + (e & 1) : a[e >> 1];
    const int key = TRANSPOSED ? a[e >> 1] : b0 + (e & 1);
    const size_t at = static_cast<size_t>(row) * N + key;
    float x = key < N ? 0.f : -INFINITY;
    if (key < N && row < N) {
      x = __ldg(bias_h + at);
      if (MODE == kMask) x += __ldg(mask_w + at);
    }
    term[e] = x;
  }
}

// The reference of an online softmax's running max m: m itself, or 0 while
// every key seen is padded (m = -inf, a lane's first keys when N < 8), so
// that e^(x - ref) is 0 for those keys and never e^(-inf + inf).
__device__ __forceinline__ float finite_or_zero(float m) { return m == -INFINITY ? 0.f : m; }

// The region ids of rows or keys i and i + 1 (i even), one pair load from
// shared memory; 0 outside REGION. Entries past N hold anything: `logit`
// leaves them out.
template <int MODE>
__device__ __forceinline__ float2 id_pair(const float* ids, int i) {
  return MODE == kRegion ? *reinterpret_cast<const float2*>(ids + i) : make_float2(0.f, 0.f);
}

// The region id of row or key i (i < Np), 0 outside REGION.
template <int MODE>
__device__ __forceinline__ float id_of(const float* ids, int i) {
  return MODE == kRegion ? ids[i] : 0.f;
}

// The logit of (row, key) from its raw q.k and its term; REGION adds -100
// where the ids of a real row and key (`real`: both below N) differ. The
// ids are loaded by the caller, a tile's own once and the other side's a
// pair at a time, so that no load waits on the comparison.
template <int MODE>
__device__ __forceinline__ float logit(float qk, float term, bool real, float id_row, float id_key,
                                       float scale) {
  float s = fmaf(qk, scale, term);
  if (MODE == kRegion && real && id_row != id_key) s += -100.f;
  return s;
}

// The tile-64 kernels' prologue (forward and backward): the term array [T,
// H, Np, P], bias[h] (+ mask[w] in MASK, T = nW; else T = 1), rows P apart
// (the backward: P = Np, N padded to a multiple of 16) so that every 16-byte
// chunk of a tile and every pair of keys is aligned, 0 past N. PERMUTED (the
// forward: P = N padded to a multiple of 32): within each block of 32 keys,
// key 8 j + 2 t + e at place 8 t + 2 j + e, so that the eight keys a lane
// (g, t) of a wgmma accumulator holds in a row are two 16-byte chunks.
__global__ void __launch_bounds__(256)
window_attention64_terms_kernel(const float* __restrict__ bias, const float* __restrict__ mask,
                                float* __restrict__ terms, int T, int H, int N, int Np, int P, int permuted) {
  const size_t total = static_cast<size_t>(T) * H * Np * P;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int at = static_cast<int>(i % P);
    const int j = permuted ? (at & ~31) + 8 * ((at >> 1) & 3) + 2 * ((at >> 3) & 3) + (at & 1) : at;
    const size_t wh_row = i / P;  // (w H + h) Np + row
    const int row = static_cast<int>(wh_row % Np);
    const size_t wh = wh_row / Np;
    const int h = static_cast<int>(wh % H);
    const int w = static_cast<int>(wh / H);
    float x = 0.f;
    if (row < N && j < N) {
      x = bias[(static_cast<size_t>(h) * N + row) * N + j];
      if (mask != nullptr) x += mask[(static_cast<size_t>(w) * N + row) * N + j];
    }
    terms[i] = x;
  }
}

// The term array of `planes` planes (nW with a dense mask, else 1), rows P
// apart, on `stream`; returns the launch's error.
inline cudaError_t launch_terms(const float* bias, const float* mask, float* terms, int planes, int H, int N,
                                int Np, int P, bool permuted, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(planes) * H * Np * P;
  const size_t blocks = (floats + 255) / 256;
  window_attention64_terms_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
      bias, mask, terms, planes, H, N, Np, P, permuted ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace
