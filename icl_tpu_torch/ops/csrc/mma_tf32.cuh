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
//
// Fragment layout of m16n8k8 (lane = 4 g + t): A rows g and g + 8 at
// columns t and t + 4; B column g at rows t and t + 4; C rows g and g + 8
// at columns 2t and 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

// An A fragment as hi and lo: one held split already, or raw values split
// here, at each use (fewer registers held, the split repeated).
template <bool EXACT>
__device__ __forceinline__ const FragA& as_split(const FragA& a) {
  return a;
}
template <bool EXACT>
__device__ __forceinline__ FragA as_split(const float (&a)[4]) {
  return split_a<EXACT>(a[0], a[1], a[2], a[3]);
}

// acc[16 x 8] = X[r0 .. r0+15] . Y[c0 .. c0+7]^T over D, 3xTF32: the A side
// in registers (FragA split, or raw float[4] split at each use, as_split),
// the B side b0 = Y[c0 + g][d + t], b1 = ...[d + t + 4].
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

}  // namespace
