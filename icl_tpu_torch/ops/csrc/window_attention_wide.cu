// Fused window attention forward for Hopper (sm_90a) at head dims above
// 64, on tensor cores: the tile-64 kernel of window_attention.cu
// (window_attention64_kernel, whose note this one follows) with the head
// dim in C = ceil(d / 64) chunks of 64 columns, a CTA per pair of output
// chunks.
//
// Replaces the same three Pallas TPU kernels of
// icl_tpu/ops/pallas/window_attention.py as window_attention.cu (_kernel
// :44, _kernel_masked :28, _kernel_region :60), which take any head dim:
// out = softmax(q.k^T * scale + bias[h] (+ mask)) . v per (window, head),
// f32 math, output in the input type, in NONE, REGION or MASK. SwinUNETR's
// head dim is feature_size / 3 (80 at fs240, 128 at fs384); a Swin-UNet
// at 128 a head. Layout as window_attention.cu's.
//
// What bounds it: the function's 4 B H N^2 d flops at the card's
// f32-accurate rate (3xTF32, 165 TFLOP/s; bf16's bytes), as at tile 64.
// Like the tile-64 kernel it is bound by latency and issue, not by a
// unit's rate (PERF.md): in f32 the producer's split and
// transposition of each step's tiles (5.8 ms of fs240 stage 1 alone) and
// the consumers' chain of products, exchange and softmax (4.7 ms alone);
// in bf16 the consumers' chain. So it issues no product the function does
// not need: a CTA of one chunk's columns that summed S over every chunk
// issued 2 C chunk-products of S a row block at C = 2 where the function
// needs C, with a wait between chunks, and staged K C times (1.75x SDPA's
// f32 time). And it keeps enough independent work on
// an SM: coupling two warpgroups on one block of rows in bf16 too ran 6.1
// ms at fs240's stage 1, against 3.5 for a CTA a chunk.
//
// Design (kept from the tile-64 kernel: producer warpgroups on an mbarrier
// ring of 32-key slots, wgmma in the 3xTF32 split or bf16, V^T with its
// keys permuted so that S's accumulator is P.V's A fragment, the term
// array, padded keys at -inf, no atomics, bitwise repeatable):
//   * A CTA owns one pair p of output chunks (p = 0 at C = 2; above, bf16
//     only, each pair is a CTA of its own that forms S over every chunk:
//     S is recomputed once a pair of chunks). Each ring slot holds K of
//     every chunk and V of the pair.
//   * f32, the pair of warpgroups: two consumer warpgroups own the same
//     block of 64 rows; warpgroup j holds Q of chunk j alone and stores
//     output chunk j. Each step it forms only the partial S_j = Q_j.K_j^T,
//     warp w of each (a pair of warps, the same 16 rows) stages its S_j in
//     the pair's exchange (a float4 a lane, two buffers by the step's
//     parity, so one named barrier a step) and adds the other's: S_0 + S_1
//     == S_1 + S_0, so both hold the same bits and run the same online
//     softmax. P.V of its chunk is summed from zero and added in f32. Only
//     warpgroup 0 stores the row log-sum-exp. Q of two chunks, split hi
//     and lo, takes 64 KB, so one block of rows a CTA, and the ring two
//     slots; two producer warpgroups split the tiles, each transposing one
//     chunk's V.
//   * bf16, a warpgroup a block of rows: one to three consumer warpgroups
//     (as many as divide the window's row blocks), each on 64 rows of its
//     own, hold Q of every chunk and the accumulators of both output
//     chunks: S over every chunk in one group of products, no exchange,
//     P.V of both chunks added in place to the rescaled accumulators; each
//     stores its rows' log-sum-exp in pair 0. One producer, whose copies of
//     whole 16-byte chunks need no finishing.
//   * Zero columns: the S products of the last chunk skip its k-steps
//     that lie wholly past d (at d = 80, 6 of 8 in f32), in a guarded form
//     of their own (`unrolled`), and f32's P.V of a last chunk of 16 or 32
//     real columns runs at n16 or n32; the form is chosen once a chunk,
//     never by a branch inside a whole chunk's k-steps.
//   * The ring (FwdWideLayout): as many slots as fit, up to six (f32 at C
//     = 2 two, 230,688 bytes; bf16 six up to C = 4, at one consumer
//     warpgroup four, so that two CTAs share an SM); the producers copy
//     step f while they finish step f - (slots - 2), so their work runs
//     beside the consumers' steps. The geometry refuses a head dim whose
//     two slots do not fit, or above ten chunks (f32 above 128, bf16 above
//     640).
//   * A kernel of its own beside window_attention.cu's, which stays as it
//     was at head dims up to 64: one template for both perturbed the
//     register allocation of the one-chunk instances (8-9% slower in f32
//     REGION at N = 343, PERF.md).
// The kernel reports its warps and shared memory through
// icl_window_attention_wide_fwd_geometry with its resident CTAs an SM.

#include "mma_tf32.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// The chunked tile-64 kernel.

constexpr int kRows64 = 64;  // query rows of a consumer warpgroup, a warp per 16
constexpr int kKeys64 = 32;  // keys a step
// Output chunks of a CTA: pair p of them, chunks kPair p and kPair p + 1
constexpr int kPair = 2;
__host__ __device__ inline int pair_ctas(int chunks) { return (chunks + kPair - 1) / kPair; }
// f32: the pair of consumer warpgroups on one block of rows, warpgroup j
// summing the partial scores of chunks j, j + kPair, ... (one chunk: f32
// takes two) and storing output chunk kPair p + j. bf16: up to kMaxGroups
// consumer warpgroups, each on 64 rows of its own, holding Q of every
// chunk (up to ten) and the accumulators of both output chunks.
constexpr int kMaxOwnF32 = 1;
constexpr int kMaxChunksBf16 = 10;
constexpr int kMaxGroups = 3;
// Producer warpgroups and registers a thread. f32: two producer
// warpgroups (the split and transposition of each step's tiles bound one:
// it took 7.9 ms of fs240 stage 1 alone, PERF.md), 128 registers at launch
// (4 warpgroups), the producers give 40 of their own to the consumers' 40
// each (producers at 80 and below spilled 8-104 bytes). bf16: one
// producer, 128 at launch (4 warpgroups), the producer gives 72 to the
// consumers' 24 each.
template <bool BF16>
struct Regs {
  static constexpr int kProducers = BF16 ? 1 : 2;
  static constexpr int kProducer = BF16 ? 56 : 88;
  static constexpr int kConsumer = BF16 ? 152 : 168;
  static constexpr int kThreads = 128 * ((BF16 ? kMaxGroups : kPair) + kProducers);  // at most
};
// named barriers: the producers', each consumer warpgroup's, then (f32)
// each pair of warps' (warp w of both consumer warpgroups) and each
// producer warpgroup's (its V transposition)
constexpr int kProducerBarrier = 1;
constexpr int kPairBarrier = kProducerBarrier + 1 + kMaxGroups;
constexpr int kTransposeBarrier = kPairBarrier + 4;
constexpr int kXchBytes = kRows64 * kKeys64 * 4;  // a warpgroup's partial S of a step, f32

// Shared memory of the kernel in bytes, from a 1024-aligned base (the
// swizzle's atoms; `total` has the kilobyte that aligns it), for a head
// dim of `chunks` 64-column chunks, `groups` consumer warpgroups (bf16; f32
// has the pair) and `slots` ring slots: each consumer warpgroup's Q tile
// of each of its chunks (f32: hi [64][64] as two [64][32] halves, then
// lo, 32 KB, of ceil(C / 2) chunks; bf16 [64][64], 8 KB, of every chunk;
// `q_chunk` apart); the ring, each slot K of every chunk (f32 hi and lo
// [32][32] x 2 each, 16 KB; bf16 [32][64], 4 KB; `k_chunk` apart), then V
// of the CTA's two output chunks from `v` (f32 V^T hi, V^T lo [64][32]
// each: V lands in the lo tile and is transposed in place; bf16 V
// [32][64]; `v_chunk` apart); f32's exchange, two buffers of each
// warpgroup's partial S; each slot's region ids of its 32 keys; each
// slot's two mbarriers (full, free).
struct FwdWideLayout {
  int q_chunk, q_tile, slots, k_chunk, k_lo, v, v_chunk, slot, xch, ids, bars, total;
  __host__ __device__ FwdWideLayout(bool bf16, int chunks, int groups, int slots_) {
    q_chunk = bf16 ? 8192 : 32768;
    q_tile = (bf16 ? chunks : pair_ctas(chunks)) * q_chunk;
    slots = slots_;
    k_chunk = bf16 ? 4096 : 16384;
    k_lo = 8192;
    v = chunks * k_chunk;
    v_chunk = bf16 ? 4096 : 16384;
    slot = v + kPair * v_chunk;
    xch = (bf16 ? groups : kPair) * q_tile + slots * slot;
    ids = xch + (bf16 ? 0 : 2 * kPair * kXchBytes);
    bars = ids + slots * kKeys64 * 4;
    total = bars + 2 * slots * 8 + 1024;
  }
};

// The consumer warpgroups of a CTA at windows of N tokens: f32 the pair;
// bf16 as many as divide the window's 64-row blocks without an empty one,
// up to kMaxGroups, whose layout with two slots fits a CTA's shared memory.
__host__ __device__ inline int wide_groups(int N, int chunks, bool bf16) {
  if (!bf16) return kPair;
  const int blocks = (N + kRows64 - 1) / kRows64;
  for (int g = kMaxGroups; g > 1; --g)
    if (blocks % g == 0 && FwdWideLayout(true, chunks, g, 2).total <= kMaxSmemBytes) return g;
  return 1;
}

// The most ring slots, up to kMaxSlots, that fit a CTA's shared memory
// (at least two: the geometry refuses a head dim whose two do not fit);
// bf16 with one consumer warpgroup up to kMaxSlotsShared, so that two CTAs
// share an SM (at N = 49, six slots kept it to one and ran 6% slower than
// a CTA a chunk).
constexpr int kMaxSlots = 6;
constexpr int kMaxSlotsShared = 4;
__host__ __device__ inline FwdWideLayout fwd_wide_layout(bool bf16, int chunks, int groups) {
  int slots = bf16 && groups == 1 ? kMaxSlotsShared : kMaxSlots;
  while (slots > 2 && FwdWideLayout(bf16, chunks, groups, slots).total > kMaxSmemBytes) --slots;
  return FwdWideLayout(bf16, chunks, groups, slots);
}

// cp.async.wait_group at a count known at run time, up to kMaxSlots - 2.
__device__ __forceinline__ void cp_async_wait_for(int groups) {
  switch (groups) {
    case 0: cp_async_wait_group<0>(); break;
    case 1: cp_async_wait_group<1>(); break;
    case 2: cp_async_wait_group<2>(); break;
    case 3: cp_async_wait_group<3>(); break;
    default: cp_async_wait_group<4>(); break;
  }
}

// The k-steps of 8 (TF32) and 16 (bf16) columns of the chunk whose first
// column is col0 that hold columns below d.
__device__ __forceinline__ int ksteps8(int d, int col0) { return min(8, (d - col0 + 7) >> 3); }
__device__ __forceinline__ int ksteps16(int d, int col0) { return min(4, (d - col0 + 15) >> 4); }

// f(0) .. f(K - 1), unrolled, or only those below kmax where kmax < K (the
// last chunk's k-steps past d): a whole chunk runs no guard.
template <int K, typename F>
__device__ __forceinline__ void unrolled(int kmax, F&& f) {
  if (kmax >= K) {
#pragma unroll
    for (int i = 0; i < K; ++i) f(i);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i < kmax) f(i);
  }
}

// d[64 x N] (+)= A[64 x 8] . B[8 x N], tf32, A from registers, B K-major,
// at N = 16 and 32: the first N / 2 accumulators of d (wgmma.cuh's n64
// layout).
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  if constexpr (N == 16)
    wgmma_tf32_rs_n16(d, a, b, scale_d);
  else if constexpr (N == 32)
    wgmma_tf32_rs_n32(d, a, b, scale_d);
  else
    wgmma_tf32_rs_n64(d, a, b, scale_d);
}

// pv = P.V of a step's 32 keys in 3xTF32 (the small terms first), from
// zero, for the first N columns of the chunk whose V^T hi and lo tiles
// `dv_hi` and `dv_lo` describe; P's k-step kk holds keys 8 kk .. 8 kk + 7
// in V^T's order. One group of products, waited for.
template <int N>
__device__ __forceinline__ void pv_tf32(float (&pv)[32], uint32_t (&ph)[4][4], uint32_t (&pl)[4][4], uint64_t dv_hi,
                                        uint64_t dv_lo) {
  fence_operands(pv);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_operands(ph[kk]);
    fence_operands(pl[kk]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs<N>(pv, pl[kk], desc_at(dv_hi, 32 * kk), kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs<N>(pv, ph[kk], desc_at(dv_lo, 32 * kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs<N>(pv, ph[kk], desc_at(dv_hi, 32 * kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_operands(ph[kk]);
    fence_operands(pl[kk]);
  }
}

// The f32 plain V tile [32][64]: chunk c of key row r at 16 (c ^ swz(r)),
// swz(r) = 2 ((r / 8) % 4) + r % 2, so that transpose_split's reads of the
// keys 8 a + 2 e + b (a < 4, b < 2) at one chunk hit 8 bank groups.
__device__ __forceinline__ int raw_chunk_at(int r, int c) {
  return r * 256 + ((c ^ (((r >> 2) & 6) | (r & 1))) << 4);
}

// x = hi + lo for a 3xTF32 product: hi = tf32(x), lo = x - hi exactly, its
// bits past TF32 dropped by the tensor cores (2^-22 of x at most), which
// saves the second rounding split() makes.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Rows of x [N, d] come in whole 16-byte chunks where d fills them and row
// 0 is 16-byte aligned; else value by value.
template <typename T>
__device__ __forceinline__ bool chunked16(const T* x, int d) {
  constexpr int kVals = 16 / sizeof(T);
  return d % kVals == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// The V values of row `row` of x [N, d] from column `col` as f32, 0 past N
// and d: from the landed f32 chunk `raw` where it was copied (`chunks`),
// else from x (bf16 reads only x: its copied chunks stay as they landed).
template <typename T, int V>
__device__ __forceinline__ void chunk_vals(float (&out)[V], const unsigned char* raw, const T* x, int row, int col,
                                           int N, int d, bool chunks) {
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = 0.f;
  if (row >= N || col >= d) return;
  if (chunks) {
    const float4 f = *reinterpret_cast<const float4*>(raw);
    out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (col + e < d) out[e] = to_float(x[static_cast<size_t>(row) * d + col + e]);
  }
}

// A tile of R rows of x [N, d] from row0, 64 values a row in 16-byte chunks,
// in the swizzled layout at `dst` (plain: f32 V's, raw_chunk_at), worked by
// `count` threads from `rank`: issue copies the whole chunks inside N and
// d; finish then (f32) splits them in place into hi (`dst`) and lo (`dst` +
// lo_offset), or (bf16) writes those inside N and d it did not copy, value
// by value. The thread that copied a chunk is the one that finishes it.
// Chunks past N or d are left as they are: zero from the kernel's start, or
// (rows past N) a finite earlier row, which a key's -inf or P = 0, or a
// row never stored, keeps out of every output; K's columns past d stay
// zero, so S has no term past d.
//
// At a head dim above 64 a tile holds the 64 columns from `col0` (a multiple
// of 64: one chunk, head_dim_chunks) of rows d values apart.
template <typename T>
struct Tile64 {
  static constexpr int kVals = 16 / sizeof(T);  // values a chunk
  static constexpr int kChunks = 64 / kVals;    // chunks a row
  const T* x;
  int row0, N, d;
  int col0;  // 0 at head dims up to 64
  __device__ void issue(unsigned char* dst, int R, bool plain, int rank, int count) const {
    if (!chunked16(x, d)) return;
    for (int i = rank; i < R * kChunks; i += count) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if (row0 + r < N && col0 + c * kVals < d)
        cp_async<16>(dst + (plain ? raw_chunk_at(r, c) : sw128_chunk(r, c, R)),
                     x + static_cast<size_t>(row0 + r) * d + col0 + c * kVals);
    }
  }
  __device__ void finish(unsigned char* dst, int lo_offset, int R, int rank, int count) const {
    const bool chunks = chunked16(x, d);
    // bf16 copied in whole chunks has nothing to finish (a pass over its
    // chunks took a quarter of fs240's stage 1, PERF.md)
    if (std::is_same<T, __nv_bfloat16>::value && chunks) return;
    for (int i = rank; i < R * kChunks; i += count) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if (row0 + r >= N || col0 + c * kVals >= d) continue;
      unsigned char* at = dst + sw128_chunk(r, c, R);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        float f[8];
        chunk_vals<T, 8>(f, at, x, row0 + r, col0 + c * kVals, N, d, false);
        __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(at);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      } else {
        float f[4];
        chunk_vals<T, 4>(f, at, x, row0 + r, col0 + c * kVals, N, d, chunks);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(f[e], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(at + lo_offset) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
};

// V^T [64 dims][32 keys] of the f32 V tile copied plain to `lo`
// (raw_chunk_at; read from x where its rows do not come in chunks), split
// into hi and lo: chunk cc of row n holds the keys 8 (cc / 2) + {0, 2, 4, 6}
// (cc even) or {1, 3, 5, 7} (cc odd); keys past N as 0, dims past d left as
// they are. A thread takes dims 4 nb .. 4 nb + 3 at chunk cc: four 16-byte
// reads of V, eight 16-byte writes; eight threads in a row take one nb and
// the eight cc, which puts both their reads and their writes on 8 bank
// groups. The dims are x's from `col0` (a head dim's chunk, Tile64). The
// plain tile is the lo tile itself (8 KB either way), so every thread
// reads its values before any writes, across named barrier `barrier` of
// the `count` (128: one item a thread) threads that run it.
template <typename T>
__device__ __forceinline__ void transpose_split(unsigned char* hi, unsigned char* lo, const T* x, int key0, int N,
                                                int d, int col0, int rank, int count, int barrier) {
  const unsigned char* raw = lo;
  const bool chunks = chunked16(x, d);
  for (int i = rank; i < 16 * 8; i += count) {
    const int cc = i & 7;
    const int nb = i >> 3;
    const bool dims = col0 + 4 * nb < d;  // dims past d: zero from the kernel's start
    float f[4][4];  // [key e][dim u]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * (cc >> 1) + 2 * e + (cc & 1);
      const int row = key0 + key;
#pragma unroll
      for (int u = 0; u < 4; ++u) f[e][u] = 0.f;
      if (row >= N || !dims) continue;
      if (chunks) {
        const float4 v = *reinterpret_cast<const float4*>(raw + raw_chunk_at(key, nb));
        f[e][0] = v.x, f[e][1] = v.y, f[e][2] = v.z, f[e][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col0 + 4 * nb + u < d) f[e][u] = to_float(x[static_cast<size_t>(row) * d + col0 + 4 * nb + u]);
      }
    }
    named_barrier(barrier, count);
    if (!dims) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(f[e][u], h[e], l[e]);
      const int at = sw128_chunk(4 * nb + u, cc, 64);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// Head dims above 64, in chunks of 64 columns (head_dim_chunks): the CTA's
// pair of output chunks is blockIdx.x % pair_ctas(chunks), its blocks of
// rows (f32: one; bf16: one a consumer warpgroup) blockIdx.x /
// pair_ctas(chunks).
template <typename T, int MODE, bool LSE>
__global__ void __launch_bounds__(Regs<std::is_same<T, __nv_bfloat16>::value>::kThreads, 1)
window_attention64_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const float* __restrict__ terms, const float* __restrict__ region_ids,
                          T* __restrict__ out, float* __restrict__ lse, int B, int H, int N, int d, int nW,
                          int windows_per_cta, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kPaired = !kBf16;  // f32: the pair on one block of rows
  constexpr int kMaxOwn = kPaired ? kMaxOwnF32 : kMaxChunksBf16;
  constexpr int kOuts = kPaired ? 1 : kPair;  // output chunks a warpgroup stores
  constexpr int kSteps = kBf16 ? 4 : 8;       // k-steps of a whole chunk's S product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (shared_addr(smem_raw) & 1023)) & 1023);
  const int steps = (N + kKeys64 - 1) / kKeys64;
  const int P = steps * kKeys64;  // the term array's rows, N padded to the steps
  const int Np = (N + 15) & ~15;
  const int chunks = head_dim_chunks(d);
  const int pairs = pair_ctas(chunks);
  const int pair = blockIdx.x % pairs;  // the CTA's output chunks: kPair pair and kPair pair + 1
  constexpr int kProducerThreads = 128 * Regs<kBf16>::kProducers;
  const int groups = blockDim.x / 128 - Regs<kBf16>::kProducers;  // consumer warpgroups; the last ones produce
  const FwdWideLayout L = fwd_wide_layout(kBf16, chunks, groups);
  const int tid = threadIdx.x;
  // the warpgroup, read from lane 0 so that the compiler knows it is the
  // same across the warp: branches on it (and on what a warpgroup owns)
  // are then uniform, and keep its products from being serialized
  const int wg = __shfl_sync(kFullMask, tid / 128, 0);
  const int r0 = blockIdx.x / pairs * kRows64 * (kPaired ? 1 : groups);  // the CTA's rows
  const int h = blockIdx.y;
  const int b_begin = blockIdx.z * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);
  if (b_begin >= b_end) return;
  const int total = (b_end - b_begin) * steps;
  auto slot_at = [&](int f) { return smem + groups * L.q_tile + (f % L.slots) * L.slot; };
  auto ids_at = [&](int f) { return reinterpret_cast<float*>(smem + L.ids) + (f % L.slots) * kKeys64; };
  auto full_bar = [&](int f) { return shared_addr(smem + L.bars + 16 * (f % L.slots)); };
  auto free_bar = [&](int f) { return shared_addr(smem + L.bars + 16 * (f % L.slots) + 8); };
  auto base_of = [&](int b) { return (static_cast<size_t>(b) * H + h) * N * d; };
  auto window_of = [&](int f) { return b_begin + f / steps; };

  // Q and the ring start zero (Tile64)
  for (int i = tid; i < L.ids / 16; i += blockDim.x) reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0)
    for (int s = 0; s < L.slots; ++s) {
      mbar_init(full_bar(s), kProducerThreads);  // the producers' threads
      mbar_init(free_bar(s), 128 * groups);      // every consumer thread
    }
  __syncthreads();

  if (wg >= groups) {
    // The producers: K of every chunk and V of the CTA's output chunks of
    // each step (and the window's region ids) into the ring, f32 split (V
    // transposed, a producer warpgroup a chunk), ahead of the consumers and
    // at most `slots` steps ahead of the slowest.
    setmaxnreg_dec<Regs<kBf16>::kProducer>();
    const int rank = tid - 128 * groups;
    auto issue = [&](int f) {
      const int b = window_of(f);
      const int key0 = kKeys64 * (f % steps);
      mbar_wait(free_bar(f), ((f / L.slots) & 1) ^ 1);  // the slot's last step, f - slots, done
      for (int j = 0; j < chunks; ++j) {  // K of every chunk
        const Tile64<T> kt{k + base_of(b), key0, N, d, kRows64 * j};
        kt.issue(slot_at(f) + j * L.k_chunk, kKeys64, false, rank, kProducerThreads);
      }
      for (int j = 0; j < kPair && kPair * pair + j < chunks; ++j) {  // V of the CTA's chunks
        const Tile64<T> vt{v + base_of(b), key0, N, d, kRows64 * (kPair * pair + j)};
        vt.issue(slot_at(f) + L.v + j * L.v_chunk + (kBf16 ? 0 : 8192), kKeys64, !kBf16, rank,
                 kProducerThreads);  // f32: plain, into V^T lo
      }
      if (MODE == kRegion && rank < kKeys64 && key0 + rank < N)  // the step's keys' ids
        cp_async<4>(ids_at(f) + rank, region_ids + static_cast<size_t>(b % nW) * N + key0 + rank);
      cp_async_commit();
    };
    auto finish = [&](int f) {
      const int b = window_of(f);
      const int key0 = kKeys64 * (f % steps);
      for (int j = 0; j < chunks; ++j) {
        const Tile64<T> kt{k + base_of(b), key0, N, d, kRows64 * j};
        kt.finish(slot_at(f) + j * L.k_chunk, L.k_lo, kKeys64, rank, kProducerThreads);
      }
      for (int j = 0; j < kPair && kPair * pair + j < chunks; ++j) {
        const int col0 = kRows64 * (kPair * pair + j);
        unsigned char* vt = slot_at(f) + L.v + j * L.v_chunk;
        if constexpr (kBf16) {
          Tile64<T>{v + base_of(b), key0, N, d, col0}.finish(vt, 0, kKeys64, rank, kProducerThreads);
        } else if (j == rank / 128) {  // producer warpgroup j transposes V of chunk j
          transpose_split(vt, vt + 8192, v + base_of(b), key0, N, d, col0, rank % 128, 128, kTransposeBarrier + j);
        }
      }
      fence_proxy_async();  // the tiles, to the products' proxy
      mbar_arrive(full_bar(f));
    };
    // Step f's copies go out (into its own slot) before step f - lag is
    // finished: the consumers hold one slot and the producer the rest, so
    // the copies of `lag` steps are in flight while one is finished, and
    // the producer works beside the consumers, not between their steps.
    const int lag = L.slots - 2;
    for (int f = 0; f < total + lag; ++f) {
      if (f < total) issue(f);
      const int g = f - lag;
      if (g >= 0) {
        cp_async_wait_for(min(lag, total - 1 - g));  // the groups issued after step g's
        named_barrier(kProducerBarrier, kProducerThreads);  // step g landed, every thread's copies
        finish(g);
      }
    }
    return;
  }

  // The consumers. Warpgroup wg owns rows w0 .. w0 + 63, warp `warp` of it
  // 16 of them; lane (g, t) rows rows[0] and rows[1]. It holds Q of chunks
  // c0, c0 + cstep, ... (`own` of them) and stores output chunks oc0 + k,
  // k < kOuts, where there are such chunks.
  setmaxnreg_inc<Regs<kBf16>::kConsumer>();
  const int rank = tid - 128 * wg;
  const int warp = rank / 32;
  const int lane = rank % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = kPaired ? r0 : r0 + kRows64 * wg;
  const int rows[2] = {w0 + 16 * warp + g, w0 + 16 * warp + g + 8};
  const int c0 = kPaired ? wg : 0;
  const int cstep = kPaired ? kPair : 1;
  const int own = kPaired ? (chunks - wg + kPair - 1) / kPair : chunks;
  const int oc0 = kPair * pair + (kPaired ? wg : 0);
  auto stores = [&](int k) { return oc0 + k < chunks; };
  // the k-steps of this warpgroup's last chunk that hold columns below d
  const int last_col0 = kRows64 * (c0 + cstep * (own - 1));
  const int kmax = kBf16 ? ksteps16(d, last_col0) : ksteps8(d, last_col0);
  // f32's P.V at the output chunk's real columns, rounded up to 16, 32 or 64
  const int width = stores(0) ? min(kRows64, d - kRows64 * oc0) : kRows64;
  const int nw = width <= 16 ? 16 : width <= 32 ? 32 : 64;
  unsigned char* q_tile = smem + wg * L.q_tile;  // each chunk's (f32: hi, then lo 16 KB on), q_chunk apart
  const uint64_t dq_hi = sw128_desc(shared_addr(q_tile));
  const uint64_t dq_lo = sw128_desc(shared_addr(q_tile + 16384));
  // Q of window b: its chunks' copies issued, or split in place by the threads that copied them
  auto q_issue = [&](int b) {
    for (int i = 0; i < own; ++i)
      Tile64<T>{q + base_of(b), w0, N, d, kRows64 * (c0 + cstep * i)}.issue(q_tile + i * L.q_chunk, kRows64, false,
                                                                           rank, 128);
  };
  auto q_finish = [&](int b) {
    for (int i = 0; i < own; ++i)
      Tile64<T>{q + base_of(b), w0, N, d, kRows64 * (c0 + cstep * i)}.finish(q_tile + i * L.q_chunk, 16384,
                                                                            kRows64, rank, 128);
  };
  q_issue(b_begin);
  cp_async_commit();

  // o: each output chunk's accumulator; f32 adds each step's pv to it,
  // bf16 rescales it and adds the step's products in place
  float o[kOuts][32], pv[kPaired ? 32 : 1], s[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int c = 0; c < kOuts; ++c) o[c][i] = 0.f;
    if constexpr (kPaired) pv[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's keys' share of the row sum
  float id_row[2] = {0.f, 0.f};
  const float* plane = terms;

  for (int f = 0; f < total; ++f) {
    const int wi = f / steps;  // the window's place in the group
    const int b = b_begin + wi;
    const int j = f - wi * steps;  // the key step
    const int key0 = kKeys64 * j;
    const bool last = j == steps - 1;
    if (j == 0) {  // the window's Q, split in place by the threads that copied it
      cp_async_wait_group<0>();
      q_finish(b);
      fence_proxy_async();
      named_barrier(kProducerBarrier + 1 + wg, 128);
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int c = 0; c < kOuts; ++c) o[c][i] = 0.f;
      plane = terms + (static_cast<size_t>(MODE == kMask ? b % nW : 0) * H + h) * Np * P;
    }
    if (MODE == kRegion && j == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        id_row[r] = rows[r] < N ? __ldg(region_ids + static_cast<size_t>(b % nW) * N + rows[r]) : 0.f;
    mbar_wait(full_bar(f), (f / L.slots) & 1);  // step f's K, V (and key ids) staged
    const float* ids = ids_at(f);

    // S = Q.K^T of the 64 rows and 32 keys over this warpgroup's chunks
    // (f32: its partial S_wg), one group of products, the first from zero
    unsigned char* slot = slot_at(f);
    auto products = [&](int i, int ksteps) {  // own chunk i, its first `ksteps` k-steps
      const int c = c0 + cstep * i;
      const uint64_t dk_hi = sw128_desc(shared_addr(slot + c * L.k_chunk));
      const uint64_t dqi_hi = desc_at(dq_hi, i * L.q_chunk);
      if constexpr (kBf16) {
        unrolled<4>(ksteps, [&](int kk) {
          wgmma_bf16_ss_n32(s, desc_at(dqi_hi, 32 * kk), desc_at(dk_hi, 32 * kk), kk + i);
        });
      } else {
        const uint64_t dqi_lo = desc_at(dq_lo, i * L.q_chunk);
        const uint64_t dk_lo = desc_at(dk_hi, L.k_lo);
        // k-step kk: dims 8 kk .. 8 kk + 7, in the half of dims 32 (kk / 4) ..
        auto qk = [](int kk) { return (kk >> 2) * kRows64 * 128 + 32 * (kk & 3); };
        auto kk_at = [](int kk) { return (kk >> 2) * kKeys64 * 128 + 32 * (kk & 3); };
        unrolled<8>(ksteps, [&](int kk) {
          wgmma_tf32_ss_n32(s, desc_at(dqi_lo, qk(kk)), desc_at(dk_hi, kk_at(kk)), kk + i);
        });
        unrolled<8>(ksteps, [&](int kk) {
          wgmma_tf32_ss_n32(s, desc_at(dqi_hi, qk(kk)), desc_at(dk_lo, kk_at(kk)), 1);
        });
        unrolled<8>(ksteps, [&](int kk) {
          wgmma_tf32_ss_n32(s, desc_at(dqi_hi, qk(kk)), desc_at(dk_hi, kk_at(kk)), 1);
        });
      }
    };
    fence_operands(s);
    wgmma_fence();
    products(0, own == 1 ? kmax : kSteps);
#pragma unroll
    for (int i = 1; i < kMaxOwn; ++i)  // bf16
      if (i < own) products(i, i + 1 == own ? kmax : kSteps);
    wgmma_commit();
    // the terms of this lane's rows at its eight keys (two chunks of the
    // permuted term array), from L2 while the products run
    float4 tm[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        tm[r][c] = rows[r] < N ? __ldg(reinterpret_cast<const float4*>(plane + static_cast<size_t>(rows[r]) * P +
                                                                        key0 + 8 * t + 4 * c))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    wgmma_wait<0>();
    fence_operands(s);
    if (last && b + 1 < b_end) {  // every warp of the group is done with Q: the next window's
      named_barrier(kProducerBarrier + 1 + wg, 128);
      q_issue(b + 1);
      cp_async_commit();
    }

    if constexpr (kPaired) {
      // S = S_0 + S_1 through the pair's exchange: this lane's partial out,
      // the other warpgroup's lane of the same rank in (the buffer of this
      // step's parity; the pair's barrier of the next step orders its reuse)
      float4* x = reinterpret_cast<float4*>(smem + L.xch + (f & 1) * kPair * kXchBytes);
      float4* mine = x + wg * (kXchBytes / 16);
      const float4* theirs = x + (1 - wg) * (kXchBytes / 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[128 * i + rank] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      named_barrier(kPairBarrier + warp, 2 * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 y = theirs[128 * i + rank];
        s[4 * i] += y.x, s[4 * i + 1] += y.y, s[4 * i + 2] += y.z, s[4 * i + 3] += y.w;
      }
    }

    // the online softmax; s[4 jn + 2 r + e] is row rows[r] at key key0 + 8 jn + 2 t + e
    float corr[2];
    const bool whole = key0 + kKeys64 <= N;  // no padded key in the step
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int key = key0 + 8 * jn + 2 * t;
      const float2 id_key = id_pair<MODE>(ids, 8 * jn + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 c = tm[r][jn >> 1];
          float term = (jn & 1) ? (e ? c.w : c.z) : (e ? c.y : c.x);
          if (!whole && key + e >= N) term = -INFINITY;
          float& x = s[4 * jn + 2 * r + e];
          x = logit<MODE>(x, term, rows[r] < N && (whole || key + e < N), id_row[r], e ? id_key.y : id_key.x,
                          scale);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float top = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) top = fmaxf(top, fmaxf(s[4 * jn + 2 * r], s[4 * jn + 2 * r + 1]));
      top = fmaxf(top, __shfl_xor_sync(kFullMask, top, 1));
      top = fmaxf(top, __shfl_xor_sync(kFullMask, top, 2));
      const float m_new = fmaxf(m[r], top);
      const float m_ref = finite_or_zero(m_new);
      corr[r] = __expf(m[r] - m_ref);
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * jn + 2 * r + e];
          x = __expf(x - m_ref);
          sum += x;
        }
      l[r] = fmaf(l[r], corr[r], sum);
      m[r] = m_new;
    }

    // P.V of the step's 32 keys for each output chunk
    unsigned char* vt = slot + L.v + (kPaired ? wg : 0) * L.v_chunk;
    if constexpr (kBf16) {
      // o = o corr + P.V, the products added in place
      uint32_t ph[2][4], pl[2][4];  // k-step kk: keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e], pl[kk][e]);
#pragma unroll
      for (int c = 0; c < kOuts; ++c) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
        fence_operands(o[c]);
      }
      fence_operands(ph[0]);
      fence_operands(ph[1]);
      fence_operands(pl[0]);
      fence_operands(pl[1]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kOuts; ++c) {
        if (!stores(c)) continue;
        const uint64_t dv = sw128_desc(shared_addr(vt + c * L.v_chunk));
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_bf16_rs_n64(o[c], pl[kk], desc_at(dv, 2048 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) wgmma_bf16_rs_n64(o[c], ph[kk], desc_at(dv, 2048 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(ph[0]);
      fence_operands(ph[1]);
      fence_operands(pl[0]);
      fence_operands(pl[1]);
#pragma unroll
      for (int c = 0; c < kOuts; ++c) fence_operands(o[c]);
      mbar_arrive(free_bar(f));  // this thread is done with the slot
    } else {
      // pv = P.V_oc from zero, then o = o corr + pv
      if (stores(0)) {
        // k-step kk: keys 8 kk .. 8 kk + 7 in V^T's order 0, 2, 4, 6, 1, 3, 5, 7
        uint32_t ph[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int from[4] = {0, 2, 1, 3};
#pragma unroll
          for (int e = 0; e < 4; ++e) split<false>(s[4 * kk + from[e]], ph[kk][e], pl[kk][e]);
        }
        const uint64_t dv_hi = sw128_desc(shared_addr(vt));
        const uint64_t dv_lo = sw128_desc(shared_addr(vt + 8192));
        if (nw == 16)
          pv_tf32<16>(pv, ph, pl, dv_hi, dv_lo);
        else if (nw == 32)
          pv_tf32<32>(pv, ph, pl, dv_hi, dv_lo);
        else
          pv_tf32<64>(pv, ph, pl, dv_hi, dv_lo);
        fence_operands(pv);
      }
      mbar_arrive(free_bar(f));  // this thread is done with the slot
#pragma unroll
      for (int i = 0; i < 32; ++i) o[0][i] = fmaf(o[0][i], corr[(i >> 1) & 1], pv[i]);
    }

    if (last) {
      const size_t base = base_of(b);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the quad's row sum; a + b == b + a, so every lane ends with the same bits
        l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
        l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
        if (rows[r] >= N) continue;
        const float inv = 1.f / l[r];
#pragma unroll
        for (int c = 0; c < kOuts; ++c) {
          if (!stores(c)) continue;
          const int col0 = kRows64 * (oc0 + c);
          T* orow = out + base + static_cast<size_t>(rows[r]) * d + col0;
#pragma unroll
          for (int nn = 0; nn < 8; ++nn)
            store_cols<T>(orow, 8 * nn + 2 * t, d - col0, o[c][4 * nn + 2 * r] * inv, o[c][4 * nn + 2 * r + 1] * inv);
        }
        // l is relative to m, the row's max, finite at a real row; one
        // warpgroup of pair 0 stores each row's
        if (LSE && t == 0 && oc0 == 0) lse[(static_cast<size_t>(b) * H + h) * N + rows[r]] = m[r] + __logf(l[r]);
      }
    }
  }
}


// Shared memory and warps of a CTA at windows of N tokens and head dim d.
size_t smem_bytes(int N, bool bf16, int d) {
  const int chunks = head_dim_chunks(d);
  return static_cast<size_t>(fwd_wide_layout(bf16, chunks, wide_groups(N, chunks, bf16)).total);
}

int cta_warps(int N, bool bf16, int d) {
  return 4 * (wide_groups(N, head_dim_chunks(d), bf16) + (bf16 ? Regs<true>::kProducers : Regs<false>::kProducers));
}

// Whether the kernel takes head dim d: a warpgroup's chunks within its
// registers' reach (f32 two chunks, bf16 ten); the geometry's occupancy
// refuses a layout that does not fit a CTA's shared memory.
bool takes(bool bf16, int d) {
  return bf16 ? head_dim_chunks(d) <= kMaxChunksBf16 : pair_ctas(head_dim_chunks(d)) <= kMaxOwnF32;
}

// Allow `kernel` `smem` bytes of shared memory before a launch.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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
    *ctas = 0;
    return cudaSuccess;
  }
  err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads, smem);
}

template <typename T, int MODE>
cudaError_t occupancy(int N, int d, int* ctas) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (!takes(kBf16, d)) {
    *ctas = 0;
    return cudaSuccess;
  }
  return fit(window_attention64_wide_kernel<T, MODE, false>, smem_bytes(N, kBf16, d), cta_warps(N, kBf16, d) * 32,
             ctas);
}

template <typename T>
cudaError_t occupancy_mode(int N, int d, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, kRegion>(N, d, ctas);
  if (has_mask) return occupancy<T, kMask>(N, d, ctas);
  return occupancy<T, kNone>(N, d, ctas);
}

// The pointers and sizes of one forward call.
struct Args {
  const void *q, *k, *v;
  const float *bias, *region_ids, *mask;
  void* out;
  float *lse, *terms;
  int B, H, N, d, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

// The term array, then the kernel over (row blocks x pairs of output
// chunks, heads, window groups), in stream order.
template <typename T, int MODE, bool LSE>
cudaError_t launch(const Args& a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (!takes(kBf16, a.d)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.N, kBf16, a.d);
  auto kernel = window_attention64_wide_kernel<T, MODE, LSE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int Np = (a.N + 15) / 16 * 16;
  err = launch_terms(a.bias, MODE == kMask ? a.mask : nullptr, a.terms, MODE == kMask ? a.nW : 1, a.H, a.N, Np,
                     (a.N + kKeys64 - 1) / kKeys64 * kKeys64, true, a.stream);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  const int chunks = head_dim_chunks(a.d);
  const int cta_rows = kRows64 * (kBf16 ? wide_groups(a.N, chunks, true) : 1);
  kernel<<<dim3((a.N + cta_rows - 1) / cta_rows * pair_ctas(chunks), a.H, groups), cta_warps(a.N, kBf16, a.d) * 32,
           smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.terms, a.region_ids,
      static_cast<T*>(a.out), a.lse, a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  return cudaGetLastError();
}

template <typename T, bool LSE>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, kRegion, LSE>(a);
  if (a.mask != nullptr) return launch<T, kMask, LSE>(a);
  return launch<T, kNone, LSE>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when every launch was accepted. As
// icl_window_attention_fwd (window_attention.cu) at tile 64, for a head dim
// D above 64 (run in head_dim_chunks(D) chunks; a smaller D, or one whose
// geometry does not fit, is refused): `region_ids` set selects REGION,
// else `mask` set selects MASK, else NONE; `is_bf16` the input type; a
// scratch `terms` [T, H, Np, P] f32 (T = nW in MASK, else 1; Np = N padded
// to a multiple of 16, P to a multiple of 32) for the term array; where
// `lse` is set the row log-sum-exp [B, H, N] f32 of the scaled logits is
// stored there. A CTA takes `windows_per_cta` windows of its blocks of 64
// rows (f32: one; bf16: one a consumer warpgroup) and one pair of 64-column
// chunks of the output of one head; its width and shared memory are those
// icl_window_attention_wide_fwd_geometry reports.
int icl_window_attention_wide_fwd(const void* q, const void* k, const void* v, const void* bias,
                                  const void* region_ids, const void* mask, void* out, void* lse, void* terms,
                                  int B, int H, int N, int D, int nW, int windows_per_cta, float scale,
                                  int is_bf16, void* stream) {
  if (windows_per_cta < 1 || N < 1 || D <= 64 || terms == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(bias), static_cast<const float*>(region_ids),
               static_cast<const float*>(mask), out, static_cast<float*>(lse), static_cast<float*>(terms),
               B, H, N, D, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  if (lse != nullptr) return is_bf16 ? launch_mode<__nv_bfloat16, true>(a) : launch_mode<float, true>(a);
  return is_bf16 ? launch_mode<__nv_bfloat16, false>(a) : launch_mode<float, false>(a);
}

// The launch geometry at windows of N tokens and head dim D (above 64), in
// the mode that `has_ids` (REGION), else `has_mask` (MASK), else neither
// (NONE) selects, and the type `is_bf16` selects: the warps of a CTA, its
// shared memory in bytes, and how many such CTAs one SM of the current
// device holds, 0 when the window does not fit. Returns a cudaError_t.
int icl_window_attention_wide_fwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                           int* smem, int* ctas) {
  if (N < 1 || D <= 64) return cudaErrorInvalidValue;
  *warps = cta_warps(N, is_bf16 != 0, D);
  *smem = static_cast<int>(smem_bytes(N, is_bf16 != 0, D));
  return is_bf16 ? occupancy_mode<__nv_bfloat16>(N, D, has_ids, has_mask, ctas)
                 : occupancy_mode<float>(N, D, has_ids, has_mask, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
