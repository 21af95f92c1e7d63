// Fused window attention forward for Hopper (sm_90a) at head dims above
// 64, on tensor cores: the tile-64 kernel of window_attention.cu
// (window_attention64_kernel, whose note this one follows) walking the head
// dim in C = ceil(d / 64) chunks of 64 columns.
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
//
// Design (kept from the tile-64 kernel: the producer warpgroup and up to
// three consumer warpgroups of 64 rows on an mbarrier ring of 32-key
// slots, wgmma in the 3xTF32 split or bf16, V^T with its keys permuted so
// that S's accumulator is P.V's A fragment, each step's P.V summed from
// zero and added in f32, the term array, padded keys at -inf, no atomics,
// bitwise repeatable):
//   * the grid's row blocks times C: a CTA owns one chunk c of the
//     output's columns. Each sums S = sum_j Q_j.K_j^T over all C chunks (a
//     group of products a chunk, waited for before the next, so that none
//     is in flight across the runtime loop), runs the same online softmax,
//     and stores O_c = P.V_c. The C CTAs of a row block recompute the same
//     S: the work of the function plus (C - 1) of its S products, about
//     1.5x its products at C = 2. Only chunk 0's CTAs store the row
//     log-sum-exp (the instance LSE).
//   * shared memory (Fwd64Layout): each consumer's Q tile of every chunk,
//     and each ring slot K of every chunk but V of the CTA's own. In f32 V
//     lands in its slot's V^T lo tile and is transposed in place (the
//     producer's threads all read before any writes), so no plain V tile
//     takes room: at C = 2 two consumer warpgroups fit with two slots (Q
//     128 KB, slots of 48 KB, 230,688 bytes) where N's row blocks come in
//     twos (N 343, 216), else one with three slots (214,448); bf16 keeps
//     three warpgroups up to C = 5. groups64 picks the most that fit, and
//     the geometry refuses a head dim none fits (f32 above 128, bf16 above
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

constexpr int kRows64 = 64;      // query rows of a consumer warpgroup, a warp per 16
constexpr int kKeys64 = 32;      // keys a step
constexpr int kMaxGroups64 = 3;  // consumer warpgroups of a CTA at most
// Registers a thread: 128 at launch (4 warpgroups), the producer gives 72
// of its own to the consumers' 24 each (three of them). At 32 and 160 the
// producer spilled 88-112 bytes and ran slower.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 152;
constexpr int kProducerBarrier = 1;  // named barriers: the producer's, then each consumer's

// Shared memory of the kernel in bytes, from a 1024-aligned base (the
// swizzle's atoms; `total` has the kilobyte that aligns it), for `groups`
// consumer warpgroups and a head dim of `chunks` 64-column chunks: each
// group's Q tile of each chunk (f32: hi [64][64] as two [64][32] halves,
// then lo, 32 KB; bf16 [64][64], 8 KB; `q_chunk` apart); a ring of `slots`
// slots, each K of every chunk (f32 hi and lo [32][32] x 2 each, 16 KB;
// bf16 [32][64], 4 KB; `k_chunk` apart), then V of the CTA's own chunk (f32
// V^T hi, V^T lo [64][32] each: V lands in the lo tile and is transposed in
// place; bf16 V [32][64]); each slot's region ids of its 32 keys; each
// slot's two mbarriers (full, free). Independent of N.
struct Fwd64Layout {
  int q_chunk, q_tile, slots, k_chunk, slot, k_lo, v_hi, v_lo, ids, bars, total;
  __host__ __device__ Fwd64Layout(int groups, bool bf16, int chunks) {
    q_chunk = bf16 ? 8192 : 32768;
    q_tile = chunks * q_chunk;
    slots = !bf16 && groups > 1 ? 2 : 3;  // f32: two let a second group fit
    k_chunk = bf16 ? 4096 : 16384;
    k_lo = 8192;
    v_hi = chunks * k_chunk;
    v_lo = v_hi + 8192;
    slot = v_hi + (bf16 ? 4096 : 16384);
    ids = groups * q_tile + slots * slot;
    bars = ids + slots * kKeys64 * 4;
    total = bars + 2 * slots * 8 + 1024;
  }
};

// Consumer warpgroups of a CTA at windows of N tokens: they share each
// staged K and V tile, so as many as divide the window's 64-row blocks
// without an empty one, up to 3, whose Q tiles and ring fit a CTA's shared
// memory (f32 at 2 chunks: 2 at N = 343 and 216, else 1; 1 where none fits,
// which the geometry then refuses).
__host__ __device__ inline int groups64(int N, int chunks, bool bf16) {
  const int blocks = (N + kRows64 - 1) / kRows64;
  for (int g = kMaxGroups64; g > 1; --g)
    if (blocks % g == 0 && Fwd64Layout(g, bf16, chunks).total <= kMaxSmemBytes) return g;
  return 1;
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
    for (int i = rank; i < R * kChunks; i += count) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if (row0 + r >= N || col0 + c * kVals >= d) continue;
      unsigned char* at = dst + sw128_chunk(r, c, R);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (chunks) continue;  // copied
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
// reads its values before any writes, across one named barrier of the
// `count` (128: one item a thread) producer threads.
template <typename T>
__device__ __forceinline__ void transpose_split(unsigned char* hi, unsigned char* lo, const T* x, int key0, int N,
                                                int d, int col0, int rank, int count) {
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
    named_barrier(kProducerBarrier, count);
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
// chunk c is blockIdx.x % chunks, its rows' block blockIdx.x / chunks. S
// sums Q.K^T over every chunk, and the CTA stores the 64 columns of O = P.V
// from 64 c; the chunks' CTAs compute the same P, so only chunk 0's store
// the log-sum-exp.
template <typename T, int MODE, bool LSE>
__global__ void __launch_bounds__((kMaxGroups64 + 1) * 128, 1)
window_attention64_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const float* __restrict__ terms, const float* __restrict__ region_ids,
                          T* __restrict__ out, float* __restrict__ lse, int B, int H, int N, int d, int nW,
                          int windows_per_cta, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (shared_addr(smem_raw) & 1023)) & 1023);
  const int steps = (N + kKeys64 - 1) / kKeys64;
  const int P = steps * kKeys64;  // the term array's rows, N padded to the steps
  const int Np = (N + 15) & ~15;
  const int groups = blockDim.x / 128 - 1;  // consumer warpgroups; the last one produces
  const int chunks = head_dim_chunks(d);
  const int chunk = blockIdx.x % chunks;  // the CTA's columns of O
  const int col0 = kRows64 * chunk;
  const Fwd64Layout L(groups, kBf16, chunks);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int r0 = blockIdx.x / chunks * kRows64 * groups;  // the CTA's rows
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
      mbar_init(full_bar(s), 128);           // the producer's threads
      mbar_init(free_bar(s), 128 * groups);  // every consumer thread
    }
  __syncthreads();

  if (wg == groups) {
    // The producer: K and V of each step (and the window's region ids)
    // into the ring, f32 split (V transposed), a step ahead of the
    // consumers and at most `slots` steps ahead of the slowest.
    setmaxnreg_dec<kProducerRegs>();
    const int rank = tid - 128 * groups;
    auto issue = [&](int f) {
      const int b = window_of(f);
      const int key0 = kKeys64 * (f % steps);
      mbar_wait(free_bar(f), ((f / L.slots) & 1) ^ 1);  // the slot's last step, f - slots, done
      for (int j = 0; j < chunks; ++j) {  // K of every chunk
        const Tile64<T> kt{k + base_of(b), key0, N, d, kRows64 * j};
        kt.issue(slot_at(f) + j * L.k_chunk, kKeys64, false, rank, 128);
      }
      const Tile64<T> vt{v + base_of(b), key0, N, d, col0};  // V of the CTA's chunk
      vt.issue(slot_at(f) + (kBf16 ? L.v_hi : L.v_lo), kKeys64, !kBf16, rank, 128);  // f32: plain, into V^T lo
      if (MODE == kRegion && rank < kKeys64 && key0 + rank < N)  // the step's keys' ids
        cp_async<4>(ids_at(f) + rank, region_ids + static_cast<size_t>(b % nW) * N + key0 + rank);
      cp_async_commit();
    };
    auto finish = [&](int f) {
      const int b = window_of(f);
      const int key0 = kKeys64 * (f % steps);
      for (int j = 0; j < chunks; ++j) {
        const Tile64<T> kt{k + base_of(b), key0, N, d, kRows64 * j};
        kt.finish(slot_at(f) + j * L.k_chunk, L.k_lo, kKeys64, rank, 128);
      }
      if constexpr (kBf16) {
        const Tile64<T> vt{v + base_of(b), key0, N, d, col0};
        vt.finish(slot_at(f) + L.v_hi, 0, kKeys64, rank, 128);
      } else {
        transpose_split(slot_at(f) + L.v_hi, slot_at(f) + L.v_lo, v + base_of(b), key0, N, d, col0, rank, 128);
      }
      fence_proxy_async();  // the tiles, to the products' proxy
      mbar_arrive(full_bar(f));
    };
    // Step f's copies go out (into its own slot) before step f - 1 is finished.
    for (int f = 0; f <= total; ++f) {
      if (f < total) issue(f);
      if (f > 0) {
        if (f < total)
          cp_async_wait_group<1>();
        else
          cp_async_wait_group<0>();
        named_barrier(kProducerBarrier, 128);  // step f - 1 landed, every thread's copies
        finish(f - 1);
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns rows w0 .. w0 + 63, warp `warp` of it
  // 16 of them; lane (g, t) rows rows[0] and rows[1].
  setmaxnreg_inc<kConsumerRegs>();
  const int rank = tid - 128 * wg;
  const int warp = rank / 32;
  const int lane = rank % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = r0 + kRows64 * wg;
  const int rows[2] = {w0 + 16 * warp + g, w0 + 16 * warp + g + 8};
  unsigned char* q_tile = smem + wg * L.q_tile;  // each chunk's (f32: hi, then lo 16 KB on), q_chunk apart
  const uint64_t dq_hi = sw128_desc(shared_addr(q_tile));
  const uint64_t dq_lo = sw128_desc(shared_addr(q_tile + 16384));
  // Q of window b: its chunks' copies issued, or split in place by the threads that copied them
  auto q_issue = [&](int b) {
    for (int j = 0; j < chunks; ++j)
      Tile64<T>{q + base_of(b), w0, N, d, kRows64 * j}.issue(q_tile + j * L.q_chunk, kRows64, false, rank, 128);
  };
  auto q_finish = [&](int b) {
    for (int j = 0; j < chunks; ++j)
      Tile64<T>{q + base_of(b), w0, N, d, kRows64 * j}.finish(q_tile + j * L.q_chunk, 16384, kRows64, rank, 128);
  };
  q_issue(b_begin);
  cp_async_commit();

  float o[32], pv[32], s[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = pv[i] = 0.f;
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
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      plane = terms + (static_cast<size_t>(MODE == kMask ? b % nW : 0) * H + h) * Np * P;
    }
    if (MODE == kRegion && j == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        id_row[r] = rows[r] < N ? __ldg(region_ids + static_cast<size_t>(b % nW) * N + rows[r]) : 0.f;
    mbar_wait(full_bar(f), (f / L.slots) & 1);  // step f's K, V (and key ids) staged
    const float* ids = ids_at(f);

    // S = Q.K^T of the 64 rows and 32 keys: one group of products a chunk,
    // the first chunk's first product from zero, the groups before the
    // last waited for here, so that none is in flight across the loop
    unsigned char* slot = slot_at(f);
    auto products = [&](int j) {
      const uint64_t dk_hi = sw128_desc(shared_addr(slot + j * L.k_chunk));
      const uint64_t dqj_hi = desc_at(dq_hi, j * L.q_chunk);
      wgmma_fence();
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ss_n32(s, desc_at(dqj_hi, 32 * kk), desc_at(dk_hi, 32 * kk), kk + j);
      } else {
        const uint64_t dqj_lo = desc_at(dq_lo, j * L.q_chunk);
        const uint64_t dk_lo = desc_at(dk_hi, L.k_lo);
        // k-step kk: dims 8 kk .. 8 kk + 7, in the half of dims 32 (kk / 4) ..
        auto qk = [](int kk) { return (kk >> 2) * kRows64 * 128 + 32 * (kk & 3); };
        auto kk_at = [](int kk) { return (kk >> 2) * kKeys64 * 128 + 32 * (kk & 3); };
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_tf32_ss_n32(s, desc_at(dqj_lo, qk(kk)), desc_at(dk_hi, kk_at(kk)), kk + j);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss_n32(s, desc_at(dqj_hi, qk(kk)), desc_at(dk_lo, kk_at(kk)), 1);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss_n32(s, desc_at(dqj_hi, qk(kk)), desc_at(dk_hi, kk_at(kk)), 1);
      }
      wgmma_commit();
    };
    fence_operands(s);
#pragma unroll 1
    for (int j = 0; j + 1 < chunks; ++j) {
      products(j);
      wgmma_wait<0>();
      fence_operands(s);
    }
    products(chunks - 1);
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

    // pv = P.V of the step's 32 keys, from zero
    const uint64_t dv_hi = sw128_desc(shared_addr(slot + L.v_hi));
    if constexpr (kBf16) {
      uint32_t ph[2][4], pl[2][4];  // k-step kk: keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], ph[kk][e], pl[kk][e]);
      fence_operands(pv);
      fence_operands(ph[0]);
      fence_operands(ph[1]);
      fence_operands(pl[0]);
      fence_operands(pl[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_bf16_rs_n64(pv, pl[kk], desc_at(dv_hi, 2048 * kk), kk);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_bf16_rs_n64(pv, ph[kk], desc_at(dv_hi, 2048 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(ph[0]);
      fence_operands(ph[1]);
      fence_operands(pl[0]);
      fence_operands(pl[1]);
    } else {
      // k-step kk: keys 8 kk .. 8 kk + 7 in V^T's order 0, 2, 4, 6, 1, 3, 5, 7
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int from[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) split<false>(s[4 * kk + from[e]], ph[kk][e], pl[kk][e]);
      }
      const uint64_t dv_lo = sw128_desc(shared_addr(slot + L.v_lo));
      fence_operands(pv);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_operands(ph[kk]);
        fence_operands(pl[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n64(pv, pl[kk], desc_at(dv_hi, 32 * kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n64(pv, ph[kk], desc_at(dv_lo, 32 * kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32_rs_n64(pv, ph[kk], desc_at(dv_hi, 32 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_operands(ph[kk]);
        fence_operands(pl[kk]);
      }
    }
    fence_operands(pv);
    mbar_arrive(free_bar(f));  // this thread is done with the slot
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);

    if (last) {
      const size_t base = base_of(b);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the quad's row sum; a + b == b + a, so every lane ends with the same bits
        l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
        l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
        if (rows[r] >= N) continue;
        const float inv = 1.f / l[r];
        T* orow = out + base + static_cast<size_t>(rows[r]) * d + col0;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          store_cols<T>(orow, 8 * nn + 2 * t, d - col0, o[4 * nn + 2 * r] * inv, o[4 * nn + 2 * r + 1] * inv);
        // l is relative to m, the row's max, finite at a real row
        if (LSE && t == 0 && chunk == 0) lse[(static_cast<size_t>(b) * H + h) * N + rows[r]] = m[r] + __logf(l[r]);
      }
    }
  }
}


// Shared memory and warps of a CTA at windows of N tokens and head dim d.
size_t smem_bytes(int N, bool bf16, int d) {
  const int chunks = head_dim_chunks(d);
  return static_cast<size_t>(Fwd64Layout(groups64(N, chunks, bf16), bf16, chunks).total);
}

int cta_warps(int N, bool bf16, int d) { return 4 * (groups64(N, head_dim_chunks(d), bf16) + 1); }

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

// The term array, then the kernel over (row blocks x chunks of the head
// dim, heads, window groups), in stream order.
template <typename T, int MODE, bool LSE>
cudaError_t launch(const Args& a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
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
  const int cta_rows = kRows64 * groups64(a.N, chunks, kBf16);
  kernel<<<dim3((a.N + cta_rows - 1) / cta_rows * chunks, a.H, groups), cta_warps(a.N, kBf16, a.d) * 32, smem,
           a.stream>>>(
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
// stored there. A CTA takes `windows_per_cta` windows of one block of rows
// and one chunk of one head; its width and shared memory are those
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
