// Fused window attention forward for Hopper (sm_90a), on tensor cores.
//
// Replaces the three Pallas TPU kernels of icl_tpu/ops/pallas/window_attention.py:
//   _kernel         (:44)  out = softmax(q.k^T * scale + bias[h]) . v
//   _kernel_masked  (:28)  the same plus mask[b % nW], any dense additive
//                          mask [nW, N, N] (Swin-UNet 2D's shift mask)
//   _kernel_region  (:60)  the same plus M, where M = -100 if the shift-region
//                          id of the key differs from the query's, else 0.
//                          M is built here from the ids [nW, N]; the dense
//                          [nW, N, N] mask never exists in device memory.
// Two kernels, each with MODE = NONE, REGION or MASK, input type float or
// bf16, f32 math, output in the input type: window_attention_kernel at
// tile DT = 16 or 32 (head dims 1 .. 32), window_attention64_kernel at
// tile 64 (head dims 33 .. 64). Operands are staged at the tile's width
// with zero columns past the head dim d, so every d of a tile runs the
// tile's products.
//
// Layout (the same as window_attention_fused): q, k, v, out [B, H, N, D]
// contiguous with B = batch * nW; bias [H, N, N] f32; region ids [nW, N]
// f32; mask [nW, N, N] f32; window index = b % nW.
//
// What bounds it: two N x N x D products per (window, head), 4 * B * H *
// N^2 * D flops, against 4 * B * H * N * D values of q, k, v, out. Counted
// at the rate that keeps f32 accuracy on this card (TF32 on the tensor
// cores over the three MMAs of a 3xTF32 product, 165 TFLOP/s), the bytes
// bound it at the Swin-UNet 2D shapes (N = 144, D = 32: N / 4 = 36 flops a
// byte in f32, under the card's ridge of 165 / 3.35 = 49) and the
// operations at the SwinUNETR shapes (N = 343, D = 16: about 86; D = 64:
// about 86 at four times the work).
//
// Tiles 16 and 32 (the building blocks are in mma_tf32.cuh, shared with the
// backward):
//   * Both products on the tensor cores as mma.sync m16n8k8 TF32 with f32
//     accumulators, in the 3xTF32 split, which keeps f32 accuracy (one
//     TF32 product alone misses the port's 1e-5 by about 100x). bf16 q, k,
//     v are exact in TF32: q.k^T is one MMA, P.v two (P is f32).
//   * One warp per 16-row query tile. Its Q fragments are read once from
//     device memory (zero past d), split into hi and lo, and held in
//     registers. Flash-style
//     online softmax over 8-key tiles: S = Q.K^T, the logits with the
//     bias (+ mask, or -100 from the ids) read one tile ahead, the row max
//     merged over the quad of lanes that holds a row (two shuffles), the
//     accumulator rescaled, P.V added. P goes from the C fragment of S
//     straight into the A fragment of P.V through a permuted k index; no
//     tile goes through memory. Each 8-key MMA of P.V sums from zero and is
//     added to the accumulator in f32, as an f32 sum over the keys would be.
//     The quad's row sums are added once at the end.
//   * One CTA per (group of windows, head), walking its windows in order: K
//     and V of the next window (and its ids) are staged with cp.async (f32)
//     into the second of two buffers while the warps work on the current
//     one; N is padded with zero rows to Np, a multiple of 16, and padded
//     keys score -inf. The head's bias rows stay hot in L1 and L2 across
//     the group's windows.
//   * Short windows (N < 8 leaves lanes with only padded keys): the online
//     softmax takes 0 as its reference while its max is -inf, so N = 4
//     gives no e^(-inf + inf).
//   * Head dims below the tile (SwinUNETR at feature sizes other than 48
//     and 96: d = fs / 3) run the tile's products on zero columns: d = 8
//     does the work of d = 16. Only the columns below d are stored. Each
//     tile has two instances: FULL for its own head dim, with d a constant
//     (the code the tile ran before it took smaller head dims), and one
//     that reads d at run time, which alone made the f32 forward at head
//     dim 16 2-4% slower than before in NONE and REGION (PERF.md).
//
// Tile 64 (head dims 33 .. 64: SwinUNETR fs99 .. fs192, Swin-UNet with 33 ..
// 64 a head), designed for Hopper's warpgroup products (wgmma.cuh):
//   * Bound: at fs192's N = 343 the operations (0.75 ms at stage 1 of an
//     inference forward in f32; bf16 by its bytes). The kernel this one
//     replaced ran mma.sync at 8 warps an SM, 6x the bound: about 0.16 MMA
//     a clock an SM. wgmma is the card's only route to its full
//     tensor-core rate, and the forward's operands suit it: S = Q.K^T reads
//     Q and K K-major as they lie, and P.V takes P from registers.
//   * A CTA is a producer warpgroup and G consumer warpgroups (groups64: 3
//     at N = 343 and 144, 2 at 216, 1 at N <= 64), each consumer owning 64
//     query rows of one head (a warp per 16), all walking one group of
//     windows in order: grid (row blocks, heads, window groups), one wave
//     of the resident CTAs. The keys come 32 a step through a ring of
//     slots (3; 2 in f32 at G = 1) that the producer fills a step ahead of
//     the consumers: cp.async, then the f32 split, a "full" mbarrier; each
//     consumer thread arrives on the slot's "free" mbarrier once its P.V
//     is done. The G consumers share every staged K and V tile (a third of
//     the L2 reads and staging work of a CTA per 64 rows) and drift up to
//     the ring's depth apart, so one's softmax overlaps another's products.
//     Each consumer stages its own Q tile with cp.async once its last S of
//     the window is done, and splits it at the next window's first step.
//   * f32: S = Q.K^T and P.V as wgmma m64n32k8 and m64n64k8 tf32 in the
//     3xTF32 split, the small terms first into one accumulator. Q and K land
//     in the 128-byte swizzle and are split into hi and lo in place by the
//     thread that copied them (lo = x - tf32(x), its bits past TF32 left to
//     the tensor cores); V lands in a plain tile and is written transposed
//     (V^T, K-major: tf32 takes no transposed operand), split, with the
//     keys of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7, so that
//     S's accumulator is P.V's A fragment in registers (product_cn's
//     trick, carried into the layout). bf16: S in one m64n32k16 product
//     (exact), P.V as m64n64k16 with V read as it lies (MN-major) and P
//     split into bf16 hi and lo (16 bits of mantissa); no split pass.
//   * Each step's P.V (32 keys) sums from zero in a second accumulator and
//     is added to the output's in f32 with the online softmax's rescale, o
//     = o * corr + pv: the tensor cores do not round each addition as an
//     f32 sum does, and 32-key runs keep f32 at phase 57's 1e-5 (4e-6 at
//     most in the card's cases).
//   * bias (+ the mask) come from the term array that the prologue shared
//     with the tile-64 backward writes once a call, here with rows N padded
//     to 32 apart and the keys of each 32 permuted so that a lane's eight
//     are two 16-byte chunks, read from L2 while S's products run; REGION
//     builds -100 from the region ids, a row's read once a window, the
//     step's 32 keys' staged by the producer. Padded keys score -inf;
//     padded rows are never stored. Shared memory starts zero and chunks
//     past N or d are never written again, so K's columns past d stay zero
//     and any d of 33 .. 64 runs one instance: d only steers the staging
//     (16-byte cp.async chunks where the rows allow, value by value where
//     they do not) and the stores.
//   * The row log-sum-exp, lse = m + log l (f32 [B, H, N]), is stored where
//     the caller passes a buffer for it (an instance of its own, LSE): the
//     tile-64 backward takes P = e^(s - lse) from it.
//   * Resources: 128 registers a thread at launch (512 threads), then
//     setmaxnreg: the producer 56, each consumer 152 (f32 spills 8-16 bytes
//     at that); shared memory (Fwd64Layout) f32 214,448 bytes at G = 3 (Q
//     hi and lo 96 KB, three slots of K and V^T hi and lo 96 KB, two plain
//     V tiles), bf16 50,608; one CTA of 16 warps an SM at G = 2 or 3 (two
//     would need 428 KB in f32, and 1,024 threads' registers), two at G =
//     1 (f32 107,808 bytes). Every output element has one owner and a
//     fixed order of sums: two runs on the same inputs are bitwise equal.
//   * Measured on the way (PERF.md, fs192 stage 1 f32): one warpgroup a CTA
//     and two CTAs an SM 4.15 ms (the parent's kernel 4.5), of which the
//     per-64-row K and V copies took about 1.0 and the split 1.4; three
//     warpgroups in lockstep, all staging 2.95; a P.V left in flight across
//     the next step's staging 3.16 (ptxas serialized the products, C7515);
//     the producer and consumers 2.5; the producer at 32 registers spilled
//     (3.11); a FULL instance for d = 64 not kept: d = 40 runs within 1%.
//
// Both kernels report their warps and shared memory through
// icl_window_attention_fwd_geometry with the resident CTAs an SM, from
// which the caller sizes the grid.

#include "mma_tf32.cuh"
#include "wgmma.cuh"

#include <type_traits>

namespace {

// Warps per CTA at most at tiles 16 and 32: the launch bounds, with two
// CTAs an SM at up to 128 registers a thread.
constexpr int kMaxWarps = 8;
constexpr int kMinCtas = 2;

// The A fragments of rows r0 .. r0 + 15 of a [N, d] operand in device
// memory at tile width DT (load_rows), split once into hi and lo; 0 past N
// and past d.
template <int DT, bool EXACT, typename T>
__device__ __forceinline__ void load_rows_split(FragA (&a)[DT / 8], const T* x, int r0, int N, int d, int g,
                                                int t) {
  float raw[DT / 8][4];
  load_rows<DT>(raw, x, r0, N, d, g, t);
#pragma unroll
  for (int kk = 0; kk < DT / 8; ++kk) a[kk] = split_a<EXACT>(raw[kk][0], raw[kk][1], raw[kk][2], raw[kk][3]);
}

// Per buffer: K [Np, DT] and V [Np, DT] (see sidx), then the ids [Np].
__host__ __device__ inline int buffer_floats(int N, int DT) {
  const int Np = (N + 15) & ~15;
  return 2 * Np * DT + Np;
}

template <typename T, int DT, int MODE, bool FULL>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinCtas)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ bias, const float* __restrict__ region_ids,
                        const float* __restrict__ mask, T* __restrict__ out, int B, int H, int N, int d_in,
                        int nW, int windows_per_cta, float scale) {
  static_assert(DT == 16 || DT == 32, "tile 64 runs window_attention64_kernel");
  const int d = FULL ? DT : d_in;  // the tile's own head dim: the compiler folds d
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  constexpr int KD = DT / 8;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int per_buffer = buffer_floats(N, DT);

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int tiles = Np / 16;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const int b_begin = blockIdx.x * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);

  // K, V (and the ids) of window b into buffer `buf`
  auto stage = [&](int buf, int b) {
    float* ks = smem + buf * per_buffer;
    const size_t base = (static_cast<size_t>(b) * H + h) * N * d;
    stage_rows<DT>(ks, k + base, N, d);
    stage_rows<DT>(ks + Np * DT, v + base, N, d);
    if (MODE == kRegion) {
      const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
      float* ids = ks + 2 * Np * DT;
      for (int i = threadIdx.x; i < N; i += blockDim.x) ids[i] = w_ids[i];
    }
    cp_async_commit();
  };

  // the padded rows and columns stay zero for every window, in every buffer
  for (int op = 0; op < 4; ++op)  // K, V of buffer 0; of buffer 1
    zero_pad<DT>(smem + (op >> 1) * per_buffer + (op & 1) * Np * DT, N, Np, d);
  if (b_begin < b_end) stage(0, b_begin);

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = (b - b_begin) & 1;
    if (b + 1 < b_end) {
      stage(cur ^ 1, b + 1);  // its buffer was released at the end of window b - 1
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // window b staged by every thread

    const float* ks = smem + cur * per_buffer;
    const float* vs = ks + Np * DT;
    const float* ids = vs + Np * DT;
    const size_t base = (static_cast<size_t>(b) * H + h) * N * d;
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(b % nW) * N * N : nullptr;

    // lane (g, t) holds rows i0 + g and i0 + g + 8 (e = 0, 1 and e = 2, 3)
    // at keys j0 + 2t and j0 + 2t + 1
    for (int tile = warp; tile < tiles; tile += warps) {
      const int i0 = 16 * tile;
      FragA qa[KD];
      load_rows_split<DT, kExact>(qa, q + base, i0, N, d, g, t);
      const int rows[2] = {i0 + g, i0 + g + 8};
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this lane's keys' share of the row sum
      float acc[KD][4];
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;

      const float id_row[2] = {id_of<MODE>(ids, rows[0]), id_of<MODE>(ids, rows[1])};
      float term[4];
      load_terms<MODE, false>(term, rows, 2 * t, N, bias_h, mask_w);
      for (int j0 = 0; j0 < Np; j0 += 8) {
        float next[4];
        load_terms<MODE, false>(next, rows, j0 + 8 + 2 * t, N, bias_h, mask_w);
        float s[4];
        product_nt<DT, kExact>(s, qa, ks, j0, g, t);
        const float2 id_key = id_pair<MODE>(ids, j0 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = logit<MODE>(s[e], term[e], rows[e >> 1] < N && j0 + 2 * t + (e & 1) < N, id_row[e >> 1],
                             (e & 1) ? id_key.y : id_key.x, scale);
        float p[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the row's max over the tile, the same bits in the four lanes
          float top = fmaxf(s[2 * r], s[2 * r + 1]);
          top = fmaxf(top, __shfl_xor_sync(kFullMask, top, 1));
          top = fmaxf(top, __shfl_xor_sync(kFullMask, top, 2));
          const float m_new = fmaxf(m[r], top);
          const float m_ref = finite_or_zero(m_new);
          const float corr = __expf(m[r] - m_ref);
          p[2 * r] = __expf(s[2 * r] - m_ref);
          p[2 * r + 1] = __expf(s[2 * r + 1] - m_ref);
          l[r] = fmaf(l[r], corr, p[2 * r] + p[2 * r + 1]);
#pragma unroll
          for (int nn = 0; nn < KD; ++nn) {
            acc[nn][2 * r] *= corr;
            acc[nn][2 * r + 1] *= corr;
          }
          m[r] = m_new;
        }
        product_cn<DT, kExact>(acc, p, vs, j0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) term[e] = next[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the quad's row sum; a + b == b + a, so every lane ends with the same bits
        l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
        l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
        if (rows[r] >= N) continue;
        const float inv = 1.f / l[r];
        T* o = out + base + static_cast<size_t>(rows[r]) * d;
#pragma unroll
        for (int nn = 0; nn < KD; ++nn)
          store_cols<T>(o, 8 * nn + 2 * t, d, acc[nn][2 * r] * inv, acc[nn][2 * r + 1] * inv);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is staged again
  }
}

// ---------------------------------------------------------------------------
// Tile 64 (the note at the head of the file).

constexpr int kRows64 = 64;      // query rows of a consumer warpgroup, a warp per 16
constexpr int kKeys64 = 32;      // keys a step
constexpr int kMaxGroups64 = 3;  // consumer warpgroups of a CTA at most
// Registers a thread: 128 at launch (4 warpgroups), the producer gives 72
// of its own to the consumers' 24 each (three of them). At 32 and 160 the
// producer spilled 88-112 bytes and ran slower.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 152;
constexpr int kProducerBarrier = 1;  // named barriers: the producer's, then each consumer's

// Consumer warpgroups of a CTA at windows of N tokens: they share each
// staged K and V tile, so as many as divide the window's 64-row blocks
// without an empty one, up to 3 (N = 343: 6 blocks, 2 CTAs of 3; N = 144:
// 3 blocks, one CTA of 3; N = 216: 4 blocks, 2 of 2; N <= 64: one).
__host__ __device__ inline int groups64(int N) {
  const int blocks = (N + kRows64 - 1) / kRows64;
  return blocks % 3 == 0 ? 3 : blocks % 2 == 0 ? 2 : 1;
}

// Shared memory of the tile-64 kernel in bytes, from a 1024-aligned base
// (the swizzle's atoms; `total` has the kilobyte that aligns it), for
// `groups` consumer warpgroups: their Q tiles (f32: hi [64][64] as two
// [64][32] halves, then lo, 32 KB; bf16 [64][64], 8 KB); a ring of `slots`
// slots, each f32 K hi, K lo ([32][32] x 2 each), V^T hi, V^T lo ([64][32]
// each), or bf16 K and V [32][64]; f32's plain V tiles [32][64] (`raws` of
// them); each slot's region ids of its 32 keys; each slot's two mbarriers
// (full, free). Independent of N.
struct Fwd64Layout {
  int q_tile, slots, slot, k_lo, v_hi, v_lo, raws, v_raw, ids, bars, total;
  __host__ __device__ Fwd64Layout(int groups, bool bf16) {
    q_tile = bf16 ? 8192 : 32768;
    slots = groups == 1 && !bf16 ? 2 : 3;  // one group: two CTAs an SM in f32
    slot = bf16 ? 8192 : 32768;
    k_lo = 8192;
    v_hi = bf16 ? 4096 : 16384;
    v_lo = 24576;
    raws = bf16 ? 0 : groups == 1 ? 1 : 2;
    v_raw = groups * q_tile + slots * slot;
    ids = v_raw + raws * 8192;
    bars = ids + slots * kKeys64 * 4;
    total = bars + 2 * slots * 8 + 1024;
  }
};

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

// The V values of chunk c of row `row` of x [N, d] as f32, 0 past N and d:
// from the landed f32 chunk `raw` where it was copied (`chunks`), else from
// x (bf16 reads only x: its copied chunks stay as they landed).
template <typename T, int V>
__device__ __forceinline__ void chunk_vals(float (&out)[V], const unsigned char* raw, const T* x, int row, int c,
                                           int N, int d, bool chunks) {
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = 0.f;
  if (row >= N || c * V >= d) return;
  if (chunks) {
    const float4 f = *reinterpret_cast<const float4*>(raw);
    out[0] = f.x, out[1] = f.y, out[2] = f.z, out[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (c * V + e < d) out[e] = to_float(x[static_cast<size_t>(row) * d + c * V + e]);
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
template <typename T>
struct Tile64 {
  static constexpr int kVals = 16 / sizeof(T);  // values a chunk
  static constexpr int kChunks = 64 / kVals;    // chunks a row
  const T* x;
  int row0, N, d;
  __device__ void issue(unsigned char* dst, int R, bool plain, int rank, int count) const {
    if (!chunked16(x, d)) return;
    for (int i = rank; i < R * kChunks; i += count) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if (row0 + r < N && c * kVals < d)
        cp_async<16>(dst + (plain ? raw_chunk_at(r, c) : sw128_chunk(r, c, R)),
                     x + static_cast<size_t>(row0 + r) * d + c * kVals);
    }
  }
  __device__ void finish(unsigned char* dst, int lo_offset, int R, int rank, int count) const {
    const bool chunks = chunked16(x, d);
    for (int i = rank; i < R * kChunks; i += count) {
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if (row0 + r >= N || c * kVals >= d) continue;
      unsigned char* at = dst + sw128_chunk(r, c, R);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (chunks) continue;  // copied
        float f[8];
        chunk_vals<T, 8>(f, at, x, row0 + r, c, N, d, false);
        __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(at);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      } else {
        float f[4];
        chunk_vals<T, 4>(f, at, x, row0 + r, c, N, d, chunks);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(f[e], hi[e], lo[e]);
        *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(at + lo_offset) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
};

// V^T [64 dims][32 keys] of the f32 V tile copied plain to `raw`
// (raw_chunk_at; read from x where its rows do not come in chunks), split
// into hi and lo: chunk cc of row n holds the keys 8 (cc / 2) + {0, 2, 4, 6}
// (cc even) or {1, 3, 5, 7} (cc odd); keys past N as 0, dims past d left as
// they are. A thread takes dims 4 nb .. 4 nb + 3 at chunk cc: four 16-byte
// reads of V, eight 16-byte writes; eight threads in a row take one nb and
// the eight cc, which puts both their reads and their writes on 8 bank
// groups.
template <typename T>
__device__ __forceinline__ void transpose_split(unsigned char* hi, unsigned char* lo, const unsigned char* raw,
                                                const T* x, int key0, int N, int d, int rank, int count) {
  const bool chunks = chunked16(x, d);
  for (int i = rank; i < 16 * 8; i += count) {
    const int cc = i & 7;
    const int nb = i >> 3;
    if (4 * nb >= d) continue;  // dims past d: zero from the kernel's start
    float f[4][4];              // [key e][dim u]
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * (cc >> 1) + 2 * e + (cc & 1);
      const int row = key0 + key;
#pragma unroll
      for (int u = 0; u < 4; ++u) f[e][u] = 0.f;
      if (row >= N) continue;
      if (chunks) {
        const float4 v = *reinterpret_cast<const float4*>(raw + raw_chunk_at(key, nb));
        f[e][0] = v.x, f[e][1] = v.y, f[e][2] = v.z, f[e][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * nb + u < d) f[e][u] = to_float(x[static_cast<size_t>(row) * d + 4 * nb + u]);
      }
    }
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

template <typename T, int MODE, bool LSE>
__global__ void __launch_bounds__((kMaxGroups64 + 1) * 128, 1)
window_attention64_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
  const Fwd64Layout L(groups, kBf16);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int r0 = blockIdx.x * kRows64 * groups;  // the CTA's rows
  const int h = blockIdx.y;
  const int b_begin = blockIdx.z * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);
  if (b_begin >= b_end) return;
  const int total = (b_end - b_begin) * steps;
  auto slot_at = [&](int f) { return smem + groups * L.q_tile + (f % L.slots) * L.slot; };
  auto ids_at = [&](int f) { return reinterpret_cast<float*>(smem + L.ids) + (f % L.slots) * kKeys64; };
  auto full_bar = [&](int f) { return shared_addr(smem + L.bars + 16 * (f % L.slots)); };
  auto free_bar = [&](int f) { return shared_addr(smem + L.bars + 16 * (f % L.slots) + 8); };
  auto raw_at = [&](int f) { return smem + L.v_raw + (L.raws == 2 ? (f & 1) * 8192 : 0); };  // f32 only
  auto base_of = [&](int b) { return (static_cast<size_t>(b) * H + h) * N * d; };
  auto window_of = [&](int f) { return b_begin + f / steps; };

  // Q, the ring and the plain V tiles start zero (Tile64)
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
      const Tile64<T> kt{k + base_of(b), key0, N, d};
      const Tile64<T> vt{v + base_of(b), key0, N, d};
      kt.issue(slot_at(f), kKeys64, false, rank, 128);
      vt.issue(kBf16 ? slot_at(f) + L.v_hi : raw_at(f), kKeys64, !kBf16, rank, 128);
      if (MODE == kRegion && rank < kKeys64 && key0 + rank < N)  // the step's keys' ids
        cp_async<4>(ids_at(f) + rank, region_ids + static_cast<size_t>(b % nW) * N + key0 + rank);
      cp_async_commit();
    };
    auto finish = [&](int f) {
      const int b = window_of(f);
      const int key0 = kKeys64 * (f % steps);
      const Tile64<T> kt{k + base_of(b), key0, N, d};
      kt.finish(slot_at(f), L.k_lo, kKeys64, rank, 128);
      if constexpr (kBf16) {
        const Tile64<T> vt{v + base_of(b), key0, N, d};
        vt.finish(slot_at(f) + L.v_hi, 0, kKeys64, rank, 128);
      } else {
        transpose_split(slot_at(f) + L.v_hi, slot_at(f) + L.v_lo, raw_at(f), v + base_of(b), key0, N, d, rank,
                        128);
      }
      fence_proxy_async();  // the tiles, to the products' proxy
      mbar_arrive(full_bar(f));
    };
    // Two plain V tiles (or bf16, none): step f's copies go out before step
    // f - 1 is finished; one: after it.
    for (int f = 0; f <= total; ++f) {
      if (L.raws != 1 && f < total) {
        named_barrier(kProducerBarrier, 128);  // step f - 2's plain V tile read by every thread
        issue(f);
      }
      if (f > 0) {
        if (L.raws != 1 && f < total)
          cp_async_wait_group<1>();
        else
          cp_async_wait_group<0>();
        named_barrier(kProducerBarrier, 128);  // step f - 1 landed, every thread's copies
        finish(f - 1);
      }
      if (L.raws == 1 && f < total) {
        named_barrier(kProducerBarrier, 128);
        issue(f);
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
  unsigned char* q_tile = smem + wg * L.q_tile;  // f32: hi, then lo 16 KB on
  const uint64_t dq_hi = sw128_desc(shared_addr(q_tile));
  const uint64_t dq_lo = sw128_desc(shared_addr(q_tile + 16384));
  auto q_of = [&](int b) { return Tile64<T>{q + base_of(b), w0, N, d}; };
  q_of(b_begin).issue(q_tile, kRows64, false, rank, 128);
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
      q_of(b).finish(q_tile, 16384, kRows64, rank, 128);
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

    // S = Q.K^T of the 64 rows and 32 keys
    unsigned char* slot = slot_at(f);
    const uint64_t dk_hi = sw128_desc(shared_addr(slot));
    fence_operands(s);
    wgmma_fence();
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_bf16_ss_n32(s, desc_at(dq_hi, 32 * kk), desc_at(dk_hi, 32 * kk), kk);
    } else {
      const uint64_t dk_lo = sw128_desc(shared_addr(slot + L.k_lo));
      // k-step kk: dims 8 kk .. 8 kk + 7, in the half of dims 32 (kk / 4) ..
      auto qk = [](int kk) { return (kk >> 2) * kRows64 * 128 + 32 * (kk & 3); };
      auto kk_at = [](int kk) { return (kk >> 2) * kKeys64 * 128 + 32 * (kk & 3); };
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss_n32(s, desc_at(dq_lo, qk(kk)), desc_at(dk_hi, kk_at(kk)), kk);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss_n32(s, desc_at(dq_hi, qk(kk)), desc_at(dk_lo, kk_at(kk)), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_tf32_ss_n32(s, desc_at(dq_hi, qk(kk)), desc_at(dk_hi, kk_at(kk)), 1);
    }
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
      q_of(b + 1).issue(q_tile, kRows64, false, rank, 128);
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
        T* orow = out + base + static_cast<size_t>(rows[r]) * d;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          store_cols<T>(orow, 8 * nn + 2 * t, d, o[4 * nn + 2 * r] * inv, o[4 * nn + 2 * r + 1] * inv);
        // l is relative to m, the row's max, finite at a real row
        if (LSE && t == 0) lse[(static_cast<size_t>(b) * H + h) * N + rows[r]] = m[r] + __logf(l[r]);
      }
    }
  }
}

// K, V and ids buffers at tile width DT (16 or 32), two of them
size_t smem_bytes(int N, int DT) { return 2 * static_cast<size_t>(buffer_floats(N, DT)) * sizeof(float); }

size_t smem_bytes(int N, int DT, bool bf16) {
  return DT == 64 ? static_cast<size_t>(Fwd64Layout(groups64(N), bf16).total) : smem_bytes(N, DT);
}

int cta_warps(int N, int DT) { return DT == 64 ? 4 * (groups64(N) + 1) : tile_warps(N, kMaxWarps); }

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

// CTAs that fit one SM, from the compiled kernel's registers and the
// window's shared memory; 0 when the shared memory exceeds a CTA's limit.
template <typename T, int DT, int MODE, bool FULL>
cudaError_t occupancy(int N, int* ctas) {
  if constexpr (DT == 64)
    return fit(window_attention64_kernel<T, MODE, false>,
               smem_bytes(N, DT, std::is_same<T, __nv_bfloat16>::value), cta_warps(N, DT) * 32, ctas);
  else
    return fit(window_attention_kernel<T, DT, MODE, FULL>, smem_bytes(N, DT), cta_warps(N, DT) * 32, ctas);
}

template <typename T, int DT, bool FULL>
cudaError_t occupancy_mode(int N, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, DT, kRegion, FULL>(N, ctas);
  if (has_mask) return occupancy<T, DT, kMask, FULL>(N, ctas);
  return occupancy<T, DT, kNone, FULL>(N, ctas);
}

// The instance of tile DT for head dim D: at tiles 16 and 32 FULL where D
// is the tile's own; tile 64 has one instance for every D.
template <typename T, int DT>
cudaError_t occupancy_dim(int N, int D, bool has_ids, bool has_mask, int* ctas) {
  return D == DT && DT != 64 ? occupancy_mode<T, DT, true>(N, has_ids, has_mask, ctas)
                             : occupancy_mode<T, DT, false>(N, has_ids, has_mask, ctas);
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

template <typename T, int DT, int MODE, bool FULL>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.N, DT);
  auto kernel = window_attention_kernel<T, DT, MODE, FULL>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  kernel<<<dim3(groups, a.H), cta_warps(a.N, DT) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.bias, a.region_ids,
      a.mask, static_cast<T*>(a.out), a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  return cudaGetLastError();
}

template <typename T, int DT, bool FULL>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, DT, kRegion, FULL>(a);
  if (a.mask != nullptr) return launch<T, DT, kMask, FULL>(a);
  return launch<T, DT, kNone, FULL>(a);
}

// Tiles 16 and 32: the tile's own head dim runs the FULL instance (d
// folded to DT), any smaller one the instance that reads d at run time.
template <int DT>
cudaError_t launch_type(const Args& a, int is_bf16) {
  if (a.lse != nullptr) return cudaErrorInvalidValue;  // stored at tile 64 only
  if (a.d == DT) return is_bf16 ? launch_mode<__nv_bfloat16, DT, true>(a) : launch_mode<float, DT, true>(a);
  return is_bf16 ? launch_mode<__nv_bfloat16, DT, false>(a) : launch_mode<float, DT, false>(a);
}

// Tile 64: the term array, then the kernel over (row blocks, heads, window
// groups), in stream order.
template <typename T, int MODE, bool LSE>
cudaError_t launch64(const Args& a) {
  const size_t smem = smem_bytes(a.N, 64, std::is_same<T, __nv_bfloat16>::value);
  auto kernel = window_attention64_kernel<T, MODE, LSE>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int Np = (a.N + 15) / 16 * 16;
  err = launch_terms(a.bias, MODE == kMask ? a.mask : nullptr, a.terms, MODE == kMask ? a.nW : 1, a.H, a.N, Np,
                     (a.N + kKeys64 - 1) / kKeys64 * kKeys64, true, a.stream);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  const int cta_rows = kRows64 * groups64(a.N);
  kernel<<<dim3((a.N + cta_rows - 1) / cta_rows, a.H, groups), cta_warps(a.N, 64) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.terms, a.region_ids,
      static_cast<T*>(a.out), a.lse, a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  return cudaGetLastError();
}

template <typename T, bool LSE>
cudaError_t launch64_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch64<T, kRegion, LSE>(a);
  if (a.mask != nullptr) return launch64<T, kMask, LSE>(a);
  return launch64<T, kNone, LSE>(a);
}

cudaError_t launch64_type(const Args& a, int is_bf16) {
  if (a.terms == nullptr) return cudaErrorInvalidValue;
  if (a.lse != nullptr) return is_bf16 ? launch64_mode<__nv_bfloat16, true>(a) : launch64_mode<float, true>(a);
  return is_bf16 ? launch64_mode<__nv_bfloat16, false>(a) : launch64_mode<float, false>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when every launch was accepted. `region_ids` set
// selects REGION, else `mask` set selects MASK, else NONE (at most one of
// the two is set). `is_bf16` selects the input type. The head dim D is any
// of 1 .. 64 (SwinUNETR: feature size / 3, 16 at fs48, 8 at fs24, 64 at
// fs192; Swin-UNet 2D, embed 96: 32); D <= 16 runs the tile-16 instance,
// D <= 32 the tile-32 one (`terms` and `lse` not read; `lse` must be
// null), D <= 64 the tile-64 kernel, which takes a scratch `terms` [T, H,
// Np, P] f32 (T = nW in MASK, else 1; Np = N padded to a multiple of 16, P
// to a multiple of 32) for its term array, and where `lse` is set stores
// the row log-sum-exp [B, H, N] f32 of the scaled logits there. A CTA takes `windows_per_cta`
// windows of one head (at tile 64, of one block of 64 rows); its width and
// shared memory are those icl_window_attention_fwd_geometry reports.
int icl_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* region_ids, const void* mask, void* out, void* lse, void* terms, int B,
                             int H, int N, int D, int nW, int windows_per_cta, float scale, int is_bf16,
                             void* stream) {
  if (windows_per_cta < 1 || N < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(bias), static_cast<const float*>(region_ids),
               static_cast<const float*>(mask), out, static_cast<float*>(lse), static_cast<float*>(terms),
               B, H, N, D, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  const int tile = head_dim_tile(D);
  if (tile == 16) return launch_type<16>(a, is_bf16);
  if (tile == 32) return launch_type<32>(a, is_bf16);
  if (tile == 64) return launch64_type(a, is_bf16);
  return cudaErrorInvalidValue;
}

// The launch geometry at windows of N tokens and head dim D (its tile's
// instance), in the mode that `has_ids` (REGION), else `has_mask` (MASK),
// else neither (NONE) selects, and the type `is_bf16` selects: the warps
// of a CTA, its shared memory in bytes, and how many such CTAs one SM of
// the current device holds, 0 when the window does not fit. Returns a
// cudaError_t.
int icl_window_attention_fwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                      int* smem, int* ctas) {
  const int tile = head_dim_tile(D);
  if (N < 1 || tile == 0) return cudaErrorInvalidValue;
  *warps = cta_warps(N, tile);
  *smem = static_cast<int>(smem_bytes(N, tile, is_bf16 != 0));
  if (tile == 16)
    return is_bf16 ? occupancy_dim<__nv_bfloat16, 16>(N, D, has_ids, has_mask, ctas)
                   : occupancy_dim<float, 16>(N, D, has_ids, has_mask, ctas);
  if (tile == 32)
    return is_bf16 ? occupancy_dim<__nv_bfloat16, 32>(N, D, has_ids, has_mask, ctas)
                   : occupancy_dim<float, 32>(N, D, has_ids, has_mask, ctas);
  return is_bf16 ? occupancy_dim<__nv_bfloat16, 64>(N, D, has_ids, has_mask, ctas)
                 : occupancy_dim<float, 64>(N, D, has_ids, has_mask, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
