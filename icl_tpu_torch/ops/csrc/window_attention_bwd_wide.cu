// Fused window attention backward for Hopper (sm_90a) at head dims above
// 64, on tensor cores: the tile-64 backward of window_attention_bwd.cu (its
// dQ and dK/dV kernels, whose note this one follows) with the head dim in
// C = ceil(d / 64) chunks of 64 columns, split between the two quads of
// warps of a CTA.
//
// Replaces the backward of the custom_vjp around the Pallas kernels of
// icl_tpu/ops/pallas/window_attention.py (_fused_attention_bwd :290-349),
// which takes any head dim, from the forward's saved output O and row
// log-sum-exp lse (window_attention_wide.cu stores them): P = e^(S - lse),
// u = rowsum(dO o O) in f32 (a prologue kernel) or rowsum(P o dP) in bf16
// (the dQ kernel's sweep), dS = P o (dP - u), dV = P^T.dO, dQ = scale
// dS.K, dK = scale dS^T.Q, dbias[h] = sum over the windows of dS; NONE,
// REGION, MASK; f32 or bf16 q, k, v, dO, f32 math, dbias in f32.
//
// What bounds it: the function's 10 B H N^2 d flops at the card's
// f32-accurate rate (3xTF32, 165 TFLOP/s) or bf16's, as at tile 64. Like
// the tile-64 kernels it runs one CTA of 8 warps an SM (about 200 to 230
// registers a thread) and is bound by latency and issue, not by a unit's
// rate (f32 about 0.14 mma.sync a clock an SM, as at tile 64): so it issues
// no product the function does not need (a quad that summed S and dP over
// every chunk, as each did before, issued 10 chunk-products a dQ step at
// C = 2 where the function needs 6, and 12 a dK/dV step where it needs 8),
// and it keeps a product's k-steps free of branches, so that the compiler
// loads one step's fragments ahead of the last step's products (a guard at
// every step, for the columns past d, took fs240's stage 1 from 24.4 to
// 31.3 ms in f32 and from 10.4 to 14.0 in bf16, PERF.md).
//
// Design:
//   * A CTA has two quads of 4 warps (kQuads); warp w of each quad (a pair)
//     owns the same 16 rows (dQ) or keys (dK/dV) of the CTA's 64. Quad j
//     writes output chunk 2p + j (p the CTA's pair of output chunks; p = 0
//     at C = 2) and forms only the partial scores of chunks j, j + 2, ...:
//     S_j = Q_j.K_j^T and dP_j = dO_j.V_j^T over a step's 16 keys (dK/dV:
//     S_j^T, dP_j^T over 16 rows). Each quad owns one 8-wide n-tile of the
//     step: it stages its partials of the other's n-tile in the pair's
//     exchange (a float4 a lane, no bank conflict), the pair meets at a
//     named barrier, and each quad forms S = S_0 + S_1 and dP = dP_0 + dP_1
//     (chunk order) on its own n-tile, then P and dS there (and that n-tile
//     of the dbias partial); it stages them (dQ: dS; dK/dV: P and dS), the
//     pair meets again, and each quad adds both n-tiles' products to its
//     chunk of dQ (dK, dV), its own n-tile first where the product is an
//     8-term one (f32). At C = 2 the products are the function's own, and
//     the softmax's work is split between the quads. bf16's sweep for u is
//     split the same way, the quads' row sums added through the exchange at
//     its end. Above two chunks (bf16 at small windows) each pair of output
//     chunks is a CTA of its own that sums every chunk's partials: S and dP
//     are recomputed there, once a pair of chunks.
//   * A fragments in registers at C = 2, as at tile 64: the dQ kernel holds
//     the warp's rows of Q_j and dO_j split once (f32: the hi halves, the
//     lo ones in place of the raw tile; bf16: m16n8k16 fragments), bf16's
//     dK/dV kernel its keys of K_j; f32's dK/dV kernel reads K_j and V_j
//     from the split tiles (held in registers they spilled at tile 64).
//     Chunks j + 2, ... (bf16, C > 2) are read from the tiles at each use.
//   * Zero columns: the products skip the k-steps and n8-tiles of the last
//     chunk that lie wholly past d (at d = 80, 6 of its 8), in a guarded
//     form of their own (`unrolled`); a whole chunk runs none.
//   * bf16's sweep and its products are two loops over one step body whose
//     pass is a constant (no branch on it in the step); the dQ kernel loads
//     each step's terms (bf16) and dbias partial a step ahead of their use.
//   * f32's dK/dV kernel forms both n-tiles of a step at once (204
//     registers; one at a time, as at tile 64, took 255 and was slower).
//   * Shared memory: f32 stages Q and dO raw (a tile a chunk) and a 12 KB
//     exchange (dQ), K and V split and a 16 KB exchange (dK/dV, 216 KB: one
//     CTA an SM; C = 3 does not fit); bf16 keeps a window of C chunks
//     resident (C = 2 at N = 343) and lays the exchange over the staged Q
//     (dK/dV: K) tiles of chunks 0 and 1, free once their fragments are in
//     registers, so its bytes, and the head dims it takes, are as before.
//   * Kept from the tile-64 backward: f32 tiles through a two-slot cp.async
//     ring split once into TF32 hi and lo, bf16 windows resident on mma.sync
//     m16n8k16, the term array, 8-term (bf16 16-term) products summed from
//     zero and added in f32, padded keys at -inf, the dbias partial [G, H,
//     N, Np] owned by the dQ CTAs of pair 0 (quad j its n-tile j) and
//     reduced in order, no atomics, bitwise repeatable.
//   * Kernels of their own beside window_attention_bwd.cu's, which stay as
//     they were at head dims up to 64: one template for both perturbed the
//     register allocation of the one-chunk bf16 instances (4-7% slower,
//     PERF.md).

#include <algorithm>
#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps64 = 4;
constexpr int kBlock64 = 64;  // rows of a dQ CTA, keys of a dK/dV CTA
// A CTA's warps come in kQuads quads of kWarps64, quad j writing chunk
// kQuads p + j of the output columns (p the CTA's pair of chunks; none past
// the last chunk) and summing the partial scores of chunks j, j + kQuads, ...
constexpr int kQuads = 2;
__host__ __device__ inline int chunk_ctas(int chunks) { return (chunks + kQuads - 1) / kQuads; }
constexpr int kStep64 = 16;   // keys a dQ step, rows a dK/dV step
// f32's ring: each step's copies issued one step ahead (a third slot, two
// steps ahead, measured no faster: the copies' latency is hidden already)
constexpr int kSlots = 2;

// Values of one chunk's [64][64] tile and [16][64] ring tile: each operand
// is staged as C such tiles, a chunk's values `kTile64` or `kTile16` on
// from the last's (the bf16 windows: `Np * 64`).
constexpr int kTile64 = 64 * 64;
constexpr int kTile16 = kStep64 * 64;

// The exchange of a pair of warps, in float4s, a lane's four values of a
// 16 x 8 C fragment (one n-tile) in each: X, each quad's partial S and dP
// (dK/dV: S^T, dP^T) of the other quad's n-tile, then Y, each quad's dS
// (dK/dV: P^T, dS^T) of its own. The dQ kernel's is 3 KB a pair, the dK/dV
// kernel's 4 KB; four pairs a CTA.
constexpr int kXchX = 2 * 32;                  // float4s of a quad's X
constexpr int kXchDq = kQuads * (kXchX + 32);  // float4s of a pair
constexpr int kXchDkdv = kQuads * (kXchX + 64);
// bf16 lays the exchange over the Q (dK/dV: K) tiles of chunks 0 and 1
static_assert(kWarps64 * kXchDq * 4 <= 2 * 64 * 32 && kWarps64 * kXchDkdv * 4 <= 2 * 64 * 32,
              "the bf16 exchange fits two chunks of a [64][64] bf16 tile");

// Shared memory of the dQ kernel, in floats, for `chunks` 64-column chunks
// of the head dim (C): the block's raw Q and dO [64][64] of each chunk
// (type T; in f32 the lo halves of the quad's chunk replace its raw
// values, the hi halves in registers), then f32: two ring slots, each K
// and V hi and lo [16][64] of each chunk (f32 lands in hi and is split in
// place) and the term tile [64][16], then the exchange; bf16: the window's
// K and V [Np][64] of each chunk, resident, the exchange over Q's chunks 0
// and 1; then the window's ids [Np] (REGION).
struct DqLayout {
  int qraw, graw, slots, slot, khi, klo, vhi, vlo, term, kw, vw, xch, ids, total;
  __host__ __device__ DqLayout(int Np, bool bf16, int mode, int chunks) {
    const int raw64 = bf16 ? 64 * 32 : 64 * 64;
    const int tile = chunks * kTile16;
    qraw = 0;
    graw = chunks * raw64;
    slots = 2 * chunks * raw64;
    khi = klo = vhi = vlo = term = slot = 0;
    kw = vw = slots;
    if (bf16) {
      vw = kw + chunks * Np * 32;
      xch = qraw;
      ids = vw + chunks * Np * 32;
    } else {
      int o = 0;
      khi = o, o += tile;
      klo = o, o += tile;
      vhi = o, o += tile;
      vlo = o, o += tile;
      term = o, o += kBlock64 * kStep64;
      slot = o;
      xch = slots + kSlots * slot;
      ids = xch + kWarps64 * kXchDq * 4;
    }
    total = ids + (mode == kRegion ? Np : 0);
  }
};

// Shared memory of the dK/dV kernel, in floats, for `chunks` chunks of the
// head dim: f32: the block's K and V hi and lo [64][64] of each chunk (each
// lands in hi and is split in place), two ring slots, each Q and dO hi and
// lo [16][64] of each chunk, the term tile [16][64], lse and u [16], then
// the exchange; bf16: the block's raw K and V [64][64] of each chunk (the
// exchange over K's chunks 0 and 1), the window's Q and dO [Np][64] of each
// chunk, lse and u [Np], resident; then the window's ids [Np] (REGION).
struct DkdvLayout {
  int kraw, klo, vhi, vlo, vraw, slots, slot, qhi, qlo, ghi, glo, term, lse, dlt, qw, gw, xch, ids, total;
  __host__ __device__ DkdvLayout(int Np, bool bf16, int mode, int chunks) {
    const int raw64 = chunks * (bf16 ? 64 * 32 : 64 * 64);
    const int tile = chunks * kTile16;
    kraw = 0;
    klo = vhi = vlo = vraw = slots = slot = qhi = qlo = ghi = glo = term = qw = gw = 0;
    if (bf16) {
      vraw = raw64;
      qw = vraw + raw64;
      gw = qw + chunks * Np * 32;
      lse = gw + chunks * Np * 32;
      dlt = lse + Np;
      xch = kraw;
      ids = dlt + Np;
    } else {
      klo = raw64;
      vhi = klo + raw64;
      vlo = vhi + raw64;
      slots = vlo + raw64;
      int o = 0;
      qhi = o, o += tile;
      qlo = o, o += tile;
      ghi = o, o += tile;
      glo = o, o += tile;
      term = o, o += kStep64 * 64;
      lse = o, o += kStep64;
      dlt = o, o += kStep64;
      slot = o;
      xch = slots + kSlots * slot;
      ids = xch + kWarps64 * kXchDkdv * 4;
    }
    total = ids + (mode == kRegion ? Np : 0);
  }
};

// u[row] = sum_c dO[row][c] O[row][c] over the B H N rows, one warp a row,
// f32: the prologue of f32 calls (bf16's u comes from the dQ kernel).
template <typename T>
__global__ void __launch_bounds__(256)
window_attention_bwd64_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                    float* __restrict__ delta, size_t rows, int d) {
  const size_t row = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_float(o[c]), to_float(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
  if (lane == 0) delta[row] = s;
}

// A term tile of rows r0 .. r0 + RT - 1 and keys k0 .. k0 + KT - 1 of one
// [Np, Np] plane of the term array (KT 16 or 64), 16-byte chunks; zeros
// past Np. Chunk c of row r lands at r KT + 4 (c ^ swz(r)), swz(r) keeping
// the lanes' reads on 32 banks (term_at): the dQ role's float2 pairs of
// rows g and g + 8 (KT 16), the dK/dV role's rows 2t, 2t + 1 at keys g, g +
// 8 (KT 64).
template <int KT>
__device__ __forceinline__ int term_at(int r, int c) {
  const int swz = KT == 16 ? ((r >> 1) & 1) << 1 : ((r >> 1) & 3) << 1;
  return r * KT + (((c >> 2) ^ swz) << 2) + (c & 3);
}
template <int RT, int KT>
__device__ __forceinline__ void issue_terms(float* tile, const float* plane, int r0, int k0, int Np) {
  constexpr int kChunks = KT / 4;
  for (int i = threadIdx.x; i < RT * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    const bool in = r0 + r < Np && k0 + c < Np;
    cp_async<16>(tile + term_at<KT>(r, c), plane + (in ? static_cast<size_t>(r0 + r) * Np + k0 + c : 0),
                 in ? 16 : 0);
  }
}

// The two warps of pair `pair` (warp `pair` of each quad) meet: named
// barrier 1 + pair (0 is __syncthreads') of their 64 threads; the shared
// memory each wrote before it is visible to the other after it.
__device__ __forceinline__ void pair_sync(int pair) { asm volatile("bar.sync %0, 64;" ::"r"(1 + pair) : "memory"); }

__device__ __forceinline__ float4 as_float4(const float (&c)[4]) { return make_float4(c[0], c[1], c[2], c[3]); }

// The quad's n-tile of a pair's sum, in chunk order (quad 0's partial, then
// quad 1's): `own` the quad's partial of that n-tile, `got` the other
// quad's, from the exchange. Both quads' sums of an n-tile have equal bits.
__device__ __forceinline__ void chunk_sum(float (&out)[4], int quad, const float (&own)[4], float4 got) {
  const float o[4] = {got.x, got.y, got.z, got.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = quad ? o[e] + own[e] : own[e] + o[e];
}

// C fragments of n-tiles 0 and 1 from the quad's own one (n-tile `quad`)
// and the other quad's (the exchange), for the 16-key bf16 products.
__device__ __forceinline__ void by_ntile(float (&n0)[4], float (&n1)[4], int quad, const float (&own)[4], float4 got) {
  const float o[4] = {got.x, got.y, got.z, got.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    n0[e] = quad ? o[e] : own[e];
    n1[e] = quad ? own[e] : o[e];
  }
}

// The k-steps of 8 (TF32) and 16 (bf16) columns of the chunk whose first
// column is col0 that hold columns below d; the n8-tiles of its output
// columns below d are ksteps8's. The products skip the rest: zero columns.
__device__ __forceinline__ int ksteps8(int d, int col0) { return min(8, (d - col0 + 7) >> 3); }
__device__ __forceinline__ int ksteps16(int d, int col0) { return min(4, (d - col0 + 15) >> 4); }

// f(0) .. f(K - 1), unrolled, or only those below kmax where kmax < K (the
// last chunk's k-steps or n8-tiles past d): a whole chunk runs no guard,
// since a guard at every step keeps the compiler from scheduling one
// step's loads ahead of the last step's products.
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

// product_nt_hilo (mma_tf32.cuh) over the first `kmax` k-steps.
template <int NT, bool EXACT>
__device__ __forceinline__ void partial_nt_hilo(float (&acc)[NT][4], const uint32_t (&xh)[8][4], const float* xlo,
                                                int x0, const float* yhi, const float* ylo, int c0, int kmax, int g,
                                                int t) {
  unrolled<8>(kmax, [&](int kk) {
    FragA a;
#pragma unroll
    for (int e = 0; e < 4; ++e) a.hi[e] = xh[kk][e];
    frag_lo<EXACT>(a.lo, xlo, x0, kk, g, t);
    mma_nt_step<NT, EXACT>(acc, a, yhi, ylo, c0, kk, g, t);
  });
}

// product_nt_tiles over the first `kmax` k-steps.
template <int NT, bool EXACT>
__device__ __forceinline__ void partial_nt_tiles(float (&acc)[NT][4], const float* xhi, const float* xlo, int x0,
                                                 const float* yhi, const float* ylo, int c0, int kmax, int g, int t) {
  unrolled<8>(kmax, [&](int kk) {
    mma_nt_step<NT, EXACT>(acc, frag_a<EXACT>(xhi, xlo, x0, kk, g, t), yhi, ylo, c0, kk, g, t);
  });
}

// product_nt_bf16 over the first `kmax` k-steps, X's fragments held in
// registers or read from a bf16 tile.
template <int NT>
__device__ __forceinline__ void partial_nt_bf16(float (&acc)[NT][4], const uint32_t (&xa)[4][4],
                                                const __nv_bfloat16* y, int c0, int kmax, int g, int t) {
  unrolled<4>(kmax, [&](int kk) { mma_nt_bf16_step<NT>(acc, xa[kk], y, c0, kk, g, t); });
}
template <int NT>
__device__ __forceinline__ void partial_nt_bf16(float (&acc)[NT][4], const __nv_bfloat16* x, int x0,
                                                const __nv_bfloat16* y, int c0, int kmax, int g, int t) {
  unrolled<4>(kmax, [&](int kk) {
    uint32_t a[4];
    frag_bf16(a, x, x0, kk, g, t);
    mma_nt_bf16_step<NT>(acc, a, y, c0, kk, g, t);
  });
}

// product_cn_tile over the first `nmax` n8-tiles of output columns.
template <bool Y_EXACT>
__device__ __forceinline__ void partial_cn_tile(float (&out)[8][4], const float (&c)[4], const float* yhi,
                                                const float* ylo, int r0, int nmax, int g, int t) {
  const FragA a = split_a<false>(c[0], c[2], c[1], c[3]);
  unrolled<8>(nmax, [&](int nn) {
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
  });
}

// product_cn_bf16 over the first `nmax` n8-tiles of output columns.
__device__ __forceinline__ void partial_cn_bf16(float (&out)[8][4], const float (&c0)[4], const float (&c1)[4],
                                                const __nv_bfloat16* y, int r0, int nmax, int g, int t) {
  uint32_t hi[4], lo[4];
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
  unrolled<8>(nmax, [&](int nn) {
    const uint32_t b[2] = {bf16_rows(y, r0 + 2 * t, 8 * nn + g), bf16_rows(y, r0 + 2 * t + 8, 8 * nn + g)};
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(part, lo, b);
    mma_bf16(part, hi, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nn][e] += part[e];
  });
}

// dQ: a CTA of kQuads quads of warps, its row block blockIdx.x /
// chunk_ctas(C) and pair of output chunks p = blockIdx.x % chunk_ctas(C),
// quad j storing dQ's 64 columns of chunk kQuads p + j from the partial
// scores of chunks j, j + kQuads, ... and the other quad's, through the
// exchange (the note above). Only pair 0's CTAs write the dbias partial
// and bf16's u.
template <typename T, int MODE>
__global__ void __launch_bounds__(kWarps64 * 32 * kQuads, 1)
window_attention_bwd64_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                 const T* __restrict__ dout, const float* __restrict__ lse,
                                 float* __restrict__ delta, const float* __restrict__ terms,
                                 const float* __restrict__ region_ids, T* __restrict__ dq,
                                 float* __restrict__ dbias_part, int B, int H, int N, int d, int nW,
                                 int windows_per_cta, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  // bf16 walks a window's keys twice, a sweep for u and then the products
  // (key_step); it keeps the window's K and V resident (half f32's bytes,
  // no split)
  constexpr bool kWhole = kExact;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int steps = Np / kStep64;
  const int chunks = head_dim_chunks(d);  // f32: 2 (3 does not fit)
  const int warp = threadIdx.x / 32;
  const int quad = warp / kWarps64;        // its n-tile of a key step, its first chunk of partials
  const int other = quad ^ 1;
  const int quad_warp = warp % kWarps64;   // the warp's 16 rows of the block: its pair
  const int pair = blockIdx.x % chunk_ctas(chunks);
  const int chunk = kQuads * pair + quad;  // its columns of dQ
  const bool stores = chunk < chunks;
  const int col0 = kBlock64 * chunk;
  const int nmax = stores ? ksteps8(d, col0) : 0;
  const bool owner = pair == 0;  // of the dbias partial (quad j its n-tile j) and bf16's u
  const DqLayout L(Np, kExact, MODE, chunks);
  T* qraw = reinterpret_cast<T*>(smem + L.qraw);
  T* graw = reinterpret_cast<T*>(smem + L.graw);
  float* qlo = reinterpret_cast<float*>(qraw + quad * kTile64);  // f32: the lo halves of the quad's chunk, in place
  float* glo = reinterpret_cast<float*>(graw + quad * kTile64);
  T* kw = reinterpret_cast<T*>(smem + L.kw);  // bf16: the window's K and V
  T* vw = reinterpret_cast<T*>(smem + L.vw);
  float* ids = smem + L.ids;
  float4* xch = reinterpret_cast<float4*>(smem + L.xch) + quad_warp * kXchDq;  // the pair's exchange
  float4* x_mine = xch + quad * kXchX;  // X: S, dP of the other's n-tile
  float4* x_got = xch + other * kXchX;
  float4* y_mine = xch + kQuads * kXchX + quad * 32;  // Y: dS of the quad's n-tile (bf16's u after the sweep)
  float4* y_got = xch + kQuads * kXchX + other * 32;
  const int kw_chunk = Np * 64;  // values of a chunk of the bf16 window

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.x / chunk_ctas(chunks) * kBlock64;  // the CTA's rows
  const int h = blockIdx.y;
  const int group = blockIdx.z;
  const int i0 = r0 + 16 * quad_warp;  // the pair's rows
  const bool busy = i0 < N;            // i0 + 16 <= Np then
  const int rows[2] = {i0 + g, i0 + g + 8};
  const int b_begin = group * windows_per_cta;
  const int b_end = min(B, b_begin + windows_per_cta);
  if (b_begin >= b_end) return;
  float* part = dbias_part + (static_cast<size_t>(group) * H + h) * N * Np;  // [N][Np]

  auto slot_at = [&](int s, int field) { return smem + L.slots + (s % kSlots) * L.slot + field; };
  auto base_of = [&](int b) { return (static_cast<size_t>(b) * H + h) * N * d; };
  auto plane_of = [&](int b) {
    return terms + (static_cast<size_t>(MODE == kMask ? b % nW : 0) * H + h) * Np * Np;
  };
  // Q and dO of the block of window b, its ids, and (bf16) its K and V, every chunk
  auto issue_window = [&](int b) {
    const size_t base = base_of(b);
    for (int jc = 0; jc < chunks; ++jc) {
      const int c0 = kBlock64 * jc;
      issue_rows<T>(qraw + jc * kTile64, q + base, r0, kBlock64, N, d, chunked(q + base, d), c0);
      issue_rows<T>(graw + jc * kTile64, dout + base, r0, kBlock64, N, d, chunked(dout + base, d), c0);
      if (kWhole) {
        issue_rows<T>(kw + jc * kw_chunk, k + base, 0, Np, N, d, chunked(k + base, d), c0);
        issue_rows<T>(vw + jc * kw_chunk, v + base, 0, Np, N, d, chunked(v + base, d), c0);
      }
    }
    if (MODE == kRegion) {
      const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
      for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async<4>(ids + i, w_ids + i);
    }
  };
  auto fill_window = [&](int b) {
    const size_t base = base_of(b);
    for (int jc = 0; jc < chunks; ++jc) {
      const int c0 = kBlock64 * jc;
      fill_rows<T>(qraw + jc * kTile64, q + base, r0, kBlock64, N, d, chunked(q + base, d), c0);
      fill_rows<T>(graw + jc * kTile64, dout + base, r0, kBlock64, N, d, chunked(dout + base, d), c0);
      if (kWhole) {
        fill_rows<T>(kw + jc * kw_chunk, k + base, 0, Np, N, d, chunked(k + base, d), c0);
        fill_rows<T>(vw + jc * kw_chunk, v + base, 0, Np, N, d, chunked(v + base, d), c0);
      }
    }
  };
  // f32: K and V of keys 16 j .. 16 j + 15 of window b, every chunk, and the term tile, into slot s
  auto issue_step = [&](int b, int j, int s) {
    const size_t base = base_of(b);
    for (int jc = 0; jc < chunks; ++jc) {
      issue_rows<T>(reinterpret_cast<T*>(slot_at(s, L.khi) + jc * kTile16), k + base, kStep64 * j, kStep64, N, d,
                    chunked(k + base, d), kBlock64 * jc);
      issue_rows<T>(reinterpret_cast<T*>(slot_at(s, L.vhi) + jc * kTile16), v + base, kStep64 * j, kStep64, N, d,
                    chunked(v + base, d), kBlock64 * jc);
    }
    issue_terms<kBlock64, kStep64>(slot_at(s, L.term), plane_of(b), r0, kStep64 * j, Np);
  };
  auto finish_step = [&](int b, int j, int s) {
    const size_t base = base_of(b);
    for (int jc = 0; jc < chunks; ++jc) {
      float* khi = slot_at(s, L.khi) + jc * kTile16;
      float* vhi = slot_at(s, L.vhi) + jc * kTile16;
      split_rows<T>(khi, slot_at(s, L.klo) + jc * kTile16, reinterpret_cast<const T*>(khi), k + base,
                    kStep64 * j, kStep64, N, d, chunked(k + base, d), kBlock64 * jc);
      split_rows<T>(vhi, slot_at(s, L.vlo) + jc * kTile16, reinterpret_cast<const T*>(vhi), v + base,
                    kStep64 * j, kStep64, N, d, chunked(v + base, d), kBlock64 * jc);
    }
  };
  // f32: step f of the CTA's walk (window b_begin + f / steps, key step f %
  // steps) into slot f % kSlots, if the walk has it; one commit group a step,
  // empty past the walk's end, so that a wait counts steps
  auto issue_flat = [&](int f) {
    if (b_begin + f / steps < b_end) issue_step(b_begin + f / steps, f % steps, f);
    cp_async_commit();
  };
  auto finish_flat = [&](int f) {
    if (b_begin + f / steps < b_end) finish_step(b_begin + f / steps, f % steps, f);
  };
  uint32_t qh[8][4], gh[8][4];  // f32: the quad's chunk of the warp's rows of Q and dO, hi halves
  uint32_t qa[4][4], ga[4][4];  // bf16: their m16n8k16 fragments

  issue_window(b_begin);
  if constexpr (kWhole) {
    cp_async_commit();
    cp_async_wait_all();
  } else {
#pragma unroll
    for (int f = 0; f < kSlots - 1; ++f) issue_flat(f);  // the first group holds the window too
    cp_async_wait_group<kSlots - 2>();
  }
  fill_window(b_begin);
  if (!kWhole) finish_flat(0);
  __syncthreads();

  int s = 0;  // steps walked: the ring slot is s % 2
  for (int b = b_begin; b < b_end; ++b) {
    const size_t base = base_of(b);
    const bool first = b == b_begin;
    const float* plane = plane_of(b);
    float lse_r[2] = {0.f, 0.f}, dlt_r[2] = {0.f, 0.f}, id_row[2] = {0.f, 0.f};
    float u[2] = {0.f, 0.f};  // bf16: this lane's share of rowsum(P o dP), the sweep's
    float acc[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;
    if (busy) {  // the quad's chunk of this warp's rows of Q and dO, split once
      if constexpr (kWhole) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          frag_bf16(qa[kk], qraw + quad * kTile64, 16 * quad_warp, kk, g, t);
          frag_bf16(ga[kk], graw + quad * kTile64, 16 * quad_warp, kk, g, t);
        }
      } else {
        load_frags_hi<T, kExact>(qh, qlo, qraw + quad * kTile64, 16 * quad_warp, g, t);
        load_frags_hi<T, kExact>(gh, glo, graw + quad * kTile64, 16 * quad_warp, g, t);
      }
      const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < N) {
          lse_r[r] = __ldg(lse + row_base + rows[r]);
          if (!kExact) dlt_r[r] = __ldg(delta + row_base + rows[r]);
        }
        id_row[r] = id_of<MODE>(ids, rows[r]);
      }
    }
    if constexpr (kWhole) __syncthreads();  // bf16's exchange lies over Q's chunks 0 and 1
    // The terms of rows g, g + 8 at the lane's keys of key step jn (bf16:
    // from the term array in L2; f32 reads its ring slot's tile at use) and
    // the dbias partial a products step adds to: loaded a step ahead of use
    float2 tm_next[2], old_next[2];
    auto prefetch = [&](bool sweep_next, int jn) {
      const int at = kStep64 * jn + 8 * quad + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (kWhole) tm_next[r] = __ldg(reinterpret_cast<const float2*>(plane + static_cast<size_t>(rows[r]) * Np + at));
        old_next[r] = !sweep_next && !first && owner && rows[r] < N
                          ? *reinterpret_cast<const float2*>(part + static_cast<size_t>(rows[r]) * Np + at)
                          : make_float2(0.f, 0.f);
      }
    };
    if (busy) prefetch(kExact, 0);
    // One key step j, the walk's step s: SWEEP (a constant, as the loops
    // below call it), bf16's sweep for u = rowsum(P o dP) in f32, or the
    // products; `last`, the window's last
    auto key_step = [&](auto sweep_tag, int j, bool last) {
      constexpr bool sweep = decltype(sweep_tag)::value;
      if (!kWhole) issue_flat(s + kSlots - 1);
      const int j0 = kStep64 * j;
      if (busy) {
        const int c = 8 * quad + 2 * t;  // the lane's keys j0 + c, + 1 of the quad's n-tile
        float2 tm[2], old[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tm[r] = kWhole ? tm_next[r]
                         : *reinterpret_cast<const float2*>(slot_at(s, L.term) +
                                                            term_at<kStep64>(16 * quad_warp + g + 8 * r, c));
          old[r] = old_next[r];
        }
        if (j + 1 < steps)
          prefetch(sweep, j + 1);
        else if (sweep)
          prefetch(false, 0);
        // the partial S and dP of the quad's chunks, both n-tiles
        float sc[2][4] = {}, dp[2][4] = {};
        if constexpr (kWhole) {
          const int kmax = ksteps16(d, kBlock64 * quad);
          partial_nt_bf16<2>(sc, qa, kw + quad * kw_chunk, j0, kmax, g, t);
          partial_nt_bf16<2>(dp, ga, vw + quad * kw_chunk, j0, kmax, g, t);
#pragma unroll 1
          for (int jc = quad + kQuads; jc < chunks; jc += kQuads) {  // C > 2: from the tiles
            const int km = ksteps16(d, kBlock64 * jc);
            partial_nt_bf16<2>(sc, qraw + jc * kTile64, 16 * quad_warp, kw + jc * kw_chunk, j0, km, g, t);
            partial_nt_bf16<2>(dp, graw + jc * kTile64, 16 * quad_warp, vw + jc * kw_chunk, j0, km, g, t);
          }
        } else {
          const int kmax = ksteps8(d, kBlock64 * quad);
          partial_nt_hilo<2, kExact>(sc, qh, qlo, 16 * quad_warp, slot_at(s, L.khi) + quad * kTile16,
                                     slot_at(s, L.klo) + quad * kTile16, 0, kmax, g, t);
          partial_nt_hilo<2, kExact>(dp, gh, glo, 16 * quad_warp, slot_at(s, L.vhi) + quad * kTile16,
                                     slot_at(s, L.vlo) + quad * kTile16, 0, kmax, g, t);
        }
        // the other quad's n-tile out, this quad's in: S and dP of its n-tile
        x_mine[lane] = quad ? as_float4(sc[0]) : as_float4(sc[1]);
        x_mine[32 + lane] = quad ? as_float4(dp[0]) : as_float4(dp[1]);
        float sv[4], pv[4];
        {
          float own_s[4], own_p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            own_s[e] = quad ? sc[1][e] : sc[0][e];
            own_p[e] = quad ? dp[1][e] : dp[0][e];
          }
          pair_sync(quad_warp);
          chunk_sum(sv, quad, own_s, x_got[lane]);
          chunk_sum(pv, quad, own_p, x_got[32 + lane]);
        }
        float ds[4];
        const float2 id_key = id_pair<MODE>(ids, j0 + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool real = rows[r] < N && j0 + c + e < N;
            const float x = logit<MODE>(sv[2 * r + e], e ? tm[r].y : tm[r].x, real, id_row[r],
                                        e ? id_key.y : id_key.x, scale);
            const float p = real ? __expf(x - lse_r[r]) : 0.f;
            if constexpr (sweep)
              u[r] = fmaf(p, pv[2 * r + e], u[r]);
            else
              ds[2 * r + e] = p * (pv[2 * r + e] - dlt_r[r]);
          }
          // (row, key pair) has one owner lane; 0 + ds = ds for the first window
          if (!sweep && owner && rows[r] < N)
            *reinterpret_cast<float2*>(part + static_cast<size_t>(rows[r]) * Np + j0 + c) =
                make_float2(old[r].x + ds[2 * r], old[r].y + ds[2 * r + 1]);
        }
        // dQ of the quad's chunk += dS . K: f32 its own n-tile's 8 keys now, the
        // other's once staged; bf16 both n-tiles' 16 keys in one product
        float* khi_out = slot_at(s, L.khi) + chunk * kTile16;  // f32 (C = 2: chunk = quad)
        float* klo_out = slot_at(s, L.klo) + chunk * kTile16;
        if constexpr (!sweep) {
          y_mine[lane] = as_float4(ds);
          if constexpr (!kWhole) {
            if (stores) partial_cn_tile<kExact>(acc, ds, khi_out, klo_out, 8 * quad, nmax, g, t);
          }
        }
        pair_sync(quad_warp);
        if (!sweep && stores) {
          if constexpr (kWhole) {
            float n0[4], n1[4];
            by_ntile(n0, n1, quad, ds, y_got[lane]);
            partial_cn_bf16(acc, n0, n1, kw + chunk * kw_chunk, j0, nmax, g, t);
          } else {
            const float4 y = y_got[lane];
            const float dso[4] = {y.x, y.y, y.z, y.w};
            partial_cn_tile<kExact>(acc, dso, khi_out, klo_out, 8 * other, nmax, g, t);
          }
        }
        if (sweep && j == steps - 1) {  // u of the quad's keys, then the pair's sum in chunk order
          const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            u[r] += __shfl_xor_sync(kFullMask, u[r], 1);
            u[r] += __shfl_xor_sync(kFullMask, u[r], 2);
          }
          y_mine[lane] = make_float4(u[0], u[1], 0.f, 0.f);
          pair_sync(quad_warp);
          const float4 got = y_got[lane];
          const float uo[2] = {got.x, got.y};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            dlt_r[r] = quad ? uo[r] + u[r] : u[r] + uo[r];  // every lane of the pair's rows: the same bits
            if (t == 0 && owner && quad == 0 && rows[r] < N) delta[row_base + rows[r]] = dlt_r[r];  // for dK/dV
          }
        }
      }
      if constexpr (!kWhole) {
        if (last && b + 1 < b_end) {  // the next window's Q, dO and ids: their tiles are free only now
          __syncthreads();
          issue_window(b + 1);
          cp_async_commit();
          cp_async_wait_all();
          fill_window(b + 1);
        } else {
          cp_async_wait_group<kSlots - 2>();  // step s + 1's copies
        }
        finish_flat(s + 1);
        __syncthreads();
      }
    };
    if constexpr (kExact) {
      for (int j = 0; j < steps; ++j, ++s) key_step(std::true_type{}, j, false);
    }
    for (int j = 0; j < steps; ++j, ++s) key_step(std::false_type{}, j, j + 1 == steps);
    if (busy && stores) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= N) continue;
        T* o = dq + base + static_cast<size_t>(rows[r]) * d + col0;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
          store_cols<T>(o, 8 * nn + 2 * t, d - col0, acc[nn][2 * r] * scale, acc[nn][2 * r + 1] * scale);
      }
    }
    if (kWhole && b + 1 < b_end) {  // the next window, once every warp is done with this one
      __syncthreads();
      issue_window(b + 1);
      cp_async_commit();
      cp_async_wait_all();
      fill_window(b + 1);
      __syncthreads();
    }
  }
}

// dK and dV: a CTA of kQuads quads of warps (blockIdx.x / chunk_ctas(C)
// as blockIdx.x of the tile-64 kernel's), quad j storing dK's and dV's 64
// columns of chunk kQuads p + j (p = blockIdx.x % chunk_ctas(C)) from the
// partial S^T and dP^T of chunks j, j + kQuads, ... and the other quad's,
// through the exchange; P^T and dS^T exchanged as well.
template <typename T, int MODE>
__global__ void __launch_bounds__(kWarps64 * 32 * kQuads, 1)
window_attention_bwd64_wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                   const T* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, const float* __restrict__ terms,
                                   const float* __restrict__ region_ids, T* __restrict__ dk, T* __restrict__ dv,
                                   int B, int H, int N, int d, int nW, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  // bf16: the window's Q and dO resident, one CTA walking the window's key
  // blocks; f32: one CTA a key block, Q and dO through the ring
  constexpr bool kWhole = kExact;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int steps = Np / kStep64;
  const int blocks = (N + kBlock64 - 1) / kBlock64;
  const int chunks = head_dim_chunks(d);
  const int warp = threadIdx.x / 32;
  const int quad = warp / kWarps64;       // its n-tile of a row step, its first chunk of partials
  const int other = quad ^ 1;
  const int quad_warp = warp % kWarps64;  // the warp's 16 keys of the block: its pair
  const int chunk = kQuads * (blockIdx.x % chunk_ctas(chunks)) + quad;  // its columns
  const bool stores = chunk < chunks;
  const int col0 = kBlock64 * chunk;
  const int nmax = stores ? ksteps8(d, col0) : 0;
  const int cta = blockIdx.x / chunk_ctas(chunks);
  const DkdvLayout L(Np, kExact, MODE, chunks);
  T* kraw = reinterpret_cast<T*>(smem + L.kraw);
  float* khi = smem + L.kraw;  // f32: K lands in hi and is split in place
  float* klo = smem + L.klo;
  float* vhi = smem + L.vhi;  // f32
  float* vlo = smem + L.vlo;
  T* vraw = kWhole ? reinterpret_cast<T*>(smem + L.vraw) : reinterpret_cast<T*>(vhi);
  T* qw = reinterpret_cast<T*>(smem + L.qw);  // bf16
  T* gw = reinterpret_cast<T*>(smem + L.gw);
  float* ids = smem + L.ids;
  float4* xch = reinterpret_cast<float4*>(smem + L.xch) + quad_warp * kXchDkdv;  // the pair's exchange
  float4* x_mine = xch + quad * kXchX;  // X: S^T, dP^T of the other's n-tile
  float4* x_got = xch + other * kXchX;
  float4* y_mine = xch + kQuads * kXchX + quad * 64;  // Y: P^T, dS^T of the quad's n-tile
  float4* y_got = xch + kQuads * kXchX + other * 64;
  const int w_chunk = Np * 64;  // values of a chunk of the bf16 window's Q or dO

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = kWhole ? cta : cta / blocks;
  const int kb_begin = kWhole ? 0 : cta - b * blocks;  // the CTA's key blocks
  const int kb_end = kWhole ? blocks : kb_begin + 1;
  const int h = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * H + h) * N * d;
  const size_t row_base = (static_cast<size_t>(b) * H + h) * N;
  const float* plane = terms + (static_cast<size_t>(MODE == kMask ? b % nW : 0) * H + h) * Np * Np;
  const bool q_chunks = chunked(q + base, d);
  const bool g_chunks = chunked(dout + base, d);
  const bool k_chunks = chunked(k + base, d);
  const bool v_chunks = chunked(v + base, d);
  int k0 = kBlock64 * kb_begin;  // the block's keys

  auto slot_at = [&](int s, int field) { return smem + L.slots + (s % kSlots) * L.slot + field; };
  // f32: Q, dO (every chunk), lse and u of rows 16 i .. 16 i + 15, and the term tile, into slot i % 2
  auto issue_step = [&](int i) {
    const int i0 = kStep64 * i;
    for (int jc = 0; jc < chunks; ++jc) {
      issue_rows<T>(reinterpret_cast<T*>(slot_at(i, L.qhi) + jc * kTile16), q + base, i0, kStep64, N, d, q_chunks,
                    kBlock64 * jc);
      issue_rows<T>(reinterpret_cast<T*>(slot_at(i, L.ghi) + jc * kTile16), dout + base, i0, kStep64, N, d,
                    g_chunks, kBlock64 * jc);
    }
    if (threadIdx.x < 2 * kStep64) {
      const int r = threadIdx.x % kStep64;
      const bool real = i0 + r < N;
      const float* src = threadIdx.x < kStep64 ? lse : delta;
      float* dst = slot_at(i, threadIdx.x < kStep64 ? L.lse : L.dlt);
      cp_async<4>(dst + r, src + row_base + (real ? i0 + r : 0), real ? 4 : 0);
    }
    issue_terms<kStep64, kBlock64>(slot_at(i, L.term), plane, i0, k0, Np);
  };
  // f32: step i's copies, if the block has step i; one commit group a step
  auto issue_flat = [&](int i) {
    if (i < steps) issue_step(i);
    cp_async_commit();
  };
  auto finish_step = [&](int i) {
    for (int jc = 0; jc < chunks; ++jc) {
      float* qhi = slot_at(i, L.qhi) + jc * kTile16;
      float* ghi = slot_at(i, L.ghi) + jc * kTile16;
      split_rows<T>(qhi, slot_at(i, L.qlo) + jc * kTile16, reinterpret_cast<const T*>(qhi), q + base, kStep64 * i,
                    kStep64, N, d, q_chunks, kBlock64 * jc);
      split_rows<T>(ghi, slot_at(i, L.glo) + jc * kTile16, reinterpret_cast<const T*>(ghi), dout + base,
                    kStep64 * i, kStep64, N, d, g_chunks, kBlock64 * jc);
    }
  };

  // the window's ids, and (bf16) its Q, dO (every chunk), lse and u
  if (MODE == kRegion) {
    const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async<4>(ids + i, w_ids + i);
  }
  if constexpr (kWhole) {
    for (int jc = 0; jc < chunks; ++jc) {
      issue_rows<T>(qw + jc * w_chunk, q + base, 0, Np, N, d, q_chunks, kBlock64 * jc);
      issue_rows<T>(gw + jc * w_chunk, dout + base, 0, Np, N, d, g_chunks, kBlock64 * jc);
    }
    for (int i = threadIdx.x; i < 2 * Np; i += blockDim.x) {
      const int r = i < Np ? i : i - Np;
      const bool real = r < N;
      cp_async<4>(smem + (i < Np ? L.lse : L.dlt) + r, (i < Np ? lse : delta) + row_base + (real ? r : 0),
                  real ? 4 : 0);
    }
  }
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    k0 = kBlock64 * kb;
    const int j0 = k0 + 16 * quad_warp;  // the pair's keys
    const bool busy = j0 < N;
    const int keys[2] = {j0 + g, j0 + g + 8};
    if (kb > kb_begin) __syncthreads();  // every warp is done with the block before
    for (int jc = 0; jc < chunks; ++jc) {
      issue_rows<T>(kraw + jc * kTile64, k + base, k0, kBlock64, N, d, k_chunks, kBlock64 * jc);
      issue_rows<T>(vraw + jc * kTile64, v + base, k0, kBlock64, N, d, v_chunks, kBlock64 * jc);
    }
    if constexpr (kWhole) {
      cp_async_commit();
      cp_async_wait_all();
    } else {
#pragma unroll
      for (int i = 0; i < kSlots - 1; ++i) issue_flat(i);  // the first group holds K and V too
      cp_async_wait_group<kSlots - 2>();
    }
    for (int jc = 0; jc < chunks; ++jc) {
      const int c0 = kBlock64 * jc;
      if constexpr (kWhole) {
        fill_rows<T>(kraw + jc * kTile64, k + base, k0, kBlock64, N, d, k_chunks, c0);
        fill_rows<T>(vraw + jc * kTile64, v + base, k0, kBlock64, N, d, v_chunks, c0);
        if (kb == kb_begin) {
          fill_rows<T>(qw + jc * w_chunk, q + base, 0, Np, N, d, q_chunks, c0);
          fill_rows<T>(gw + jc * w_chunk, dout + base, 0, Np, N, d, g_chunks, c0);
        }
      } else {
        split_rows<T>(khi + jc * kTile64, klo + jc * kTile64, kraw + jc * kTile64, k + base, k0, kBlock64, N, d,
                      k_chunks, c0);
        split_rows<T>(vhi + jc * kTile64, vlo + jc * kTile64, vraw + jc * kTile64, v + base, k0, kBlock64, N, d,
                      v_chunks, c0);
      }
    }
    if constexpr (!kWhole) finish_step(0);
    __syncthreads();

    uint32_t ka[4][4];  // bf16: the quad's chunk of the warp's keys of K, m16n8k16 fragments
    float id_key[2] = {0.f, 0.f};
    if (busy) {
      if constexpr (kWhole) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_bf16(ka[kk], kraw + quad * kTile64, 16 * quad_warp, kk, g, t);
      }
      id_key[0] = id_of<MODE>(ids, keys[0]);
      id_key[1] = id_of<MODE>(ids, keys[1]);
    }
    if constexpr (kWhole) __syncthreads();  // bf16's exchange lies over K's chunks 0 and 1
    float dka[8][4], dva[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      dka[nn][0] = dka[nn][1] = dka[nn][2] = dka[nn][3] = 0.f;
      dva[nn][0] = dva[nn][1] = dva[nn][2] = dva[nn][3] = 0.f;
    }
    // One step over rows 16 i .. 16 i + 15: Q and dO rows c0 .. c0 + 15 of
    // qs, gs (a ring slot, or the resident window; chunk j `stride` values
    // on), lse and u at ls_at, dl_at.
    auto step = [&](int i, const auto* qs, const float* ql, const auto* gs, const float* gl, int stride, int c0,
                    const float* ls_at, const float* dl_at) {
      const int c = 8 * quad + 2 * t;  // the lane's rows 16 i + c, + 1 of the quad's n-tile
      // the term of the lane's row c + e % 2 at key g + 8 (e / 2): bf16 reads
      // the term array in L2 before the products, f32 the ring slot's tile at
      // its use (registers)
      auto term = [&](int e) {
        const int row = c + (e & 1);
        const int key = 16 * quad_warp + g + 8 * (e >> 1);
        return kWhole ? __ldg(plane + static_cast<size_t>(kStep64 * i + row) * Np + k0 + key)
                      : slot_at(i, L.term)[term_at<kBlock64>(row, key)];
      };
      float tm[4];
      if constexpr (kWhole) {
#pragma unroll
        for (int e = 0; e < 4; ++e) tm[e] = term(e);
      }
      // S^T = K.Q^T, dP^T = V.dO^T of the quad's n-tile, summed with the other
      // quad's partials: keys (C rows) g, g + 8, rows (C columns) c, c + 1
      float st[4], dpt[4];
      if constexpr (kWhole) {
        float sp[2][4] = {}, pp[2][4] = {};
        const int kmax = ksteps16(d, kBlock64 * quad);
        partial_nt_bf16<2>(sp, ka, qs + quad * stride, c0, kmax, g, t);
        partial_nt_bf16<2>(pp, vraw + quad * kTile64, 16 * quad_warp, gs + quad * stride, c0, kmax, g, t);
#pragma unroll 1
        for (int jc = quad + kQuads; jc < chunks; jc += kQuads) {  // C > 2: K from the tiles
          const int km = ksteps16(d, kBlock64 * jc);
          partial_nt_bf16<2>(sp, kraw + jc * kTile64, 16 * quad_warp, qs + jc * stride, c0, km, g, t);
          partial_nt_bf16<2>(pp, vraw + jc * kTile64, 16 * quad_warp, gs + jc * stride, c0, km, g, t);
        }
        x_mine[lane] = quad ? as_float4(sp[0]) : as_float4(sp[1]);
        x_mine[32 + lane] = quad ? as_float4(pp[0]) : as_float4(pp[1]);
        float own_s[4], own_p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          own_s[e] = quad ? sp[1][e] : sp[0][e];
          own_p[e] = quad ? pp[1][e] : pp[0][e];
        }
        pair_sync(quad_warp);
        chunk_sum(st, quad, own_s, x_got[lane]);
        chunk_sum(dpt, quad, own_p, x_got[32 + lane]);
      } else {
        // f32 (C = 2: the quad's chunk alone), both n-tiles at once
        float sp[2][4] = {}, pp[2][4] = {};
        const int km = ksteps8(d, kBlock64 * quad);
        partial_nt_tiles<2, kExact>(sp, khi + quad * kTile64, klo + quad * kTile64, 16 * quad_warp, qs + quad * stride,
                                    ql + quad * stride, c0, km, g, t);
        partial_nt_tiles<2, kExact>(pp, vhi + quad * kTile64, vlo + quad * kTile64, 16 * quad_warp, gs + quad * stride,
                                    gl + quad * stride, c0, km, g, t);
        x_mine[lane] = quad ? as_float4(sp[0]) : as_float4(sp[1]);
        x_mine[32 + lane] = quad ? as_float4(pp[0]) : as_float4(pp[1]);
        float own_s[4], own_p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          own_s[e] = quad ? sp[1][e] : sp[0][e];
          own_p[e] = quad ? pp[1][e] : pp[0][e];
        }
        pair_sync(quad_warp);
        chunk_sum(st, quad, own_s, x_got[lane]);
        chunk_sum(dpt, quad, own_p, x_got[32 + lane]);
      }
      const int row0 = kStep64 * i + c;
      const float2 ls = *reinterpret_cast<const float2*>(ls_at + c);
      const float2 dl = *reinterpret_cast<const float2*>(dl_at + c);
      const float2 id_row = id_pair<MODE>(ids, row0);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = e >> 1;  // key g or g + 8
        const int rr = e & 1;   // row c or c + 1
        const bool real = row0 + rr < N && keys[kr] < N;
        const float x = logit<MODE>(st[e], kWhole ? tm[e] : term(e), real, rr ? id_row.y : id_row.x, id_key[kr],
                                    scale);
        p[e] = real ? __expf(x - (rr ? ls.y : ls.x)) : 0.f;
        ds[e] = p[e] * (dpt[e] - (rr ? dl.y : dl.x));
      }
      // dV += P^T.dO, dK += dS^T.Q of the quad's chunk: f32 its own n-tile's
      // 8 rows now, the other's once staged; bf16 both n-tiles' 16 in one
      y_mine[lane] = as_float4(p);
      y_mine[32 + lane] = as_float4(ds);
      if constexpr (!kWhole) {
        if (stores) {
          partial_cn_tile<kExact>(dva, p, gs + chunk * stride, gl + chunk * stride, c0 + 8 * quad, nmax, g, t);
          partial_cn_tile<kExact>(dka, ds, qs + chunk * stride, ql + chunk * stride, c0 + 8 * quad, nmax, g, t);
        }
      }
      pair_sync(quad_warp);
      if (stores) {
        if constexpr (kWhole) {
          float n0[4], n1[4];
          by_ntile(n0, n1, quad, p, y_got[lane]);
          partial_cn_bf16(dva, n0, n1, gs + chunk * stride, c0, nmax, g, t);
          by_ntile(n0, n1, quad, ds, y_got[32 + lane]);
          partial_cn_bf16(dka, n0, n1, qs + chunk * stride, c0, nmax, g, t);
        } else {
          const float4 py = y_got[lane], dy = y_got[32 + lane];
          const float po4[4] = {py.x, py.y, py.z, py.w}, dso[4] = {dy.x, dy.y, dy.z, dy.w};
          partial_cn_tile<kExact>(dva, po4, gs + chunk * stride, gl + chunk * stride, c0 + 8 * other, nmax, g, t);
          partial_cn_tile<kExact>(dka, dso, qs + chunk * stride, ql + chunk * stride, c0 + 8 * other, nmax, g, t);
        }
      }
    };
    for (int i = 0; i < steps; ++i) {
      if constexpr (kWhole) {
        if (busy)
          step(i, qw, nullptr, gw, nullptr, w_chunk, kStep64 * i, smem + L.lse + kStep64 * i,
               smem + L.dlt + kStep64 * i);
      } else {
        issue_flat(i + kSlots - 1);
        if (busy)
          step(i, slot_at(i, L.qhi), slot_at(i, L.qlo), slot_at(i, L.ghi), slot_at(i, L.glo), kTile16, 0,
               slot_at(i, L.lse), slot_at(i, L.dlt));
        cp_async_wait_group<kSlots - 2>();  // step i + 1's copies
        if (i + 1 < steps) finish_step(i + 1);
        __syncthreads();
      }
    }
    if (busy && stores) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (keys[r] >= N) continue;
        const size_t row = base + static_cast<size_t>(keys[r]) * d + col0;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int c = 8 * nn + 2 * t;
          store_cols<T>(dk + row, c, d - col0, dka[nn][2 * r] * scale, dka[nn][2 * r + 1] * scale);
          store_cols<T>(dv + row, c, d - col0, dva[nn][2 * r], dva[nn][2 * r + 1]);
        }
      }
    }
  }
}

// dbias[h, i, j] = sum_g part[g, h, i, j] in the order g = 0 .. G-1, the
// partial's rows Np apart.
__global__ void dbias_reduce64_kernel(const float* __restrict__ part, float* __restrict__ dbias, int groups,
                                      int H, int N, int Np) {
  const size_t hnn = static_cast<size_t>(H) * N * N;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < hnn; i += stride) {
    const size_t row = i / N;  // h * N + row
    const size_t at = row * Np + (i - row * N);
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[static_cast<size_t>(g) * H * N * Np + at];
    dbias[i] = s;
  }
}

// The pointers and sizes of one backward call.
struct Args {
  const void *q, *k, *v, *dout, *out;
  const float *lse, *bias, *region_ids, *mask;
  void *dq, *dk, *dv;
  float *delta, *terms, *dbias_part, *dbias;
  int B, H, N, d, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

// Warps of a CTA of either kernel: two quads.
constexpr int kCtaWarps = kWarps64 * kQuads;

// The larger of the two kernels' shared memory (DqLayout, DkdvLayout) at
// windows of N tokens and head dim d's chunks, in bytes.
size_t smem_bytes(int N, bool bf16, int mode, int d) {
  const int Np = (N + 15) / 16 * 16;
  const int chunks = head_dim_chunks(d);
  return static_cast<size_t>(std::max(DqLayout(Np, bf16, mode, chunks).total,
                                      DkdvLayout(Np, bf16, mode, chunks).total)) *
         sizeof(float);
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
    if (ctas != nullptr) *ctas = 0;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return ctas == nullptr ? cudaSuccess : cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads, smem);
}

// CTAs of the dQ kernel that fit one SM, whose grid the caller sizes from
// it (the dK/dV kernel's grid is one CTA a window, key block, pair of
// chunks and head), or 0 where either kernel does not fit.
template <typename T, int MODE>
cudaError_t occupancy(int N, int d, int* ctas) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int Np = (N + 15) / 16 * 16;
  const int chunks = head_dim_chunks(d);
  int dq = 0, dkdv = 0;
  cudaError_t err = fit(window_attention_bwd64_wide_dq_kernel<T, MODE>,
                        DqLayout(Np, kBf16, MODE, chunks).total * sizeof(float), kCtaWarps * 32, &dq);
  if (err == cudaSuccess)
    err = fit(window_attention_bwd64_wide_dkdv_kernel<T, MODE>,
              DkdvLayout(Np, kBf16, MODE, chunks).total * sizeof(float), kCtaWarps * 32, &dkdv);
  *ctas = dkdv > 0 ? dq : 0;
  return err;
}

template <typename T>
cudaError_t occupancy_mode(int N, int d, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, kRegion>(N, d, ctas);
  if (has_mask) return occupancy<T, kMask>(N, d, ctas);
  return occupancy<T, kNone>(N, d, ctas);
}

// The prologues (the term array; f32: u = rowsum(dO o O)), the dQ kernel
// (the dbias partial; bf16: u), the dK/dV kernel, the dbias reduction, in
// stream order; both kernels a CTA per pair of chunks.
template <typename T, int MODE>
cudaError_t launch(const Args& a) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int Np = (a.N + 15) / 16 * 16;
  const int blocks = (a.N + kBlock64 - 1) / kBlock64;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  const int chunks = head_dim_chunks(a.d);
  const size_t dq_smem = DqLayout(Np, kBf16, MODE, chunks).total * sizeof(float);
  const size_t kv_smem = DkdvLayout(Np, kBf16, MODE, chunks).total * sizeof(float);
  auto dq_kernel = window_attention_bwd64_wide_dq_kernel<T, MODE>;
  auto kv_kernel = window_attention_bwd64_wide_dkdv_kernel<T, MODE>;
  cudaError_t err = fit(dq_kernel, dq_smem, 0, nullptr);
  if (err == cudaSuccess) err = fit(kv_kernel, kv_smem, 0, nullptr);
  if (err != cudaSuccess) return err;
  err = launch_terms(a.bias, MODE == kMask ? a.mask : nullptr, a.terms, MODE == kMask ? a.nW : 1, a.H, a.N, Np, Np,
                     false, a.stream);
  if (err != cudaSuccess) return err;
  if (!kBf16) {  // bf16's u comes from the dQ kernel's sweep, not from the rounded O
    const size_t rows = static_cast<size_t>(a.B) * a.H * a.N;
    window_attention_bwd64_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
        static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta, rows, a.d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_kernel<<<dim3(blocks * chunk_ctas(chunks), a.H, groups), kCtaWarps * 32, dq_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.terms, a.region_ids, static_cast<T*>(a.dq),
      a.dbias_part, a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((kBf16 ? a.B : a.B * blocks) * chunk_ctas(chunks), a.H), kCtaWarps * 32, kv_smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, a.terms, a.region_ids, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.B, a.H, a.N, a.d, a.nW, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t hnn = static_cast<size_t>(a.H) * a.N * a.N;
  size_t reduce_blocks = (hnn + 255) / 256;
  if (reduce_blocks > 4096) reduce_blocks = 4096;
  dbias_reduce64_kernel<<<static_cast<unsigned>(reduce_blocks), 256, 0, a.stream>>>(a.dbias_part, a.dbias, groups,
                                                                                    a.H, a.N, Np);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, kRegion>(a);
  if (a.mask != nullptr) return launch<T, kMask>(a);
  return launch<T, kNone>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when every launch was accepted. As
// icl_window_attention_bwd (window_attention_bwd.cu) at tile 64, for a head
// dim D above 64 (run in head_dim_chunks(D) chunks; a smaller D, or one
// whose geometry does not fit, is refused): the forward's output `out` and
// row log-sum-exp `lse` [B, H, N] f32 (required; a bf16 `out` is not
// read), scratch `delta` [B, H, N] f32, `terms` [T, H, Np, Np] f32 (T = nW
// in MASK, else 1; Np = N padded to a multiple of 16) and `dbias_part` of
// ceil(B / windows_per_cta) * H * N * Np floats, windows_per_cta being the
// dQ kernel's. The CTA's width and shared memory are those
// icl_window_attention_wide_bwd_geometry reports.
int icl_window_attention_wide_bwd(const void* q, const void* k, const void* v, const void* dout, const void* out,
                                  const void* lse, const void* bias, const void* region_ids, const void* mask,
                                  void* dq, void* dk, void* dv, void* delta, void* terms, void* dbias_part,
                                  void* dbias, int B, int H, int N, int D, int nW, int windows_per_cta,
                                  float scale, int is_bf16, void* stream) {
  if (windows_per_cta < 1 || N < 1 || D <= 64) return cudaErrorInvalidValue;
  if (out == nullptr || lse == nullptr || delta == nullptr || terms == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, out,
               static_cast<const float*>(lse), static_cast<const float*>(bias),
               static_cast<const float*>(region_ids), static_cast<const float*>(mask), dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(terms), static_cast<float*>(dbias_part),
               static_cast<float*>(dbias), B, H, N, D, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_mode<__nv_bfloat16>(a) : launch_mode<float>(a);
}

// The launch geometry at windows of N tokens and head dim D (above 64), in
// the mode that `has_ids` (REGION), else `has_mask` (MASK), else neither
// (NONE) selects: the warps of a CTA, the larger of the two kernels' shared
// memory in bytes, and how many dQ CTAs one SM of the current device holds,
// 0 when the window does not fit. Returns a cudaError_t.
int icl_window_attention_wide_bwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                           int* smem, int* ctas) {
  if (N < 1 || D <= 64) return cudaErrorInvalidValue;
  *warps = kCtaWarps;
  *smem = static_cast<int>(smem_bytes(N, is_bf16 != 0, has_ids ? kRegion : has_mask ? kMask : kNone, D));
  return is_bf16 ? occupancy_mode<__nv_bfloat16>(N, D, has_ids, has_mask, ctas)
                 : occupancy_mode<float>(N, D, has_ids, has_mask, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
