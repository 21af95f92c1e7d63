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
// One template, MODE = NONE, REGION or MASK, tile DT = 16, 32 or 64 (any
// head dim d of 1 .. DT: the operands are staged at width DT with zero
// columns past d, see mma_tf32.cuh; so d = 1 .. 64 in all), input type
// float or bf16, f32 math, output in the input type.
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
// operations at the SwinUNETR shapes (N = 343, D = 16: about 86).
//
// Design (the building blocks are in mma_tf32.cuh, shared with the
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
//   * Tile 64 (head dims 33 .. 64: SwinUNETR fs99 .. fs192, Swin-UNet
//     embeddings of 33 .. 64 a head): two buffers of K and V [Np, 64] take
//     363 KB at N = 343 (Np 352), past a CTA's 227 KB. Where two do not
//     fit, K and V are staged once per window into one buffer (181 KB),
//     after every warp is done with the window before, giving up the
//     overlap of the next window's load with this one's products; where
//     they fit (N = 144: 148 KB, N = 49) the two buffers stay. Chosen over
//     streaming key blocks through shared memory under the online softmax,
//     which would make the shared memory independent of N, because a warp
//     would then hold the running state of every row tile it owns across
//     the key blocks (22 tiles at N = 343) or the CTA would need a warp per
//     row tile, neither of which the registers allow at tile 64. The Q
//     fragments (64 registers a lane in f32) and the 16 x 64 accumulator
//     (32) need more than 128 registers a thread, so the tile-64 instances
//     run one CTA an SM (its launch bounds), which the shared memory at
//     N = 343 forces anyway.
//   * Short windows (N < 8 leaves lanes with only padded keys): the online
//     softmax takes 0 as its reference while its max is -inf, so N = 4
//     gives no e^(-inf + inf).
//   * Head dims below the tile (SwinUNETR at feature sizes other than 48
//     and 96: d = fs / 3) run the tile's products on zero columns: d = 8
//     does the work of d = 16. Only the columns below d are stored. Each
//     tile has two instances: FULL for its own head dim, with d a constant
//     (the code the tile ran before it took smaller head dims), and one
//     that reads d at run time, which alone made the f32 forward at head
//     dim 16 2-4% slower than before in NONE and REGION (PERF.md). At tile
//     64 the runtime-d instance is 16-25% slower at head dim 64 in REGION
//     and MASK (f32 and bf16), so it keeps its FULL instance too (PERF.md).
//     The backward has no such fork: its runtime-d instance is as fast.
//   * The row log-sum-exp, lse = m + log l of the online softmax (f32 [B,
//     H, N]), is stored at tile 64 where the caller passes a buffer for it:
//     the tile-64 backward takes P = e^(s - lse) from it instead of a sweep
//     over the keys. The wrapper passes one only when the output needs a
//     gradient. The store is an instance of its own (LSE): with it merely
//     compiled into every instance, the forward ran 2-4% slower at tiles 16
//     and 32 and 6-8% in bf16 at tile 64 (PERF.md), so every instance
//     without it is the code it was.
//   * The warps and the shared memory are chosen here from N and D;
//     icl_window_attention_fwd_geometry reports them with the resident CTAs
//     an SM, from which the caller sizes the grid. Every output element has
//     one owner and a fixed order of sums: two runs on the same inputs are
//     bitwise equal.

#include "mma_tf32.cuh"

#include <type_traits>

namespace {

// Warps per CTA at most: the launch bounds, with two CTAs an SM at up to
// 128 registers a thread (tiles 16 and 32), one at up to 255 (tile 64).
constexpr int kMaxWarps = 8;
__host__ __device__ constexpr int min_ctas(int DT) { return DT == 64 ? 1 : 2; }

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

// Buffers of K, V and ids: two, but one at tile 64 where two exceed a
// CTA's shared memory (N > 224).
__host__ __device__ inline int buffers(int N, int DT) {
  return DT < 64 || 2 * buffer_floats(N, DT) * static_cast<int>(sizeof(float)) <= kMaxSmemBytes ? 2 : 1;
}

template <typename T, int DT, int MODE, bool FULL, bool LSE>
__global__ void __launch_bounds__(kMaxWarps * 32, min_ctas(DT))
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ bias, const float* __restrict__ region_ids,
                        const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse, int B,
                        int H, int N, int d_in, int nW, int windows_per_cta, float scale) {
  const int d = FULL ? DT : d_in;  // the tile's own head dim: the compiler folds d
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  constexpr int KD = DT / 8;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int per_buffer = buffer_floats(N, DT);
  const int nbuf = DT == 64 ? buffers(N, DT) : 2;  // 2 folded in at tiles 16 and 32

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
  for (int op = 0; op < 2 * nbuf; ++op)  // K, V of buffer 0; of buffer 1
    zero_pad<DT>(smem + (op >> 1) * per_buffer + (op & 1) * Np * DT, N, Np, d);
  if (b_begin < b_end) stage(0, b_begin);

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = nbuf == 2 ? (b - b_begin) & 1 : 0;
    if (nbuf == 2 && b + 1 < b_end) {
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
        // l is relative to m, the row's max, finite at a real row
        if (LSE && t == 0) lse[(static_cast<size_t>(b) * H + h) * N + rows[r]] = m[r] + __logf(l[r]);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is staged again
    if (nbuf == 1 && b + 1 < b_end) stage(0, b + 1);  // one buffer: free only now
  }
}

// K, V and ids buffers at tile width DT, two of them or one (buffers)
size_t smem_bytes(int N, int DT) {
  return static_cast<size_t>(buffers(N, DT)) * buffer_floats(N, DT) * sizeof(float);
}

int cta_warps(int N) { return tile_warps(N, kMaxWarps); }

template <typename T, int DT, int MODE, bool FULL, bool LSE = false>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(window_attention_kernel<T, DT, MODE, FULL, LSE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// CTAs that fit one SM, from the compiled kernel's registers and the
// window's shared memory; 0 when the shared memory exceeds a CTA's limit.
template <typename T, int DT, int MODE, bool FULL>
cudaError_t occupancy(int N, int* ctas) {
  const size_t smem = smem_bytes(N, DT);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) {
    *ctas = 0;
    return cudaSuccess;
  }
  err = prepare<T, DT, MODE, FULL>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, window_attention_kernel<T, DT, MODE, FULL, false>,
                                                       cta_warps(N) * 32, smem);
}

template <typename T, int DT, bool FULL>
cudaError_t occupancy_mode(int N, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, DT, kRegion, FULL>(N, ctas);
  if (has_mask) return occupancy<T, DT, kMask, FULL>(N, ctas);
  return occupancy<T, DT, kNone, FULL>(N, ctas);
}

// The instance of tile DT for head dim D: FULL where D is the tile's own.
template <typename T, int DT>
cudaError_t occupancy_dim(int N, int D, bool has_ids, bool has_mask, int* ctas) {
  return D == DT ? occupancy_mode<T, DT, true>(N, has_ids, has_mask, ctas)
                 : occupancy_mode<T, DT, false>(N, has_ids, has_mask, ctas);
}

// The pointers and sizes of one forward call.
struct Args {
  const void *q, *k, *v;
  const float *bias, *region_ids, *mask;
  void* out;
  float* lse;
  int B, H, N, d, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DT, int MODE, bool FULL, bool LSE>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.N, DT);
  cudaError_t err = prepare<T, DT, MODE, FULL, LSE>(smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  window_attention_kernel<T, DT, MODE, FULL, LSE><<<dim3(groups, a.H), cta_warps(a.N) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.bias, a.region_ids,
      a.mask, static_cast<T*>(a.out), a.lse, a.B, a.H, a.N, a.d, a.nW, a.windows_per_cta, a.scale);
  return cudaGetLastError();
}

template <typename T, int DT, bool FULL, bool LSE>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, DT, kRegion, FULL, LSE>(a);
  if (a.mask != nullptr) return launch<T, DT, kMask, FULL, LSE>(a);
  return launch<T, DT, kNone, FULL, LSE>(a);
}

template <int DT, bool LSE>
cudaError_t launch_lse(const Args& a, int is_bf16) {
  if (a.d == DT) return is_bf16 ? launch_mode<__nv_bfloat16, DT, true, LSE>(a) : launch_mode<float, DT, true, LSE>(a);
  return is_bf16 ? launch_mode<__nv_bfloat16, DT, false, LSE>(a) : launch_mode<float, DT, false, LSE>(a);
}

// The tile's own head dim runs the FULL instance (d folded to DT), any
// smaller one the instance that reads d at run time; at tile 64 an
// instance that also stores the row log-sum-exp where `lse` is set.
template <int DT>
cudaError_t launch_type(const Args& a, int is_bf16) {
  if (a.lse == nullptr) return launch_lse<DT, false>(a, is_bf16);
  if constexpr (DT == 64) return launch_lse<DT, true>(a, is_bf16);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `region_ids` set
// selects REGION, else `mask` set selects MASK, else NONE (at most one of
// the two is set). `lse`, where set, receives the row log-sum-exp [B, H, N]
// f32 of the scaled logits; head dims 33 .. 64 only (tile 64). `is_bf16` selects the input type. The head dim D is any
// of 1 .. 64 (SwinUNETR: feature size / 3, 16 at fs48, 8 at fs24, 64 at
// fs192; Swin-UNet 2D, embed 96: 32); D <= 16 runs the tile-16 instance,
// D <= 32 the tile-32 one, D <= 64 the tile-64 one (head_dim_tile). A CTA
// takes `windows_per_cta` windows of one head;
// its width and shared memory are those icl_window_attention_fwd_geometry
// reports.
int icl_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* region_ids, const void* mask, void* out, void* lse, int B,
                             int H, int N, int D, int nW, int windows_per_cta, float scale, int is_bf16,
                             void* stream) {
  if (windows_per_cta < 1 || N < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(bias), static_cast<const float*>(region_ids),
               static_cast<const float*>(mask), out, static_cast<float*>(lse),
               B, H, N, D, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  const int tile = head_dim_tile(D);
  if (tile == 16) return launch_type<16>(a, is_bf16);
  if (tile == 32) return launch_type<32>(a, is_bf16);
  if (tile == 64) return launch_type<64>(a, is_bf16);
  return cudaErrorInvalidValue;
}

// The launch geometry at windows of N tokens and head dim D (its tile's
// instance), in the mode that `has_ids` (REGION), else `has_mask` (MASK),
// else neither (NONE) selects: the warps of a CTA, its shared memory in
// bytes, and how many such CTAs one SM of the current device holds, 0 when
// the window does not fit. Returns a cudaError_t.
int icl_window_attention_fwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                      int* smem, int* ctas) {
  const int tile = head_dim_tile(D);
  if (N < 1 || tile == 0) return cudaErrorInvalidValue;
  *warps = cta_warps(N);
  *smem = static_cast<int>(smem_bytes(N, tile));
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
