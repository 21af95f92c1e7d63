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
// One template, MODE = NONE, REGION or MASK, head dim D = 16 or 32, input
// type float or bf16, f32 math, output in the input type.
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
//     device memory, split into hi and lo, and held in registers. Flash-style
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
//   * The warps and the shared memory are chosen here from N and D;
//     icl_window_attention_fwd_geometry reports them with the resident CTAs
//     an SM, from which the caller sizes the grid. Every output element has
//     one owner and a fixed order of sums: two runs on the same inputs are
//     bitwise equal.

#include "mma_tf32.cuh"

#include <type_traits>

namespace {

// Warps per CTA at most: the launch bounds, with two CTAs an SM at up to
// 128 registers a thread.
constexpr int kMaxWarps = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The A fragments of rows r0 .. r0 + 15 of a [N, D] operand in device
// memory, split once into hi and lo (load_a_split's pattern); 0 past N.
template <int D, bool EXACT, typename T>
__device__ __forceinline__ void load_rows_split(FragA (&a)[D / 8], const T* x, int r0, int N, int g, int t) {
  const int lo = r0 + g;
  const int hi = r0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    a[kk] = split_a<EXACT>(lo < N ? to_float(x[lo * D + c]) : 0.f, hi < N ? to_float(x[hi * D + c]) : 0.f,
                           lo < N ? to_float(x[lo * D + c + 4]) : 0.f,
                           hi < N ? to_float(x[hi * D + c + 4]) : 0.f);
  }
}

// Per buffer: K [Np, D] and V [Np, D] (see sidx), then the ids [Np].
__host__ __device__ inline int buffer_floats(int N, int D) {
  const int Np = (N + 15) & ~15;
  return 2 * Np * D + Np;
}

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ bias, const float* __restrict__ region_ids,
                        const float* __restrict__ mask, T* __restrict__ out, int B, int H, int N,
                        int nW, int windows_per_cta, float scale) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // bf16 is exact in TF32
  constexpr int KD = D / 8;
  extern __shared__ __align__(16) float smem[];
  const int Np = (N + 15) & ~15;
  const int per_buffer = buffer_floats(N, D);

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
    const size_t base = (static_cast<size_t>(b) * H + h) * N * D;
    stage_rows<D>(ks, k + base, N);
    stage_rows<D>(ks + Np * D, v + base, N);
    if (MODE == kRegion) {
      const float* w_ids = region_ids + static_cast<size_t>(b % nW) * N;
      float* ids = ks + 2 * Np * D;
      for (int i = threadIdx.x; i < N; i += blockDim.x) ids[i] = w_ids[i];
    }
    cp_async_commit();
  };

  // the padded rows stay zero for every window, in both buffers
  for (int i = threadIdx.x; i < (Np - N) * D; i += blockDim.x) {  // 4 operands x (Np - N) rows x D / 4 chunks
    const int r = i / (D / 4);
    const int op = r / (Np - N);  // 0, 1: K, V of buffer 0; 2, 3: of buffer 1
    const int at = (op >> 1) * per_buffer + (op & 1) * Np * D + sidx<D>(N + r % (Np - N), (i % (D / 4)) * 4);
    *reinterpret_cast<float4*>(smem + at) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
    const float* vs = ks + Np * D;
    const float* ids = vs + Np * D;
    const size_t base = (static_cast<size_t>(b) * H + h) * N * D;
    const float* mask_w = MODE == kMask ? mask + static_cast<size_t>(b % nW) * N * N : nullptr;

    // lane (g, t) holds rows i0 + g and i0 + g + 8 (e = 0, 1 and e = 2, 3)
    // at keys j0 + 2t and j0 + 2t + 1
    for (int tile = warp; tile < tiles; tile += warps) {
      const int i0 = 16 * tile;
      FragA qa[KD];
      load_rows_split<D, kExact>(qa, q + base, i0, N, g, t);
      const int rows[2] = {i0 + g, i0 + g + 8};
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this lane's keys' share of the row sum
      float acc[KD][4];
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;

      float term[4];
      load_terms<MODE, false>(term, rows, 2 * t, N, bias_h, mask_w);
      for (int j0 = 0; j0 < Np; j0 += 8) {
        float next[4];
        load_terms<MODE, false>(next, rows, j0 + 8 + 2 * t, N, bias_h, mask_w);
        float s[4];
        product_nt<D, kExact>(s, qa, ks, j0, g, t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = logit<MODE>(s[e], term[e], rows[e >> 1], j0 + 2 * t + (e & 1), N, scale, ids);
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
        product_cn<D, kExact>(acc, p, vs, j0, g, t);
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
        T* o = out + base + static_cast<size_t>(rows[r]) * D + 2 * t;
#pragma unroll
        for (int nn = 0; nn < KD; ++nn) store2<T>(o + 8 * nn, acc[nn][2 * r] * inv, acc[nn][2 * r + 1] * inv);
      }
    }
    __syncthreads();  // every warp is done with buffer `cur` before it is staged again
  }
}

// K, V and ids buffers, two of them
size_t smem_bytes(int N, int D) { return 2 * static_cast<size_t>(buffer_floats(N, D)) * sizeof(float); }

int cta_warps(int N) { return tile_warps(N, kMaxWarps); }

template <typename T, int D, int MODE>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(window_attention_kernel<T, D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// CTAs that fit one SM, from the compiled kernel's registers and the
// window's shared memory; 0 when the shared memory exceeds a CTA's limit.
template <typename T, int D, int MODE>
cudaError_t occupancy(int N, int* ctas) {
  const size_t smem = smem_bytes(N, D);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) {
    *ctas = 0;
    return cudaSuccess;
  }
  err = prepare<T, D, MODE>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, window_attention_kernel<T, D, MODE>,
                                                       cta_warps(N) * 32, smem);
}

template <typename T, int D>
cudaError_t occupancy_mode(int N, bool has_ids, bool has_mask, int* ctas) {
  if (has_ids) return occupancy<T, D, kRegion>(N, ctas);
  if (has_mask) return occupancy<T, D, kMask>(N, ctas);
  return occupancy<T, D, kNone>(N, ctas);
}

// The pointers and sizes of one forward call.
struct Args {
  const void *q, *k, *v;
  const float *bias, *region_ids, *mask;
  void* out;
  int B, H, N, nW, windows_per_cta;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int MODE>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.N, D);
  cudaError_t err = prepare<T, D, MODE>(smem);
  if (err != cudaSuccess) return err;
  const int groups = (a.B + a.windows_per_cta - 1) / a.windows_per_cta;
  window_attention_kernel<T, D, MODE><<<dim3(groups, a.H), cta_warps(a.N) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.bias, a.region_ids,
      a.mask, static_cast<T*>(a.out), a.B, a.H, a.N, a.nW, a.windows_per_cta, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mode(const Args& a) {
  if (a.region_ids != nullptr) return launch<T, D, kRegion>(a);
  if (a.mask != nullptr) return launch<T, D, kMask>(a);
  return launch<T, D, kNone>(a);
}

template <int D>
cudaError_t launch_type(const Args& a, int is_bf16) {
  return is_bf16 ? launch_mode<__nv_bfloat16, D>(a) : launch_mode<float, D>(a);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. `region_ids` set
// selects REGION, else `mask` set selects MASK, else NONE (at most one of
// the two is set). `is_bf16` selects the input type. The head dim D must
// be 16 (SwinUNETR fs48: 48/3 = 96/6 = 192/12 = 384/24) or 32 (Swin-UNet
// 2D, embed 96: 96/3 = 192/6 = 384/12 = 768/24). A CTA takes
// `windows_per_cta` windows of one head; its width and shared memory are
// those icl_window_attention_fwd_geometry reports.
int icl_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                             const void* region_ids, const void* mask, void* out, int B, int H,
                             int N, int D, int nW, int windows_per_cta, float scale, int is_bf16,
                             void* stream) {
  if (windows_per_cta < 1 || N < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v,
               static_cast<const float*>(bias), static_cast<const float*>(region_ids),
               static_cast<const float*>(mask), out,
               B, H, N, nW, windows_per_cta, scale, static_cast<cudaStream_t>(stream)};
  if (D == 16) return launch_type<16>(a, is_bf16);
  if (D == 32) return launch_type<32>(a, is_bf16);
  return cudaErrorInvalidValue;
}

// The launch geometry at windows of N tokens and head dim D, in the mode
// that `has_ids` (REGION), else `has_mask` (MASK), else neither (NONE)
// selects: the warps of a CTA, its shared memory in bytes, and how many
// such CTAs one SM of the current device holds, 0 when the window does not
// fit. Returns a cudaError_t.
int icl_window_attention_fwd_geometry(int N, int D, int has_ids, int has_mask, int is_bf16, int* warps,
                                      int* smem, int* ctas) {
  if (N < 1 || (D != 16 && D != 32)) return cudaErrorInvalidValue;
  *warps = cta_warps(N);
  *smem = static_cast<int>(smem_bytes(N, D));
  if (D == 16)
    return is_bf16 ? occupancy_mode<__nv_bfloat16, 16>(N, has_ids, has_mask, ctas)
                   : occupancy_mode<float, 16>(N, has_ids, has_mask, ctas);
  return is_bf16 ? occupancy_mode<__nv_bfloat16, 32>(N, has_ids, has_mask, ctas)
                 : occupancy_mode<float, 32>(N, has_ids, has_mask, ctas);
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
