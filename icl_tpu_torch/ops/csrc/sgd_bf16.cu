// Fused SGD update of a bf16 train state with stochastically rounded stores,
// for Hopper (sm_90a).
//
// Replaces icl_tpu/train/optim.py:_sgd_bf16_state (:73-120), which is XLA
// ops, not a Pallas kernel: for every element of one bf16 leaf, in f32,
//
//   g32  = g + wd * p          (g = 0 for a leaf that got no gradient)
//   b32  = m * buf + g32
//   p32  = p - lr * b32
//
// and the new buf and p are each rounded to bf16 stochastically
// (icl_tpu/train/optim.py:stochastic_round_bf16, :44-64): 16 random bits
// are added below the bf16 mantissa of the f32 bit pattern, which is then
// truncated. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no contraction into FMA), as the plain PyTorch
// version in ops/sgd_bf16.py computes them, so that the two agree bit for
// bit.
//
// The dither: Philox4x32-10 (Salmon et al. 2011) with key (seed low 32
// bits, seed high 32 bits) and counter (element group i / 4, update
// count, leaf index, 0). Word j of its output belongs to element 4 * (i /
// 4) + j: the low 16 bits dither buf (stream 0), the high 16 bits p
// (stream 1). The JAX package draws its bits from rng_bit_generator,
// which is implementation-defined, so the two packages agree on the
// rounding rule and not on the bits.
//
// What bounds it: 10 bytes a parameter (read g, p, buf; write p, buf), 3.4
// ms for the flagship's 1.15 B parameters at 3.35 TB/s. The Philox rounds
// are about 20 integer operations per round per four elements, inside
// the card's integer rate at that traffic.
//
// Design: one thread per 8 elements, 16-byte loads and stores of g, p and
// buf, two Philox calls a thread; the lr (f32) and the update count
// (int64) are read from device memory, so that a CUDA graph that captured
// the launch takes each replay's values. A ragged tail, or a leaf that is
// not 16-byte aligned, takes the scalar path of the same arithmetic.
//
// A shard of a leaf (tensor parallelism) draws the dithers of its
// elements' indices in the whole leaf: local element i is global element
// offset + (i / cols) * stride + i % cols (cols == stride: offset + i, a
// block of rows; else a block of columns, cols of each row of stride).
// Where a thread's 8 elements are 8 consecutive global elements from a
// multiple of 4, it makes the two Philox calls of the unsharded leaf;
// else one per element, of that element's group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
  const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  c = philox_round(c, k0, k1);
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    k0 += kW0;
    k1 += kW1;
    c = philox_round(c, k0, k1);
  }
  return c;
}

__device__ __forceinline__ __nv_bfloat16 round_bf16(float x, uint32_t dither16) {
  const uint32_t bits = (__float_as_uint(x) + dither16) & 0xFFFF0000u;
  return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
}

struct Update {
  float lr, momentum, wd;
  __device__ __forceinline__ void operator()(float g, float& p, float& b) const {
    const float g32 = __fadd_rn(g, __fmul_rn(wd, p));
    b = __fadd_rn(__fmul_rn(momentum, b), g32);
    p = __fsub_rn(p, __fmul_rn(lr, b));
  }
};

__device__ __forceinline__ uint32_t word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

__device__ __forceinline__ uint4 dither_group(unsigned long long gi, uint32_t cnt, uint32_t leaf,
                                              uint32_t seed_lo, uint32_t seed_hi) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(gi), cnt, leaf, static_cast<uint32_t>(gi >> 32)),
                       seed_lo, seed_hi);
}

struct IndexMap {
  long long offset, cols, stride;
  __device__ __forceinline__ long long operator()(long long i) const {
    return offset + (i / cols) * stride + i % cols;
  }
};

__global__ void __launch_bounds__(kThreads)
sgd_bf16_kernel(__nv_bfloat16* __restrict__ p, const __nv_bfloat16* __restrict__ g,
                __nv_bfloat16* __restrict__ buf, long long n, const float* __restrict__ lr,
                const long long* __restrict__ count, float momentum, float wd, uint32_t seed_lo,
                uint32_t seed_hi, uint32_t leaf, int vector_ok, IndexMap map, int map_aligned) {
  const long long first = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (first >= n) return;
  const Update upd{*lr, momentum, wd};
  const uint32_t cnt = static_cast<uint32_t>(*count);
  uint32_t words[kPerThread];
  if (map_aligned) {  // 8 consecutive global elements from a multiple of 4
    const long long group = map(first) >> 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 d = dither_group(static_cast<unsigned long long>(group + h), cnt, leaf, seed_lo,
                                   seed_hi);
#pragma unroll
      for (int j = 0; j < 4; ++j) words[4 * h + j] = word(d, j);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const long long gi = map(first + e < n ? first + e : first);
      words[e] = word(dither_group(static_cast<unsigned long long>(gi >> 2), cnt, leaf, seed_lo,
                                   seed_hi), static_cast<int>(gi & 3));
    }
  }
  if (vector_ok && first + kPerThread <= n) {
    uint4 gv = make_uint4(0u, 0u, 0u, 0u);
    if (g != nullptr) gv = *reinterpret_cast<const uint4*>(g + first);
    uint4 pv = *reinterpret_cast<const uint4*>(p + first);
    uint4 bv = *reinterpret_cast<const uint4*>(buf + first);
    const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
    __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(&pv);
    __nv_bfloat16* be = reinterpret_cast<__nv_bfloat16*>(&bv);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      float pf = __bfloat162float(pe[e]), bf = __bfloat162float(be[e]);
      upd(__bfloat162float(ge[e]), pf, bf);
      const uint32_t w = words[e];
      be[e] = round_bf16(bf, w & 0xFFFFu);
      pe[e] = round_bf16(pf, w >> 16);
    }
    *reinterpret_cast<uint4*>(p + first) = pv;
    *reinterpret_cast<uint4*>(buf + first) = bv;
    return;
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {  // unrolled, so that words[] stays in registers
    const long long i = first + e;
    if (i >= n) break;
    float pf = __bfloat162float(p[i]), bf = __bfloat162float(buf[i]);
    upd(g != nullptr ? __bfloat162float(g[i]) : 0.0f, pf, bf);
    const uint32_t w = words[e];
    buf[i] = round_bf16(bf, w & 0xFFFFu);
    p[i] = round_bf16(pf, w >> 16);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. p, buf: the
// leaf's bf16 parameter and momentum, updated in place; g: its bf16
// gradient, or null for none (taken as 0); n elements, contiguous; lr: a
// device f32; count: a device int64, the number of updates already made;
// offset, cols, stride: the global index of local element i, offset + (i
// / cols) * stride + i % cols (0, n, n for a whole leaf; cols == stride
// for a block of rows).
int icl_sgd_bf16(void* p, const void* g, void* buf, long long n, const void* lr,
                 const void* count, float momentum, float weight_decay,
                 unsigned long long seed, int leaf, long long offset, long long cols,
                 long long stride, void* stream) {
  if (n <= 0) return 0;
  if (cols <= 0 || stride < cols || offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(buf) |
                         reinterpret_cast<uintptr_t>(g)) & 15u) == 0;
  // every thread's 8 elements map to 8 consecutive global ones from a multiple of 4
  const bool map_aligned = (offset & 3) == 0 &&
                           (cols == stride ? true : (cols & 7) == 0 && (stride & 3) == 0);
  const long long threads = (n + kPerThread - 1) / kPerThread;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  sgd_bf16_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(p), static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(buf), n, static_cast<const float*>(lr),
      static_cast<const long long*>(count), momentum, weight_decay,
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32), static_cast<uint32_t>(leaf),
      aligned ? 1 : 0, IndexMap{offset, cols, stride}, map_aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

const char* icl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
