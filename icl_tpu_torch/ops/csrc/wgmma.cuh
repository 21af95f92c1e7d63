// Hopper's warpgroup products (wgmma.mma_async, sm_90a only) and the
// barriers around them, for the tile-64 window-attention forward, in raw
// PTX.
//
//   * A warpgroup (four consecutive warps, 128 threads) issues each product
//     together; warp w of it owns rows 16 w .. 16 w + 15 of the 64-row
//     tile. The accumulator of m64nN holds, at lane 4 g + t, d[i] = D[16 w
//     + g + 8 ((i >> 1) & 1)][8 (i >> 2) + 2 t + (i & 1)]: per 8-column
//     block the C fragment of mma.sync m16n8k8. An A operand from registers
//     is the A fragment of mma.sync, per warp: tf32 (k8) a0 = A[g][t], a1 =
//     A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]; bf16 (k16) the
//     pairs at columns (2t, 2t + 1) and (2t + 8, 2t + 9).
//   * Operands in shared memory are described by a 64-bit descriptor, here
//     always the 128-byte swizzle: rows of 128 bytes, eight rows to a
//     1024-byte atom (aligned to 1024), 16-byte chunk c of row r stored at
//     chunk c ^ (r % 8) of its row (sw128_chunk), the next eight rows 1024
//     bytes on (SBO). K-major (the k index along the row): a k-step of 32
//     bytes (8 tf32, 16 bf16) is the descriptor's start moved 32 bytes.
//     MN-major (bf16 only: tf32 takes no transposed operand): rows are k,
//     the 64 values of a row the n index; a k-step of 16 rows is 2048
//     bytes on.
//   * Barriers between warpgroups: mbarriers (a producer's tiles ready, a
//     slot free again), named barriers (one warpgroup), and setmaxnreg to
//     move registers from a producer warpgroup to the consumers.
//   * The products run asynchronously: fence (orders this thread's earlier
//     register and shared-memory accesses before the products), the
//     products, commit (closes a group), wait (until at most N groups are
//     in flight). Registers a product reads or writes are touched by no
//     other instruction between its issue and the wait; fence_operands
//     keeps the compiler from moving such accesses across. Shared memory
//     written by ordinary stores (or cp.async) is made visible to the
//     products' async proxy by fence_proxy_async before the barrier that
//     publishes it.

#pragma once

#include <stdint.h>

namespace {

// Byte offset of 16-byte chunk c of row r of a tile of R rows of 64 values
// in the 128-byte swizzle: f32's 16 chunks a row split into two tiles [R][32]
// (values 0 .. 31, then 32 .. 63), R * 128 bytes apart; bf16's 8 in one.
__device__ __forceinline__ int sw128_chunk(int r, int c, int R) {
  return (c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The descriptor of a 128-byte-swizzled operand whose tile starts at shared
// address `addr` (1024-aligned but for a k-step's offset): LBO 1 (unused by
// the swizzled layouts this kernel gives it), SBO 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// A descriptor moved by `bytes` (a multiple of 16) within its tile.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, int bytes) { return desc + (bytes >> 4); }

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// A barrier of `count` threads (a multiple of 32) by id, 1 .. 15 (0 is
// __syncthreads'): one warpgroup's, apart from the others.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A warpgroup gives up registers (dec) or takes them (inc) from the CTA's
// pool, to REGS a thread; every warp of the warpgroup runs it together.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// mbarriers in shared memory (8 bytes each): init by one thread, arrive
// (release), wait for the phase of parity `parity` to complete (acquire).
// A wait that has not returned after about 2^34 clocks (seconds) traps:
// a fault to the caller instead of a card that never finishes.
__device__ __forceinline__ void mbar_init(uint32_t addr, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(addr) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// Each product below: d = A.B + (scale_d ? d : 0), f32 accumulators.

// d[64 x 32] (+)= A[64 x 8] . B[8 x 32], tf32, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64], tf32, A from registers, B K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64 x 32] (+)= A[64 x 16] . B[16 x 32], bf16, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_bf16_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], bf16, A from registers, B MN-major (transposed).
__device__ __forceinline__ void wgmma_bf16_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace
