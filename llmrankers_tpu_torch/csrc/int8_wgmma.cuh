// Pieces of the int8 wgmma GEMMs (int8_fusedq.cu, B3, B4, B6; int4_w4a8.cu, B7): the
// mbarrier ring, 2-D TMA loads and stores, shared-memory descriptors and the
// wgmma.mma_async m64nNk32.s32.s8.s8 wrapper, as wgmma_bf16.cuh holds the
// bf16 forms for flash_blhd.cu. int8 wgmma reads both operands from shared
// memory K-major only (the transpose flags exist for 16-bit types alone), so
// A is the activations [M, K] and B the weights' [N, K] buffers: B3's, B4's
// and B6's in rows of 128 bytes under the 128-byte swizzle that TMA writes,
// B7's (packed bytes expanded to s8) in rows of 64 bytes under the 64-byte
// swizzle.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <stdint.h>

namespace s8wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A wait that outlasts 2^26 polls (seconds; a stage takes microseconds)
// traps, so that a broken ring ends the launch with an error instead of
// holding the card. The loop lies inside one asm block: a wait loop in C++
// is a divergent path to ptxas, which then serialises the wgmmas around it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.ne.u32 p, n, %2;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity), "n"(1 << 26)
      : "memory");
}

// One box of a 2-D tensor map (c0 innermost) into shared memory at dst,
// completing on the mbarrier bar.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory at src into a 2-D tensor map at (c0, c1); the
// parts of the box outside the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Waits until the stores issued so far have read their shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over the `count` threads that name barrier `id` (1-15).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A K-major operand tile of 128-byte rows under the 128-byte swizzle: eight
// rows (1024 bytes) per core-matrix group, the leading offset unused; the
// start address moves 32 bytes per k32 step inside the swizzle atom. Tiles
// are 1024-aligned, so the base offset field stays 0.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for 64-byte rows under the 64-byte swizzle: eight rows (512
// bytes) per core-matrix group; the start address moves 32 bytes per k32
// step inside the row. Tiles are 1024-aligned (base offset 0).
__device__ __forceinline__ uint64_t desc_k64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128] in s8 with s32 sums, both operands
// in shared memory K-major; scale_d 0 overwrites D (a K-block's first step).
// Thread T of warp w holds D[w*16 + T/4 + 8h][8j + 2(T%4) + e] in d[4j + 2h + e].
__device__ __forceinline__ void mma_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

}  // namespace s8wg
