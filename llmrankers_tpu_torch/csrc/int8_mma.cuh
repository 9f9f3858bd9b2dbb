// Pieces of the int8 tensor-core GEMMs: the per-row, per-K-block activation
// quantize pass (every int8 and int4 GEMM), and for the mma.sync bodies of
// int8_fusedq.cu the m16n8k32 s8 mma, ldmatrix, and the byte transpose that
// stages an N-contiguous int8 weight tile K-major.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 256;  // eight warps, one (row, K-block) each
constexpr float kAmaxFloor = (float)1e-8;
constexpr float kInv127 = (float)(1.0 / 127.0);

// Per-row, per-K-block quantization, with the TPU body's arithmetic:
// scale = max(amax, 1e-8) * f32(1/127), q = clip(rint(x * rcp_rn(scale)),
// -127, 127). Writes q to x8 [M, K] and the scale to sx [M, K/kb].
__global__ void __launch_bounds__(kQuantThreads)
    quantize_blocks_kernel(const __nv_bfloat16* __restrict__ x,
                           int8_t* __restrict__ x8, float* __restrict__ sx, int M, int K,
                           int kb) {
  const int nk = K / kb;
  const long long task =
      (long long)blockIdx.x * (kQuantThreads / 32) + threadIdx.x / 32;
  if (task >= (long long)M * nk) return;
  const int lane = threadIdx.x % 32;
  const long long row = task / nk;
  const int b = (int)(task % nk);
  const __nv_bfloat16* xr = x + row * K + (long long)b * kb;
  int8_t* qr = x8 + row * K + (long long)b * kb;

  float amax = 0.f;
  for (int c = lane * 8; c < kb; c += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float scale = __fmul_rn(fmaxf(amax, kAmaxFloor), kInv127);
  const float inv = __frcp_rn(scale);
  for (int c = lane * 8; c < kb; c += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int q = __float2int_rn(__fmul_rn(__bfloat162float(e[i]), inv));
      q = min(127, max(-127, q));
      packed[i / 4] |= (uint32_t)(q & 0xff) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) sx[row * nk + b] = scale;
}

// The quantize pass over [M, K] in K-blocks of kb; returns cudaGetLastError().
inline cudaError_t launch_quantize(const __nv_bfloat16* x, int8_t* x8, float* sx, int M,
                                   int K, int kb, cudaStream_t stream) {
  const long long tasks = (long long)M * (K / kb);
  const int warps = kQuantThreads / 32;
  quantize_blocks_kernel<<<(unsigned)((tasks + warps - 1) / warps), kQuantThreads, 0,
                           stream>>>(x, x8, sx, M, K, kb);
  return cudaGetLastError();
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 16-byte matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i). Thread l receives bytes 4(l%4)..4(l%4)+3
// of row l/4 of each matrix: for int8 that is the m16n8k32 fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Stages four k-rows (4*kg..4*kg+3) of eight int8 columns (ng*8..ng*8+7)
// K-contiguous: w[r][0] holds columns 0-3 of k-row r, w[r][1] columns 4-7;
// the four k-rows of each column become one 32-bit word (k in byte order) at
// byte 4*kg of shared row ng*8 + column (rows of row_bytes bytes). The four
// lanes that share k-rows (ng % 4 = 0..3) store their columns in an order
// rotated by 2 * (ng % 4), so each store instruction of a warp writes 32
// distinct banks.
__device__ __forceinline__ void store_b_transposed(const uint32_t (&w)[4][2], int8_t* bs,
                                                   int row_bytes, int kg, int ng) {
  uint32_t cols[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t lo01 = __byte_perm(w[0][h], w[1][h], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0][h], w[1][h], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2][h], w[3][h], 0x5140);
    const uint32_t hi23 = __byte_perm(w[2][h], w[3][h], 0x7362);
    cols[h * 4 + 0] = __byte_perm(lo01, lo23, 0x5410);
    cols[h * 4 + 1] = __byte_perm(lo01, lo23, 0x7632);
    cols[h * 4 + 2] = __byte_perm(hi01, hi23, 0x5410);
    cols[h * 4 + 3] = __byte_perm(hi01, hi23, 0x7632);
  }
  // Rotate by 2 * q: by 4 when q & 2, then by 2 when q & 1. The indices
  // are constants after unrolling, so the words stay in registers.
  const int q = ng % 4;
  uint32_t tmp[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) tmp[c] = cols[c];
#pragma unroll
  for (int c = 0; c < 8; ++c) cols[c] = (q & 2) ? tmp[(c + 4) % 8] : tmp[c];
#pragma unroll
  for (int c = 0; c < 8; ++c) tmp[c] = cols[c];
#pragma unroll
  for (int c = 0; c < 8; ++c) cols[c] = (q & 1) ? tmp[(c + 2) % 8] : tmp[c];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = (c + 2 * q) % 8;
    *reinterpret_cast<uint32_t*>(bs + (ng * 8 + col) * row_bytes + kg * 4) = cols[c];
  }
}

}  // namespace
