// The per-row, per-K-block activation quantize pass that every int8 and
// int4 GEMM of the port runs before its wgmma kernel (B3, B4, B6, B7).
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

}  // namespace
