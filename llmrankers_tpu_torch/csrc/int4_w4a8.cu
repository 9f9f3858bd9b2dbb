// W4A8 GEMM: group-wise int4 weights, activations quantized to int8 in a
// pass before it, for sm_90a.
//
// Replaces the TPU kernel llmrankers_tpu/ops/int4_matmul.py::
// quantized_matmul_int4 (body _kernel_w4a8). The weight is packed by
// pack_int4: per group of G input rows (G 128, 256 or 512) and output column,
// packed row r of the group holds byte (hi4 << 4) | (lo4 + 8), where lo4 is
// the weight of input row gG + r and hi4 that of row gG + G/2 + r, both in
// [-7, 7]; the group scales are f32 [K/G, N]. x is bf16 [M, K], quantized
// per row and per group exactly as the W8A8 kernels quantize per K-block
// (int8_mma.cuh), and the pass also writes z = 8 * (sum of the row's int8
// values over the first half of the group). For each group the kernel takes
// two int32 dots, in the TPU body's form:
//   acc_lo = q[gG .. gG+G/2) . (p & 0x0F)     (lo4 + 8, in [1, 15])
//   acc_hi = q[gG+G/2 .. gG+G) . (p & 0xF0)   (16 * hi4 as a signed byte)
// and folds them in its order, with round-to-nearest f32 steps:
//   d = float(acc_lo - z) + float(acc_hi) * 0.0625
//   accf += (d * sx[row, g]) * sw[g, col]
// then writes accf (+ residual) as bf16. acc_lo - z is q_lo . lo4 exactly,
// and float(16 S) * 0.0625 == float(S), so an arithmetic-shift unpack would
// give the same bits; the masks keep each nibble plane one AND per word.
//
// Design. One block of eight warps per 64 x 128 output tile; a stage reads
// 64 packed rows of the tile's 128 columns once (the weight bytes are read
// once per block) and unpacks them while it stages them K-major, as the W8A8
// kernel transposes its B tile, into two int8 planes: the lo plane for A
// columns gG + s .. + 64 and the hi plane for A columns gG + G/2 + s .. + 64,
// whose two 64-byte pieces per row are staged beside them. Each warp owns
// 32 rows x 32 columns with two int32 accumulator sets (lo, hi) and one f32
// set, so three register sets stay under the limit without spills. Two
// shared buffers of 30 KB (rows padded to 80 bytes, conflict-free ldmatrix),
// filled from registers as in the W8A8 kernel; dynamic shared memory, since
// the two buffers exceed the 48 KB a static array may hold. Ragged M is
// masked; N must be a multiple of 128, so every column tile is full.
//
// What bounds it. At Qwen2.5-3B's FFN shapes (M = 20480; K 2048, N 11008,
// G 512; K 11008, N 2048, G 256) the work is bound by the int8 tensor-core
// rate; at small M by the packed weight's bytes. mma.sync from registers and
// one stage of prefetch leave most of the tensor-core rate unused; wgmma,
// TMA and a deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps: 2 along M x 4 along N
constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 64;        // packed rows per stage = K of each plane
constexpr int kRow = kBK + 16; // shared-memory row stride in bytes
constexpr int kPlaneA = kBM * kRow;
constexpr int kPlaneB = kBN * kRow;
constexpr int kStageBytes = 2 * (kPlaneA + kPlaneB);  // lo + hi planes of A and B
constexpr int kSmemBytes = 2 * kStageBytes;

struct W4Params {
  const int8_t* x8;          // [M, K] quantized activations
  const int8_t* p4;          // [K/2, N] packed int4
  const float* sx;           // [M, K/G] activation scales
  const int* z;              // [M, K/G] 8 * sum of the lo half's int8 values
  const float* sw;           // [K/G, N] group scales
  const __nv_bfloat16* res;  // [M, N] or null
  __nv_bfloat16* out;        // [M, N]
  int M, K, N, G;
};

struct Stage {
  uint4 a[2];  // two 16-byte pieces of A rows (lo or hi plane)
  uint2 b[4];  // four packed k-rows of eight columns
};

// Stage s covers packed rows s*64 .. s*64+63: group s / (G/128), offset
// (s % (G/128)) * 64 within its half. Eight threads per A row: pieces 0-3
// read the lo plane's 64 bytes, pieces 4-7 the hi plane's.
__device__ __forceinline__ void load_stage(Stage& st, const W4Params& p, int m0, int s,
                                           int tid, int kg, const int8_t* wcol) {
  const int half = p.G / 2, per_group = half / kBK;
  const int k0 = (s / per_group) * p.G + (s % per_group) * kBK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 8, piece = idx % 8;
    const int col = k0 + (piece / 4) * half + (piece % 4) * 16;
    st.a[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < p.M) {
      st.a[i] = *reinterpret_cast<const uint4*>(p.x8 + (long long)(m0 + r) * p.K + col);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    st.b[r] = *reinterpret_cast<const uint2*>(wcol + (long long)(s * kBK + kg * 4 + r) * p.N);
  }
}

// Shared layout of a buffer: A lo, A hi (64 rows each), B lo, B hi (128
// K-contiguous columns each).
__device__ __forceinline__ void store_stage(const Stage& st, int8_t* buf, int tid, int kg,
                                            int ng) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 8, piece = idx % 8;
    *reinterpret_cast<uint4*>(buf + (piece / 4) * kPlaneA + r * kRow + (piece % 4) * 16) =
        st.a[i];
  }
  uint32_t lo[4][2], hi[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = h ? st.b[r].y : st.b[r].x;
      lo[r][h] = w & 0x0F0F0F0Fu;  // lo4 + 8
      hi[r][h] = w & 0xF0F0F0F0u;  // 16 * hi4
    }
  }
  store_b_transposed(lo, buf + 2 * kPlaneA, kRow, kg, ng);
  store_b_transposed(hi, buf + 2 * kPlaneA + kPlaneB, kRow, kg, ng);
}

__global__ void __launch_bounds__(kThreads) w4a8_gemm_kernel(const W4Params p) {
  extern __shared__ __align__(16) int8_t smem[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = p.K / p.G;
  const int per_group = p.G / 2 / kBK, stages = p.K / 2 / kBK;

  // B staging as in the W8A8 kernel: k-rows 4*kg..4*kg+3 of columns
  // ng*8..ng*8+7.
  const int kg = (warp % 2) * 8 + lane / 4, ng = (warp / 2) * 4 + lane % 4;
  const int8_t* wcol = p.p4 + n0 + ng * 8;

  float accf[2][4][4];
  int acc[2][2][4][4];  // [plane][i][j][e]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[i][j][e] = 0.f;
        acc[0][i][j][e] = 0;
        acc[1][i][j][e] = 0;
      }

  Stage st;
  load_stage(st, p, m0, 0, tid, kg, wcol);
  store_stage(st, smem, tid, kg, ng);
  __syncthreads();
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix mi, its row mr
  for (int s = 0; s < stages; ++s) {
    const int8_t* buf = smem + (s & 1) * kStageBytes;
    if (s + 1 < stages) load_stage(st, p, m0, s + 1, tid, kg, wcol);

#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const int8_t* as = buf + pl * kPlaneA;
      const int8_t* bs = buf + 2 * kPlaneA + pl * kPlaneB;
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
        uint32_t bf[4][2];
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, bs + (wn * 32 + (j + mi / 2) * 8 + mr) * kRow + ks + (mi % 2) * 16);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t af[4];
          ldmatrix_x4(af, as + (wm * 32 + i * 16 + (mi % 2) * 8 + mr) * kRow + ks +
                              (mi / 2) * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[pl][i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }

    if ((s + 1) % per_group == 0) {
      // The group ends: fold in the TPU body's order, then reset both sums.
      const int grp = s / per_group;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + i * 16 + g + h * 8;
          const bool valid = row < p.M;
          const float sc = valid ? p.sx[(long long)row * nk + grp] : 0.f;
          const int zz = valid ? p.z[(long long)row * nk + grp] : 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + wn * 32 + j * 8 + 2 * t + e;
              const int c = 2 * h + e;
              const float d = __fadd_rn(__int2float_rn(acc[0][i][j][c] - zz),
                                        __fmul_rn(__int2float_rn(acc[1][i][j][c]), 0.0625f));
              accf[i][j][c] = __fadd_rn(
                  accf[i][j][c],
                  __fmul_rn(__fmul_rn(d, sc), p.sw[(long long)grp * p.N + col]));
              acc[0][i][j][c] = 0;
              acc[1][i][j][c] = 0;
            }
          }
        }
      }
    }

    if (s + 1 < stages) store_stage(st, smem + ((s + 1) & 1) * kStageBytes, tid, kg, ng);
    __syncthreads();
  }

  // Epilogue: accf (+ residual), rounded once to bf16.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + i * 16 + g + h * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[e] = accf[i][j][2 * h + e];
          if (p.res != nullptr) {
            o[e] = __fadd_rn(o[e], __bfloat162float(p.res[(long long)row * p.N + col + e]));
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row * p.N + col) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
}

}  // namespace

// B7: out[M, N] = W4A8(x[M, K] bf16, p4[K/2, N] packed int4, sw[K/G, N] f32)
// (+ res[M, N] bf16). x8 [M, K] int8, sx [M, K/G] f32 and z [M, K/G] int32
// are scratch the caller allocates. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int quantized_matmul_int4_bf16(const void* x, const void* p4, const void* sw,
                                          const void* res, void* x8, void* sx, void* z,
                                          void* out, int M, int K, int N, int G,
                                          void* stream) {
  if (M <= 0 || (G != 128 && G != 256 && G != 512) || K % G || N % kBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_quantize(static_cast<const __nv_bfloat16*>(x),
                                    static_cast<int8_t*>(x8), static_cast<float*>(sx),
                                    static_cast<int*>(z), M, K, G, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(w4a8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  W4Params p;
  p.x8 = static_cast<const int8_t*>(x8);
  p.p4 = static_cast<const int8_t*>(p4);
  p.sx = static_cast<const float*>(sx);
  p.z = static_cast<const int*>(z);
  p.sw = static_cast<const float*>(sw);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  w4a8_gemm_kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
