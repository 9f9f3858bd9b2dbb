// W8A8 int8 GEMMs with activation quantization in the kernel, for sm_90a.
//
// Replaces the TPU kernels of llmrankers_tpu/ops/int8_matmul.py:
//   quantized_matmul (body _kernel_fusedq):
//       out = (sum_kb float(x8_kb . w8_kb) * sx[row, kb]) * sw (+ res)
//   gated_matmul (body _kernel_gated), over one packed [K, 2N] weight whose
//   halves sit at columns 0 and N, and gated_matmul_pair (the same body),
//   over two separate [K, N] weights w0 and w1:
//       out = act(h0 * s0) * (h1 * s1), act gelu_new, relu or silu
//   int8_matmul (body _kernel), on activations quantized by the caller:
//       out = (float(x8 . w8) * sx) * sw, the int32 sum over all of K
// x is bf16 [M, K]; it is quantized per row and per K-block of kb columns
// (kb is the TPU kernel's K-block, computed by the Python wrapper), with the
// TPU body's arithmetic step for step: scale = max(amax, 1e-8) * f32(1/127),
// q = clip(rint(x * rcp_rn(scale)), -127, 127). Every f32 step of the fold
// and the epilogue uses round-to-nearest intrinsics with no contraction into
// FMA, in the plain version's order, so the kernel and its plain PyTorch
// version agree to the last bit wherever the int8 values agree. int8_matmul
// is the GEMM alone with kb = K: its fold computes 0 + float(acc) * sx, which
// is float(acc) * sx exactly, and the int32 sum is exact for K <= 133,000.
//
// Design. Two launches per call (int8_matmul: the GEMM only). (1) One warp
// per (row, K-block) computes amax, writes the int8 row block to a scratch
// [M, K] and its scale to [M, K/kb]; the wrapper allocates both. A K-block of
// 256 to 2048 bf16 per row does not fit a GEMM tile, so amax must be known
// before the block is quantized; the separate pass reads x once and writes a
// quarter of its bytes. (2) The GEMM, one of two bodies.
//
// B3 (quantized_matmul): int8_gemm_wgmma_kernel, for Hopper. The weight
// comes K-major, an [N, K] buffer (models/quant.py lays B3's leaves out so),
// because wgmma reads s8 operands from shared memory K-major only. One block
// per 128 x 128 output tile, 288 threads:
// - a producer warp, one of whose threads issues the TMA loads of the A tile
//   (x8 rows, K-contiguous) and the B tile (the weight's N rows,
//   K-contiguous), 128 x 128 bytes each, into a ring of six 32 KB stages
//   under the 128-byte swizzle, each stage completing on its "full"
//   mbarrier;
// - two consumer warpgroups, each owning 64 rows x 128 columns, that run
//   wgmma m64n128k32 s8 from shared-memory descriptors (four per stage) and
//   release a stage on its "empty" mbarrier once the products that read it
//   are done (wgmma.wait_group 1: one stage's products stay in flight while
//   the next is issued). At the end of each K-block a warpgroup waits for
//   its products and folds accf += float(acc) * sx[row, b] with the row
//   scales it loaded at the block's start; the next block's first wgmma
//   overwrites acc (scale-d 0). The two warpgroups move through the ring
//   independently, so one's products run while the other folds;
// - an epilogue that applies the column scale and the residual in
//   registers, writes the bf16 tile to shared memory under the 128-byte
//   swizzle and stores it by TMA, which drops the rows past M (TMA also
//   zero-fills them on the way in).
// A producer warp rather than a warpgroup leaves room for the 64 int32 sums
// and their 64 f32 folds (168 registers, no spill). Every wait loop sits in
// one asm block and the role branch is on a warp index broadcast from lane
// 0: ptxas serialises the wgmmas (C7518) when it sees a divergent path
// around them, which cost a first version much of its rate. Blocks run N tiles
// fastest, so the weight stays in the 50 MB L2 while each x8 panel is read
// from memory about once. In trials a version without the TMA loads ran
// faster than one without the wgmmas, yet sharing the tiles across a
// cluster by TMA multicast (2 x 1, 1 x 2 and 2 x 2 blocks) gained at one
// shape and lost at the others, so each block loads its own.
//
// B4, B6 and B9: int8_gemm_kernel, on mma.sync. One block of eight warps
// per 128 x 128 output tile (gated: 128 rows x 64 columns of each weight,
// both sharing the A tile), K in stages of 64 bytes. A (int8 x,
// K-contiguous) is staged as it is; B (int8 w, [K, N] N-contiguous) is
// transposed to K-contiguous while it is staged, four k-rows of eight
// columns at a time with byte permutes, since mma.sync wants B K-major and
// ldmatrix .trans handles only 16-bit elements. Four neighbouring lanes read
// one 32-byte sector of a k-row, and they store their transposed columns in
// rotated order, so the stores of a warp hit 32 distinct banks. Two shared
// buffers: the next stage's global loads go to registers before the current
// stage is multiplied and to the other buffer after, one barrier per stage.
// Shared-memory rows are padded to 80 bytes, so the ldmatrix.x4 fragment
// reads are free of bank conflicts. The products run on the tensor cores as
// mma.sync.m16n8k32.s32.s8.s8.s32; each warp owns 64 rows x 32 columns with
// int32 accumulators that are folded into f32 (times the row scale) and
// reset at the end of every K-block, never carried across it. The gated
// variants read their two weights through two pointers with one row stride:
// w1 = w0 + N and stride 2N for the packed leaf, the second weight and
// stride N for the pair.
//
// Both bodies fold in block order with the same f32 steps and apply the
// column scale (f32, or bf16 read in place) and the residual in the plain
// version's order; int32 sums are exact in any order, so each is bit-exact
// against the plain version.
//
// What bounds it. At flan-t5-xl's encoder shapes (M = 20480, K 2048 or
// 5120, N 2048 to 2 x 5120) and Qwen2.5-3B's (M = 20480, K 2048 or 11008,
// N 256 to 2 x 11008) the work is bound by the int8 tensor-core rate.
// mma.sync from registers, one stage of prefetch and one block of eight
// warps per SM (240 registers a thread) leave most of that rate unused in
// the B4/B6/B9 body; B3's body feeds wgmma by TMA. Later work: the gated
// variants on B3's mainloop, and the quantize pass fused into it.
#include <cuda.h>  // CUtensorMap; no -lcuda (driver entry point)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"
#include "tma_encode.cuh"

namespace {

constexpr int kThreads = 256;   // eight warps: 2 along M x 4 along N
constexpr int kBM = 128;        // output rows per block
constexpr int kBN = 128;        // B-tile columns (gated: 64 of each weight)
constexpr int kBK = 64;         // int8 K per stage; every K-block is a multiple
constexpr int kRow = kBK + 16;  // shared-memory row stride in bytes
constexpr float kGeluC = (float)0.7978845608028654;
constexpr float kGeluA = (float)0.044715;

struct GemmParams {
  const int8_t* x8;           // [M, K]
  const int8_t* w0;           // [K, ldw]: the weight (gated: the first)
  const int8_t* w1;           // gated: the second weight, [K, ldw]
  const float* sx;            // [M, K / kb]
  const void* s0;             // [1, N] column scales of w0, f32 or bf16
  const void* s1;             // gated: of w1
  const __nv_bfloat16* res;   // [M, N] or null
  __nv_bfloat16* out;         // [M, N]
  int M, K, N, ldw, kb, act;  // act: 0 gelu_new, 1 relu, 2 silu
  int s_bf16;                 // the column scales are bf16 (else f32)
};

// A column scale in f32; a bf16 scale widens exactly, so reading the
// decoder's bf16 leaves in place gives the bits of their f32 copy.
__device__ __forceinline__ float col_scale(const void* s, int bf16, int col) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s)[col])
              : static_cast<const float*>(s)[col];
}

// The same arithmetic as the plain version's gelu_new, in its order.
__device__ __forceinline__ float gelu_new(float h) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kGeluA, h), h), h);
  const float t = tanhf(__fmul_rn(kGeluC, __fadd_rn(h, cube)));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, t));
}

// h * sigmoid(h), the sigmoid as 1 / (1 + exp(-h)).
__device__ __forceinline__ float silu(float h) {
  return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-h))));
}

__device__ __forceinline__ float activate(int act, float h) {
  if (act == 0) return gelu_new(h);
  if (act == 1) return fmaxf(h, 0.f);
  return silu(h);
}

// Local B-tile column of a warp's accumulator tile j (0..3). Plain: the
// warp's 32 columns; gated: 16 columns of w0 (j 0, 1) and the same 16 of w1
// (j 2, 3), which sit at local columns 64..127.
template <bool GATED>
__device__ __forceinline__ int tile_col(int wn, int j) {
  if constexpr (GATED) {
    return (j < 2 ? 0 : 64) + wn * 16 + (j % 2) * 8;
  } else {
    return wn * 32 + j * 8;
  }
}

// One K stage in registers, on its way from global to shared memory: two
// 16-byte pieces of A rows, and four k-rows of eight B columns.
struct Stage {
  uint4 a[2];
  uint2 b[4];
};

// wcol: this thread's eight B columns in row 0 of its weight.
__device__ __forceinline__ void load_stage(Stage& st, const GemmParams& p, int m0,
                                           int k0, int tid, int kg, const int8_t* wcol) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 4, c = (idx % 4) * 16;
    st.a[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < p.M) {
      st.a[i] = *reinterpret_cast<const uint4*>(p.x8 + (long long)(m0 + r) * p.K + k0 + c);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    st.b[r] = *reinterpret_cast<const uint2*>(wcol + (long long)(k0 + kg * 4 + r) * p.ldw);
  }
}

// A as it is; B transposed to K-contiguous rows.
__device__ __forceinline__ void store_stage(const Stage& st, int8_t* as, int8_t* bs,
                                            int tid, int kg, int ng) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    *reinterpret_cast<uint4*>(as + (idx / 4) * kRow + (idx % 4) * 16) = st.a[i];
  }
  uint32_t w[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    w[r][0] = st.b[r].x;
    w[r][1] = st.b[r].y;
  }
  store_b_transposed(w, bs, kRow, kg, ng);
}

template <bool GATED>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(const GemmParams p) {
  __shared__ __align__(16) int8_t as[2][kBM * kRow];
  __shared__ __align__(16) int8_t bs[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * (GATED ? kBN / 2 : kBN);  // output column
  const int nk = p.K / p.kb;
  const int stages = p.K / kBK, per_block = p.kb / kBK;

  // B staging: this thread transposes k-rows 4*kg..4*kg+3 of 8 columns
  // ng*8..ng*8+7. Four neighbouring lanes read 32 contiguous bytes of a
  // k-row (one sector); a warp covers 8 k-groups.
  const int kg = (warp % 2) * 8 + lane / 4, ng = (warp / 2) * 4 + lane % 4;
  const int8_t* wcol = p.w0 + n0 + ng * 8;
  if constexpr (GATED) {
    if (ng >= 8) wcol = p.w1 + n0 + (ng - 8) * 8;
  }

  float accf[4][4][4];
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[i][j][e] = 0.f;
        acc[i][j][e] = 0;
      }

  // Two shared buffers: stage s+1 is loaded into registers before stage s
  // is multiplied, and stored to the other buffer after, so its global
  // loads are in flight during the products; one barrier per stage.
  Stage st;
  load_stage(st, p, m0, 0, tid, kg, wcol);
  store_stage(st, as[0], bs[0], tid, kg, ng);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) load_stage(st, p, m0, (s + 1) * kBK, tid, kg, wcol);

    // ldmatrix lanes: matrix mi = lane / 8, its row lane % 8.
    const int mi = lane / 8, mr = lane % 8;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        // matrices: tile j k 0-15, tile j k 16-31, tile j+1 k 0-15, k 16-31
        uint32_t r[4];
        ldmatrix_x4(r, bs[buf] + (tile_col<GATED>(wn, j + mi / 2) + mr) * kRow + ks +
                           (mi % 2) * 16);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // matrices: rows 0-7 k 0-15, rows 8-15 k 0-15, rows 0-7 k 16-31, ...
        uint32_t af[4];
        ldmatrix_x4(af, as[buf] + (wm * 64 + i * 16 + (mi % 2) * 8 + mr) * kRow + ks +
                            (mi / 2) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }

    if ((s + 1) % per_block == 0) {
      // The K-block ends: accf += float(acc) * sx[row, b], then reset acc.
      const int b = s / per_block;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 64 + i * 16 + g + h * 8;
          const float sc = row < p.M ? p.sx[(long long)row * nk + b] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              accf[i][j][2 * h + e] = __fadd_rn(
                  accf[i][j][2 * h + e],
                  __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), sc));
              acc[i][j][2 * h + e] = 0;
            }
          }
        }
      }
    }

    if (s + 1 < stages) store_stage(st, as[buf ^ 1], bs[buf ^ 1], tid, kg, ng);
    __syncthreads();
  }

  // Epilogue.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + i * 16 + g + h * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < (GATED ? 2 : 4); ++j) {
        const int col = n0 + (GATED ? wn * 16 + j * 8 : wn * 32 + j * 8) + 2 * t;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (GATED) {
            const float h0 =
                __fmul_rn(accf[i][j][2 * h + e], col_scale(p.s0, p.s_bf16, col + e));
            const float h1 =
                __fmul_rn(accf[i][j + 2][2 * h + e], col_scale(p.s1, p.s_bf16, col + e));
            o[e] = __fmul_rn(activate(p.act, h0), h1);
          } else {
            o[e] = __fmul_rn(accf[i][j][2 * h + e], col_scale(p.s0, p.s_bf16, col + e));
            if (p.res != nullptr) {
              o[e] = __fadd_rn(o[e], __bfloat162float(p.res[(long long)row * p.N + col + e]));
            }
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row * p.N + col) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
}

int launch_gemm(const GemmParams& p, bool gated, cudaStream_t stream) {
  if (p.M <= 0 || p.K % 128 || p.N % 128 || p.kb % kBK || p.kb <= 0 || p.K % p.kb ||
      p.act < 0 || p.act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p.N / (gated ? kBN / 2 : kBN), (p.M + kBM - 1) / kBM);
  if (gated) {
    int8_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    int8_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The quantize pass, then the GEMM.
int launch(const __nv_bfloat16* x, const GemmParams& p, int8_t* x8, float* sx,
           bool gated, cudaStream_t stream) {
  if (p.M <= 0 || p.K % 128 || p.kb % kBK || p.kb <= 0 || p.K % p.kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = launch_quantize(x, x8, sx, p.M, p.K, p.kb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_gemm(p, gated, stream);
}

GemmParams params(const void* x8, const void* sx, const void* w0, const void* s0,
                  void* out, int M, int K, int N, int ldw, int kb) {
  GemmParams p;
  p.x8 = static_cast<const int8_t*>(x8);
  p.w0 = static_cast<const int8_t*>(w0);
  p.w1 = nullptr;
  p.sx = static_cast<const float*>(sx);
  p.s0 = s0;
  p.s1 = nullptr;
  p.res = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldw = ldw;
  p.kb = kb;
  p.act = 0;
  p.s_bf16 = 0;
  return p;
}

// ---------------------------------------------------------------------------
// B3 on wgmma (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kWgRows = 128;                      // output rows per block
constexpr int kWgCols = 128;                      // output columns per block
constexpr int kWgK = 128;                         // int8 K per stage: one swizzle row
constexpr int kWgStages = 6;                      // ring depth
constexpr int kWgTile = kWgRows * kWgK;           // bytes of one operand tile
constexpr int kWgStage = 2 * kWgTile;             // A and B
constexpr int kWgThreads = 2 * 128 + 32;          // two consumer warpgroups, one producer warp
constexpr int kWgConsumers = 2 * 128;             // arrivals that empty a stage
constexpr int kWgOut = kWgRows * kWgCols * 2;     // the bf16 output tile, staged for TMA
constexpr int kWgSmem = kWgStages * kWgStage + kWgOut + 16 * kWgStages + 1024;  // + bars, align
constexpr int kMaxSmem = 232448;                  // bytes a block may use on sm_90

struct WgParams {
  const float* sx;            // [M, K / kb]
  const void* sw;             // [1, N] f32 or bf16
  const __nv_bfloat16* res;   // [M, N] or null
  __nv_bfloat16* out;         // [M, N]
  int M, N, nk, per_block, stages;  // stages: K / kWgK; per_block: kb / kWgK
  int sw_bf16;
};

__global__ void __launch_bounds__(kWgThreads, 1)
    int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap to, const WgParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = s8wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t out_tile = base + kWgStages * kWgStage;  // two 64-row halves
  const uint32_t full = out_tile + kWgOut;  // full[s], then empty[s]
  const uint32_t empty = full + 8 * kWgStages;
  // The warp index broadcast from lane 0, so that ptxas sees each role's
  // branch as uniform: a divergent path around the wgmmas serialises them.
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n0 = blockIdx.x * kWgCols, m0 = blockIdx.y * kWgRows;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      s8wg::mbar_init(full + 8 * s, 1);
      s8wg::mbar_init(empty + 8 * s, kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < p.stages; ++i) {
        const int s = i % kWgStages;
        s8wg::mbar_wait(empty + 8 * s, ((i / kWgStages) & 1) ^ 1);
        const uint32_t st = base + s * kWgStage;
        s8wg::mbar_expect_tx(full + 8 * s, kWgStage);
        s8wg::tma_2d(st, &ta, full + 8 * s, i * kWgK, m0);
        s8wg::tma_2d(st + kWgTile, &tb, full + 8 * s, i * kWgK, n0);
      }
    }
    return;
  }

  // Consumer warpgroup cw: rows cw*64..cw*64+63 of the tile, all 128 columns.
  const int cw = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = m0 + cw * 64 + w * 16 + g;  // this thread's rows: r0, r0 + 8
  int acc[64];
  float accf[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    accf[i] = 0.f;
  }
  int i = 0;  // stage count
  for (int b = 0; b < p.nk; ++b) {
    // The block's row scales, read while its products run.
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = r0 + 8 * h < p.M ? __ldg(p.sx + (long long)(r0 + 8 * h) * p.nk + b) : 0.f;
    }
    for (int step = 0; step < p.per_block; ++step, ++i) {
      const int s = i % kWgStages;
      s8wg::mbar_wait(full + 8 * s, (i / kWgStages) & 1);
      const uint32_t a = base + s * kWgStage + cw * 64 * kWgK;
      const uint32_t bt = base + s * kWgStage + kWgTile;
      s8wg::reg_fence(acc);
      s8wg::fence();
#pragma unroll
      for (int kk = 0; kk < kWgK / 32; ++kk) {
        // The block's first product overwrites the sums of the one before.
        s8wg::mma_n128(acc, s8wg::desc_k128(a + kk * 32), s8wg::desc_k128(bt + kk * 32),
                       step > 0 || kk > 0);
      }
      s8wg::commit();
      // The previous stage's products are done: release it.
      s8wg::wait<1>();
      s8wg::reg_fence(acc);
      if (step > 0) s8wg::mbar_arrive(empty + 8 * ((i + kWgStages - 1) % kWgStages));
    }
    // The K-block ends: accf += float(acc) * sx[row, b], in block order.
    s8wg::wait<0>();
    s8wg::reg_fence(acc);
    s8wg::mbar_arrive(empty + 8 * ((i + kWgStages - 1) % kWgStages));
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * h + e;
          accf[q] = __fadd_rn(accf[q], __fmul_rn(__int2float_rn(acc[q]), sc[h]));
        }
      }
    }
  }

  // Epilogue: times the column scale, plus the residual (rows below M), in
  // the plain version's order; the bf16 tile goes to shared memory in two
  // panels of 64 columns under the 128-byte swizzle (a warp's stores hit 32
  // banks) and leaves by TMA, which drops the rows past M. The scales and a
  // row's residual are loaded in one batch before any store.
  float swv[32];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      swv[2 * j + e] = col_scale(p.sw, p.sw_bf16, n0 + j * 8 + 2 * t + e);
    }
  }
  uint8_t* const half =
      reinterpret_cast<uint8_t*>(smem_raw) + (out_tile - raw) + cw * (kWgOut / 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lrow = w * 16 + g + 8 * h;  // row in this warpgroup's half
    const int row = m0 + cw * 64 + lrow;
    float2 rv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      rv[j] = p.res == nullptr || row >= p.M
                  ? make_float2(0.f, 0.f)
                  : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                        p.res + (long long)row * p.N + n0 + j * 8 + 2 * t));
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float o0 = __fmul_rn(accf[4 * j + 2 * h], swv[2 * j]);
      float o1 = __fmul_rn(accf[4 * j + 2 * h + 1], swv[2 * j + 1]);
      if (p.res != nullptr) {
        o0 = __fadd_rn(o0, rv[j].x);
        o1 = __fadd_rn(o1, rv[j].y);
      }
      const int off = (j / 8) * (64 * 128) + lrow * 128 + (((j % 8) ^ (lrow % 8)) << 4) + 4 * t;
      *reinterpret_cast<__nv_bfloat162*>(half + off) = __floats2bfloat162_rn(o0, o1);
    }
  }
  s8wg::fence_async_smem();
  s8wg::named_barrier(1 + cw, 128);
  if (w == 0 && lane == 0) {
    const uint32_t src = out_tile + cw * (kWgOut / 2);
    s8wg::tma_store_2d(&to, src, n0, m0 + cw * 64);
    s8wg::tma_store_2d(&to, src + 64 * 128, n0 + 64, m0 + cw * 64);
    s8wg::tma_store_drain();  // the block's shared memory outlives the reads
  }
}

// A row-major [rows, cols] matrix as a 2-D tensor map (cols innermost) with
// boxes of box_rows rows x 128 bytes under the 128-byte swizzle; rows past
// the end read as zero and are not written.
CUresult encode_2d(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int esize,
                   const void* ptr, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The quantize pass, then the wgmma GEMM over the K-major weight wt [N, K].
int launch_wgmma(const __nv_bfloat16* x, const int8_t* wt, const WgParams& p, int8_t* x8,
                 int K, int kb, cudaStream_t stream) {
  if (p.M <= 0 || K <= 0 || K % kWgK || p.N <= 0 || p.N % kWgCols || kb <= 0 || kb % kWgK ||
      K % kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1000;
  CUtensorMap ta, tb, to;
  const CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult rc = encode_2d(fn, &ta, s8, 1, x8, p.M, K, kWgRows);
  if (rc == CUDA_SUCCESS) rc = encode_2d(fn, &tb, s8, 1, wt, p.N, K, kWgCols);
  if (rc == CUDA_SUCCESS) {
    rc = encode_2d(fn, &to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.out, p.M, p.N, 64);
  }
  if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  // The shared-memory cap is raised once per device; every launch asks for
  // the same size.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(int8_gemm_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  err = launch_quantize(x, x8, const_cast<float*>(p.sx), p.M, K, kb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.N / kWgCols, (p.M + kWgRows - 1) / kWgRows);  // N tiles fastest
  int8_gemm_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(ta, tb, to, p);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kWgSmem <= kMaxSmem, "the B3 ring does not fit shared memory");

}  // namespace

// B3: out[M, N] = W8A8(x[M, K] bf16, w8[K, N] int8, sw[1, N]) (+ res[M, N]),
// sw f32, or bf16 when sw_bf16 is 1 (the decoder's scale leaves). w8 is
// K-major: w8 points at an [N, K] buffer, row n holding column n's K weights.
// x8 [M, K] int8 and sx [M, K/kb] f32 are scratch the caller allocates.
// Returns 0 on success, a CUDA runtime error code when a launch or its setup
// failed, -CUresult when a tensor map could not be encoded, -1000 when the
// driver's cuTensorMapEncodeTiled could not be found.
extern "C" int quantized_matmul_bf16(const void* x, const void* w8, const void* sw,
                                     const void* res, void* x8, void* sx, void* out,
                                     int M, int K, int N, int kb, int sw_bf16,
                                     void* stream) {
  WgParams p;
  p.sx = static_cast<const float*>(sx);
  p.sw = sw;
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.N = N;
  p.nk = kb > 0 ? K / kb : 0;
  p.per_block = kb / kWgK;
  p.stages = K / kWgK;
  p.sw_bf16 = sw_bf16;
  return launch_wgmma(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8), p,
                      static_cast<int8_t*>(x8), K, kb, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one B3 block, in bytes.
extern "C" int quantized_matmul_smem_bytes() { return kWgSmem; }

// B4: out[M, N] = act(x @ w0 * s0) * (x @ w1 * s1) over wp[K, 2N] int8 with
// w0 at columns 0..N-1 and w1 at N..2N-1, scales sp[1, 2N]; act 0 gelu_new,
// 1 relu, 2 silu. Scratch as for quantized_matmul_bf16.
extern "C" int gated_matmul_bf16(const void* x, const void* wp, const void* sp,
                                 void* x8, void* sx, void* out, int M, int K, int N,
                                 int kb, int act, void* stream) {
  GemmParams p = params(x8, sx, wp, sp, out, M, K, N, 2 * N, kb);
  p.w1 = p.w0 + N;
  p.s1 = static_cast<const float*>(sp) + N;
  p.act = act;
  return launch(static_cast<const __nv_bfloat16*>(x), p, static_cast<int8_t*>(x8),
                static_cast<float*>(sx), true, static_cast<cudaStream_t>(stream));
}

// B6: out[M, N] = act(x @ w0 * s0) * (x @ w1 * s1) over two separate int8
// weights w0, w1 [K, N] with scales s0, s1 [1, N], f32 or, when s_bf16 is 1,
// bf16 (the decoder's w_gate and w_up, act 2 silu). Scratch as for
// quantized_matmul_bf16.
extern "C" int gated_matmul_pair_bf16(const void* x, const void* w0, const void* s0,
                                      const void* w1, const void* s1, void* x8, void* sx,
                                      void* out, int M, int K, int N, int kb, int act,
                                      int s_bf16, void* stream) {
  GemmParams p = params(x8, sx, w0, s0, out, M, K, N, N, kb);
  p.w1 = static_cast<const int8_t*>(w1);
  p.s1 = s1;
  p.act = act;
  p.s_bf16 = s_bf16;
  return launch(static_cast<const __nv_bfloat16*>(x), p, static_cast<int8_t*>(x8),
                static_cast<float*>(sx), true, static_cast<cudaStream_t>(stream));
}

// B9: out[M, N] bf16 = (float(x8 @ w8) * sx) * sw on activations the caller
// quantized: x8 [M, K] int8, sx [M, 1] f32, w8 [K, N] int8, sw [1, N] f32.
// The GEMM alone, with one K-block of K.
extern "C" int int8_matmul_bf16(const void* x8, const void* sx, const void* w8,
                                const void* sw, void* out, int M, int K, int N,
                                void* stream) {
  const GemmParams p = params(x8, sx, w8, sw, out, M, K, N, N, K);
  return launch_gemm(p, false, static_cast<cudaStream_t>(stream));
}
