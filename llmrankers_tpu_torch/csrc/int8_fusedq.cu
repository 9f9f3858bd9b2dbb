// W8A8 int8 GEMMs with activation quantization in the kernel, for sm_90a.
//
// Replaces the TPU kernels of llmrankers_tpu/ops/int8_matmul.py:
//   quantized_matmul (body _kernel_fusedq), B3:
//       out = (sum_kb float(x8_kb . w8_kb) * sx[row, kb]) * sw (+ res)
//   gated_matmul (body _kernel_gated), B4, over one packed [K, 2N] weight
//   whose halves sit at columns 0 and N, and gated_matmul_pair (the same
//   body), B6, over two separate [K, N] weights w0 and w1:
//       out = act(h0 * s0) * (h1 * s1), act gelu_new, relu or silu
//   int8_matmul (body _kernel), B9, on activations quantized by the caller:
//       out = (float(x8 . w8) * sx) * sw, the int32 sum over all of K
// x is bf16 [M, K]; it is quantized per row and per K-block of kb columns
// (kb is the TPU kernel's K-block, computed by the Python wrapper), with the
// TPU body's arithmetic step for step: scale = max(amax, 1e-8) * f32(1/127),
// q = clip(rint(x * rcp_rn(scale)), -127, 127). Every f32 step of the fold
// and the epilogue uses round-to-nearest intrinsics with no contraction into
// FMA, in the plain version's order, so the kernels and their plain PyTorch
// versions agree to the last bit wherever the int8 values agree. int8_matmul
// is the GEMM alone with kb = K: its fold computes 0 + float(acc) * sx, which
// is float(acc) * sx exactly, and the int32 sum is exact for K <= 133,000.
//
// Design. Two launches per call (int8_matmul: the GEMM only). (1) One warp
// per (row, K-block) computes amax, writes the int8 row block to a scratch
// [M, K] and its scale to [M, K/kb]; the wrapper allocates both. A K-block of
// 256 to 2048 bf16 per row does not fit a GEMM tile, so amax must be known
// before the block is quantized; the separate pass reads x once and writes a
// quarter of its bytes. (2) The GEMM, one of three kernels.
//
// B3, B4 and B6 on wgmma. The weights come K-major, [N, K] buffers
// (models/quant.py lays every int8 leaf with a column scale out so), because
// wgmma reads s8 operands from shared memory K-major only. Two kernels share
// one mainloop, 288 threads a block:
// - a producer warp, one of whose threads issues the TMA loads of the A tile
//   (x8 rows, K-contiguous) and a 128-row B tile (weight rows,
//   K-contiguous), 128 x 128 bytes each, into a ring of six 32 KB stages
//   under the 128-byte swizzle, each stage completing on its "full"
//   mbarrier;
// - two consumer warpgroups, each owning 64 rows x 128 accumulator columns,
//   that run wgmma m64n128k32 s8 from shared-memory descriptors (four per
//   stage) and release a stage on its "empty" mbarrier once the products
//   that read it are done (wgmma.wait_group 1: one stage's products stay in
//   flight while the next is issued). At the end of each K-block a
//   warpgroup waits for its products and folds accf += float(acc) * sx[row,
//   b] with the row scales it loaded at the block's start; the next block's
//   first wgmma overwrites acc (scale-d 0). The two warpgroups move through
//   the ring independently, so one's products run while the other folds;
// - an epilogue in registers, whose bf16 tile goes to shared memory under
//   the 128-byte swizzle and leaves by TMA, which drops the rows past M (TMA
//   also zero-fills them on the way in).
// B3 (int8_gemm_wgmma_kernel): one block per 128 x 128 output tile, the B
// tile 128 weight rows in one box; the epilogue applies the column scale and
// the residual and stores two 64-column panels per warpgroup.
// B4 and B6 (int8_gated_wgmma_kernel): one block per 128 rows x 64 output
// columns. The B tile stacks 64 rows of w0 over the same 64 rows of w1,
// loaded as two 64-row boxes: the swizzle repeats every 8 rows, so they land
// where one 128-row box would and the consumers run unchanged, with
// accumulator columns 0-63 holding x . w0 and 64-127 x . w1. A thread holds
// column c of both (acc[4j + 2h + e] and acc[4(j + 8) + 2h + e]), so the
// epilogue pairs them in registers, act(h0 * s0) * (h1 * s1), and stores one
// 64-column panel per warpgroup. B4's halves are rows n0 and N + n0 of one
// [2N, K] tensor map, B6's rows n0 of two maps. The arithmetic intensity of
// a block is B3's; the [M, 2N] intermediate is never written.
// A producer warp rather than a warpgroup leaves room for the 64 int32 sums
// and their 64 f32 folds (168 registers, no spill). Every wait loop sits in
// one asm block and the role branch is on a warp index broadcast from lane
// 0: ptxas serialises the wgmmas (C7518) when it sees a divergent path
// around them, which cost a first version of B3 much of its rate. B3's
// blocks run N tiles fastest, so the weight (at most 23 MB at the main
// paths' sites) stays in the 50 MB L2 while each x8 panel is read from
// memory about once. B6's two weights (45 MB) did not stay so (632 TOP/s
// against B4's 999 on an H100), so the gated kernel takes its blocks in
// groups of 32 row tiles, row tiles fastest within a group: on the same
// card B6's GEMM ran 2.90 ms with N tiles fastest, 2.19-2.22 ms in groups
// of 8, 2.12-2.16 in groups of 16 to 64; B4's moved within 3%. In trials a
// version of B3 without the TMA loads ran faster than one without the
// wgmmas, yet sharing the tiles across a cluster by TMA multicast (2 x 1,
// 1 x 2 and 2 x 2 blocks) gained at one shape and lost at the others, so
// each block loads its own.
//
// B9: int8_gemm_kernel, on mma.sync. One block of eight warps per 128 x 128
// output tile, K in stages of 64 bytes. A (int8 x, K-contiguous) is staged
// as it is; B (int8 w, [K, N] N-contiguous) is transposed to K-contiguous
// while it is staged, four k-rows of eight columns at a time with byte
// permutes, since mma.sync wants B K-major and ldmatrix .trans handles only
// 16-bit elements. Four neighbouring lanes read one 32-byte sector of a
// k-row, and they store their transposed columns in rotated order, so the
// stores of a warp hit 32 distinct banks. Two shared buffers: the next
// stage's global loads go to registers before the current stage is
// multiplied and to the other buffer after, one barrier per stage.
// Shared-memory rows are padded to 80 bytes, so the ldmatrix.x4 fragment
// reads are free of bank conflicts. The products run on the tensor cores as
// mma.sync.m16n8k32.s32.s8.s8.s32; each warp owns 64 rows x 32 columns with
// int32 accumulators that are folded into f32 (times the row scale) at the
// end of every K-block.
//
// Every body folds in block order with the same f32 steps and applies the
// column scale (f32, or bf16 read in place) and the residual in the plain
// version's order; int32 sums are exact in any order, so each is bit-exact
// against the plain version.
//
// What bounds it. At flan-t5-xl's encoder shapes (M = 20480, K 2048 or
// 5120, N 2048 to 2 x 5120) and Qwen2.5-3B's (M = 20480, K 2048 or 11008,
// N 256 to 2 x 11008) the work is bound by the int8 tensor-core rate.
// mma.sync from registers, one stage of prefetch and one block of eight
// warps per SM (240 registers a thread) leave most of that rate unused in
// B9's body; the others feed wgmma by TMA. Later work: B9 on the wgmma
// mainloop, persistent tiles, and the quantize pass fused into the GEMM.
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
constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 64;         // int8 K per stage; every K-block is a multiple
constexpr int kRow = kBK + 16;  // shared-memory row stride in bytes
constexpr float kGeluC = (float)0.7978845608028654;
constexpr float kGeluA = (float)0.044715;

struct GemmParams {
  const int8_t* x8;           // [M, K]
  const int8_t* w;            // [K, N]
  const float* sx;            // [M, K / kb]
  const float* sw;            // [1, N]
  __nv_bfloat16* out;         // [M, N]
  int M, K, N, kb;
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

// One K stage in registers, on its way from global to shared memory: two
// 16-byte pieces of A rows, and four k-rows of eight B columns.
struct Stage {
  uint4 a[2];
  uint2 b[4];
};

// wcol: this thread's eight B columns in row 0 of the weight.
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
    st.b[r] = *reinterpret_cast<const uint2*>(wcol + (long long)(k0 + kg * 4 + r) * p.N);
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

__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(const GemmParams p) {
  __shared__ __align__(16) int8_t as[2][kBM * kRow];
  __shared__ __align__(16) int8_t bs[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int nk = p.K / p.kb;
  const int stages = p.K / kBK, per_block = p.kb / kBK;

  // B staging: this thread transposes k-rows 4*kg..4*kg+3 of 8 columns
  // ng*8..ng*8+7. Four neighbouring lanes read 32 contiguous bytes of a
  // k-row (one sector); a warp covers 8 k-groups.
  const int kg = (warp % 2) * 8 + lane / 4, ng = (warp / 2) * 4 + lane % 4;
  const int8_t* wcol = p.w + n0 + ng * 8;

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
        ldmatrix_x4(r, bs[buf] + (wn * 32 + (j + mi / 2) * 8 + mr) * kRow + ks +
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
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row * p.N + col) =
            __floats2bfloat162_rn(__fmul_rn(accf[i][j][2 * h], p.sw[col]),
                                  __fmul_rn(accf[i][j][2 * h + 1], p.sw[col + 1]));
      }
    }
  }
}

int launch_gemm(const GemmParams& p, cudaStream_t stream) {
  if (p.M <= 0 || p.K % 128 || p.N % 128 || p.kb % kBK || p.kb <= 0 || p.K % p.kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p.N / kBN, (p.M + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B3, B4 and B6 on wgmma (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int kWgRows = 128;                      // output rows per block
constexpr int kWgCols = 128;                      // B3: output columns per block
constexpr int kGatedCols = 64;                    // B4/B6: output columns per block
constexpr int kGroupRows = 32;                    // B4/B6: row tiles a block group sweeps
constexpr int kWgK = 128;                         // int8 K per stage: one swizzle row
constexpr int kWgStages = 6;                      // ring depth
constexpr int kWgTile = kWgRows * kWgK;           // bytes of one operand tile
constexpr int kWgStage = 2 * kWgTile;             // A and B
constexpr int kWgThreads = 2 * 128 + 32;          // two consumer warpgroups, one producer warp
constexpr int kWgConsumers = 2 * 128;             // arrivals that empty a stage
constexpr int kWgOut = kWgRows * kWgCols * 2;     // B3's bf16 output tile, staged for TMA
constexpr int kGatedOut = kWgRows * kGatedCols * 2;  // the gated kernel's
constexpr int kWgSmem = kWgStages * kWgStage + kWgOut + 16 * kWgStages + 1024;  // + bars, align
constexpr int kGatedSmem = kWgStages * kWgStage + kGatedOut + 16 * kWgStages + 1024;
constexpr int kMaxSmem = 232448;                  // bytes a block may use on sm_90

struct WgParams {
  const float* sx;            // [M, K / kb]
  const void* sw;             // [1, N] f32 or bf16 (gated: w0's)
  const void* s1;             // gated: w1's column scales, sw's type
  const __nv_bfloat16* res;   // B3: [M, N] or null
  __nv_bfloat16* out;         // [M, N]
  int M, N, nk, per_block, stages;  // stages: K / kWgK; per_block: kb / kWgK
  int sw_bf16;
  int act;                    // gated: 0 gelu_new, 1 relu, 2 silu
  int w1_row;                 // gated: w1's first row in its map (B4: N, B6: 0)
};

// The ring's shared memory from a 1024-aligned base: the stages, the output
// tile (out_bytes), then the full[s] and empty[s] mbarriers.
struct Ring {
  uint32_t base, out_tile, full, empty;
};

__device__ __forceinline__ Ring ring_at(uint32_t raw, int out_bytes) {
  Ring r;
  r.base = (raw + 1023u) & ~1023u;
  r.out_tile = r.base + kWgStages * kWgStage;
  r.full = r.out_tile + out_bytes;
  r.empty = r.full + 8 * kWgStages;
  return r;
}

__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      s8wg::mbar_init(r.full + 8 * s, 1);
      s8wg::mbar_init(r.empty + 8 * s, kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The consumers' mainloop, shared by the wgmma kernels: warpgroup cw
// multiplies rows cw*64..cw*64+63 of each stage's A tile by its 128-row B
// tile and folds each K-block's int32 sums into accf times the row scales of
// rows r0 and r0 + 8, in block order.
__device__ __forceinline__ void consume(float (&accf)[64], const Ring& ring, int cw, int r0,
                                        const WgParams& p) {
  int acc[64];
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
      s8wg::mbar_wait(ring.full + 8 * s, (i / kWgStages) & 1);
      const uint32_t a = ring.base + s * kWgStage + cw * 64 * kWgK;
      const uint32_t bt = ring.base + s * kWgStage + kWgTile;
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
      if (step > 0) s8wg::mbar_arrive(ring.empty + 8 * ((i + kWgStages - 1) % kWgStages));
    }
    // The K-block ends: accf += float(acc) * sx[row, b], in block order.
    s8wg::wait<0>();
    s8wg::reg_fence(acc);
    s8wg::mbar_arrive(ring.empty + 8 * ((i + kWgStages - 1) % kWgStages));
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
}

__global__ void __launch_bounds__(kWgThreads, 1)
    int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap to, const WgParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = s8wg::smem_u32(smem_raw);
  const Ring ring = ring_at(raw, kWgOut);  // out tile: two 64-row halves
  // The warp index broadcast from lane 0, so that ptxas sees each role's
  // branch as uniform: a divergent path around the wgmmas serialises them.
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n0 = blockIdx.x * kWgCols, m0 = blockIdx.y * kWgRows;
  ring_init(ring);

  if (warp == 8) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < p.stages; ++i) {
        const int s = i % kWgStages;
        s8wg::mbar_wait(ring.empty + 8 * s, ((i / kWgStages) & 1) ^ 1);
        const uint32_t st = ring.base + s * kWgStage;
        s8wg::mbar_expect_tx(ring.full + 8 * s, kWgStage);
        s8wg::tma_2d(st, &ta, ring.full + 8 * s, i * kWgK, m0);
        s8wg::tma_2d(st + kWgTile, &tb, ring.full + 8 * s, i * kWgK, n0);
      }
    }
    return;
  }

  // Consumer warpgroup cw: rows cw*64..cw*64+63 of the tile, all 128 columns.
  const int cw = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = m0 + cw * 64 + w * 16 + g;  // this thread's rows: r0, r0 + 8
  float accf[64];
  consume(accf, ring, cw, r0, p);

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
      reinterpret_cast<uint8_t*>(smem_raw) + (ring.out_tile - raw) + cw * (kWgOut / 2);
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
    const uint32_t src = ring.out_tile + cw * (kWgOut / 2);
    s8wg::tma_store_2d(&to, src, n0, m0 + cw * 64);
    s8wg::tma_store_2d(&to, src + 64 * 128, n0 + 64, m0 + cw * 64);
    s8wg::tma_store_drain();  // the block's shared memory outlives the reads
  }
}

// B4 and B6: out = act(x . w0 * s0) * (x . w1 * s1) for 128 rows x 64
// columns; tb0 and tb1 map w0 and w1 in boxes of 64 rows, w1 from row
// p.w1_row + n0 (B4: tb1 is tb0 and w1_row N).
__global__ void __launch_bounds__(kWgThreads, 1)
    int8_gated_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb0,
                            const __grid_constant__ CUtensorMap tb1,
                            const __grid_constant__ CUtensorMap to, const WgParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = s8wg::smem_u32(smem_raw);
  const Ring ring = ring_at(raw, kGatedOut);  // out tile: one 64-row panel per warpgroup
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // uniform roles, as in B3
  // Blocks in groups of kGroupRows row tiles, row tiles fastest within a
  // group: the blocks in flight share a few weight tiles and x8 panels, so
  // each weight tile comes from memory once a group, not once a row tile
  // (see the note at the top).
  const int id = blockIdx.y * gridDim.x + blockIdx.x;
  const int first = id / (kGroupRows * gridDim.x) * kGroupRows;
  const int rows = min(static_cast<int>(gridDim.y) - first, kGroupRows);
  const int in_group = id % (kGroupRows * gridDim.x);
  const int n0 = in_group / rows * kGatedCols, m0 = (first + in_group % rows) * kWgRows;
  ring_init(ring);

  if (warp == 8) {
    // Producer: per stage the A box and the B tile as two 64-row boxes, w0's
    // rows over w1's; the stage completes on all three (32 KB).
    if (lane == 0) {
      for (int i = 0; i < p.stages; ++i) {
        const int s = i % kWgStages;
        s8wg::mbar_wait(ring.empty + 8 * s, ((i / kWgStages) & 1) ^ 1);
        const uint32_t st = ring.base + s * kWgStage;
        s8wg::mbar_expect_tx(ring.full + 8 * s, kWgStage);
        s8wg::tma_2d(st, &ta, ring.full + 8 * s, i * kWgK, m0);
        s8wg::tma_2d(st + kWgTile, &tb0, ring.full + 8 * s, i * kWgK, n0);
        s8wg::tma_2d(st + kWgTile + kWgTile / 2, &tb1, ring.full + 8 * s, i * kWgK,
                     p.w1_row + n0);
      }
    }
    return;
  }

  // Consumer warpgroup cw: rows cw*64..cw*64+63, accumulator columns 0-63
  // x . w0 and 64-127 x . w1.
  const int cw = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = m0 + cw * 64 + w * 16 + g;  // this thread's rows: r0, r0 + 8
  float accf[64];
  consume(accf, ring, cw, r0, p);

  // Epilogue: output column c = 8j + 2t + e pairs accf[4j + 2h + e] (w0)
  // with accf[4(j + 8) + 2h + e] (w1): act(h0 * s0) * (h1 * s1), in the
  // plain version's order. The 64-column bf16 panel goes to shared memory
  // under the 128-byte swizzle and leaves by TMA, which drops the rows past M.
  float s0v[16], s1v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s0v[2 * j + e] = col_scale(p.sw, p.sw_bf16, n0 + j * 8 + 2 * t + e);
      s1v[2 * j + e] = col_scale(p.s1, p.sw_bf16, n0 + j * 8 + 2 * t + e);
    }
  }
  uint8_t* const panel =
      reinterpret_cast<uint8_t*>(smem_raw) + (ring.out_tile - raw) + cw * (kGatedOut / 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lrow = w * 16 + g + 8 * h;  // row in this warpgroup's panel
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float h0 = __fmul_rn(accf[4 * j + 2 * h + e], s0v[2 * j + e]);
        const float h1 = __fmul_rn(accf[4 * (j + 8) + 2 * h + e], s1v[2 * j + e]);
        o[e] = __fmul_rn(activate(p.act, h0), h1);
      }
      const int off = lrow * 128 + ((j ^ (lrow % 8)) << 4) + 4 * t;
      *reinterpret_cast<__nv_bfloat162*>(panel + off) = __floats2bfloat162_rn(o[0], o[1]);
    }
  }
  s8wg::fence_async_smem();
  s8wg::named_barrier(1 + cw, 128);
  if (w == 0 && lane == 0) {
    s8wg::tma_store_2d(&to, ring.out_tile + cw * (kGatedOut / 2), n0, m0 + cw * 64);
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

// Raises a kernel's shared-memory cap to `bytes` once per device (slot: one
// per kernel); every launch of a kernel asks for the same size.
cudaError_t allow_smem(const void* kernel, int slot, int bytes) {
  static bool raised[2][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && raised[slot][dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) raised[slot][dev] = true;
  return err;
}

// The quantize pass, then a wgmma GEMM: B3 over the K-major weight w0
// [N, K] when w1 is null, else the gated kernel over w0 and w1, each a
// buffer of w_rows rows of K (B4: w1 is w0, one [2N, K] buffer; B6: two
// [N, K] buffers).
int launch_wgmma(const __nv_bfloat16* x, const int8_t* w0, const int8_t* w1, int w_rows,
                 const WgParams& p, int8_t* x8, int K, int kb, cudaStream_t stream) {
  const bool gated = w1 != nullptr;
  const int cols = gated ? kGatedCols : kWgCols;
  if (p.M <= 0 || K <= 0 || K % kWgK || p.N <= 0 || p.N % cols || kb <= 0 || kb % kWgK ||
      K % kb || p.act < 0 || p.act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1000;
  CUtensorMap ta, tb0, tb1, to;
  const CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int box = cols;  // weight rows a B box holds (gated: two boxes a stage)
  CUresult rc = encode_2d(fn, &ta, s8, 1, x8, p.M, K, kWgRows);
  if (rc == CUDA_SUCCESS) rc = encode_2d(fn, &tb0, s8, 1, w0, w_rows, K, box);
  tb1 = tb0;
  if (rc == CUDA_SUCCESS && gated && w1 != w0) {
    rc = encode_2d(fn, &tb1, s8, 1, w1, w_rows, K, box);
  }
  if (rc == CUDA_SUCCESS) {
    rc = encode_2d(fn, &to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.out, p.M, p.N, 64);
  }
  if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  cudaError_t err = gated ? allow_smem(reinterpret_cast<const void*>(int8_gated_wgmma_kernel),
                                       1, kGatedSmem)
                          : allow_smem(reinterpret_cast<const void*>(int8_gemm_wgmma_kernel),
                                       0, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_quantize(x, x8, const_cast<float*>(p.sx), p.M, K, kb, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.N / cols, (p.M + kWgRows - 1) / kWgRows);  // B3: N tiles fastest
  if (gated) {
    int8_gated_wgmma_kernel<<<grid, kWgThreads, kGatedSmem, stream>>>(ta, tb0, tb1, to, p);
  } else {
    int8_gemm_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(ta, tb0, to, p);
  }
  return static_cast<int>(cudaGetLastError());
}

WgParams wg_params(const void* sx, const void* sw, void* out, int M, int K, int N, int kb) {
  WgParams p;
  p.sx = static_cast<const float*>(sx);
  p.sw = sw;
  p.s1 = nullptr;
  p.res = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.N = N;
  p.nk = kb > 0 ? K / kb : 0;
  p.per_block = kb / kWgK;
  p.stages = K / kWgK;
  p.sw_bf16 = 0;
  p.act = 0;
  p.w1_row = 0;
  return p;
}

static_assert(kWgSmem <= kMaxSmem, "the B3 ring does not fit shared memory");
static_assert(kGatedSmem <= kMaxSmem, "the gated ring does not fit shared memory");

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
  WgParams p = wg_params(sx, sw, out, M, K, N, kb);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.sw_bf16 = sw_bf16;
  return launch_wgmma(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
                      nullptr, N, p, static_cast<int8_t*>(x8), K, kb,
                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one B3 block, in bytes.
extern "C" int quantized_matmul_smem_bytes() { return kWgSmem; }

// B4: out[M, N] = act(x @ w0 * s0) * (x @ w1 * s1) over wp[K, 2N] int8 with
// w0 at columns 0..N-1 and w1 at N..2N-1, scales sp[1, 2N] f32; act 0
// gelu_new, 1 relu, 2 silu. wp is K-major: a [2N, K] buffer, rows 0..N-1
// w0's columns and N..2N-1 w1's. Scratch and return codes as for
// quantized_matmul_bf16.
extern "C" int gated_matmul_bf16(const void* x, const void* wp, const void* sp,
                                 void* x8, void* sx, void* out, int M, int K, int N,
                                 int kb, int act, void* stream) {
  WgParams p = wg_params(sx, sp, out, M, K, N, kb);
  p.s1 = static_cast<const float*>(sp) + N;
  p.act = act;
  p.w1_row = N;
  const int8_t* w = static_cast<const int8_t*>(wp);
  return launch_wgmma(static_cast<const __nv_bfloat16*>(x), w, w, 2 * N, p,
                      static_cast<int8_t*>(x8), K, kb, static_cast<cudaStream_t>(stream));
}

// B6: out[M, N] = act(x @ w0 * s0) * (x @ w1 * s1) over two separate int8
// weights w0, w1 [K, N], each K-major (an [N, K] buffer), with scales s0, s1
// [1, N], f32 or, when s_bf16 is 1, bf16 (the decoder's w_gate and w_up,
// act 2 silu). Scratch and return codes as for quantized_matmul_bf16.
extern "C" int gated_matmul_pair_bf16(const void* x, const void* w0, const void* s0,
                                      const void* w1, const void* s1, void* x8, void* sx,
                                      void* out, int M, int K, int N, int kb, int act,
                                      int s_bf16, void* stream) {
  WgParams p = wg_params(sx, s0, out, M, K, N, kb);
  p.s1 = s1;
  p.act = act;
  p.sw_bf16 = s_bf16;
  return launch_wgmma(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w0),
                      static_cast<const int8_t*>(w1), N, p, static_cast<int8_t*>(x8), K, kb,
                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one B4/B6 block, in bytes.
extern "C" int gated_matmul_smem_bytes() { return kGatedSmem; }

// B9: out[M, N] bf16 = (float(x8 @ w8) * sx) * sw on activations the caller
// quantized: x8 [M, K] int8, sx [M, 1] f32, w8 [K, N] int8, sw [1, N] f32.
// The GEMM alone, with one K-block of K.
extern "C" int int8_matmul_bf16(const void* x8, const void* sx, const void* w8,
                                const void* sw, void* out, int M, int K, int N,
                                void* stream) {
  GemmParams p;
  p.x8 = static_cast<const int8_t*>(x8);
  p.w = static_cast<const int8_t*>(w8);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.kb = K;
  return launch_gemm(p, static_cast<cudaStream_t>(stream));
}
