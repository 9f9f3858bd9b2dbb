// W4A8 GEMM: group-wise int4 weights, activations quantized to int8 in a
// pass before it, for sm_90a.
//
// Replaces the TPU kernel llmrankers_tpu/ops/int4_matmul.py::
// quantized_matmul_int4 (_w4a8_matmul_2d, body _kernel_w4a8). The weight is
// packed by pack_int4: per group of G input rows (G 128, 256 or 512) and
// output column, packed row r of the group holds byte (hi4 << 4) | (lo4 + 8),
// where lo4 is the weight of input row gG + r and hi4 that of row
// gG + G/2 + r, both in [-7, 7]; the group scales sw are f32 [K/G, N]. x is
// bf16 [M, K], quantized per row and per group exactly as the W8A8 kernels
// quantize per K-block (int8_quantize.cuh), with scales sx [M, K/G].
//
// Layout. The packed leaf [K/2, N] is K-major: an [N, K/2] buffer seen
// through its transpose (models/quant.py), so column n's packed bytes of
// group g run contiguously (gG/2 .. gG/2 + G/2). A TMA box of packed bytes
// [128 columns x 64 bytes] at packed row gG/2 + r0 therefore expands, offset
// for offset, into two K-major s8 tiles of the same shape and the same
// 64-byte swizzle: the lo plane (weights of A columns gG + r0 .. + 64) and
// the hi plane (A columns gG + G/2 + r0 .. + 64). Nothing is transposed and
// no address changes; the expansion is word-wise:
//   hi16 = w & 0xF0F0F0F0                          = 16 * hi4 per signed byte
//   lo16 = ((w << 4) & 0xF0F0F0F0) ^ 0x80808080    = 16 * lo4 per signed byte
// ((lo4 + 8) << 4 is 16 lo4 + 128 mod 256; the XOR takes the 128 away.)
//
// One exact accumulator per group. Both planes feed one int32 sum:
//   acc = q_lo . lo16 + q_hi . hi16 = 16 D,  D = q_lo . lo4 + q_hi . hi4,
// |acc| <= 16 * G * 127 * 7 = 7,282,688 at G 512, below 2^24, so float(acc)
// is exact and float(acc) * 0.0625 is D exactly. The TPU body's
// d = float(acc_lo - z) + float(acc_hi) * 0.0625 is D exactly too (both
// terms are integers below 2^24, and so is their sum), so the fold
//   accf = accf + (d * sx[row, g]) * sw[g, col]
// in group order, in round-to-nearest f32 steps with no contraction, gives
// the plain version's bits (ops/int4_matmul.py::quantized_matmul_int4_plain).
// No zero-point sum is needed.
//
// Design. One block per 128 x 128 output tile, N tiles fastest (the 11.3 MB
// packed weight of Qwen2.5-3B's gate/up stays in the 50 MB L2 while each x8
// panel is read about once), 352 threads:
// - warp 8, one thread: TMA loads per stage of the packed box [128 x 64 B],
//   the two x8 boxes [128 rows x 64 B] at K coordinates gG + r0 and
//   gG + G/2 + r0 (one tensor map; rows past M are zero-filled) and the
//   group's sw row [128] f32, all completing on the stage's "full" mbarrier;
// - warps 9 and 10: wait on "full", write lo16 and hi16 into the stage's two
//   expanded tiles, fence.proxy.async (the generic writes become visible to
//   wgmma), arrive on the stage's "expanded" mbarrier;
// - two consumer warpgroups, 64 rows x 128 columns each: per stage four
//   wgmma m64n128k32 s8 from shared-memory descriptors (64-byte swizzle)
//   into one int32 set, the group's first overwriting it (scale-d 0); the
//   previous stage is released on its "empty" mbarrier once its products are
//   done (wgmma.wait_group 1). At the end of a group a warpgroup waits for
//   its products, folds with the row scales it loaded at the group's start
//   and sw from the stage's shared memory, then releases the stage;
// - an epilogue that adds the residual in registers, writes the bf16 tile
//   to shared memory under the 128-byte swizzle and stores it by TMA, which
//   drops the rows past M.
// A stage is 8 KB packed + 16 KB x8 + 16 KB expanded + 512 B sw (41 KB
// aligned); four stages and the 32 KB output tile take 197 KB. Boxes 64
// bytes wide serve every G (a group's half is a whole number of them, so a
// stage never spans two groups): 128-byte boxes, B3's width, would give
// stages of 80 KB, two in the budget, and need a path of their own at G 128.
// Three producer warps rather than a warpgroup keep the per-thread register
// cap at 184 (65,536 / 352) for the 64 int32 sums and their 64 f32 folds.
// As in B3, every wait loop sits in one asm block and the role branch is on
// a warp index broadcast from lane 0, so ptxas sees no divergent path around
// the wgmmas (which it would serialise, warning C7518). ptxas gives it 168
// registers, no spill; 201,824 bytes of dynamic shared memory.
//
// Tried, and did not pay (trial builds timed in turns on the card): a
// version whose expanders wrote nothing ran no faster, so the expansion's
// shared-memory traffic does not set the pace and the register-A route
// (the weight as wgmma's A operand from registers, transposed output) was
// not taken; a third expander warp; five stages with the output tile laid
// over the ring (faster at gate/up, slower at down); a float(D) built from
// acc >> 4 by a magic-number add instead of the int-to-float conversion;
// the activation scale premultiplied by 1/16 (exact, but no faster). Three
// stages ran slower than four.
//
// What bounds it. At Qwen2.5-3B's FFN sites at M = 20480 ([20480, 2048] x
// [2048, 11008], G 512; [20480, 11008] x [11008, 2048], G 256) the int8
// operations at 1,979 TOP/s (0.47 ms each); at decode M 8, the packed
// weight's bytes (11.3 MB, 3.4 us at 3.35 TB/s). At M 8 only N/128 blocks
// run (86 at gate/up, 16 at down), each streaming its columns' whole K.
#include <cuda.h>  // CUtensorMap; no -lcuda (driver entry point)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_quantize.cuh"  // launch_quantize
#include "int8_wgmma.cuh"  // mbarriers, TMA, s8 wgmma
#include "tma_encode.cuh"

namespace {

constexpr int kRows = 128;                 // output rows per block
constexpr int kCols = 128;                 // output columns per block
constexpr int kW = 64;                     // packed bytes per column and stage: K of each plane
constexpr int kTile = 128 * kW;            // one [128 x 64] byte tile
constexpr int kStages = 4;                 // ring depth
// A stage: the packed box, the x8 lo and hi boxes, the expanded lo and hi
// planes, the group's sw row; 1024-aligned, so every tile keeps the swizzle
// phase TMA wrote it with.
constexpr int kPacked = 0, kXlo = kTile, kXhi = 2 * kTile, kElo = 3 * kTile, kEhi = 4 * kTile;
constexpr int kSw = 5 * kTile;
constexpr int kStage = (kSw + kCols * 4 + 1023) / 1024 * 1024;
constexpr int kTxBytes = 3 * kTile + kCols * 4;  // what TMA writes per stage
constexpr int kConsumers = 2 * 128;              // arrivals that empty a stage
constexpr int kExpanders = 2 * 32;               // arrivals that mark a stage expanded
constexpr int kThreads = kConsumers + 32 + kExpanders;
constexpr int kOut = kRows * kCols * 2;          // the bf16 output tile, staged for TMA
constexpr int kSmem = kStages * kStage + kOut + 3 * 8 * kStages + 1024;  // + bars, align
constexpr int kMaxSmem = 232448;                 // bytes a block may use on sm_90

static_assert(kSmem <= kMaxSmem, "the B7 ring does not fit shared memory");
static_assert(kTile / 16 % kExpanders == 0, "the expanders split a tile evenly");

struct W4Params {
  const float* sx;           // [M, K/G]
  const __nv_bfloat16* res;  // [M, N] or null
  int M, N, G, nk, per_group, stages;  // nk: K / G; per_group: G / 2 / kW; stages: K / 2 / kW
};

// 16 * lo4 and 16 * hi4 as signed bytes, four packed bytes per word.
__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

__global__ void __launch_bounds__(kThreads, 1)
    w4a8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,  // x8 [M, K]
                           const __grid_constant__ CUtensorMap tp,  // packed [N, K/2]
                           const __grid_constant__ CUtensorMap ts,  // sw [K/G, N] f32
                           const __grid_constant__ CUtensorMap to,  // out [M, N] bf16
                           const W4Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = s8wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t out_tile = base + kStages * kStage;  // two 64-row halves
  const uint32_t full = out_tile + kOut;          // full[s]: TMA landed
  const uint32_t expanded = full + 8 * kStages;   // expanded[s]: planes written
  const uint32_t empty = expanded + 8 * kStages;  // empty[s]: products done
  // The warp index broadcast from lane 0, so that ptxas sees each role's
  // branch as uniform: a divergent path around the wgmmas serialises them.
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kRows;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      s8wg::mbar_init(full + 8 * s, 1);
      s8wg::mbar_init(expanded + 8 * s, kExpanders);
      s8wg::mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // Loads: one thread keeps the ring full. Stage i covers packed bytes
    // r0 .. r0 + 64 of group g's half.
    if (lane == 0) {
      const int half = p.G / 2;
      for (int i = 0; i < p.stages; ++i) {
        const int s = i % kStages;
        const int g = i / p.per_group, r0 = (i % p.per_group) * kW;
        s8wg::mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        const uint32_t st = base + s * kStage, bar = full + 8 * s;
        s8wg::mbar_expect_tx(bar, kTxBytes);
        s8wg::tma_2d(st + kPacked, &tp, bar, g * half + r0, n0);
        s8wg::tma_2d(st + kXlo, &tx, bar, g * p.G + r0, m0);
        s8wg::tma_2d(st + kXhi, &tx, bar, g * p.G + half + r0, m0);
        s8wg::tma_2d(st + kSw, &ts, bar, n0, g);
      }
    }
    return;
  }
  if (warp > 8) {
    // Expansion: each thread turns eight 16-byte chunks of the packed box
    // into the same chunks of the two planes (neighbouring threads on
    // neighbouring chunks: no bank conflicts).
    const int e = tid - (kConsumers + 32);
    constexpr int kPer = kTile / 16 / kExpanders;
    for (int i = 0; i < p.stages; ++i) {
      const int s = i % kStages;
      s8wg::mbar_wait(full + 8 * s, (i / kStages) & 1);
      uint8_t* const st = gbase + s * kStage;
      uint4 v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        v[j] = *reinterpret_cast<const uint4*>(st + kPacked + 16 * (e + j * kExpanders));
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int off = 16 * (e + j * kExpanders);
        *reinterpret_cast<uint4*>(st + kElo + off) =
            make_uint4(lo16(v[j].x), lo16(v[j].y), lo16(v[j].z), lo16(v[j].w));
        *reinterpret_cast<uint4*>(st + kEhi + off) =
            make_uint4(hi16(v[j].x), hi16(v[j].y), hi16(v[j].z), hi16(v[j].w));
      }
      s8wg::fence_async_smem();
      s8wg::mbar_arrive(expanded + 8 * s);
    }
    return;
  }

  // Consumer warpgroup cw: rows cw*64..cw*64+63 of the tile, all 128 columns.
  const int cw = warp / 4, w = warp % 4, g8 = lane / 4, t = lane % 4;
  const int r0 = m0 + cw * 64 + w * 16 + g8;  // this thread's rows: r0, r0 + 8
  int acc[64];
  float accf[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) {
    acc[q] = 0;
    accf[q] = 0.f;
  }
  int i = 0;  // stage count
  for (int g = 0; g < p.nk; ++g) {
    // The group's row scales, read while its products run.
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = r0 + 8 * h < p.M ? __ldg(p.sx + (long long)(r0 + 8 * h) * p.nk + g) : 0.f;
    }
    for (int step = 0; step < p.per_group; ++step, ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      s8wg::mbar_wait(full + 8 * s, parity);
      s8wg::mbar_wait(expanded + 8 * s, parity);
      const uint32_t st = base + s * kStage;
      const uint32_t a = st + kXlo + cw * 64 * kW;  // this warpgroup's rows of x8 lo
      s8wg::reg_fence(acc);
      s8wg::fence();
      // The group's first product overwrites the sums of the one before.
      // Two k32 steps of the lo plane, then two of the hi plane.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t ka = a + (kk / 2) * (kXhi - kXlo) + (kk % 2) * 32;
        const uint32_t kb = st + (kk / 2 ? kEhi : kElo) + (kk % 2) * 32;
        s8wg::mma_n128(acc, s8wg::desc_k64(ka), s8wg::desc_k64(kb), step > 0 || kk > 0);
      }
      s8wg::commit();
      // The previous stage's products are done: release it.
      s8wg::wait<1>();
      s8wg::reg_fence(acc);
      if (step > 0) s8wg::mbar_arrive(empty + 8 * ((i + kStages - 1) % kStages));
    }
    // The group ends: accf += (float(acc) * 0.0625 * sx[row, g]) * sw[g, col]
    // in round-to-nearest steps, sw from the last stage, then release it.
    s8wg::wait<0>();
    s8wg::reg_fence(acc);
    const int last = (i + kStages - 1) % kStages;
    const float* const swr = reinterpret_cast<const float*>(gbase + last * kStage + kSw);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 sw = *reinterpret_cast<const float2*>(swr + j * 8 + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 4 * j + 2 * h + e;
          const float d = __fmul_rn(__int2float_rn(acc[q]), 0.0625f);
          accf[q] = __fadd_rn(accf[q], __fmul_rn(__fmul_rn(d, sc[h]), e ? sw.y : sw.x));
        }
      }
    }
    s8wg::mbar_arrive(empty + 8 * last);
  }

  // Epilogue: plus the residual (rows below M), in the plain version's
  // order; the bf16 tile goes to shared memory in two panels of 64 columns
  // under the 128-byte swizzle (a warp's stores hit 32 banks) and leaves by
  // TMA, which drops the rows past M. A row's residual is loaded in one
  // batch before any store.
  uint8_t* const half = gbase + (out_tile - base) + cw * (kOut / 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lrow = w * 16 + g8 + 8 * h;  // row in this warpgroup's half
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
      float o0 = accf[4 * j + 2 * h];
      float o1 = accf[4 * j + 2 * h + 1];
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
    const uint32_t src = out_tile + cw * (kOut / 2);
    s8wg::tma_store_2d(&to, src, n0, m0 + cw * 64);
    s8wg::tma_store_2d(&to, src + 64 * 128, n0 + 64, m0 + cw * 64);
    s8wg::tma_store_drain();  // the block's shared memory outlives the reads
  }
}

// A row-major [rows, cols] matrix (cols innermost, esize bytes each) as a
// 2-D tensor map with boxes of box_rows x box_cols; rows past the end read
// as zero and are not written.
CUresult encode_2d(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int esize,
                   const void* ptr, long long rows, long long cols, int box_cols, int box_rows,
                   CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// B7: out[M, N] = W4A8(x[M, K] bf16, p4[K/2, N] packed int4, sw[K/G, N] f32)
// (+ res[M, N] bf16). p4 is K-major: it points at an [N, K/2] buffer, row n
// holding column n's packed bytes. x8 [M, K] int8 and sx [M, K/G] f32 are
// scratch the caller allocates. Returns 0 on success, a CUDA runtime error
// code when a launch or its setup failed, -CUresult when a tensor map could
// not be encoded, -1000 when the driver's cuTensorMapEncodeTiled could not
// be found.
extern "C" int quantized_matmul_int4_bf16(const void* x, const void* p4, const void* sw,
                                          const void* res, void* x8, void* sx, void* out,
                                          int M, int K, int N, int G, void* stream) {
  if (M <= 0 || (G != 128 && G != 256 && G != 512) || K <= 0 || K % G || N <= 0 ||
      N % kCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1000;
  CUtensorMap tx, tp, ts, to;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult rc = encode_2d(fn, &tx, u8, 1, x8, M, K, kW, kRows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc == CUDA_SUCCESS) {
    rc = encode_2d(fn, &tp, u8, 1, p4, N, K / 2, kW, kCols, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (rc == CUDA_SUCCESS) {
    rc = encode_2d(fn, &ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sw, K / G, N, kCols, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (rc == CUDA_SUCCESS) {
    rc = encode_2d(fn, &to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, M, N, 64, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  // The shared-memory cap is raised once per device; every launch asks for
  // the same size.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(w4a8_gemm_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_quantize(static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8),
                        static_cast<float*>(sx), M, K, G, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  W4Params p;
  p.sx = static_cast<const float*>(sx);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.M = M;
  p.N = N;
  p.G = G;
  p.nk = K / G;
  p.per_group = G / 2 / kW;
  p.stages = K / 2 / kW;
  const dim3 grid(N / kCols, (M + kRows - 1) / kRows);  // N tiles fastest
  w4a8_gemm_wgmma_kernel<<<grid, kThreads, kSmem, st>>>(tx, tp, ts, to, p);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one B7 block, in bytes.
extern "C" int quantized_matmul_int4_smem_bytes() { return kSmem; }
