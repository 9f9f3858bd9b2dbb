// W8A8 int8 GEMMs with activation quantization in the kernel, for sm_90a.
//
// Replaces the TPU kernels llmrankers_tpu/ops/int8_matmul.py::quantized_matmul
// (body _kernel_fusedq) and ::gated_matmul (body _kernel_gated):
//   quantized_matmul: out = (sum_kb float(x8_kb . w8_kb) * sx[row, kb]) * sw (+ res)
//   gated_matmul:     out = act(h0 * s0) * (h1 * s1) over one packed [K, 2N]
//                     int8 weight whose halves sit at columns 0 and N.
// x is bf16 [M, K]; it is quantized per row and per K-block of kb columns
// (kb is the TPU kernel's K-block, computed by the Python wrapper), with the
// TPU body's arithmetic step for step: scale = max(amax, 1e-8) * f32(1/127),
// q = clip(rint(x * rcp_rn(scale)), -127, 127). Every f32 step of the fold
// and the epilogue uses round-to-nearest intrinsics with no contraction into
// FMA, in the plain version's order, so the kernel and its plain PyTorch
// version agree to the last bit wherever the int8 values agree.
//
// Design. Two launches per call. (1) One warp per (row, K-block) computes
// amax, writes the int8 row block to a scratch [M, K] and its scale to
// [M, K/kb]; the wrapper allocates both. A K-block of 576 to 2048 bf16 per
// row does not fit a GEMM tile, so amax must be known before the block is
// quantized; the separate pass reads x once and writes a quarter of its
// bytes. (2) The GEMM: one block of eight warps per 128 x 128 output tile
// (gated: 128 rows x 64 columns of each half, both halves sharing the A
// tile), K in stages of 64 bytes. A (int8 x, K-contiguous) is staged as it
// is; B (int8 w, [K, N] N-contiguous) is transposed to K-contiguous while it
// is staged, four k-rows of eight columns at a time with byte permutes, since
// mma.sync wants B K-major and ldmatrix .trans handles only 16-bit elements.
// Four neighbouring lanes read one 32-byte sector of a k-row, and they store
// their transposed columns in rotated order, so the stores of a warp hit 32
// distinct banks. Two shared buffers: the next stage's global loads go to
// registers before the current stage is multiplied and to the other buffer
// after, one barrier per stage. Shared-memory rows are padded to 80 bytes,
// so the ldmatrix.x4 fragment reads are free of bank conflicts. The
// products run on the tensor cores as mma.sync.m16n8k32.s32.s8.s8.s32; each
// warp owns 64 rows x 32 columns with int32 accumulators that are folded
// into f32 (times the row scale) and reset at the end of every K-block,
// never carried across it.
//
// What bounds it. At flan-t5-xl's encoder shapes (M = 20480, K 2048 or
// 5120, N 2048 to 2 x 5120) the work is bound by the int8 tensor-core rate.
// mma.sync from registers, one stage of prefetch and one block of eight
// warps per SM (240 registers a thread) leave most of that rate unused.
// Later work: wgmma from shared memory with TMA and a deeper pipeline, the
// weights stored K-major so both operands load without the transpose, and
// the quantize pass fused into the producer of x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // eight warps: 2 along M x 4 along N
constexpr int kBM = 128;        // output rows per block
constexpr int kBN = 128;        // B-tile columns (gated: 64 of each half)
constexpr int kBK = 64;         // int8 K per stage; every K-block is a multiple
constexpr int kRow = kBK + 16;  // shared-memory row stride in bytes
constexpr float kAmaxFloor = (float)1e-8;
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kGeluC = (float)0.7978845608028654;
constexpr float kGeluA = (float)0.044715;

struct GemmParams {
  const int8_t* x8;           // [M, K]
  const int8_t* w8;           // [K, ldw]
  const float* sx;            // [M, K / kb]
  const float* sw;            // [1, ldw]
  const __nv_bfloat16* res;   // [M, N] or null
  __nv_bfloat16* out;         // [M, N]
  int M, K, N, ldw, kb, act;  // act: 0 gelu_new, 1 relu
};

// ---------------------------------------------------------------------------
// (1) Per-row, per-K-block quantization
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    quantize_blocks_kernel(const __nv_bfloat16* __restrict__ x,
                           int8_t* __restrict__ x8, float* __restrict__ sx,
                           int M, int K, int kb) {
  const int nk = K / kb;
  const long long task =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
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

// ---------------------------------------------------------------------------
// (2) The GEMM
// ---------------------------------------------------------------------------
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

// The same arithmetic as the plain version's gelu_new, in its order.
__device__ __forceinline__ float gelu_new(float h) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kGeluA, h), h), h);
  const float t = tanhf(__fmul_rn(kGeluC, __fadd_rn(h, cube)));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, t));
}

// Local B-tile column of a warp's accumulator tile j (0..3). Plain: the
// warp's 32 columns; gated: 16 columns of half 0 (j 0, 1) and the same 16
// of half 1 (j 2, 3), which sits at local columns 64..127.
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

__device__ __forceinline__ void load_stage(Stage& st, const GemmParams& p, int m0,
                                           int k0, int tid, int kg, int gcol) {
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
    st.b[r] = *reinterpret_cast<const uint2*>(
        p.w8 + (long long)(k0 + kg * 4 + r) * p.ldw + gcol);
  }
}

// A as it is; B transposed to K-contiguous rows: the four k-rows of each of
// the thread's eight columns become one 32-bit word (k in byte order). The
// four lanes that share k-rows (ng % 4 = 0..3) store their columns in an
// order rotated by 2 * (ng % 4), so each store instruction of a warp writes
// 32 distinct banks.
__device__ __forceinline__ void store_stage(const Stage& st, int8_t* as, int8_t* bs,
                                            int tid, int kg, int ng) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    *reinterpret_cast<uint4*>(as + (idx / 4) * kRow + (idx % 4) * 16) = st.a[i];
  }
  uint32_t cols[8];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const uint32_t r0 = w ? st.b[0].y : st.b[0].x, r1 = w ? st.b[1].y : st.b[1].x;
    const uint32_t r2 = w ? st.b[2].y : st.b[2].x, r3 = w ? st.b[3].y : st.b[3].x;
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
    const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
    cols[w * 4 + 0] = __byte_perm(lo01, lo23, 0x5410);
    cols[w * 4 + 1] = __byte_perm(lo01, lo23, 0x7632);
    cols[w * 4 + 2] = __byte_perm(hi01, hi23, 0x5410);
    cols[w * 4 + 3] = __byte_perm(hi01, hi23, 0x7632);
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
    *reinterpret_cast<uint32_t*>(bs + (ng * 8 + col) * kRow + kg * 4) = cols[c];
  }
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
  int gcol = n0 + ng * 8;
  if constexpr (GATED) {
    if (ng >= 8) gcol = p.N + n0 + (ng - 8) * 8;
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
  load_stage(st, p, m0, 0, tid, kg, gcol);
  store_stage(st, as[0], bs[0], tid, kg, ng);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) load_stage(st, p, m0, (s + 1) * kBK, tid, kg, gcol);

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
            const float h0 = __fmul_rn(accf[i][j][2 * h + e], p.sw[col + e]);
            const float h1 = __fmul_rn(accf[i][j + 2][2 * h + e], p.sw[p.N + col + e]);
            const float a = p.act == 0 ? gelu_new(h0) : fmaxf(h0, 0.f);
            o[e] = __fmul_rn(a, h1);
          } else {
            o[e] = __fmul_rn(accf[i][j][2 * h + e], p.sw[col + e]);
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

int launch(const __nv_bfloat16* x, const GemmParams& p, int8_t* x8, float* sx,
           bool gated, cudaStream_t stream) {
  if (p.M <= 0 || p.K % 128 || p.N % 128 || p.kb % kBK || p.kb <= 0 || p.K % p.kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tasks = (long long)p.M * (p.K / p.kb);
  const int warps = kThreads / 32;
  quantize_blocks_kernel<<<(unsigned)((tasks + warps - 1) / warps), kThreads, 0, stream>>>(
      x, x8, sx, p.M, p.K, p.kb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.N / (gated ? kBN / 2 : kBN), (p.M + kBM - 1) / kBM);
  if (gated) {
    int8_gemm_kernel<true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    int8_gemm_kernel<false><<<grid, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B3: out[M, N] = W8A8(x[M, K] bf16, w8[K, N] int8, sw[1, N] f32) (+ res[M, N]).
// x8 [M, K] int8 and sx [M, K/kb] f32 are scratch the caller allocates.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int quantized_matmul_bf16(const void* x, const void* w8, const void* sw,
                                     const void* res, void* x8, void* sx, void* out,
                                     int M, int K, int N, int kb, void* stream) {
  GemmParams p;
  p.x8 = static_cast<const int8_t*>(x8);
  p.w8 = static_cast<const int8_t*>(w8);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sw);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldw = N;
  p.kb = kb;
  p.act = 0;
  return launch(static_cast<const __nv_bfloat16*>(x), p, static_cast<int8_t*>(x8),
                static_cast<float*>(sx), false, static_cast<cudaStream_t>(stream));
}

// B4: out[M, N] = act(x @ w0 * s0) * (x @ w1 * s1) over wp[K, 2N] int8 with
// w0 at columns 0..N-1 and w1 at N..2N-1, scales sp[1, 2N]; act 0 gelu_new,
// 1 relu. Scratch as for quantized_matmul_bf16.
extern "C" int gated_matmul_bf16(const void* x, const void* wp, const void* sp,
                                 void* x8, void* sx, void* out, int M, int K, int N,
                                 int kb, int act, void* stream) {
  if (act != 0 && act != 1) return static_cast<int>(cudaErrorInvalidValue);
  GemmParams p;
  p.x8 = static_cast<const int8_t*>(x8);
  p.w8 = static_cast<const int8_t*>(wp);
  p.sx = static_cast<const float*>(sx);
  p.sw = static_cast<const float*>(sp);
  p.res = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldw = 2 * N;
  p.kb = kb;
  p.act = act;
  return launch(static_cast<const __nv_bfloat16*>(x), p, static_cast<int8_t*>(x8),
                static_cast<float*>(sx), true, static_cast<cudaStream_t>(stream));
}
