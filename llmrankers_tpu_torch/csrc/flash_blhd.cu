// Flash attention for sm_90a, bf16, over any layout whose head rows are
// contiguous: [B, L, H*Dh] (the projection layout), [B, H, L, Dh], or views of
// either, addressed by a batch, a head and a row stride per tensor.
//
// Replaces three TPU kernels of llmrankers_tpu/ops/flash.py:
//   flash_mha_blhd (body _kernel_blhd): T5 encoder self-attention in the
//     projection layout, head h at column offset h*Dh (B1);
//   flash_mha_packed: the same on q/k/v views of one packed qkv tensor (B2);
//   flash_mha (body _kernel): decoder prefill attention on [B, H, L, Dh],
//     GQA-native (query head h reads K/V head h / G, the repeated K/V is
//     never materialised) with a causal sliding window in index space (B5).
// All three: an additive batch-invariant [H, Lq, Lk] bias (the T5
// relative-position bias), a key-padding mask, an optional causal mask at
// offset Lk - Lq, a score scale, and an fp32 online softmax. The masking
// constants are the TPU kernels': masked scores are -1e30, the running max is
// floored at -1e28, and the row sum at 1e-30, so a row that sees no key (a
// batch-padding row, a left-padding position) comes out as exact zeros.
//
// What bounds it. Each visible (head, query, key) pair costs 4*Dh operations
// on the bf16 tensor cores; q, k, v and the bias are read once and o written
// once. At B 32, L 640 (flan-t5 encoders, Dh 64, and Qwen2.5-3B prefill, Dh
// 128, H 16, KV 2) both give 0.04-0.06 ms on this card (989 TFLOP/s, 3.35
// TB/s); at Rank-R1's L 4096 the operations do (0.17 ms at B 4, causal,
// left-padded). What limits the kernel is keeping the tensor cores fed
// between the two products and the softmax, and not computing the pairs no
// mask lets through.
//
// Design, one block per (128 query rows, head, batch), three warpgroups:
// - Products on wgmma (Hopper's warpgroup MMA; mma.sync reaches a fraction
//   of its rate). Each of two consumer warpgroups owns 64 query rows. S =
//   Q K^T is an m64n64k16 chain with Q and the K tile in shared memory.
//   O += P V takes P from registers as the A operand (the S accumulators,
//   rescaled and exponentiated, re-packed in place as bf16 pairs: S and P
//   never touch memory) and reads V as it lies in shared memory, MN-major,
//   through the transpose flag: V is not transposed by any thread.
// - Loads by TMA through a ring of four stages. One thread of the producer
//   warpgroup loads Q once and, per key tile, K, V and (where given) the
//   [128 x 64] bias tile, each completing on the stage's "full" mbarrier;
//   the consumers arrive on its "empty" mbarrier when they are done with it,
//   so the next tile's loads run under this tile's products. Tiles are
//   panels of 64, 32 or 16 columns of Dh under the 128-, 64- or 32-byte
//   swizzle that the wgmma descriptors name (64 for Dh 64 and 128, the
//   largest that divides Dh), so any Dh that is a multiple of 16 up to 128
//   runs. Every layout the wrapper takes is a 4-D tensor map (Dh, L, heads,
//   batch) with the view's own strides, the packed qkv views and the
//   transposed decoder views included: one kernel serves all three.
// - Warp specialisation: the producer warpgroup hands registers to the
//   consumers at run time (setmaxnreg 40 and 232). ptxas (CUDA 12.9) still
//   allocates every role within the 168 registers a thread that 384 threads
//   leave: with 128-key tiles the instances from Dh 64 up spilled whatever
//   the setmaxnreg counts, so the tiles are 64 keys, and S (32 registers),
//   P (16) and O (64 at Dh 128) fit with no spill at any Dh.
// - No global load between the two products: the bias tile sits in shared
//   memory (read with the swizzle the TMA wrote), and each block turns its
//   batch row of kv_mask into one validity bit per key in shared memory
//   before the loop (4 KB of bits cover 32768 keys, where one float per key
//   would not fit beside the ring at Lk 32768).
// - Tiles that hold no key are not loaded: from the bits, the block lists the
//   64-key tiles that have a valid key and lie inside its causal and window
//   range, and both roles walk that list. Left padding in decoder batches and
//   right padding in T5 batches drop out whole; a row whose list is empty
//   comes out as zeros. Tiles that are wholly valid and wholly inside the
//   causal band skip the per-element predicates, and a consumer skips the
//   products of a tile that lies wholly outside its own 64 rows' band.
// - 128 query rows (two consumer warpgroups of 64, wgmma's M) and 64 keys a
//   tile (above): 12 warps a block, 8 of them computing, where the
//   mma.sync kernel this one replaces had 4 warps at 176 registers. Four
//   stages: at 64 keys a tile a stage is consumed about
//   as fast as TMA refills it, and in a trial four were faster than three,
//   five or six at every shape chip_flash_ab.py times. The ring with Q takes
//   at most 224 KB of the 227 KB (Dh 128 with a bias). Blocks are issued
//   longest causal row range first. Overlapping one tile's softmax with the
//   next tile's S (two S register sets) made ptxas serialise the wgmmas and
//   spill, and was slower: the two consumer warpgroups overlap instead.
#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda (driver entry point)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_encode.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kConsumers = 2;         // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kConsumers;  // query rows per block
constexpr int kBK = 64;               // keys per tile
constexpr int kStages = 4;            // ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e28f;

struct Params {
  const int32_t* kv_mask;  // [B, Lk] {0, 1}, or null
  __nv_bfloat16* o;
  long long o_bs, o_hs, o_rs;  // output strides, in elements
  int lq, lk;
  int group;  // query heads per K/V head
  float scale;
  int causal;
  int window;  // causal sliding window in index space; 0 = none
  int has_bias;
};

// The dynamic shared memory of one block, in bytes from a 1024-aligned base:
// Q, the ring (per stage K, V and the bias tile), the mbarriers, the key
// bits and the list of key tiles. flash.py::_smem_bytes mirrors it.
struct Smem {
  uint32_t stage0, v_off, b_off, stage_bytes, bars, bits, list, count, total;
};

__host__ __device__ inline Smem smem_plan(int dh, int lk, int has_bias) {
  Smem s;
  const uint32_t kv = kBK * dh * 2;
  s.stage0 = kBQ * dh * 2;  // Q
  s.v_off = kv;
  s.b_off = 2 * kv;
  s.stage_bytes = 2 * kv + (has_bias ? kBQ * kBK * 2 : 0);  // all of it by TMA
  s.bars = s.stage0 + kStages * s.stage_bytes;
  s.bits = s.bars + 8 * (2 * kStages + 1);
  s.list = s.bits + 4 * ((lk + kBK - 1) / kBK) * (kBK / 32);  // whole tiles of bits
  s.count = s.list + 4 * ((lk + kBK - 1) / kBK);
  s.total = s.count + 4 + 1024;  // + slack to align the base
  return s;
}

// Panels of Dh: W columns each under a W*2-byte swizzle.
template <int DH>
struct Panel {
  static constexpr int W = DH % 64 == 0 ? 64 : DH % 32 == 0 ? 32 : 16;
  static constexpr int P = DH / W;        // panels
  static constexpr uint32_t kRow = W * 2;  // bytes per panel row
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint32_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;
};

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
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type. Buffers are 1024-aligned,
// so the base offset field stays 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bias values at (row, col) and (row, col + 1) of a [128 x kBK] tile
// that TMA wrote as [128 x 64] boxes under the 128-byte swizzle: the 16-byte
// chunk index is XORed with the row mod 8.
__device__ __forceinline__ float2 bias_pair(const uint8_t* tile, int row, int col) {
  const int c = col & 63;
  const int off = (col >> 6) * (kBQ * 128) + row * 128 + ((((c >> 3) ^ (row & 7)) << 4) |
                                                          ((c & 7) * 2));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_blhd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                 const Params p) {
  using T = Panel<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // generic pointer to the base
  const Smem L = smem_plan(DH, p.lk, p.has_bias);
  uint32_t* const bits = reinterpret_cast<uint32_t*>(sm + L.bits);
  int* const list = reinterpret_cast<int*>(sm + L.list);
  int* const count = reinterpret_cast<int*>(sm + L.count);
  const uint32_t bars = base + L.bars;  // full[s], then empty[s], then Q's
  const uint32_t q_bar = bars + 16 * kStages;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal range first
  const int off = p.lk - p.lq;                         // causal diagonal
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // One validity bit per key: below Lk and, with a mask, unmasked; the
  // words run to the end of the last tile.
  const int nwords = (p.lk + kBK - 1) / kBK * (kBK / 32);
  const int32_t* const mrow = p.kv_mask ? p.kv_mask + static_cast<long long>(b) * p.lk : nullptr;
  for (int w = warp; w < nwords; w += kThreads / 32) {
    const int col = w * 32 + lane;
    const bool valid = col < p.lk && (mrow == nullptr || mrow[col] != 0);
    const uint32_t word = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) bits[w] = word;
  }
  __syncthreads();
  // The key tiles this block reads: inside its causal and window range and
  // holding a valid key; entry = tile * 2 + (every key of the tile valid).
  int t_begin = 0, t_end = (p.lk + kBK - 1) / kBK;
  if (p.causal) {
    t_end = (min(p.lk, max(0, q0 + kBQ + off)) + kBK - 1) / kBK;
    if (p.window > 0) t_begin = max(0, q0 + off - p.window + 1) / kBK;
  }
  if (warp == 0) {
    int n = 0;
    for (int t0 = t_begin; t0 < t_end; t0 += 32) {
      const int t = t0 + lane;
      uint32_t any = 0u, all = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int w = t * (kBK / 32) + i;
        const uint32_t word = t < t_end ? bits[w] : 0u;
        any |= word;
        all &= word;
      }
      const bool keep = t < t_end && any != 0u;
      const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) list[n + __popc(ballot & ((1u << lane) - 1u))] = 2 * t + (all == 0xffffffffu);
      n += __popc(ballot);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  const int n = *count;

  if (warp < 4) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0 && n > 0) {
      mbar_expect_tx(q_bar, kBQ * DH * 2);
#pragma unroll
      for (int pi = 0; pi < T::P; ++pi) {
        tma_4d(base + pi * kBQ * T::kRow, &tq, q_bar, pi * T::W, q0, h, b);
      }
      const int kvh = h / p.group;
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((i / kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = base + L.stage0 + s * L.stage_bytes;
        const int k0 = (list[i] >> 1) * kBK;
        mbar_expect_tx(full, L.stage_bytes);
#pragma unroll
        for (int pi = 0; pi < T::P; ++pi) {
          tma_4d(st + pi * kBK * T::kRow, &tk, full, pi * T::W, k0, kvh, b);
          tma_4d(st + L.v_off + pi * kBK * T::kRow, &tv, full, pi * T::W, k0, kvh, b);
        }
        if (p.has_bias) {
#pragma unroll
          for (int c = 0; c < kBK / 64; ++c) {
            tma_3d(st + L.b_off + c * kBQ * 128, &tb, full, k0 + c * 64, q0, h);
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warp / 4 - 1;
    const int w = warp % 4, g = lane / 4, t = lane % 4;
    const int lr0 = cw * 64 + w * 16 + g;  // this thread's rows in the block: lr0, lr0 + 8
    const int r0 = q0 + lr0;
    const int rbase = q0 + cw * 64;  // the warpgroup's first row
    const int vis_last = rbase + 63 + off;             // last key its last row sees
    const int vis_first = rbase + off - p.window + 1;  // first key its first row sees (window)
    const uint32_t qa = base + cw * 64 * T::kRow;

    float acc[DH / 2];  // O: DH / 8 column blocks of 4 (fragment layout of wgmma's D)
#pragma unroll
    for (int j = 0; j < DH / 2; ++j) acc[j] = 0.f;
    float m[2] = {kMFloor, kMFloor};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums

    if (n > 0) mbar_wait(q_bar, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      mbar_wait(bars + 8 * s, (i / kStages) & 1);
      const int k0 = (list[i] >> 1) * kBK;
      const bool all_valid = list[i] & 1;
      bool skip = false, edge = false;
      if (p.causal) {
        skip = k0 > vis_last || (p.window > 0 && k0 + kBK - 1 < vis_first);
        edge = k0 + kBK - 1 > rbase + off || (p.window > 0 && k0 < vis_first + 63);
      }
      if (!skip) {
        const uint32_t st = base + L.stage0 + s * L.stage_bytes;
        // S = Q K^T
        float sc[kBK / 2];
#pragma unroll
        for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;
        wg_fence();
#pragma unroll
        for (int pi = 0; pi < T::P; ++pi) {
#pragma unroll
          for (int kk = 0; kk < T::W / 16; ++kk) {
            const uint64_t da =
                make_desc(qa + pi * kBQ * T::kRow + kk * 32, 16, 8 * T::kRow, T::kLayout);
            const uint64_t db =
                make_desc(st + pi * kBK * T::kRow + kk * 32, 16, 8 * T::kRow, T::kLayout);
            wgmma::ss<kBK>(sc, da, db, 1);
          }
        }
        wg_commit_wait();
        reg_fence(sc);

        // Scale, bias, key bits, causal band; row maxima.
        const uint8_t* const btile = sm + L.stage0 + s * L.stage_bytes + L.b_off;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const int c = j * 8 + 2 * t;  // column in the tile
          const uint32_t word = all_valid ? 0xffffffffu : bits[k0 / 32 + j / 4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2 bv = make_float2(0.f, 0.f);
            if (p.has_bias) bv = bias_pair(btile, lr0 + 8 * r, c);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * j + 2 * r + e] * p.scale + (e ? bv.y : bv.x);
              if (!((word >> ((c + e) & 31)) & 1u)) x = kNegInf;
              if (edge) {
                const int rel = r0 + 8 * r + off - (k0 + c + e);
                if (rel < 0 || (p.window > 0 && rel >= p.window)) x = kNegInf;
              }
              sc[4 * j + 2 * r + e] = x;
              mx[r] = fmaxf(mx[r], x);
            }
          }
        }
        // Online softmax: a row's values sit in the 4 lanes of a quad.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(fmaxf(m[r], mx[r]), kMFloor);
          const float alpha = __expf(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha;
#pragma unroll
          for (int j = 0; j < DH / 8; ++j) {
            acc[4 * j + 2 * r] *= alpha;
            acc[4 * j + 2 * r + 1] *= alpha;
          }
        }
        // P = exp(S - m) as wgmma A fragments: column blocks 2kk and 2kk+1
        // of S are the k-step kk of P.
        uint32_t pf[kBK / 16][4];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float p0 = __expf(sc[4 * j] - m[0]), p1 = __expf(sc[4 * j + 1] - m[0]);
          const float p2 = __expf(sc[4 * j + 2] - m[1]), p3 = __expf(sc[4 * j + 3] - m[1]);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
          pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
        // O += P V, V read MN-major: 8-key row groups SBO apart, Dh panels LBO apart.
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db = make_desc(st + L.v_off + kk * 16 * T::kRow, kBK * T::kRow,
                                        8 * T::kRow, T::kLayout);
          wgmma::rs<DH>(acc, pf[kk], db);
        }
        wg_commit_wait();
        reg_fence(acc);
      }
      mbar_arrive(bars + 8 * (kStages + s));
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* const ob = p.o + b * p.o_bs + h * p.o_hs;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = j * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < p.lq) {
          *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_rs + c) = __floats2bfloat162_rn(
              acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

}  // namespace

namespace {

CUtensorMapSwizzle swizzle_for(int w) {
  return w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A bf16 tensor map of `rank` dims (innermost first), strides in bytes for
// dims 1.., a box of `box` elements. Out-of-bounds elements read as zero.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* bias, const Params& p,
           int batch, int heads, const long long* st, cudaStream_t stream) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1000;
  const Smem L = smem_plan(DH, p.lk, p.has_bias);
  if (L.total > static_cast<uint32_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  using T = Panel<DH>;
  const CUtensorMapSwizzle sw = swizzle_for(T::W);
  const int kv_heads = heads / p.group;
  CUtensorMap tq, tk, tv, tb = {};
  // q, k, v: (Dh, rows, heads, batch) with the views' row, head and batch
  // strides (elements, turned into bytes).
  const cuuint64_t dq[4] = {DH, static_cast<cuuint64_t>(p.lq), static_cast<cuuint64_t>(heads),
                            static_cast<cuuint64_t>(batch)};
  const cuuint64_t dk[4] = {DH, static_cast<cuuint64_t>(p.lk),
                            static_cast<cuuint64_t>(kv_heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t sq[3] = {2ull * st[2], 2ull * st[1], 2ull * st[0]};
  const cuuint64_t sk[3] = {2ull * st[5], 2ull * st[4], 2ull * st[3]};
  const cuuint64_t sv[3] = {2ull * st[8], 2ull * st[7], 2ull * st[6]};
  const cuuint32_t bq[4] = {T::W, kBQ, 1, 1};
  const cuuint32_t bk[4] = {T::W, kBK, 1, 1};
  CUresult rc = encode(fn, &tq, q, 4, dq, sq, bq, sw);
  if (rc == CUDA_SUCCESS) rc = encode(fn, &tk, k, 4, dk, sk, bk, sw);
  if (rc == CUDA_SUCCESS) rc = encode(fn, &tv, v, 4, dk, sv, bk, sw);
  if (rc == CUDA_SUCCESS && p.has_bias) {
    // bias [H, Lq, Lk] contiguous: (Lk, Lq, H), boxes of 64 keys x 128 rows.
    const cuuint64_t db[3] = {static_cast<cuuint64_t>(p.lk), static_cast<cuuint64_t>(p.lq),
                              static_cast<cuuint64_t>(heads)};
    const cuuint64_t sb[2] = {2ull * p.lk, 2ull * p.lk * p.lq};
    const cuuint32_t bb[3] = {64, kBQ, 1};
    rc = encode(fn, &tb, bias, 3, db, sb, bb, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != CUDA_SUCCESS) return -static_cast<int>(rc);
  // The shared memory cap is raised once per device and instance, to what
  // any launch may ask for.
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(flash_blhd_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  const dim3 grid((p.lq + kBQ - 1) / kBQ, heads, batch);
  flash_blhd_kernel<DH><<<grid, kThreads, L.total, stream>>>(tq, tk, tv, tb, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory the kernel takes for (dh, lk, has_bias), in bytes.
extern "C" int flash_smem_bytes(int dh, int lk, int has_bias) {
  return static_cast<int>(smem_plan(dh, lk, has_bias).total);
}

// Returns 0 on success; a CUDA runtime error code when the launch or its
// setup failed; -CUresult when a tensor map could not be encoded; -1000 when
// the driver's cuTensorMapEncodeTiled could not be found. Pointers are device
// pointers; strides are in elements, each tensor's as (batch, head, row), and
// the wrapper has checked that TMA can describe them (16-byte aligned bases,
// strides in whole 16 bytes). kv_mask and bias may be null. `heads` counts
// query heads, `group` query heads per K/V head; `window` 0 means no window.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               const void* kv_mask, const void* bias, void* o,
                               int batch, int heads, int lq, int lk, int dh,
                               int group, const long long* strides, float scale,
                               int causal, int window, void* stream) {
  Params p;
  p.kv_mask = static_cast<const int32_t*>(kv_mask);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_bs = strides[9];
  p.o_hs = strides[10];
  p.o_rs = strides[11];
  p.lq = lq;
  p.lk = lk;
  p.group = group;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.has_bias = bias != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(q, k, v, bias, p, batch, heads, strides, s);
    case 32: return launch<32>(q, k, v, bias, p, batch, heads, strides, s);
    case 48: return launch<48>(q, k, v, bias, p, batch, heads, strides, s);
    case 64: return launch<64>(q, k, v, bias, p, batch, heads, strides, s);
    case 80: return launch<80>(q, k, v, bias, p, batch, heads, strides, s);
    case 96: return launch<96>(q, k, v, bias, p, batch, heads, strides, s);
    case 112: return launch<112>(q, k, v, bias, p, batch, heads, strides, s);
    case 128: return launch<128>(q, k, v, bias, p, batch, heads, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
