// Flash attention for sm_90a, bf16, over any layout whose head rows are
// contiguous: [B, L, H*Dh] (the projection layout), [B, H, L, Dh], or views of
// either, addressed by a batch, a head and a row stride per tensor.
//
// Replaces three TPU kernels of llmrankers_tpu/ops/flash.py:
//   flash_mha_blhd (body _kernel_blhd): T5 encoder self-attention in the
//     projection layout, head h at column offset h*Dh;
//   flash_mha_packed: the same on q/k/v views of one packed qkv tensor;
//   flash_mha (body _kernel): decoder prefill attention on [B, H, L, Dh],
//     GQA-native (query head h reads K/V head h / G, the repeated K/V is
//     never materialised) with a causal sliding window in index space.
// All three: an additive batch-invariant [H, Lq, Lk] bias (the T5
// relative-position bias), an additive key-padding penalty, an optional
// causal mask at offset Lk - Lq from the true (unpadded) lengths, a score
// scale, and an fp32 online softmax. The masking constants are the TPU
// kernels': masked scores are -1e30, the running max is floored at -1e28, and
// the row sum at 1e-30, so a fully masked row (a batch-padding row, a
// left-padding position) comes out as exact zeros, never NaN.
//
// Design. One block of four warps per (q-tile of 64 rows, head, batch); each
// warp owns 16 query rows. A loop over 64-key tiles takes the place of the
// TPU's sequential grid axis. Q stays in registers as mma.sync A fragments
// for the whole loop; each K tile is staged row-major and each V tile
// transposed in shared memory (rows padded by 8 elements so the fragment
// reads are free of bank conflicts). S = Q K^T and O += P V run on the
// tensor cores as mma.m16n8k16 with bf16 operands and fp32 accumulators; the
// S accumulators are rescaled, masked and exponentiated in registers and
// re-packed in place as the A fragments of P, so S and P never touch memory.
// A head is addressed by its own stride (Dh in the projection layout, L*Dh
// in [B, H, L, Dh]), so the packed qkv layout of flash_mha_packed and the
// transposed projection views of the decoder need only other strides and
// bases. Causal blocks skip the key tiles past their last visible column and,
// with a window, the tiles wholly before their first one.
//
// What bounds it. At the main paths' shapes (flan-t5-large encoder, L 512 to
// 640, H 16, Dh 64; Qwen2.5-3B prefill, L 128 to 1024, H 16, KV 2, Dh 128)
// the work is bound by the tensor-core operations and, in T5, by the read of
// the [H, L, L] bias, which every (batch, q-tile) block streams again from
// L2. In GQA the G query heads of one KV head read the same K/V tiles, which
// the L2 serves after the first. This first version issues mma.sync from
// registers with synchronous global-to-shared copies and no double buffering,
// so it leaves
// most of Hopper's tensor-core rate unused. Later work: compute the bias
// inside the kernel from the [buckets, H] table (it is a function of k - q
// alone), double-buffer K/V with cp.async or TMA, and move to wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e28f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* kv_mask;     // [B, Lk] {0, 1}, or null
  const __nv_bfloat16* bias;  // [H, Lq, Lk] contiguous, or null
  __nv_bfloat16* o;
  // batch, head and row strides, in elements
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs;
  int lq, lk;
  int group;  // query heads per K/V head
  float scale;
  int causal;
  int window;  // causal sliding window in index space; 0 = none
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b 16x8 given by
// columns, c 16x8 fp32 (PTX ISA fragment layouts for mma.m16n8k16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    flash_blhd_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][DH + 8];
  __shared__ __align__(16) __nv_bfloat16 vt[DH][kBK + 8];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int q0 = blockIdx.x * kBQ;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const int causal_off = p.lk - p.lq;

  const int kvh = h / p.group;
  const __nv_bfloat16* qb = p.q + b * p.q_bs + h * p.q_hs;
  const __nv_bfloat16* kb = p.k + b * p.k_bs + kvh * p.k_hs;
  const __nv_bfloat16* vb = p.v + b * p.v_bs + kvh * p.v_hs;

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < p.lq ? ld_pair(qb + r0 * p.q_rs + c) : 0u;
    qf[kk][1] = r1 < p.lq ? ld_pair(qb + r1 * p.q_rs + c) : 0u;
    qf[kk][2] = r0 < p.lq ? ld_pair(qb + r0 * p.q_rs + c + 8) : 0u;
    qf[kk][3] = r1 < p.lq ? ld_pair(qb + r1 * p.q_rs + c + 8) : 0u;
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m[2] = {kMFloor, kMFloor};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  // Causal: keys past the block's last visible column contribute nothing;
  // with a window, neither do the tiles wholly before its first one.
  int k_end = p.lk, k_begin = 0;
  if (p.causal) k_end = min(k_end, max(0, q0 + kBQ + causal_off));
  if (p.causal && p.window > 0) {
    k_begin = max(0, q0 + causal_off - p.window + 1) / kBK * kBK;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * DH / 8; i += kWarps * 32) {
      const int key = i / (DH / 8), d = (i % (DH / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + key < p.lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + key) * p.k_rs + d);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + key) * p.v_rs + d);
      }
      *reinterpret_cast<uint4*>(&ks[key][d]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[d + e][key] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[j * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[j], qf[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    // scale, bias, key penalty, causal predicate; row maxima.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float x = kNegInf;  // the ragged edge past Lk
        if (col < p.lk) {
          x = s[j][e] * p.scale;
          if (p.bias != nullptr && row < p.lq) {
            x += __bfloat162float(
                p.bias[((long long)h * p.lq + row) * p.lk + col]);
          }
          if (p.kv_mask != nullptr && p.kv_mask[(long long)b * p.lk + col] == 0) {
            x += kNegInf;
          }
          if (p.causal) {
            const int rel = row + causal_off - col;
            if (rel < 0 || (p.window > 0 && rel >= p.window)) x = kNegInf;
          }
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }

    // Online softmax: a row's 64 values sit in the 4 lanes of a quad.
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
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // P = exp(S - m), re-packed as bf16 A fragments: key tiles 2kk and
    // 2kk+1 of S form the k-step kk of P.
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = __expf(s[j][0] - m[0]), p1 = __expf(s[j][1] - m[0]);
      const float p2 = __expf(s[j][2] - m[1]), p3 = __expf(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const __nv_bfloat16* vr = &vt[j * 8 + g][kk * 16 + 2 * t];
        mma_bf16(acc[j], pf[kk], ld_pair(vr), ld_pair(vr + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = p.o + b * p.o_bs + h * p.o_hs;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < p.lq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.o_rs + c) =
          __floats2bfloat162_rn(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    }
    if (r1 < p.lq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.o_rs + c) =
          __floats2bfloat162_rn(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

template <int DH>
void launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const dim3 grid((p.lq + kBQ - 1) / kBQ, heads, batch);
  flash_blhd_kernel<DH><<<grid, kWarps * 32, 0, stream>>>(p);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Pointers are
// device pointers; strides are in elements, each tensor's as (batch, head,
// row); kv_mask and bias may be null. `heads` counts query heads, `group`
// query heads per K/V head; `window` 0 means no sliding window.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               const void* kv_mask, const void* bias, void* o,
                               int batch, int heads, int lq, int lk, int dh,
                               int group, const long long* strides, float scale,
                               int causal, int window, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.kv_mask = static_cast<const int32_t*>(kv_mask);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.o = static_cast<__nv_bfloat16*>(o);
  long long* const dst[12] = {&p.q_bs, &p.q_hs, &p.q_rs, &p.k_bs, &p.k_hs, &p.k_rs,
                              &p.v_bs, &p.v_hs, &p.v_rs, &p.o_bs, &p.o_hs, &p.o_rs};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];  // a host array
  p.lq = lq;
  p.lk = lk;
  p.group = group;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: launch<16>(p, batch, heads, s); break;
    case 32: launch<32>(p, batch, heads, s); break;
    case 48: launch<48>(p, batch, heads, s); break;
    case 64: launch<64>(p, batch, heads, s); break;
    case 80: launch<80>(p, batch, heads, s); break;
    case 96: launch<96>(p, batch, heads, s); break;
    case 112: launch<112>(p, batch, heads, s); break;
    case 128: launch<128>(p, batch, heads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
