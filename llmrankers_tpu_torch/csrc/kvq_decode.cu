// One-token GQA decode attention over a quantized KV cache (int8, or planar
// int4), bf16 queries, f32 output.
//
// Replaces the TPU kernel llmrankers_tpu/ops/kvq_attention.py::
// kvq_decode_attention (pallas_call at :212, body _kernel :56). Inputs:
//   q      [B, KV, G, Dh]   bf16 (query head kv*G + g reads KV head kv)
//   kp, vp [B, KV, T, Dhp]  int8 payload: Dhp = Dh (int8) or Dh/2 (int4: the
//                           low nibble of byte j is dim j, the high nibble
//                           dim Dh/2 + j)
//   ks, vs [B, KV, T, S]    f32 scales per position and head, S = 1 or 2
//                           (one per nibble plane)
//   kn, vn [B, KV, Dh]      bf16, the current token's unquantized K/V
//   mask   [B, T]           bool key validity (the window included)
// out [B, KV, G, Dh] f32 = softmax(scale * [q.K^T | q.kn]) . [V | vn], with
// the k scale folded in after the dot per plane and the v scale into the
// probabilities, as the TPU kernel does.
//
// What bounds it: bytes. A call reads the cache once (int8: 2*B*KV*T*Dh
// bytes, 8.4 MB at Qwen2.5-3B's decode shape) and does about one operation
// per byte, far below the card's ~300 operations per byte of bandwidth. The
// TPU grid has one program per (b, kv): 16 at batch 8 with 2 KV heads, for
// 132 SMs. So this is flash-decoding: pass 1 splits T into chunks of TCHUNK
// positions, one block per (split, kv, b) (576 blocks at T 2304), so a
// decode step fills the card; each block keeps f32 (max, sum, acc) for its G
// query rows and writes them to a workspace. Pass 2, one block per (g, kv,
// b), joins the splits' partial softmaxes and the self term. Each payload
// byte is loaded once: a warp takes one cache row at a time, a lane holds
// Dh/32 of its dims (for int4 both nibble planes of the same bytes), and the
// G dot products are summed across the warp with shuffles. Plain CUDA cores;
// no tensor cores, TMA or cp.async pipelining yet (loading all of a warp's
// rows before the arithmetic was tried, and slowed the split pass from 0.034
// to 0.044 ms: 124 registers a thread cut the resident warps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TCHUNK = 64;    // cache positions per split block
constexpr int WARPS = 8;      // warps per split block
constexpr int MAXG = 8;       // query heads per KV head held in registers
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e28f;

struct Params {
  const __nv_bfloat16* q;
  const int8_t* kp;
  const float* ks;
  const int8_t* vp;
  const float* vs;
  const __nv_bfloat16* kn;
  const __nv_bfloat16* vn;
  const uint8_t* mask;
  float* ws;  // [B*KV*nsplit, G, Dh + 2]: acc, then max and sum
  float* out;
  int B, KV, G, T, nsplit;
  float scale;
};

// The DPL dims of one cache row that a lane holds, as floats, from the bytes
// it loads once. int8: bytes lane*DPL .. +DPL-1 are dims lane*DPL + j.
// int4: bytes lane*DPL/2 .. hold the low plane's dims lane*DPL/2 + j (slots
// j < DPL/2) and the high plane's dims Dh/2 + lane*DPL/2 + j (slots DPL/2 + j).
// NB consecutive signed bytes in one load (the row base is 16-byte aligned and
// the lane's offset a multiple of NB), sign-extended.
template <int NB>
__device__ __forceinline__ void load_bytes(const int8_t* p, int (&b)[NB]) {
  unsigned w;
  if constexpr (NB == 4) w = static_cast<unsigned>(__ldg(reinterpret_cast<const int*>(p)));
  else if constexpr (NB == 2)
    w = static_cast<unsigned short>(__ldg(reinterpret_cast<const short*>(p)));
  else w = static_cast<unsigned char>(__ldg(reinterpret_cast<const signed char*>(p)));
#pragma unroll
  for (int j = 0; j < NB; ++j) b[j] = static_cast<int>(w << (24 - 8 * j)) >> 24;
}

template <int DPL, bool INT4>
__device__ __forceinline__ void load_row(const int8_t* row, int lane, float (&x)[DPL]) {
  if constexpr (INT4) {
    constexpr int HP = DPL / 2;
    int b[HP];
    load_bytes<HP>(row + lane * HP, b);
#pragma unroll
    for (int j = 0; j < HP; ++j) {
      x[j] = static_cast<float>(static_cast<int>(static_cast<unsigned>(b[j]) << 28) >> 28);
      x[HP + j] = static_cast<float>(b[j] >> 4);
    }
  } else {
    int b[DPL];
    load_bytes<DPL>(row + lane * DPL, b);
#pragma unroll
    for (int j = 0; j < DPL; ++j) x[j] = static_cast<float>(b[j]);
  }
}

template <int DPL, bool INT4>
__device__ __forceinline__ int dim_of(int lane, int j, int dh) {
  if (INT4) {
    constexpr int HP = DPL / 2;
    return j < HP ? lane * HP + j : dh / 2 + lane * HP + (j - HP);
  }
  return lane * DPL + j;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int DPL, bool INT4>
__global__ void __launch_bounds__(WARPS * 32) kvq_split_kernel(Params p) {
  constexpr int DH = DPL * 32;
  constexpr int S = INT4 ? 2 : 1;
  constexpr int DHP = INT4 ? DH / 2 : DH;
  __shared__ float s_sc[MAXG][TCHUNK];           // scores, then probabilities
  __shared__ float s_red[WARPS][MAXG * DH];      // per-warp p.V partials
  __shared__ float s_m[MAXG], s_l[MAXG];

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = p.G, T = p.T;
  const long bh = static_cast<long>(b) * p.KV + kv;
  const int t0 = split * TCHUNK;
  const int n = min(TCHUNK, T - t0);

  // This lane's dims of every query row.
  float q[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      q[g][j] = g < G ? __bfloat162float(p.q[(bh * G + g) * DH + dim_of<DPL, INT4>(lane, j, DH)])
                      : 0.f;
    }
  }

  // Pass 1: scores of the chunk's rows, one row per warp at a time.
  const int8_t* kbase = p.kp + (bh * T + t0) * DHP;
  const float* ksb = p.ks + (bh * T + t0) * S;
  const uint8_t* mrow = p.mask + static_cast<long>(b) * T + t0;
  for (int r = warp; r < n; r += WARPS) {
    float x[DPL];
    load_row<DPL, INT4>(kbase + static_cast<long>(r) * DHP, lane, x);
    const float s0 = ksb[r * S];
    const float s1 = INT4 ? ksb[r * S + 1] : 0.f;
    const float pen = mrow[r] ? 0.f : NEG_INF;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          if (INT4 && j >= DPL / 2) hi += q[g][j] * x[j];
          else lo += q[g][j] * x[j];
        }
        const float part = INT4 ? lo * s0 + hi * s1 : lo * s0;
        const float tot = warp_sum(part);
        if (lane == 0) s_sc[g][r] = tot * p.scale + pen;
      }
    }
  }
  __syncthreads();

  // The chunk's max and sum per query row, one warp per row.
  if (warp < G) {
    float m = M_FLOOR;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, s_sc[warp][r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = __expf(s_sc[warp][r] - m);
      s_sc[warp][r] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();

  // Pass 2: p.V over the chunk's rows, the v scale folded into p.
  float acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  const int8_t* vbase = p.vp + (bh * T + t0) * DHP;
  const float* vsb = p.vs + (bh * T + t0) * S;
  for (int r = warp; r < n; r += WARPS) {
    float x[DPL];
    load_row<DPL, INT4>(vbase + static_cast<long>(r) * DHP, lane, x);
    const float s0 = vsb[r * S];
    const float s1 = INT4 ? vsb[r * S + 1] : s0;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float pr = s_sc[g][r];
        const float w0 = pr * s0, w1 = pr * s1;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] += ((INT4 && j >= DPL / 2) ? w1 : w0) * x[j];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) s_red[warp][g * DH + dim_of<DPL, INT4>(lane, j, DH)] = acc[g][j];
  __syncthreads();

  float* ws = p.ws + (bh * p.nsplit + split) * static_cast<long>(G) * (DH + 2);
  for (int i = threadIdx.x; i < G * DH; i += WARPS * 32) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += s_red[w][i];
    ws[(i / DH) * (DH + 2) + (i % DH)] = a;
  }
  if (threadIdx.x < G) {
    ws[threadIdx.x * (DH + 2) + DH] = s_m[threadIdx.x];
    ws[threadIdx.x * (DH + 2) + DH + 1] = s_l[threadIdx.x];
  }
}

// Pass 2: one block of DH threads per (g, kv, b); thread d writes dim d.
template <int DH>
__global__ void __launch_bounds__(DH) kvq_combine_kernel(Params p) {
  __shared__ float s_part[DH / 32];
  const int g = blockIdx.x, kv = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = p.G;
  const long bh = static_cast<long>(b) * p.KV + kv;
  // The self term's score q.kn, summed over the block.
  const float part = warp_sum(__bfloat162float(p.q[(bh * G + g) * DH + d]) *
                              __bfloat162float(p.kn[bh * DH + d]));
  if ((d & 31) == 0) s_part[d >> 5] = part;
  __syncthreads();
  float ss = 0.f;
#pragma unroll
  for (int w = 0; w < DH / 32; ++w) ss += s_part[w];
  ss *= p.scale;
  const long stride = static_cast<long>(G) * (DH + 2);  // from one split to the next
  const float* ws = p.ws + bh * p.nsplit * stride + g * (DH + 2);
  float m = ss;
  for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, ws[s * stride + DH]);
  const float e_self = __expf(ss - m);
  float l = e_self, a = e_self * __bfloat162float(p.vn[bh * DH + d]);
  for (int s = 0; s < p.nsplit; ++s) {
    const float* row = ws + s * stride;
    const float c = __expf(row[DH] - m);
    l += row[DH + 1] * c;
    a += row[d] * c;
  }
  p.out[(bh * G + g) * DH + d] = a / fmaxf(l, 1e-30f);
}

template <int DPL, bool INT4>
void launch(const Params& p, cudaStream_t stream) {
  kvq_split_kernel<DPL, INT4><<<dim3(p.nsplit, p.KV, p.B), WARPS * 32, 0, stream>>>(p);
  kvq_combine_kernel<DPL * 32><<<dim3(p.G, p.KV, p.B), DPL * 32, 0, stream>>>(p);
}

}  // namespace

extern "C" int kvq_decode_bf16(const void* q, const void* kp, const void* ks,
                               const void* vp, const void* vs, const void* kn,
                               const void* vn, const void* mask, void* ws, void* out,
                               int B, int KV, int G, int T, int Dh, int int4,
                               float scale, cudaStream_t stream) {
  if (G < 1 || G > MAXG || (Dh != 64 && Dh != 128) || T < 1) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kp = static_cast<const int8_t*>(kp);
  p.ks = static_cast<const float*>(ks);
  p.vp = static_cast<const int8_t*>(vp);
  p.vs = static_cast<const float*>(vs);
  p.kn = static_cast<const __nv_bfloat16*>(kn);
  p.vn = static_cast<const __nv_bfloat16*>(vn);
  p.mask = static_cast<const uint8_t*>(mask);
  p.ws = static_cast<float*>(ws);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.T = T;
  p.nsplit = (T + TCHUNK - 1) / TCHUNK;
  p.scale = scale;
  if (Dh == 128) {
    if (int4) launch<4, true>(p, stream);
    else launch<4, false>(p, stream);
  } else {
    if (int4) launch<2, true>(p, stream);
    else launch<2, false>(p, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
