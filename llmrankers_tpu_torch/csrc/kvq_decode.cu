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
// probabilities (rounded to bf16 before the p.V product, as the TPU kernel
// and the plain version do). A masked key contributes exactly 0; a row with
// no valid key returns vn from its self term.
//
// What bounds it: bytes. A call needs the rows of the valid keys once (a
// masked key adds exactly 0; int8: 2*KV*Dh bytes and the scales per valid
// (b, key), 6.3 MB at Qwen2.5-3B's decode shape B 8, KV 2, T 2304, where
// about 64% of the slots are valid) and does about one operation per byte,
// far below the card's ~300 operations per byte of bandwidth; at 3.35 TB/s
// the bytes take 1.9 us (int8) or 1.1 us (int4). The TPU grid has one program per (b, kv): 16 at batch 8 with 2 KV
// heads, for 132 SMs. At this size the kernel is a chain of latencies (the
// mask, then the cache tiles, then the join), and what the design does is
// keep that chain short: one launch, no workspace, no masked tiles.
//
// Design: one launch; the blocks of one (b, kv) form a thread-block cluster
// along grid x (cluster_size in the wrapper: 8 at batch 8 with 2 KV heads,
// 128 blocks; 1 where B*KV alone fills the card; at most 8, the portable
// size). 256 threads a block: two groups of four warps take alternate tiles
// of the block's share, each warp 16 keys of a tile.
// - Plan from the mask: every block reads its batch row of the mask (T
//   bytes, 16-byte vector loads between a ragged head and tail, issued
//   before the block's first barrier), sets one bit per valid key in shared
//   memory, lists the TILE-key tiles that hold a valid key (one warp,
//   ballots) and takes its share of that list, balanced by valid tiles:
//   rank r of C takes list entries [n*r/C, n*(r+1)/C). Tiles with no valid
//   key (prefix padding, the unwritten max_new tail, keys outside a window)
//   are never loaded. ops/kvq_attention.py::key_tiles mirrors the plan.
// - Cache tiles by bulk asynchronous copy (cp.async.bulk, TMA without a
//   tensor map): a (b, kv) slab's rows are contiguous, so a tile's K and V
//   payloads are two copies of rows*Dhp bytes (Dhp is 32, 64 or 128, so
//   addresses and sizes are whole 16 bytes) that complete on the stage's
//   mbarrier. Each group issues its tiles (lane 0 of its warps in turn)
//   into a ring of STAGES stages up front (a block's whole share at the decode shape: 3-4 tiles at T 2304)
//   and refills a stage once its four warps are done with it (a named
//   barrier a group). A stuck mbarrier wait traps after 2^26 polls.
// - Scale rows by 4-byte cp.async on the same mbarrier: a tile's scale rows
//   start at (b*KV*T + t0)*S floats, which is not 16-byte aligned for odd T,
//   and a partial tile's are not a whole 16 bytes, so a bulk copy cannot
//   take them; each thread of the group copies one or two floats and
//   arrives on the stage's barrier once they land (cp.async.mbarrier.arrive
//   .noinc; the barrier counts the group's 128 threads and the bulk copies'
//   bytes). Masked keys' scales are never used, so unwritten slots may hold
//   anything.
// - Both products on mma.sync m16n8k16 bf16 (exact for int8 and int4
//   values), f32 sums: S = Q K^T with the G <= 8 query rows padded to 16;
//   O += P V with P from the S accumulators (the FA2 register reuse) and V's
//   bytes converted to bf16 as the fragments are formed. The contraction
//   dims of S and the output dims of O are permuted so that a thread reads
//   whole 8-32-byte runs of a cache row from shared memory: no per-row
//   cross-lane reduction, and every byte is loaded into registers once.
//   int8 -> float by the 2^23 magic number, int4 -> bf16 by the 128 magic
//   number. Each warp keeps its own online softmax state (max, sum, acc)
//   over its keys; the k scale multiplies S per column and plane, the v
//   scale P per column and plane, and P * v_scale is rounded to bf16.
// - The splits join in the cluster's shared memory: each block merges its
//   eight warps into (max, sum, acc[G][Dh]) through the ring, kept in mma
//   fragment order (in dim order the 32 lanes of a warp hit one bank, and
//   the kernel took 21.3 us instead of 13.8). Rank s owns a slice of the output
//   slots; every rank pushes its (max, sum) per row and its partial of each
//   slice into the owner's receive buffers by remote stores to distributed
//   shared memory (map_shared_rank); one cluster barrier makes them visible
//   (a relaxed cluster arrive at the start, waited for before the pushes,
//   makes sure every block is running first); each rank joins its slice from
//   its own shared memory, adds the self term q.kn / vn (its operands loaded
//   at the start) and writes it. No workspace and no second kernel.
// The route: tensor cores through mma.sync, not wgmma: G <= 8 query rows
// would fill an eighth of wgmma's 64. CUDA cores with one thread per key row
// were not tried.
//
// Sizes (ptxas, CUDA 12.8, sm_90a): TILE 64 keys, STAGES 6; at most 128
// registers a thread (__launch_bounds__(256, 2)): Dh 64 111 (int8) and 120
// (int4) registers, no spill; Dh 128 128 registers with 40 (int8) and 56
// (int4) bytes of spill stores. Dynamic shared memory at T 2304: 101,736 B
// (Dh 128 int8), 55,656 B (int4). Where the time goes at B 8, KV 2, T 2304,
// int8 (chip_kvq_trace.py; median over the blocks, us since a block's
// start; H100 SXM): plan done 1.7 (the mask's latency), tiles issued 2.4,
// first tile waited 4.5 (every block issues its whole share at once, so the
// transfers interleave and a first tile lands late), last tile done 7.0,
// partial merged 7.4, pushed and past the cluster barrier 8.8 (the slowest
// rank), joined 9.5; 11.4 us a launch with a cold L2.
// Tried and dropped (chip_smoke.py phase 22 on the versions named; cold
// device time, int8 / int4 at T 2304): the block's partials added into
// shared memory with float atomicAdd (a CAS loop: 106 / 48 us); four warps
// a block, partials in dim order (16.9 / 14.7 us); eight warps with one
// block an SM (154 registers): the card holds 15 clusters of 8, so the 16th
// waited for a second wave (21.2 / 16.5 us); every rank pulling all ranks'
// partials for its slice by remote loads, with a second cluster barrier to
// keep them alive (12.8 / 11.8 us, against 11.7 / 10.7 pushing); scales
// and mask bytes by ordinary loads a tile ahead (the mask byte gated the
// scale loads: two dependent latencies a tile). Clusters of 6 and 4 were
// slower than 8 in a trial.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 64;       // cache positions per tile
constexpr int WARPS = 8;       // two groups of four: each warp takes 16 positions of a tile
constexpr int THREADS = WARPS * 32;
constexpr int GROUPS = 2;      // group h takes tiles h, h + 2, ... of the block's share
constexpr int GROUP_THREADS = THREADS / GROUPS;
constexpr int MAXG = 8;        // query heads per KV head (the mma rows 0..7)
constexpr int STAGES = 6;      // tiles in flight per block
constexpr int MAX_CLUSTER = 8; // the portable cluster size
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory attribute is kept
// Dynamic shared memory a block may use: the card's 232448 bytes less 8 KB
// for the static arrays (the partial, 4 KB at Dh 128, and the join's state).
constexpr int SMEM_LIMIT = 224256;
// 10 bytes a tile fit fewer than 2^16 tiles: the tile list's uint16 indices hold.
static_assert(SMEM_LIMIT / 10 < 65536, "tile indices overflow uint16");
constexpr float NEG_INF = -1e30f;

template <int DH, bool INT4>
struct Cfg {
  static constexpr int DHP = INT4 ? DH / 2 : DH;  // payload bytes per cache row
  static constexpr int S = INT4 ? 2 : 1;          // scales per row
  static constexpr int NBK = DHP / 4;    // K bytes per thread per row: quad q owns [q*NBK, +NBK)
  static constexpr int KSTEPS = NBK / 4;  // S k-steps per plane: 4 bytes each
  static constexpr int NBV = DHP / 8;    // V bytes per thread per row: group r owns [r*NBV, +NBV)
  static constexpr int NT = DH / 8;      // output n-tiles (NBV per plane)
  static constexpr int TILE_BYTES = TILE * DHP;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
};

// Dynamic shared memory: the ring of K and V payload tiles and their f32
// scale rows (s per row), then per tile two words of key-validity bits and
// a uint16 list entry (ops/kvq_attention.py::_smem_bytes mirrors this).
__host__ __device__ constexpr int smem_bytes(int dhp, int s, int T) {
  return STAGES * 2 * TILE * (dhp + 4 * s) + 10 * ((T + TILE - 1) / TILE);
}

struct Params {
  const __nv_bfloat16* q;
  const int8_t* kp;
  const float* ks;
  const int8_t* vp;
  const float* vs;
  const __nv_bfloat16* kn;
  const __nv_bfloat16* vn;
  const uint8_t* mask;
  float* out;
  int B, KV, G, T, cluster;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A wait that outlasts 2^26 polls (seconds; a tile takes microseconds) traps,
// so that a broken ring ends the launch with an error instead of holding the
// card.
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

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // A rows 8..15 (a1, a3) are the padding rows: zero.
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte i of w (w already XORed with 0x80808080: the int8 value + 128) as a
// float: 2^23 + u has u in its low mantissa bits.
__device__ __forceinline__ float s8f(uint32_t wx, int i) {
  return __int_as_float(static_cast<int>(__byte_perm(wx, 0x4B000000u, 0x7440u | i))) -
         8388736.f;
}

// Two nibbles u0, u1 (each already XORed with 8: the int4 value + 8) as a
// bf16 pair: bf16 0x43uu is 128 + u, so subtracting 136 leaves the value.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t u0, uint32_t u1) {
  const uint32_t bits = 0x43004300u | u0 | (u1 << 16);
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  const uint32_t c136 = 0x43084308u;
  v = __hsub2(v, *reinterpret_cast<const __nv_bfloat162*>(&c136));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// n 32-bit words from 16-byte-aligned shared memory.
template <int N>
__device__ __forceinline__ void lds_words(const uint8_t* p, uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * i);
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// The stage's mbarrier gets one arrival from this thread once its earlier
// cp.async copies have landed (the barrier counts GROUP_THREADS of these).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A block's mask row is read in 16-byte vectors between a ragged head and
// tail (the row of batch b starts at b*T bytes). The first four vectors a
// thread takes (T up to 16384) are loaded before the block's first barrier,
// so that their latency runs under the set-up.
struct MaskLoad {
  uint4 x[4];
  bool head, tail;
};

__device__ __forceinline__ int mask_head(const uint8_t* row, int T) {
  return min(T, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
}

__device__ __forceinline__ void load_vectors(const uint4* v, int nvec, int k0, uint4 (&x)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = k0 + u * THREADS;
    x[u] = k < nvec ? __ldg(v + k) : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void mask_load(const uint8_t* row, int T, int tid, MaskLoad& m) {
  const int head = mask_head(row, T);
  const int nvec = (T - head) / 16;
  const int tail = head + nvec * 16;
  m.head = tid < head && row[tid];
  m.tail = tid < T - tail && row[tail + tid];
  load_vectors(reinterpret_cast<const uint4*>(row + head), nvec, tid, m.x);
}

// Sets the validity bit of every nonzero byte of the 16-byte vector x
// holding keys at..at+15 (one or two words).
__device__ __forceinline__ void mark_vector(const uint4& x, int at, uint32_t* bits) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  if (!(w[0] | w[1] | w[2] | w[3])) return;
  uint32_t m0 = 0, m1 = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (!((w[j >> 2] >> (8 * (j & 3))) & 0xFFu)) continue;
    const int key = at + j;
    if (key / 32 == at / 32) m0 |= 1u << (key % 32);
    else m1 |= 1u << (key % 32);
  }
  if (m0) atomicOr(bits + at / 32, m0);
  if (m1) atomicOr(bits + at / 32 + 1, m1);
}

// One validity bit per key of the mask row (word k/32, bit k%32; two words a
// tile), set with shared atomicOr (bits zeroed before): the loaded vectors
// first, then any beyond them.
__device__ __forceinline__ void mark_keys(const uint8_t* row, int T, const MaskLoad& m,
                                          uint32_t* bits, int tid) {
  const int head = mask_head(row, T);
  const int nvec = (T - head) / 16;
  const int tail = head + nvec * 16;
  if (m.head) atomicOr(bits + tid / 32, 1u << (tid % 32));
  if (m.tail) atomicOr(bits + (tail + tid) / 32, 1u << ((tail + tid) % 32));
#pragma unroll
  for (int u = 0; u < 4; ++u) mark_vector(m.x[u], head + 16 * (tid + u * THREADS), bits);
  const uint4* v = reinterpret_cast<const uint4*>(row + head);
  for (int k0 = tid + 4 * THREADS; k0 < nvec; k0 += 4 * THREADS) {
    uint4 x[4];
    load_vectors(v, nvec, k0, x);
#pragma unroll
    for (int u = 0; u < 4; ++u) mark_vector(x[u], head + 16 * (k0 + u * THREADS), bits);
  }
}

template <int DH, bool INT4>
// Two blocks an SM (at most 128 registers a thread): with one, the card
// holds 15 clusters of 8 and the 16th of batch 8 x 2 KV heads waits for a
// second wave.
__global__ void __launch_bounds__(THREADS, 2) kvq_decode_kernel(const Params p) {
  using C = Cfg<DH, INT4>;
  constexpr int S = C::S;
  constexpr int PLANES = INT4 ? 2 : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bar[STAGES];
  // Receive buffers of the join: from each rank, its partial of this
  // rank's output slots and its (max, sum) per row.
  __shared__ float r_acc[MAXG * DH + MAX_CLUSTER];
  __shared__ float r_m[MAX_CLUSTER * MAXG], r_l[MAX_CLUSTER * MAXG];
  __shared__ float s_m[MAXG], s_l[MAXG];
  __shared__ float w_m[WARPS][MAXG], w_l[WARPS][MAXG];
  __shared__ float s_self[MAXG], s_vn[DH];
  __shared__ int s_nvalid;

  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");  // running
  const int rank = static_cast<int>(cluster.block_rank());
  const int C_ = p.cluster;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, quad = lane & 3;
  const int group = warp / (WARPS / GROUPS), gtid = tid % GROUP_THREADS;
  const int wk = 16 * (warp % (WARPS / GROUPS));  // this warp's first key of a tile
  const int G = p.G, T = p.T;
  const long bh = static_cast<long>(b) * p.KV + kv;
  const int ntiles = (T + TILE - 1) / TILE;
  uint8_t* ring = smem;
  float* scl = reinterpret_cast<float*>(smem + STAGES * C::STAGE_BYTES);  // [STAGES][2][TILE][S]
  uint32_t* bits = reinterpret_cast<uint32_t*>(scl + STAGES * 2 * TILE * S);  // [2 * ntiles]
  uint16_t* list = reinterpret_cast<uint16_t*>(bits + 2 * ntiles);

  // Q as mma A fragments, rows g = grp (rows 8..15 are the zero padding):
  // plane pl, k-step s holds dims pl*DH/2 + quad*NBK + 4s + {0,1} and
  // {2,3}. Loaded first, so that their latency runs under the plan's.
  uint32_t qa[PLANES][C::KSTEPS][2];
#pragma unroll
  for (int pl = 0; pl < PLANES; ++pl)
#pragma unroll
    for (int s = 0; s < C::KSTEPS; ++s) {
      uint2 v = make_uint2(0, 0);
      if (grp < G)
        v = __ldg(reinterpret_cast<const uint2*>(p.q + (bh * G + grp) * DH + pl * (DH / 2) +
                                                 quad * C::NBK + 4 * s));
      qa[pl][s][0] = v.x;
      qa[pl][s][1] = v.y;
    }

  // The self term's operands (row g = warp, DH/32 dims a lane) and vn.
  constexpr int DPL = DH / 32;
  __nv_bfloat162 sq[DPL / 2], sk[DPL / 2];
  if (warp < G) {
#pragma unroll
    for (int h = 0; h < DPL / 2; ++h) {
      sq[h] = reinterpret_cast<const __nv_bfloat162*>(p.q + (bh * G + warp) * DH)[lane * DPL / 2 + h];
      sk[h] = reinterpret_cast<const __nv_bfloat162*>(p.kn + bh * DH)[lane * DPL / 2 + h];
    }
  }
  const float vn = tid < DH ? __bfloat162float(p.vn[bh * DH + tid]) : 0.f;
  const uint8_t* mrow = p.mask + static_cast<long>(b) * T;
  MaskLoad ml;
  mask_load(mrow, T, tid, ml);

  for (int i = tid; i < 2 * ntiles; i += THREADS) bits[i] = 0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&bar[s]), GROUP_THREADS + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The plan: the tiles with a valid key, and this block's share of them.
  mark_keys(mrow, T, ml, bits, tid);
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int t = base + lane;
      const bool f = t < ntiles && (bits[2 * t] | bits[2 * t + 1]);
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(bal & ((1u << lane) - 1u))] = static_cast<uint16_t>(t);
      n += __popc(bal);
    }
    if (lane == 0) s_nvalid = n;
  }
  __syncthreads();
  const int nvalid = s_nvalid;
  const int first = nvalid * rank / C_;  // 32-bit: nvalid < 2^16, rank < 8
  const int mine = nvalid * (rank + 1) / C_ - first;

  // Tile i of this block's share into stage i % STAGES, by the group that
  // takes it (STAGES is even, so a group refills only its own stages): K
  // and V payloads by bulk copy (the group's first thread), the scale rows
  // by 4-byte cp.async (every thread of the group, each then arriving on the
  // stage's barrier).
  auto issue = [&](int i) {
    const int t0 = list[first + i] * TILE;
    const int n = min(TILE, T - t0);
    const uint32_t bb = smem_u32(&bar[i % STAGES]);
    if (gtid == 32 * ((i / GROUPS) % (WARPS / GROUPS))) {  // the group's warps take turns
      const uint32_t bytes = static_cast<uint32_t>(n * C::DHP);
      const uint32_t st = smem_u32(ring + (i % STAGES) * C::STAGE_BYTES);
      const long off = (bh * T + t0) * C::DHP;
      mbar_expect_tx(bb, 2 * bytes);
      bulk_copy(st, p.kp + off, bytes, bb);
      bulk_copy(st + C::TILE_BYTES, p.vp + off, bytes, bb);
    }
    float* dst = scl + (i % STAGES) * 2 * TILE * S;
    const long src = (bh * T + t0) * S;
    for (int e = gtid; e < 2 * n * S; e += GROUP_THREADS) {
      const int half = e >= n * S, r = e - half * n * S;
      cp_async4(smem_u32(dst + half * TILE * S + r), (half ? p.vs : p.ks) + src + r);
    }
    cp_async_arrive(bb);
  };
  for (int i = group; i < min(STAGES, mine); i += GROUPS) issue(i);

  // The self term's score, under the first copies.
  if (warp < G) {
    float part = 0.f;
#pragma unroll
    for (int h = 0; h < DPL / 2; ++h) {
      const float2 a = __bfloat1622float2(sq[h]), k = __bfloat1622float2(sk[h]);
      part += a.x * k.x + a.y * k.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) s_self[warp] = part * p.scale;
  }
  if (tid < DH) s_vn[tid] = vn;

  float m_run = NEG_INF, l_run = 0.f;  // the online softmax of row grp over this warp's keys
  float acc[C::NT][4];
#pragma unroll
  for (int j = 0; j < C::NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = group; i < mine; i += GROUPS) {
    const int t = list[first + i];
    mbar_wait(smem_u32(&bar[i % STAGES]), (i / STAGES) & 1);
    const uint8_t* kt = ring + (i % STAGES) * C::STAGE_BYTES;
    const uint8_t* vt = kt + C::TILE_BYTES;
    const float* ksc = scl + (i % STAGES) * 2 * TILE * S;
    const float* vsc = ksc + TILE * S;
    const uint64_t vbits = bits[2 * t] | (static_cast<uint64_t>(bits[2 * t + 1]) << 32);

    // S = Q K^T over keys wk + 8*nt + (column), per plane.
    float sc[PLANES][2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      uint32_t w[C::NBK / 4];
      lds_words(kt + (wk + 8 * nt + grp) * C::DHP + quad * C::NBK, w);
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl)
        sc[pl][nt][0] = sc[pl][nt][1] = sc[pl][nt][2] = sc[pl][nt][3] = 0.f;
#pragma unroll
      for (int s = 0; s < C::KSTEPS; ++s) {
        if constexpr (INT4) {
          const uint32_t wx = w[s] ^ 0x88888888u;
          const uint32_t lo = wx & 0x0F0F0F0Fu, hi = (wx >> 4) & 0x0F0F0F0Fu;
          mma_bf16(sc[0][nt], qa[0][s][0], qa[0][s][1], nib2_bf16(lo & 0xFF, (lo >> 8) & 0xFF),
                   nib2_bf16((lo >> 16) & 0xFF, lo >> 24));
          mma_bf16(sc[1][nt], qa[1][s][0], qa[1][s][1], nib2_bf16(hi & 0xFF, (hi >> 8) & 0xFF),
                   nib2_bf16((hi >> 16) & 0xFF, hi >> 24));
        } else {
          const uint32_t wx = w[s] ^ 0x80808080u;
          mma_bf16(sc[0][nt], qa[0][s][0], qa[0][s][1], pack_bf16(s8f(wx, 0), s8f(wx, 1)),
                   pack_bf16(s8f(wx, 2), s8f(wx, 3)));
        }
      }
    }

    // Scores of row grp at this thread's keys wk + 2*quad + {0, 1, 8,
    // 9} (c0, c1 of each n-tile), the k scale per plane; masked keys drop
    // out (their scales are never used: they may be anything).
    float sv[4], pr[4];
    bool ok[4];
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int nt = k >> 1, e = k & 1, key = wk + 8 * nt + 2 * quad + e;
      ok[k] = (vbits >> key) & 1u;
      float s = sc[0][nt][e] * ksc[key * S];
      if constexpr (INT4) s += sc[1][nt][e] * ksc[key * S + 1];
      sv[k] = ok[k] ? s * p.scale : NEG_INF;
      mx = fmaxf(mx, sv[k]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float corr = __expf(m_run - m_new);
    float rs = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pr[k] = ok[k] ? __expf(sv[k] - m_new) : 0.f;
      rs += pr[k];
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * corr + rs;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < C::NT; ++j) acc[j][0] *= corr, acc[j][1] *= corr;

    // P (v scale folded in, bf16) as A fragments: keys 2*quad + {0,1} and
    // 2*quad + 8 + {0,1} of the warp's 16.
    uint32_t pa[PLANES][2];
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl) {
      float pv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int key = wk + 8 * (k >> 1) + 2 * quad + (k & 1);
        pv[k] = ok[k] ? pr[k] * vsc[key * S + pl] : 0.f;
      }
      pa[pl][0] = pack_bf16(pv[0], pv[1]);
      pa[pl][1] = pack_bf16(pv[2], pv[3]);
    }

    // O += P V: B fragments from V rows wk + 2*quad + {0, 1, 8, 9},
    // bytes [grp*NBV, +NBV) of each; n-tile j of plane pl is output dim
    // pl*DH/2 + n*NBV + j for the mma column n.
    uint32_t vw[4][C::NBV / 4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      lds_words(vt + (wk + 2 * quad + (r & 1) + 8 * (r >> 1)) * C::DHP + grp * C::NBV,
                vw[r]);
#pragma unroll
    for (int j = 0; j < C::NBV; ++j) {
      const int wi = j >> 2, bi = j & 3;
      if constexpr (INT4) {
        uint32_t tb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) tb[r] = ((vw[r][wi] >> (8 * bi)) & 0xFFu) ^ 0x88u;
        mma_bf16(acc[j], pa[0][0], pa[0][1], nib2_bf16(tb[0] & 0xF, tb[1] & 0xF),
                 nib2_bf16(tb[2] & 0xF, tb[3] & 0xF));
        mma_bf16(acc[C::NBV + j], pa[1][0], pa[1][1], nib2_bf16(tb[0] >> 4, tb[1] >> 4),
                 nib2_bf16(tb[2] >> 4, tb[3] >> 4));
      } else {
        float f[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) f[r] = s8f(vw[r][wi] ^ 0x80808080u, bi);
        mma_bf16(acc[j], pa[0][0], pa[0][1], pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
      }
    }

    // Every warp of the group is done with this stage (named barrier 1 +
    // group: the groups may take different numbers of tiles).
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(GROUP_THREADS) : "memory");
    if (i + STAGES < mine) issue(i + STAGES);
  }

  // The block's partial: the eight warps' states joined through the ring,
  // free now (every tile issued was waited for). Partials stay in mma
  // fragment order, slot k = (j*2 + e)*32 + lane for n-tile j, column
  // 2*(lane%4) + e, row lane/4, so that shared-memory accesses run over
  // consecutive words (in dim order the 32 lanes of a warp hit one bank).
  constexpr int FRAG = MAXG * DH;  // = 64 * NT slots
  if (quad == 0 && grp < G) {
    w_m[warp][grp] = m_run;
    w_l[warp][grp] = l_run;
  }
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(ring);  // [WARPS][FRAG]
  float f = 0.f;  // rows past G are padding
  if (grp < G) {
    float M = w_m[0][grp];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, w_m[w][grp]);
    f = __expf(m_run - M);
    if (warp == 0 && quad == 0) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l += w_l[w][grp] * __expf(w_m[w][grp] - M);
      s_m[grp] = M;
      s_l[grp] = l;
    }
  }
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) wacc[warp * FRAG + (2 * j + e) * 32 + lane] = acc[j][e] * f;
  __syncthreads();

  // The splits join through distributed shared memory: rank s owns output
  // slots [s*chunk, (s+1)*chunk); every rank pushes its (max, sum) per row
  // and its partial of those slots into rank s's receive buffers (remote
  // stores), then one cluster barrier makes them visible and each rank
  // joins its slots from its own shared memory, the self term included. The
  // barrier at the start (waited for just before the pushes) makes sure
  // every block of the cluster is running before any writes into it.
  const int chunk = (FRAG + C_ - 1) / C_;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int k = tid; k < FRAG; k += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += wacc[w * FRAG + k];
    const int s = k / chunk;
    cluster.map_shared_rank(r_acc, s)[rank * chunk + k - s * chunk] = a;
  }
  if (tid < C_ * MAXG) {
    const int s = tid / MAXG, g = tid % MAXG;
    cluster.map_shared_rank(r_m, s)[rank * MAXG + g] = g < G ? s_m[g] : NEG_INF;
    cluster.map_shared_rank(r_l, s)[rank * MAXG + g] = g < G ? s_l[g] : 0.f;
  }
  cluster.sync();
  const int end = min(FRAG, (rank + 1) * chunk);
  for (int k = rank * chunk + tid; k < end; k += THREADS) {
    const int ln = k % 32, g = ln >> 2;
    if (g >= G) continue;
    const int j = k / 64, e = (k / 32) & 1;
    const int d = (j / C::NBV) * (DH / 2) + (2 * (ln & 3) + e) * C::NBV + j % C::NBV;
    float M = s_self[g];
    for (int r = 0; r < C_; ++r) M = fmaxf(M, r_m[r * MAXG + g]);
    const float es = __expf(s_self[g] - M);
    float L = es, A = es * s_vn[d];
    for (int r = 0; r < C_; ++r) {
      const float fr = __expf(r_m[r * MAXG + g] - M);
      L += r_l[r * MAXG + g] * fr;
      A += r_acc[r * chunk + k - rank * chunk] * fr;
    }
    p.out[(bh * G + g) * DH + d] = A / L;
  }
}

// Lets the instance take `smem` bytes of dynamic shared memory on the
// current device. The attribute is kept per instance and device, and only
// ever raised: a launch and the occupancy query both come through here, so
// a query at a short cache never lowers what a launch at a long one set.
template <int DH, bool INT4>
cudaError_t allow_smem(int smem) {
  static std::mutex lock;
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> held(lock);
  if (smem <= allowed[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(kvq_decode_kernel<DH, INT4>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess) allowed[dev] = smem;
  return rc;
}

template <int DH, bool INT4>
cudaError_t launch(const Params& p, int smem, cudaStream_t stream) {
  const cudaError_t rc = allow_smem<DH, INT4>(smem);
  if (rc != cudaSuccess) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.KV, p.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kvq_decode_kernel<DH, INT4>, p);
}

template <int DH, bool INT4>
int active_clusters(int smem, int cluster) {
  if (allow_smem<DH, INT4>(smem) != cudaSuccess) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kvq_decode_kernel<DH, INT4>, &cfg) == cudaSuccess ? n : 0;
}

}  // namespace

// Dynamic shared memory of one block (0 for what the kernel does not take).
extern "C" int kvq_smem_bytes(int Dh, int int4, int T) {
  if ((Dh != 64 && Dh != 128) || T < 1) return 0;
  return smem_bytes(int4 ? Dh / 2 : Dh, int4 ? 2 : 1, T);
}

// Clusters of `cluster` blocks that can be resident at once (occupancy
// query; 0 when the launch could not run).
extern "C" int kvq_max_active_clusters(int Dh, int int4, int T, int cluster) {
  const int smem = kvq_smem_bytes(Dh, int4, T);
  if (!smem || cluster < 1 || cluster > MAX_CLUSTER) return 0;
  if (Dh == 128) return int4 ? active_clusters<128, true>(smem, cluster)
                             : active_clusters<128, false>(smem, cluster);
  return int4 ? active_clusters<64, true>(smem, cluster) : active_clusters<64, false>(smem, cluster);
}

extern "C" int kvq_decode_bf16(const void* q, const void* kp, const void* ks,
                               const void* vp, const void* vs, const void* kn,
                               const void* vn, const void* mask, void* out,
                               int B, int KV, int G, int T, int Dh, int int4, int cluster,
                               float scale, cudaStream_t stream) {
  if (G < 1 || G > MAXG || (Dh != 64 && Dh != 128) || T < 1 || B < 1 || KV < 1 ||
      cluster < 1 || cluster > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  const int smem = kvq_smem_bytes(Dh, int4, T);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kp = static_cast<const int8_t*>(kp);
  p.ks = static_cast<const float*>(ks);
  p.vp = static_cast<const int8_t*>(vp);
  p.vs = static_cast<const float*>(vs);
  p.kn = static_cast<const __nv_bfloat16*>(kn);
  p.vn = static_cast<const __nv_bfloat16*>(vn);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.T = T;
  p.cluster = cluster;
  p.scale = scale;
  cudaError_t rc;
  if (Dh == 128) rc = int4 ? launch<128, true>(p, smem, stream) : launch<128, false>(p, smem, stream);
  else rc = int4 ? launch<64, true>(p, smem, stream) : launch<64, false>(p, smem, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
