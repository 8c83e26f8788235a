// Block-table paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py:_paged_attend_kernel,
// reached through _paged_attend_grouped by both serving entries:
//   * ragged_attend (G = 1): flat token t is a group of one query;
//   * verify_attend (G = draft_k + 1 <= 8): slot n's speculative verify
//     window, K consecutive queries that share one block-table walk;
// over float pools, or over quantized pools (the kernel's quantized
// branch): int8 or fp8 e4m3 payloads with one fp32 scale per (pool
// entry, head), dequantized at load as k.f32 * k_scale.
//
// Group n's queries attend the keys of slot max(slot_ids[n], 0) (a
// padding group of slot -1 clamps to slot 0, as the Pallas pool_map
// does) found through block_tables[slot, pos / BS]; query j sees the
// keys at positions <= positions[n, j]. The walk ends at the TRUE
// maximum of the group's positions, not at its last query: the verify
// region pads short groups with position 0, so a group can read
// [p, p + 1, 0, 0]. The scaled query is rounded to its own dtype as
// the Pallas wrapper does; logits, the online softmax (running max,
// denominator, weighted sum, the running max starting at the Pallas
// kernel's finite mask value) and the PV product are fp32; the output
// takes q's dtype. Pages past the walk are never read.
//
// What bounds it: device memory. A walk reads (max pos + 1) K and V
// rows of H x Dh elements (and, quantized, their fp32 scales) and does
// 4 Dh G flops per row and head: a few flops a byte, far below the
// ~295 the tensor cores need. Decode and verify walks are long (up to
// the whole context) and few (8 slots at the serving shapes), so what
// holds a kernel is how many bytes it keeps in flight, and whether the
// longest walk is the serial path of one SM. A prefill chunk is many
// queries of one slot: walked a query at a time, it reads its slot's
// pages once per query (Σ (pos + 1) rows, 17x the bytes it needs at
// the serving step's shape). Two kernels:
//
// paged_attend_kernel (fp32 pools, and fp32 queries over 16-bit pools,
// on both entries): one block of 4 warps per (group, head); the warps
// take the walk's pages in turn (warp w reads pages w, w+4, ...), each
// keeping its own online-softmax state, and merge the four states in
// shared memory at the end. Each lane holds Dh/32 elements of every
// query of the group and of its accumulator in registers; a K or V row
// of one head is one coalesced warp load; keys are taken CHUNK at a
// time (8 for up to 4 queries, 4 for up to 8) with unconditional loads,
// so 2 * CHUNK row loads are in flight before the first dot product
// needs one.
//
// verify_walk_kernel (16-bit pools with queries of their type, and
// int8 / fp8 pools with any float queries, on both entries): a
// split-page walk of whole pages across heads, over groups of queries
// from one of two sources:
//   * the verify entry (kRagged false, G >= 2): group n is the [G]
//     queries of q[n], walked to the maximum of positions[n];
//   * the ragged entry (kRagged true; also verify calls of G = 1):
//     groups are found on the device, the maximal runs of consecutive
//     flat tokens whose slot is the same (clamped as above), cut every
//     kRows = 16 tokens (mma.sync's rows), so a prefill chunk reads a
//     page once per 16 queries. Each row keeps its own position for the
//     mask; the group's walk ends at the true maximum of its rows'
//     positions (any order, any slot layout is right; pack_step's —
//     decodes, then chunks in ascending positions, then padding —
//     is what makes the runs long).
//   * Work items: (group, head block, range of key tiles). A key tile
//     is KT = gcd(BS, 16) consecutive entries of one page; a head block
//     is 16 heads at Dh = 64, 8 at Dh = 128 (a tile of K and V is then
//     64 KB in 16 bits, 33 KB quantized). Verify: each group's walk of
//     last / KT + 1 tiles is cut into R equal ranges (ops/
//     paged_attention.py:verify_plan, R = SMs / (groups x head blocks)),
//     so the longest walk is spread over R blocks instead of being one
//     block's serial path. (Ranges in proportion to each walk's length,
//     planned in every block from all groups' positions, gave items of at
//     most 3 tiles instead of 4 at verify_case's shape, and read 4-13%
//     slower on an H100, in calls where the parent's kernel read the same:
//     the plan's extra round trip and longer merges cost more than the
//     shorter items saved.) Ragged: walks differ by 64x (a 1024-key
//     decode, a padding group's one tile), so every block plans from
//     the tokens' slots and positions (build_plan: neighbour compares
//     and block scans in shared memory, no host read): each item takes
//     at most W tiles, the fewest that keep the items within one an SM
//     (a second wave of short items cost more than longer items), a
//     group ceil(tiles / W) ranges of its walk; a unit of one range
//     writes its output in place and skips the combine. (A pre-pass
//     launch that planned once for the walk to copy read 3.4-4.5 µs
//     slower on an H100.)
//   * Loads: a producer warp reads the item's block-table entries into
//     registers (32 pages a load, the next 32 prefetched), then keeps a
//     ring of tiles in flight (verify 3 stages, 5 quantized; ragged 2),
//     each pool entry's
//     heads of the block one bulk copy (cp.async.bulk: 2 KB of [H, Dh]
//     in bf16) into a row padded by 16 bytes, so the rows of 8 keys fall
//     on 8 bank groups; quantized tiles bring their [KT, heads] fp32
//     scales by cp.async. No global load the producer makes depends on
//     another inside the ring's loop.
//   * Arithmetic on the tensor cores, a warp a head (mma.sync m16n8k16,
//     fp32 sums): S = q K^T with the group's queries as the rows (G <= 8
//     of 16; a ragged group all 16) and 16 keys as the columns, K by
//     ldmatrix; the online
//     softmax in fp32 on the S fragments (a row's 16 keys lie in 4
//     lanes); then O += P V with P's fragments taken from S's, V by
//     ldmatrix.trans. int8 / e4m3 K and V are converted exactly to the
//     product type in registers, value by value (one 16-byte load of a
//     key row a lane, the fragments' columns permuted so a lane's dims
//     are consecutive, measured ~9% slower on an H100), and their fp32
//     scales multiply the fp32 dot product and p. Rounding stays where
//     the CUDA-core version has it: the scaled
//     query is rounded to its dtype (fp32 queries are split into three
//     bf16 parts, exact), and p (times v's scale) is split into a hi and
//     a lo part of the product type (three for fp32 queries), so P V
//     keeps ~16 significant bits of p where one part would keep 8.
//   * Combine: each item stores its (m, l, acc) per (query, head) in
//     fp32; after a grid-wide sync (a cooperative launch, at most one
//     block an SM) the (group, head) units are merged: the items of a
//     unit in range order, each rescaled to the largest max, as the
//     warp merge above does; verify units a block each, their states
//     staged in shared memory so that every thread's loads are in
//     flight together; ragged units a warp for each 2 rows at Dh 64 (1
//     at 128), dealt to the blocks first. An item
//     that holds no key of a query adds weight 0 (its max stays at the
//     mask value). Two launches give the same bits.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/paged_attention.py), launched on the caller's
// stream, allocating nothing (the wrapper passes the walk's scratch).

#include <cooperative_groups.h>
#include <cuda_fp8.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;   // warps per (group, head), one thread block
// the Pallas kernel's finite mask value: the running max starts here
constexpr float kMaskValue = -0.7f * 3.40282347e38f / 1e6f;

// one fp8 e4m3 value as stored (torch.float8_e4m3fn bytes)
struct fp8e4m3 {
  unsigned char bits;
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(signed char x) { return (float)x; }
__device__ __forceinline__ float to_float(fp8e4m3 x) {
  // every e4m3 value is exact in fp16
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(x.bits), __NV_E4M3);
  return __half2float(__half(h));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// GMAX: the register footprint, a static bound on the group size G
// (queries g >= G hold zeros and position -1, so every key is masked
// for them, and are never written)
template <typename TQ, typename TKV, int HEAD_DIM, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
paged_attend_kernel(const TQ* __restrict__ q,          // [N, G, H, Dh]
                    const TKV* __restrict__ k_pool,    // [NB, BS, H, Dh]
                    const TKV* __restrict__ v_pool,    // [NB, BS, H, Dh]
                    const int* __restrict__ block_tables,  // [S, MB]
                    const int* __restrict__ slot_ids,      // [N]
                    const int* __restrict__ positions,     // [N, G]
                    TQ* __restrict__ out,              // [N, G, H, Dh]
                    int N, int G, int H, int BS, int S, int MB,
                    float scale) {
  constexpr int EPL = HEAD_DIM / 32;           // elements per lane
  constexpr int CHUNK = GMAX <= 4 ? 8 : 4;     // keys per inner step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = (int)(blockIdx.x / H);   // the block's (group, head)
  const int h = (int)(blockIdx.x % H);
  int slot = slot_ids[n];
  slot = slot < 0 ? 0 : (slot >= S ? S - 1 : slot);  // padding -> slot 0
  int qpos[GMAX];
  int last = 0;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    qpos[g] = g < G ? positions[(long long)n * G + g] : -1;
    last = max(last, qpos[g]);
  }
  last = min(last, MB * BS - 1);                  // newest key any query sees
  const int* row = block_tables + (long long)slot * MB;
  const long long entry_stride = (long long)H * HEAD_DIM;

  float qv[GMAX][EPL], acc[GMAX][EPL], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      const long long qo =
          (((long long)n * G + g) * H + h) * HEAD_DIM + lane * EPL;
      const Vec<TQ, EPL> x = *reinterpret_cast<const Vec<TQ, EPL>*>(q + qo);
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        qv[g][i] = to_float(from_float<TQ>(to_float(x.v[i]) * scale));
    } else {
#pragma unroll
      for (int i = 0; i < EPL; ++i) qv[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
    m[g] = kMaskValue;
    l[g] = 0.f;
  }

  // the block's warps take the walk's pages in turn: warp w reads pages
  // w, w + kWarps, ... and keeps its own softmax state
  for (int b = warp; b * BS <= last; b += kWarps) {
    const long long entry0 = (long long)row[b] * BS;  // block's first entry
    const int n_keys = min(BS, last - b * BS + 1);   // keys of block b read
    for (int j0 = 0; j0 < n_keys; j0 += CHUNK) {
      // every load is unconditional — a key past the block's last read
      // key re-reads that key, and the masks below drop it — so all
      // 2 * CHUNK row loads are issued before the first is used (a
      // branch around each load pair serialises them)
      Vec<TKV, EPL> kx[CHUNK], vx[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const long long e = entry0 + min(j0 + j, n_keys - 1);
        const long long off =
            e * entry_stride + (long long)h * HEAD_DIM + lane * EPL;
        kx[j] = *reinterpret_cast<const Vec<TKV, EPL>*>(k_pool + off);
        vx[j] = *reinterpret_cast<const Vec<TKV, EPL>*>(v_pool + off);
      }
      float kf[CHUNK][EPL], vf[CHUNK][EPL], s[GMAX][CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          kf[j][i] = to_float(kx[j].v[i]);
          vf[j][i] = to_float(vx[j].v[i]);
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) d = fmaf(qv[g][i], kf[j][i], d);
          s[g][j] = d;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
#pragma unroll
          for (int j = 0; j < CHUNK; ++j)
            s[g][j] += __shfl_xor_sync(0xffffffffu, s[g][j], o);
        }
      }
      const int key0 = b * BS + j0;  // position of the chunk's first key
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        // key j is visible to query g when it was read and is not past
        // the query's own position
        const int n_vis = min(n_keys - j0, qpos[g] - key0 + 1);
        float mc = kMaskValue;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
          if (j < n_vis) mc = fmaxf(mc, s[g][j]);
        const float m_new = fmaxf(m[g], mc);
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float p = j < n_vis ? expf(s[g][j] - m_new) : 0.f;
          psum += p;
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(p, vf[j][i], acc[g][i]);
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
    }
  }

  // merge the warps' states: rescale each to the largest running max
  __shared__ float sm_m[kWarps][GMAX], sm_l[kWarps][GMAX];
  __shared__ float sm_acc[kWarps][GMAX][HEAD_DIM];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {  // one query per warp in turn
    float mx = kMaskValue;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, sm_m[v][g]);
    float denom = 0.f, o[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float c = expf(sm_m[v][g] - mx);
      denom = fmaf(c, sm_l[v][g], denom);
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        o[i] = fmaf(c, sm_acc[v][g][lane * EPL + i], o[i]);
    }
    denom = fmaxf(denom, 1e-30f);
    Vec<TQ, EPL> r;
#pragma unroll
    for (int i = 0; i < EPL; ++i) r.v[i] = from_float<TQ>(o[i] / denom);
    const long long qo =
        (((long long)n * G + g) * H + h) * HEAD_DIM + lane * EPL;
    *reinterpret_cast<Vec<TQ, EPL>*>(out + qo) = r;
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* slot_ids;
  const int* positions;
  void* out;
  int N, G, H, BS, S, MB;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HEAD_DIM, int GMAX>
cudaError_t launch_shape(const Args& a) {
  const dim3 grid((unsigned)((long long)a.N * a.H));  // one per (group, head)
  const dim3 block(kWarps * 32);
  paged_attend_kernel<TQ, TKV, HEAD_DIM, GMAX><<<grid, block, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), a.block_tables, a.slot_ids,
      a.positions, static_cast<TQ*>(a.out), a.N,
      a.G, a.H, a.BS, a.S, a.MB, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HEAD_DIM>
cudaError_t launch_group(const Args& a) {
  if (a.G == 1) return launch_shape<TQ, TKV, HEAD_DIM, 1>(a);
  if (a.G <= 4) return launch_shape<TQ, TKV, HEAD_DIM, 4>(a);
  if (a.G <= 8) return launch_shape<TQ, TKV, HEAD_DIM, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch(int head_dim, const Args& a) {
  switch (head_dim) {
    case 64: return launch_group<TQ, TKV, 64>(a);
    case 128: return launch_group<TQ, TKV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------- the walk

namespace vw {

using namespace hopper;

constexpr int kKT = 16;               // keys a tile, at most
constexpr int kRingBudget = 204800;   // shared-memory bytes of the ring
constexpr int kMaxStages = 6;         // tiles in it, at most
// tiles in the ring of the ragged walk, at most: 2 read 3-5% faster
// than 3 or 6 on an H100 (17 MB in flight over the card already), and
// its combine stages nothing in the ring
constexpr int kRaggedStages = 2;
constexpr int kRows = 16;             // rows of a ragged group (mma's m16)
constexpr int kMaxTokens = 1024;      // flat tokens a ragged launch plans

// The tensor-core type of the products: fp16 under fp16 queries, else
// bf16 (fp32 queries are split into three bf16 parts).
template <typename TQ>
using ME = typename std::conditional<std::is_same<TQ, __half>::value, __half,
                                     __nv_bfloat16>::type;

template <typename TQ, typename TKV, int HEAD_DIM, bool kRagged = false>
struct Cfg {
  static constexpr int kHB = HEAD_DIM == 64 ? 16 : 8;  // heads a block
  static constexpr int kConsumers = kHB * 32;          // a warp a head
  static constexpr int kThreads = kConsumers + 32;     // and a producer warp
  static constexpr bool kQuant = sizeof(TKV) == 1;
  // parts of q and of p in the tensor-core type: fp32 queries three
  // (exact), p two (hi + lo: ~16 significant bits) or three
  static constexpr int kQParts = std::is_same<TQ, float>::value ? 3 : 1;
  static constexpr int kPParts = std::is_same<TQ, float>::value ? 3 : 2;
  // a pool entry's heads of the block, padded by 16 bytes so that the 8
  // keys an ldmatrix reads fall on 8 different bank groups
  static constexpr int kRowBytes = kHB * HEAD_DIM * (int)sizeof(TKV) + 16;
  static constexpr int kTileBytes = kKT * kRowBytes;   // K or V of a tile
  static constexpr int kScales = kKT * kHB;            // fp32 a pool a tile
  static constexpr int kStageBytes =
      2 * kTileBytes + (kQuant ? 2 * kScales * 4 : 0);
  static constexpr int kMost = kRagged ? kRaggedStages : kMaxStages;
  static constexpr int kStages =
      kRingBudget / kStageBytes < kMost ? kRingBudget / kStageBytes : kMost;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kSmem = 128 + kRing + 2 * kStages * 8;
};

__device__ __forceinline__ int walk_last(const int* positions, int n, int G,
                                         int MB, int BS) {
  int last = 0;
  for (int g = 0; g < G; ++g)
    last = max(last, positions[(long long)n * G + g]);
  return min(last, MB * BS - 1);
}

// Item `item` = (group n, head block hbk, range r of R): its walk's slot,
// its newest key `last` (the true maximum of the group's positions,
// inside the table), and its key tiles [t0, t1) of the walk's tn.
struct Walk {
  int n, hbk, slot, last, t0, t1;
};
__device__ __forceinline__ Walk walk_of(int item, const int* positions,
                                        const int* slot_ids, int G, int S,
                                        int MB, int BS, int KT, int hblk,
                                        int R) {
  Walk w;
  w.n = item / (hblk * R);
  w.hbk = item / R % hblk;
  const int r = item % R;
  int slot = slot_ids[w.n];
  w.slot = slot < 0 ? 0 : (slot >= S ? S - 1 : slot);  // padding -> slot 0
  w.last = walk_last(positions, w.n, G, MB, BS);
  const long long tn = w.last / KT + 1;
  w.t0 = (int)(r * tn / R);
  w.t1 = (int)((r + 1) * tn / R);
  return w;
}

// ------------------------------------------------------ the ragged plan

// The plan of T flat tokens, in ints: a header (groups, W, items, state
// slots), then for each group its first token, newest key, slot, first
// item and first state slot, T + 1 entries each (start[groups] = T,
// item[groups] = items).
__host__ __device__ constexpr int plan_ints(int T) { return 8 + 5 * (T + 1); }
// The plan, the tokens' slots and positions, and a block scan's totals.
__host__ __device__ constexpr int plan_smem(int T) {
  return 4 * ((plan_ints(T) + 2 * T + 1) & ~1) + 32 * 8;
}

struct Plan {
  int* p;
  int T;
  __device__ int groups() const { return p[0]; }
  __device__ int items() const { return p[2]; }
  __device__ int* start() const { return p + 8; }
  __device__ int* last() const { return p + 8 + (T + 1); }
  __device__ int* slot() const { return p + 8 + 2 * (T + 1); }
  __device__ int* item() const { return p + 8 + 3 * (T + 1); }
  __device__ int* sslot() const { return p + 8 + 4 * (T + 1); }
};

// The exclusive scan, over the block's threads in thread order, of v
// (kMax: the running maximum from `lo`; else the sum from 0), and the
// whole in `total`; `buf`: 32 values of shared memory. Every thread of
// the block calls it (blockDim.x a multiple of 32).
template <bool kMax, typename V>
__device__ __forceinline__ V block_scan(V v, V lo, V* buf, V& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  V x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = kMax ? (y > x ? y : x) : x + y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    V w = lane < nw ? buf[lane] : (kMax ? lo : V(0));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = kMax ? (y > w ? y : w) : w + y;
    }
    buf[lane] = w;  // through warp `lane`
  }
  __syncthreads();
  V ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = kMax ? lo : V(0);
  if (warp > 0) {
    const V b = buf[warp - 1];
    ex = kMax ? (b > ex ? b : ex) : ex + b;
  }
  total = buf[nw - 1];
  __syncthreads();  // buf is free again
  return ex;
}

// A group's items and state slots, packed as (items << 32) | slots: n
// ranges a head block, state slots only for units of several ranges.
__device__ __forceinline__ unsigned long long plan_count(int n, int hblk) {
  return ((unsigned long long)(hblk * n) << 32) |
         (unsigned)(n > 1 ? hblk * n : 0);
}

// The ragged plan of T flat tokens into `pl` in shared memory, built by
// every thread of the block, at most PER tokens a thread.
// Groups: the maximal runs of consecutive tokens of the same slot (slot
// -1 clamped to 0, past S to S - 1, as the walk reads them), cut every
// kRows tokens. Group g's walk has last / KT + 1 key tiles, `last` the
// maximum of its rows' positions clamped into [0, last_key]. With W =
// the fewest tiles an item at least W0 = max(wmin, ceil(hblk x all
// tiles / target)) whose items number at most `target`, a group has n
// = ceil(tiles / W) ranges a head block, hblk x n items, and as many
// state slots when n > 1. Items a group take (head block, range) in
// that order, as do its slots; so the slots number fewer than 2 x
// target (a group of n > 1 has tiles > W >= W0, so n < 2 tiles / W).
// `cs`, `ps`: T ints of shared memory each; `buf`: 32 of 8 bytes.
template <int PER>
__device__ void build_plan(const int* __restrict__ slot_ids,
                           const int* __restrict__ positions, int T, int S,
                           int last_key, int KT, int hblk, int target,
                           int wmin, int* cs, int* ps,
                           unsigned long long* buf, Plan pl) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < T; i += nt) {
    const int s = slot_ids[i];
    cs[i] = s < 0 ? 0 : (s >= S ? S - 1 : s);
    ps[i] = positions[i];
  }
  __syncthreads();
  const int per = (T + nt - 1) / nt, i0 = tid * per;  // this thread's tokens
  int* ibuf = reinterpret_cast<int*>(buf);
  // the newest run start at or before each token
  int rs[PER], run = -1, unused;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = i0 + k;
    if (k < per && i < T && (i == 0 || cs[i] != cs[i - 1])) run = i;
    rs[k] = run;
  }
  const int before = block_scan<true>(run, -1, ibuf, unused);
  // group starts: a run's every kRows-th token
  bool first[PER];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = i0 + k;
    first[k] = k < per && i < T && (i - max(rs[k], before)) % kRows == 0;
    mine += first[k];
  }
  int groups;
  int g = block_scan<false>(mine, 0, ibuf, groups);
  // each group's newest key (its rows in any order) and its tiles
  int last[PER], tiles = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    last[k] = 0;
    if (first[k]) {
      const int i = i0 + k;
      int top = ps[i];
      for (int r = 1; r < kRows && i + r < T && cs[i + r] == cs[i]; ++r)
        top = max(top, ps[i + r]);
      last[k] = min(max(top, 0), last_key);
      tiles += last[k] / KT + 1;
    }
  }
  int all;
  block_scan<false>(tiles, 0, ibuf, all);
  // W: the fewest tiles an item, from W0 up, whose items fit `target` (a
  // second wave of items costs more than longer items), found by
  // bisection: W1 fits when target > hblk x groups (each group's ceil
  // adds at most one item a head block), else no W fits and W ends at
  // `all`, a group an item.
  const long long ht = (long long)hblk * all;
  int lo = max(wmin, (int)((ht + target - 1) / target));
  const long long room = target - (long long)hblk * groups;
  int hi = max(lo, room > 0 ? (int)((ht + room - 1) / room) : all);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int n = 0, fit;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (first[k]) n += (last[k] / KT + mid) / mid;
    block_scan<false>(hblk * n, 0, ibuf, fit);
    if (fit <= target) hi = mid;
    else lo = mid + 1;
  }
  const int W = lo;
  unsigned long long counts = 0, sum;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (first[k]) counts += plan_count((last[k] / KT + W) / W, hblk);
  unsigned long long at = block_scan<false>(counts, 0ull, buf, sum);
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (first[k]) {
      const int i = i0 + k;
      pl.start()[g] = i;
      pl.last()[g] = last[k];
      pl.slot()[g] = cs[i];
      pl.item()[g] = (int)(at >> 32);
      pl.sslot()[g] = (int)(at & 0xffffffffu);
      at += plan_count((last[k] / KT + W) / W, hblk);
      ++g;
    }
  if (tid == 0) {
    pl.p[0] = groups;
    pl.p[1] = W;
    pl.p[2] = (int)(sum >> 32);
    pl.p[3] = (int)(sum & 0xffffffffu);
    pl.start()[groups] = T;
    pl.item()[groups] = (int)(sum >> 32);
  }
}

// What a launch walks besides its operands: the verify entry's R ranges a
// walk; the ragged entry's wmin and target (build_plan) and its state's
// capacity in slots of kRows rows.
struct WalkArgs {
  int R, wmin, target, slots;
};

// An item's work: rows row0 .. row0 + rows - 1 of the flat queries (its
// group), head block hbk, the walk's slot and newest key, key tiles
// [t0, t1); its state at slot sbase, or (`direct`: the unit's one item)
// its output written in place.
struct Item {
  int row0, rows, hbk, slot, last, t0, t1, sbase;
  bool direct;
};

template <bool kRagged>
__device__ __forceinline__ Item item_of(int item, const Plan& pl,
                                        const int* positions,
                                        const int* slot_ids, int G, int S,
                                        int MB, int BS, int KT, int hblk,
                                        int R) {
  Item it;
  if constexpr (kRagged) {
    const int* first = pl.item();
    int lo = 0, hi = pl.groups() - 1;  // the group: the last starting <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= item) lo = mid;
      else hi = mid - 1;
    }
    const int n = (first[lo + 1] - first[lo]) / hblk;  // ranges a head block
    const int k = item - first[lo], c = k % n;
    it.row0 = pl.start()[lo];
    it.rows = pl.start()[lo + 1] - it.row0;
    it.hbk = k / n;
    it.slot = pl.slot()[lo];
    it.last = pl.last()[lo];
    const long long tn = it.last / KT + 1;
    it.t0 = (int)(c * tn / n);
    it.t1 = (int)((c + 1) * tn / n);
    it.sbase = pl.sslot()[lo] + k;
    it.direct = n == 1;
  } else {
    const Walk w =
        walk_of(item, positions, slot_ids, G, S, MB, BS, KT, hblk, R);
    it.row0 = w.n * G;
    it.rows = G;
    it.hbk = w.hbk;
    it.slot = w.slot;
    it.last = w.last;
    it.t0 = w.t0;
    it.t1 = w.t1;
    it.sbase = item;
    it.direct = false;
  }
  return it;
}

// ----------------------------------------------- tensor-core fragments

template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x split into P parts of the tensor-core type T, part i holding what
// the parts before it left: parts[0] + parts[1] + ... ~ x.
template <typename T, int P>
__device__ __forceinline__ void split(float x, float (&parts)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    parts[i] = to_float(from_float<T>(x));
    x -= parts[i];
  }
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), fp32 sums
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

template <int N>
__device__ __forceinline__ void bar_sync1() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// Two 1-byte pool values as a pair of the tensor-core type T (exact:
// int8 and e4m3 values are exact in bf16 and fp16).
template <typename T, typename TKV>
__device__ __forceinline__ uint32_t pair(TKV a, TKV b) {
  return pack2<T>(to_float(a), to_float(b));
}

// A pair's halves kept where `lo` / `hi` hold (masked keys read zeros,
// whatever the shared memory held).
__device__ __forceinline__ uint32_t keep(uint32_t v, bool lo, bool hi) {
  return v & ((lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u));
}

// state: acc [slots][RS][kHB][HEAD_DIM], then m and l [slots][RS][kHB],
// fp32: verify a slot an item (slots = items, RS = G), ragged a slot an
// item of a unit of several (slots = wa.slots, RS = kRows). Grid:
// `gridDim.x` persistent blocks (cooperative). Ragged: q [T, H, Dh],
// positions [T], N = T <= kMaxTokens, G = 1, and the plan after the
// barriers in shared memory.
template <typename TQ, typename TKV, int HEAD_DIM, bool kRagged>
__global__ void __launch_bounds__(Cfg<TQ, TKV, HEAD_DIM>::kThreads, 1)
verify_walk_kernel(const TQ* __restrict__ q,            // [N, G, H, Dh]
                   const TKV* __restrict__ k_pool,      // [NB, BS, H, Dh]
                   const TKV* __restrict__ v_pool,
                   const float* __restrict__ k_scale,   // [NB, BS, H]
                   const float* __restrict__ v_scale,
                   const int* __restrict__ block_tables,  // [S, MB]
                   const int* __restrict__ slot_ids,      // [N]
                   const int* __restrict__ positions,     // [N, G]
                   TQ* __restrict__ out,                  // [N, G, H, Dh]
                   float* __restrict__ state, int N, int G, int H, int BS,
                   int S, int MB, float scale, WalkArgs wa) {
  using C = Cfg<TQ, TKV, HEAD_DIM, kRagged>;
  using T = ME<TQ>;
  constexpr int QP = C::kQParts, PP = C::kPParts;
  constexpr int KS = HEAD_DIM / 16;  // k16 steps of q . k
  constexpr int ND = HEAD_DIM / 8;   // n8 tiles of p . v
  constexpr int RH = kRagged ? 2 : 1;  // fragment rows in use: g (g + 8)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRing);
  uint64_t* empty = full + C::kStages;
  const int KT = BS % 16 == 0 ? 16 : BS % 8 == 0 ? 8 : BS % 4 == 0 ? 4
               : BS % 2 == 0 ? 2 : 1;  // gcd(BS, 16)
  const int hblk = (H + C::kHB - 1) / C::kHB;
  const Plan pl{reinterpret_cast<int*>(empty + C::kStages), N};
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], C::kQuant ? 33 : 1);
      mbar_init(&empty[i], C::kConsumers);
    }
    mbar_init_fence();
  }
  if constexpr (kRagged) {
    int* cs = pl.p + plan_ints(N);
    build_plan<(kMaxTokens + C::kThreads - 1) / C::kThreads>(
        slot_ids, positions, N, S, MB * BS - 1, KT, hblk, wa.target, wa.wmin,
        cs, cs + N,
        reinterpret_cast<unsigned long long*>(
            pl.p + ((plan_ints(N) + 2 * N + 1) & ~1)),
        pl);
  }
  __syncthreads();
  const int items = kRagged ? pl.items() : N * hblk * wa.R;
  const int RS = kRagged ? kRows : G;  // state rows a slot
  const long long slots = kRagged ? wa.slots : items;
  float* st_acc = state;
  float* st_m = state + slots * RS * C::kHB * HEAD_DIM;
  float* st_l = st_m + slots * RS * C::kHB;

  if (threadIdx.x >= C::kConsumers) {
    // ------------------------------------------------ producer warp
    const int lane = threadIdx.x & 31;
    long long it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item w = item_of<kRagged>(item, pl, positions, slot_ids, G, S,
                                      MB, BS, KT, hblk, wa.R);
      if (w.t0 >= w.t1) continue;
      const int* row = block_tables + (long long)w.slot * MB;
      const int p_last = (w.t1 - 1) * KT / BS;
      int base = w.t0 * KT / BS;
      // this lane's page entries: page base + lane, and 32 pages on
      int cur = base + lane <= p_last ? row[base + lane] : 0;
      int nxt = base + 32 + lane <= p_last ? row[base + 32 + lane] : 0;
      const int h0 = w.hbk * C::kHB, hb = min(C::kHB, H - h0);
      const uint32_t entry_bytes = hb * HEAD_DIM * (int)sizeof(TKV);
      for (int t = w.t0; t < w.t1; ++t, ++it) {
        const int p = t * KT / BS;
        if (p - base >= 32) {
          base += 32;
          cur = nxt;
          nxt = base + 32 + lane <= p_last ? row[base + 32 + lane] : 0;
        }
        const int blk = __shfl_sync(0xffffffffu, cur, p - base);
        const long long e0 = (long long)blk * BS + (t * KT - p * BS);
        const int stage = (int)(it % C::kStages);
        mbar_wait(&empty[stage], (int)((it / C::kStages) & 1) ^ 1);
        unsigned char* st = ring + stage * C::kStageBytes;
        if (lane == 0) mbar_arrive_tx(&full[stage], 2 * KT * entry_bytes);
        __syncwarp();
        if (lane % 16 < KT) {  // lanes 0.. K's entries, 16.. V's
          const int which = lane / 16, e = lane % 16;
          bulk_load(st + which * C::kTileBytes + e * C::kRowBytes,
                    (which ? v_pool : k_pool) +
                        ((e0 + e) * H + h0) * HEAD_DIM,
                    entry_bytes, &full[stage]);
        }
        if constexpr (C::kQuant) {
          float* sd = reinterpret_cast<float*>(st + 2 * C::kTileBytes);
          for (int i = lane; i < 2 * KT * hb; i += 32) {
            const int which = i / (KT * hb), j = i % (KT * hb);
            cp_async_4(sd + which * C::kScales + j,
                       (which ? v_scale : k_scale) + (e0 + j / hb) * H + h0 +
                           j % hb,
                       true);
          }
          mbar_arrive_cp_async(&full[stage]);
        }
      }
    }
  } else {
    // ------------------------------------------ consumers: a warp a head
    const int hh = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
    long long it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item w = item_of<kRagged>(item, pl, positions, slot_ids, G, S,
                                      MB, BS, KT, hblk, wa.R);
      if (w.t0 >= w.t1) continue;
      const int h0 = w.hbk * C::kHB, hb = min(C::kHB, H - h0);
      const int hc = min(hh, hb - 1);  // warps past the heads read one
      // rows g and (ragged) g + 8 of the group (rows past it, and a
      // verify group's rows 8.., are zeros): q scaled and rounded to its
      // dtype, as A fragments in QP parts
      int qpos[RH];
#pragma unroll
      for (int rh = 0; rh < RH; ++rh)
        qpos[rh] = g + 8 * rh < w.rows ? positions[w.row0 + g + 8 * rh] : -1;
      uint32_t qa[QP][KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            float x0 = 0.f, x1 = 0.f;
            if (rh < RH && g + 8 * rh < w.rows) {
              const TQ* src =
                  q + ((long long)(w.row0 + g + 8 * rh) * H + h0 + hc) *
                          HEAD_DIM + ks * 16 + 8 * hf + 2 * tq;
              x0 = to_float(from_float<TQ>(to_float(src[0]) * scale));
              x1 = to_float(from_float<TQ>(to_float(src[1]) * scale));
            }
            float p0[QP], p1[QP];
            split<T, QP>(x0, p0);
            split<T, QP>(x1, p1);
#pragma unroll
            for (int i = 0; i < QP; ++i)
              qa[i][ks][2 * hf + rh] = pack2<T>(p0[i], p1[i]);
          }
      float o[ND][4], m[RH], lsum[RH];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
#pragma unroll
      for (int rh = 0; rh < RH; ++rh) {
        m[rh] = kMaskValue;
        lsum[rh] = 0.f;
      }
      for (int t = w.t0; t < w.t1; ++t, ++it) {
        const int stage = (int)(it % C::kStages);
        mbar_wait(&full[stage], (int)((it / C::kStages) & 1));
        const unsigned char* kt = ring + stage * C::kStageBytes;
        const unsigned char* vt = kt + C::kTileBytes;
        const float* ksc =
            reinterpret_cast<const float*>(kt + 2 * C::kTileBytes);
        const float* vsc = ksc + C::kScales;
        const int hoff = hc * HEAD_DIM * (int)sizeof(TKV);
        // s[nt][2 rh + e]: row g + 8 rh, key 8 nt + 2 tq + e
        float s[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];  // (nt 0: b0, b1), (nt 1: b0, b1)
          if constexpr (C::kQuant) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const TKV* pk = reinterpret_cast<const TKV*>(
                    kt + (8 * nt + g) * C::kRowBytes + hoff) +
                    ks * 16 + 8 * hf + 2 * tq;
                b[2 * nt + hf] = pair<T>(pk[0], pk[1]);
              }
          } else {
            ldsm_x4(b, kt + ((lane & 7) + 8 * (lane >> 4)) * C::kRowBytes +
                           hoff + (ks * 16 + 8 * ((lane >> 3) & 1)) * 2);
          }
#pragma unroll
          for (int i = 0; i < QP; ++i) {
            mma<T>(s[0], qa[i][ks], b[0], b[1]);
            mma<T>(s[1], qa[i][ks], b[2], b[3]);
          }
        }
        // the online softmax of each row over the tile's keys
        const int n_keys = min(KT, w.last - t * KT + 1);  // keys read
        float pv[RH][2][2];
        bool vis[RH][2][2];
#pragma unroll
        for (int rh = 0; rh < RH; ++rh) {
          float mt = kMaskValue;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = 8 * nt + 2 * tq + e;
              float& sv = s[nt][2 * rh + e];
              if constexpr (C::kQuant) sv *= ksc[key * hb + hc];
              vis[rh][nt][e] = key < n_keys && t * KT + key <= qpos[rh];
              if (vis[rh][nt][e]) mt = fmaxf(mt, sv);
            }
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float m_new = fmaxf(m[rh], mt);
          const float alpha = expf(m[rh] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pv[rh][nt][e] =
                  vis[rh][nt][e] ? expf(s[nt][2 * rh + e] - m_new) : 0.f;
              psum += pv[rh][nt][e];
            }
          psum += __shfl_xor_sync(0xffffffffu, psum, 1);
          psum += __shfl_xor_sync(0xffffffffu, psum, 2);
          lsum[rh] = lsum[rh] * alpha + psum;
          m[rh] = m_new;
#pragma unroll
          for (int nd = 0; nd < ND; ++nd) {
            o[nd][2 * rh] *= alpha;
            o[nd][2 * rh + 1] *= alpha;
          }
        }
        // p (times v's scale) as A fragments in PP parts
        uint32_t pa[PP][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            float x[2] = {0.f, 0.f};
            if (rh < RH) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                x[e] = pv[rh][nt][e];
                if constexpr (C::kQuant)  // (a key not read has no scale)
                  x[e] = vis[rh][nt][e]
                             ? x[e] * vsc[(8 * nt + 2 * tq + e) * hb + hc]
                             : 0.f;
              }
            }
            float p0[PP], p1[PP];
            split<T, PP>(x[0], p0);
            split<T, PP>(x[1], p1);
#pragma unroll
            for (int i = 0; i < PP; ++i)
              pa[i][2 * nt + rh] = pack2<T>(p0[i], p1[i]);
          }
        // o += p . v over the n8 tiles of head_dim; keys past n_keys read
        // zeros
        const bool k0 = 2 * tq < n_keys, k1 = 2 * tq + 1 < n_keys;
        const bool k8 = 2 * tq + 8 < n_keys, k9 = 2 * tq + 9 < n_keys;
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];  // (nd: b0, b1), (nd + 1: b0, b1)
          if constexpr (C::kQuant) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const TKV* pv0 = reinterpret_cast<const TKV*>(
                    vt + (2 * tq + 8 * hf) * C::kRowBytes + hoff) +
                    (nd + j) * 8 + g;
                b[2 * j + hf] = pair<T>(pv0[0], pv0[C::kRowBytes]);
              }
          } else {
            ldsm_x4_t(b, vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) *
                                  C::kRowBytes +
                             hoff + (nd * 8 + 8 * (lane >> 4)) * 2);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t b0 = keep(b[2 * j], k0, k1);
            const uint32_t b1 = keep(b[2 * j + 1], k8, k9);
#pragma unroll
            for (int i = 0; i < PP; ++i) mma<T>(o[nd + j], pa[i], b0, b1);
          }
        }
        __syncwarp();
        mbar_arrive(&empty[stage]);
      }
#pragma unroll
      for (int rh = 0; rh < RH; ++rh) {
        const int r = g + 8 * rh;
        if (hh >= hb || r >= w.rows) continue;
        if (w.direct) {  // the unit's only item: its output, in place
          const float den = fmaxf(lsum[rh], 1e-30f);
          TQ* dst = out + ((long long)(w.row0 + r) * H + h0 + hh) * HEAD_DIM +
                    2 * tq;
#pragma unroll
          for (int nd = 0; nd < ND; ++nd) {
            Vec<TQ, 2> res;
            res.v[0] = from_float<TQ>(o[nd][2 * rh] / den);
            res.v[1] = from_float<TQ>(o[nd][2 * rh + 1] / den);
            *reinterpret_cast<Vec<TQ, 2>*>(dst + nd * 8) = res;
          }
        } else {
          const long long sidx = ((long long)w.sbase * RS + r) * C::kHB + hh;
#pragma unroll
          for (int nd = 0; nd < ND; ++nd)
            *reinterpret_cast<float2*>(st_acc + sidx * HEAD_DIM + nd * 8 +
                                       2 * tq) =
                make_float2(o[nd][2 * rh], o[nd][2 * rh + 1]);
          if (tq == 0) {
            st_m[sidx] = m[rh];
            st_l[sidx] = lsum[rh];
          }
        }
      }
    }
  }

  // ----------------------------------------------------------- combine
  cooperative_groups::this_grid().sync();  // every item's state is stored
  if (threadIdx.x >= C::kConsumers) return;
  const int tid = threadIdx.x;
  constexpr int D4 = HEAD_DIM / 4;  // float4s a row
  if constexpr (kRagged) {
    // A warp a (group, head, RPW rows) of a unit of several ranges (units
    // of one wrote their output already), dealt to the blocks first so
    // that every SM has warps at work: lane (row, d4) finds its row's
    // largest max over the ranges, then sums its float4 of the row's
    // accumulators in range order, each range weighted by exp(m - max)
    // (a range that holds no key of the row adds weight 0); the ranges'
    // loads are unrolled so that several are in flight.
    constexpr int RPW = 32 / D4;  // rows a warp: 2 at Dh 64, 1 at 128
    constexpr int kU = kRows / RPW;  // warps a (group, head)
    const int lane = tid & 31;
    const int sub = lane / D4, d4 = lane % D4;
    const int subs = pl.groups() * H * kU;
    for (int u = blockIdx.x + gridDim.x * (tid >> 5); u < subs;
         u += gridDim.x * (C::kConsumers / 32)) {
      const int n = u / (H * kU), h = u / kU % H, rb = u % kU;
      const int hk = h / C::kHB, hh = h % C::kHB;
      const int R = (pl.item()[n + 1] - pl.item()[n]) / hblk;
      const int row0 = pl.start()[n], rows = pl.start()[n + 1] - row0;
      const int row = rb * RPW + sub;
      if (R == 1 || rb * RPW >= rows) continue;  // (warp-uniform)
      const long long sbase = pl.sslot()[n] + (long long)hk * R;
      const bool mine = row < rows;
      const float* sm = st_m + ((sbase * kRows + row) * C::kHB + hh);
      const float* sl = st_l + ((sbase * kRows + row) * C::kHB + hh);
      const float* sa = st_acc + ((sbase * kRows + row) * C::kHB + hh) *
                                     HEAD_DIM + 4 * d4;
      constexpr long long kStep = (long long)kRows * C::kHB;  // a range on
      float mx = kMaskValue;
      if (mine) {
#pragma unroll 8
        for (int r = 0; r < R; ++r) mx = fmaxf(mx, sm[r * kStep]);
      }
      float den = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mine) {
#pragma unroll 8
        for (int r = 0; r < R; ++r) {
          const float w = expf(sm[r * kStep] - mx);
          const float4 v =
              *reinterpret_cast<const float4*>(sa + r * kStep * HEAD_DIM);
          den = fmaf(w, sl[r * kStep], den);
          acc.x = fmaf(w, v.x, acc.x);
          acc.y = fmaf(w, v.y, acc.y);
          acc.z = fmaf(w, v.z, acc.z);
          acc.w = fmaf(w, v.w, acc.w);
        }
        den = fmaxf(den, 1e-30f);
        Vec<TQ, 4> res;
        res.v[0] = from_float<TQ>(acc.x / den);
        res.v[1] = from_float<TQ>(acc.y / den);
        res.v[2] = from_float<TQ>(acc.z / den);
        res.v[3] = from_float<TQ>(acc.w / den);
        *reinterpret_cast<Vec<TQ, 4>*>(
            out + ((long long)(row0 + row) * H + h) * HEAD_DIM + 4 * d4) = res;
      }
    }
  } else {
    // A (group, head) unit at a time, in shared memory (the ring's):
    // each item's m and l, each query's largest max and the items'
    // weights exp(m - max) (0 for an empty range), then the items'
    // accumulators kRC at a time, every thread's loads in flight
    // together; the sums over the items run in range order.
    constexpr int kRC = 16;  // items a pass of the accumulators
    const int R = wa.R;
    float* wgt = reinterpret_cast<float*>(ring);  // [R][G]: m, weights
    float* lsm = wgt + R * G;                     // [R][G]
    float* mxs = lsm + R * G;                     // [G]
    float* dens = mxs + G;                        // [G]
    float4* red = reinterpret_cast<float4*>(
        ring + ((2 * R * G + 2 * G) * 4 + 15) / 16 * 16);  // [kRC][G][D4]
    for (int u = blockIdx.x; u < N * H; u += gridDim.x) {
      const int n = u / H, h = u % H, hk = h / C::kHB, hh = h % C::kHB;
      const long long tn = walk_last(positions, n, G, MB, BS) / KT + 1;
      const long long item0 = ((long long)n * hblk + hk) * R;
      for (int i = tid; i < R * G; i += C::kConsumers) {
        const int r = i / G, g = i % G;
        const bool ok = (r + 1) * tn / R != r * tn / R;  // a range with tiles
        const long long sidx = ((item0 + r) * G + g) * C::kHB + hh;
        wgt[i] = ok ? st_m[sidx] : kMaskValue;
        lsm[i] = ok ? st_l[sidx] : 0.f;
      }
      bar_sync1<C::kConsumers>();
      if (tid < G) {
        float mx = kMaskValue;
        for (int r = 0; r < R; ++r) mx = fmaxf(mx, wgt[r * G + tid]);
        mxs[tid] = mx;
      }
      bar_sync1<C::kConsumers>();
      for (int i = tid; i < R * G; i += C::kConsumers)
        wgt[i] = expf(wgt[i] - mxs[i % G]);  // an empty range: l = acc = 0
      bar_sync1<C::kConsumers>();
      if (tid < G) {
        float den = 0.f;
        for (int r = 0; r < R; ++r)
          den = fmaf(wgt[r * G + tid], lsm[r * G + tid], den);
        dens[tid] = fmaxf(den, 1e-30f);
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // thread (g, d4)
      for (int r0 = 0; r0 < R; r0 += kRC) {
        for (int i = tid; i < kRC * G * D4; i += C::kConsumers) {
          const int rr = i / (G * D4), g = i / D4 % G, d4 = i % D4;
          const int r = r0 + rr;
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < R && (r + 1) * tn / R != r * tn / R) {
            a = *reinterpret_cast<const float4*>(
                st_acc + (((item0 + r) * G + g) * C::kHB + hh) * HEAD_DIM +
                4 * d4);
            const float c = wgt[r * G + g];
            a = make_float4(c * a.x, c * a.y, c * a.z, c * a.w);
          }
          red[i] = a;
        }
        bar_sync1<C::kConsumers>();
        if (tid < G * D4)
          for (int rr = 0; rr < kRC && r0 + rr < R; ++rr) {
            const float4 a = red[rr * G * D4 + tid];
            acc.x += a.x;
            acc.y += a.y;
            acc.z += a.z;
            acc.w += a.w;
          }
        bar_sync1<C::kConsumers>();
      }
      if (tid < G * D4) {
        const int g = tid / D4, d = tid % D4 * 4;
        const float den = dens[g];
        Vec<TQ, 4> res;
        res.v[0] = from_float<TQ>(acc.x / den);
        res.v[1] = from_float<TQ>(acc.y / den);
        res.v[2] = from_float<TQ>(acc.z / den);
        res.v[3] = from_float<TQ>(acc.w / den);
        *reinterpret_cast<Vec<TQ, 4>*>(
            out + (((long long)n * G + g) * H + h) * HEAD_DIM + d) = res;
      }
    }
  }
}

template <typename TQ, typename TKV, int HEAD_DIM, bool kRagged>
cudaError_t launch_shape(const Args& a, float* state, const WalkArgs& wa,
                         int grid) {
  using C = Cfg<TQ, TKV, HEAD_DIM, kRagged>;
  auto kern = verify_walk_kernel<TQ, TKV, HEAD_DIM, kRagged>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem + (kRagged ? plan_smem(kMaxTokens) : 0));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem + (kRagged ? plan_smem(a.N) : 0);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // the combine's grid sync
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TQ*>(a.q),
      static_cast<const TKV*>(a.k_pool), static_cast<const TKV*>(a.v_pool),
      a.k_scale, a.v_scale, a.block_tables, a.slot_ids, a.positions,
      static_cast<TQ*>(a.out), state, a.N, a.G, a.H, a.BS, a.S, a.MB,
      a.scale, wa);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kRagged>
cudaError_t launch(int head_dim, const Args& a, float* state,
                   const WalkArgs& wa, int grid) {
  if (kRagged ? (a.G != 1 || a.N > kMaxTokens) : (a.G < 2 || a.G > 8))
    return cudaErrorInvalidValue;
  if (head_dim == 64)
    return launch_shape<TQ, TKV, 64, kRagged>(a, state, wa, grid);
  if (head_dim == 128)
    return launch_shape<TQ, TKV, 128, kRagged>(a, state, wa, grid);
  return cudaErrorInvalidValue;
}

// The walk pairs: 16-bit pools under queries of their type (1 / 1, 2 /
// 2), int8 / fp8 pools (3, 4, with k_scale/v_scale) under any float query.
template <bool kRagged>
cudaError_t launch_pair(int head_dim, int q_dtype, int kv_dtype,
                        const Args& a, float* st, const WalkArgs& wa,
                        int grid) {
  if (kv_dtype <= 2 && (a.k_scale != nullptr || a.v_scale != nullptr))
    return cudaErrorInvalidValue;
  if (kv_dtype >= 3 && (a.k_scale == nullptr || a.v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, kRagged>(head_dim, a, st, wa,
                                                         grid);
  if (q_dtype == 2 && kv_dtype == 2)
    return launch<__half, __half, kRagged>(head_dim, a, st, wa, grid);
  if (kv_dtype != 3 && kv_dtype != 4) return cudaErrorInvalidValue;
  const bool i8 = kv_dtype == 3;
  if (q_dtype == 0)
    return i8 ? launch<float, signed char, kRagged>(head_dim, a, st, wa, grid)
              : launch<float, fp8e4m3, kRagged>(head_dim, a, st, wa, grid);
  if (q_dtype == 1)
    return i8 ? launch<__nv_bfloat16, signed char, kRagged>(head_dim, a, st,
                                                            wa, grid)
              : launch<__nv_bfloat16, fp8e4m3, kRagged>(head_dim, a, st, wa,
                                                        grid);
  if (q_dtype == 2)
    return i8 ? launch<__half, signed char, kRagged>(head_dim, a, st, wa, grid)
              : launch<__half, fp8e4m3, kRagged>(head_dim, a, st, wa, grid);
  return cudaErrorInvalidValue;
}

}  // namespace vw

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8, 4 =
// float8_e4m3fn. paged_attend_kernel over q [N, G, H, Dh] (G <= 8):
// float32 queries over float32, bfloat16 or float16 pools; the other
// pairs are the walk's (paddle_tpu_torch_paged_verify,
// paddle_tpu_torch_paged_ragged) and refused here. Returns a
// cudaError_t; 0 when the kernel was launched.
extern "C" int paddle_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* slot_ids, const void* positions, void* out, int N, int G,
    int H, int head_dim, int BS, int S, int MB, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  if (N <= 0 || G <= 0 || H <= 0 || q_dtype != 0 || kv_dtype > 2 ||
      k_scale != nullptr || v_scale != nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(slot_ids),
               static_cast<const int*>(positions), out, N, G, H, BS, S, MB,
               scale, static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 0) return (int)launch<float, float>(head_dim, a);
  if (kv_dtype == 1) return (int)launch<float, __nv_bfloat16>(head_dim, a);
  return (int)launch<float, __half>(head_dim, a);
}

// The verify walk (verify_walk_kernel): the verify entry at 2 <= G <= 8
// over the walk pairs: 16-bit pools under queries of their type (1 / 1,
// 2 / 2) or int8 / fp8 pools (3, 4, with k_scale/v_scale) under any
// float query. Operands as for paddle_tpu_torch_paged_attention, the
// pools 16-byte aligned; `ranges` (R) and `grid` are ops/
// paged_attention.py:verify_plan's; state: fp32 scratch of items x G x
// heads a block x (head_dim + 2), items = N x ceil(H / heads a block) x
// R (16 heads a block at head_dim 64, 8 at 128). Returns a cudaError_t;
// 0 when the kernel was launched.
extern "C" int paddle_tpu_torch_paged_verify(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* slot_ids, const void* positions, void* out, void* state,
    int N, int G, int H, int head_dim, int BS, int S, int MB, int q_dtype,
    int kv_dtype, float scale, int ranges, int grid, void* stream) {
  if (N <= 0 || G < 2 || G > 8 || H <= 0 || BS <= 0 || ranges <= 0 ||
      grid <= 0 || state == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(slot_ids),
               static_cast<const int*>(positions), out, N, G, H, BS, S, MB,
               scale, static_cast<cudaStream_t>(stream)};
  return (int)vw::launch_pair<false>(head_dim, q_dtype, kv_dtype, a,
                                     static_cast<float*>(state),
                                     vw::WalkArgs{ranges, 0, 0, 0},
                                     grid);
}

// The ragged walk (verify_walk_kernel, groups found on the device): q
// [T, H, Dh], slot_ids and positions [T] (T <= 1024), over the walk
// pairs of paddle_tpu_torch_paged_verify. `wmin`, `target`: the plan's
// (ops/paged_attention.py:ragged_plan); state: fp32 scratch of `slots`
// x 16 x heads a block x (head_dim + 2), slots = 2 x target; `grid`
// persistent blocks, at most one an SM. Returns a cudaError_t; 0 when
// the kernel was launched.
extern "C" int paddle_tpu_torch_paged_ragged(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* slot_ids, const void* positions, void* out, void* state,
    int T, int H, int head_dim, int BS, int S, int MB,
    int q_dtype, int kv_dtype, float scale, int wmin, int target,
    int slots, int grid, void* stream) {
  if (T <= 0 || H <= 0 || BS <= 0 || wmin <= 0 || target <= 0 ||
      slots < 2 * target || grid <= 0 || state == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(slot_ids),
               static_cast<const int*>(positions), out, T, 1, H, BS, S, MB,
               scale, static_cast<cudaStream_t>(stream)};
  return (int)vw::launch_pair<true>(
      head_dim, q_dtype, kv_dtype, a, static_cast<float*>(state),
      vw::WalkArgs{0, wmin, target, slots}, grid);
}
