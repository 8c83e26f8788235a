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
// denominator, weighted sum) and the PV product are fp32; the output
// takes q's dtype.
//
// What bounds it: device memory. Each (group, head) reads (max pos + 1)
// K and V rows of Dh elements (and, quantized, one fp32 scale per row)
// and does 4 * Dh * G flops per row — at most a few flops per byte,
// far below the ~295 the tensor cores need, and a decode or verify walk
// is long (up to the whole context) while there are few of them (8
// slots x 16 heads). So the design spends nothing on matrix units and
// everything on reading each needed row once per group, with as many
// reads in flight as it can:
//   * one block of 4 warps per (group, head); the warps take the walk's
//     pages in turn (warp w reads pages w, w+4, ...), each keeping its
//     own online-softmax state, and merge the four states in shared
//     memory at the end, so a long walk takes a quarter of the time;
//   * each lane holds Dh/32 elements of every query of the group and of
//     its accumulator in registers, and a K or V row is one coalesced
//     warp load (lane l reads elements [l*Dh/32, (l+1)*Dh/32)); each
//     row, once loaded, serves all G dot products — that single read is
//     the point of the verify entry;
//   * keys are taken CHUNK at a time (8 for up to 4 queries, 4 for up
//     to 8), with unconditional loads, so 2 * CHUNK row loads are in
//     flight before the first dot product needs one, and the G * CHUNK
//     cross-lane sums interleave their shuffles;
//   * the walk stops at the group's newest position: pages past it are
//     never read, and no mask value is materialised for a masked key.
// Quantized rows are Dh bytes: at Dh = 64 a warp load fills half a
// 128-byte line (a layout in which one load covers two rows is later
// work). No K/V row is staged in shared memory (only the warps' final
// states are): within a block no row is read twice, and rows that
// several groups of one slot share (a prefill chunk re-walks its slot's
// pages once per token) are served from L2.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/paged_attention.py), launched on the caller's
// stream, allocating nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

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
                    const float* __restrict__ k_scale,  // [NB, BS, H]
                    const float* __restrict__ v_scale,  // [NB, BS, H]
                    const int* __restrict__ block_tables,  // [S, MB]
                    const int* __restrict__ slot_ids,      // [N]
                    const int* __restrict__ positions,     // [N, G]
                    TQ* __restrict__ out,              // [N, G, H, Dh]
                    int N, int G, int H, int BS, int S, int MB,
                    float scale) {
  constexpr int EPL = HEAD_DIM / 32;           // elements per lane
  constexpr int CHUNK = GMAX <= 4 ? 8 : 4;     // keys per inner step
  constexpr bool kQuant = sizeof(TKV) == 1;    // int8 / fp8 payloads
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
      float ks[CHUNK], vs[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const long long e = entry0 + min(j0 + j, n_keys - 1);
        const long long off =
            e * entry_stride + (long long)h * HEAD_DIM + lane * EPL;
        kx[j] = *reinterpret_cast<const Vec<TKV, EPL>*>(k_pool + off);
        vx[j] = *reinterpret_cast<const Vec<TKV, EPL>*>(v_pool + off);
        if constexpr (kQuant) {
          ks[j] = k_scale[e * H + h];
          vs[j] = v_scale[e * H + h];
        }
      }
      float kf[CHUNK][EPL], vf[CHUNK][EPL], s[GMAX][CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          kf[j][i] = to_float(kx[j].v[i]);
          vf[j][i] = to_float(vx[j].v[i]);
          if constexpr (kQuant) {  // dequantize in fp32, as the TPU kernel
            kf[j][i] *= ks[j];
            vf[j][i] *= vs[j];
          }
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
      static_cast<const TKV*>(a.v_pool), a.k_scale, a.v_scale,
      a.block_tables, a.slot_ids, a.positions, static_cast<TQ*>(a.out), a.N,
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

template <typename TQ>
cudaError_t launch_quantized(int head_dim, int kv_dtype, const Args& a) {
  if (a.k_scale == nullptr || a.v_scale == nullptr)
    return cudaErrorInvalidValue;
  if (kv_dtype == 3) return launch<TQ, signed char>(head_dim, a);
  if (kv_dtype == 4) return launch<TQ, fp8e4m3>(head_dim, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, 3 = int8, 4 =
// float8_e4m3fn. Supported (q, pool) pairs: equal float types, float32
// queries over 16-bit pools, and any float query type over int8 or fp8
// pools, which need k_scale/v_scale ([NB, BS, H] fp32). Returns a
// cudaError_t; 0 when the kernel was launched.
extern "C" int paddle_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* slot_ids, const void* positions, void* out, int N, int G,
    int H, int head_dim, int BS, int S, int MB, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  if (N <= 0 || G <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(slot_ids),
               static_cast<const int*>(positions), out, N, G, H, BS, S, MB,
               scale, static_cast<cudaStream_t>(stream)};
  if (kv_dtype <= 2 && (k_scale != nullptr || v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch<float, float>(head_dim, a);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(head_dim, a);
  else if (q_dtype == 2 && kv_dtype == 2)
    err = launch<__half, __half>(head_dim, a);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch<float, __nv_bfloat16>(head_dim, a);
  else if (q_dtype == 0 && kv_dtype == 2)
    err = launch<float, __half>(head_dim, a);
  else if (q_dtype == 0)
    err = launch_quantized<float>(head_dim, kv_dtype, a);
  else if (q_dtype == 1)
    err = launch_quantized<__nv_bfloat16>(head_dim, kv_dtype, a);
  else if (q_dtype == 2)
    err = launch_quantized<__half>(head_dim, kv_dtype, a);
  return (int)err;
}
