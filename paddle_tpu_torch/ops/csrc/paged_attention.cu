// Block-table paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py:_paged_attend_kernel
// (reached through _paged_attend_grouped and ragged_attend) for the G=1
// ragged entry over float pools: flat token t attends the keys of slot
// max(slot_ids[t], 0) at positions <= positions[t], found through
// block_tables[slot, pos / BS]. The scaled query is rounded to its own
// dtype as the Pallas wrapper does; logits, the online softmax (running
// max, denominator, weighted sum) and the PV product are fp32; the
// output takes q's dtype.
//
// What bounds it: device memory. Each (token, head) reads (pos+1) K and
// V rows of Dh elements and does 4*Dh flops per row — about one flop per
// byte in bf16, far below the ~295 flops per byte the tensor cores need.
// So the design spends nothing on matrix units and everything on
// reading each needed row once, in full 128-byte lines:
//   * one warp per (token, head): each lane holds Dh/32 elements of q
//     and of the accumulator in registers, and a K or V row is one
//     coalesced warp load (lane l reads elements [l*Dh/32, (l+1)*Dh/32));
//   * keys are taken 8 at a time, so 16 row loads are in flight per warp
//     before the first dot product needs one, and the 8 cross-lane sums
//     interleave their shuffles;
//   * the walk stops at the query's own position: blocks past
//     positions[t] / BS are never read, and no mask value is ever
//     materialised for a masked key.
// Nothing is staged in shared memory: within a block no row is read
// twice, and rows that several tokens of one slot share (a prefill
// chunk re-walks its slot's pages once per token) are served from L2.
// That re-read is the first target of a later redesign.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/paged_attention.py), launched on the caller's
// stream, allocating nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // warps per thread block
constexpr int kChunk = 8;   // keys per inner step
// the Pallas kernel's finite mask value: the running max starts here
constexpr float kMaskValue = -0.7f * 3.40282347e38f / 1e6f;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

template <typename TQ, typename TKV, int HEAD_DIM>
__global__ void __launch_bounds__(kWarps * 32)
paged_attend_kernel(const TQ* __restrict__ q,          // [T, H, Dh]
                    const TKV* __restrict__ k_pool,    // [NB, BS, H, Dh]
                    const TKV* __restrict__ v_pool,    // [NB, BS, H, Dh]
                    const int* __restrict__ block_tables,  // [S, MB]
                    const int* __restrict__ slot_ids,      // [T]
                    const int* __restrict__ positions,     // [T]
                    TQ* __restrict__ out,              // [T, H, Dh]
                    int T, int H, int BS, int S, int MB, float scale) {
  constexpr int EPL = HEAD_DIM / 32;  // elements per lane
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)T * H) return;  // warp-uniform
  const int t = (int)(w / H);
  const int h = (int)(w % H);
  int slot = slot_ids[t];
  slot = slot < 0 ? 0 : (slot >= S ? S - 1 : slot);  // padding -> slot 0
  const int last = min(positions[t], MB * BS - 1);   // newest visible key
  const int* row = block_tables + (long long)slot * MB;
  const long long entry_stride = (long long)H * HEAD_DIM;
  const long long block_stride = (long long)BS * entry_stride;
  const long long qo = w * HEAD_DIM + lane * EPL;

  float qv[EPL];
  {
    const Vec<TQ, EPL> x = *reinterpret_cast<const Vec<TQ, EPL>*>(q + qo);
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      qv[i] = to_float(from_float<TQ>(to_float(x.v[i]) * scale));
  }
  float m = kMaskValue, l = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  for (int b = 0; b * BS <= last; ++b) {
    const long long base = (long long)row[b] * block_stride +
                           (long long)h * HEAD_DIM + lane * EPL;
    const int n = min(BS, last - b * BS + 1);  // visible keys of block b
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float kf[kChunk][EPL], vf[kChunk][EPL], s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j0 + j < n) {
          const long long off = base + (long long)(j0 + j) * entry_stride;
          const Vec<TKV, EPL> kx =
              *reinterpret_cast<const Vec<TKV, EPL>*>(k_pool + off);
          const Vec<TKV, EPL> vx =
              *reinterpret_cast<const Vec<TKV, EPL>*>(v_pool + off);
#pragma unroll
          for (int i = 0; i < EPL; ++i) {
            kf[j][i] = to_float(kx.v[i]);
            vf[j][i] = to_float(vx.v[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < EPL; ++i) kf[j][i] = vf[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) d = fmaf(qv[i], kf[j][i], d);
        s[j] = d;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
      }
      float mc = kMaskValue;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j0 + j < n) mc = fmaxf(mc, s[j]);
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (j0 + j < n) ? expf(s[j] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[i] = fmaf(p, vf[j][i], acc[i]);
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  const float denom = fmaxf(l, 1e-30f);
  Vec<TQ, EPL> o;
#pragma unroll
  for (int i = 0; i < EPL; ++i) o.v[i] = from_float<TQ>(acc[i] / denom);
  *reinterpret_cast<Vec<TQ, EPL>*>(out + qo) = o;
}

template <typename TQ, typename TKV>
cudaError_t launch(int head_dim, const void* q, const void* k_pool,
                   const void* v_pool, const int* block_tables,
                   const int* slot_ids, const int* positions, void* out,
                   int T, int H, int BS, int S, int MB, float scale,
                   cudaStream_t stream) {
  const long long warps = (long long)T * H;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
#define PADDLE_PAGED_LAUNCH(D)                                              \
  paged_attend_kernel<TQ, TKV, D><<<grid, block, 0, stream>>>(              \
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),          \
      static_cast<const TKV*>(v_pool), block_tables, slot_ids, positions,  \
      static_cast<TQ*>(out), T, H, BS, S, MB, scale)
  switch (head_dim) {
    case 64: PADDLE_PAGED_LAUNCH(64); break;
    case 128: PADDLE_PAGED_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef PADDLE_PAGED_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. Supported
// (q, pool) pairs: equal types, or float32 queries over 16-bit pools.
// Returns a cudaError_t; 0 when the kernel was launched.
extern "C" int paddle_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* slot_ids, const void* positions,
    void* out, int T, int H, int head_dim, int BS, int S, int MB,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  if (T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(slot_ids);
  const int* ps = static_cast<const int*>(positions);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch<float, float>(head_dim, q, k_pool, v_pool, bt, sl, ps, out,
                               T, H, BS, S, MB, scale, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        head_dim, q, k_pool, v_pool, bt, sl, ps, out, T, H, BS, S, MB, scale,
        st);
  else if (q_dtype == 2 && kv_dtype == 2)
    err = launch<__half, __half>(head_dim, q, k_pool, v_pool, bt, sl, ps, out,
                                 T, H, BS, S, MB, scale, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch<float, __nv_bfloat16>(head_dim, q, k_pool, v_pool, bt, sl,
                                       ps, out, T, H, BS, S, MB, scale, st);
  else if (q_dtype == 0 && kv_dtype == 2)
    err = launch<float, __half>(head_dim, q, k_pool, v_pool, bt, sl, ps, out,
                                T, H, BS, S, MB, scale, st);
  return (int)err;
}
