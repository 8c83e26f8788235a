// Fused residual-add + LayerNorm for Hopper (sm_90a), forward and
// backward.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:_fwd_kernel and
// _bwd_kernel. Over rows of width d:
//   forward   z = x + r (summed in fp32; z is stored in x's dtype),
//             out = (z - mu) * rstd * w + b from the fp32 sum, with
//             mu = mean(z), rstd = rsqrt(mean((z - mu)^2) + eps), both
//             fp32 and kept for the backward;
//   backward  reads the STORED z with the fp32 mu and rstd,
//             zhat = (z - mu) * rstd, gw = g * w,
//             dz = rstd * (gw - mean(gw) - zhat * mean(gw * zhat)) + g_z.
// dw and db (sums over rows) stay outside, as in the JAX package.
//
// What bounds it: device memory. Per element the forward reads two
// values and writes two, the backward reads three and writes one, and
// each does a handful of flops: far below what the card computes per
// byte. So the design reads each element once and writes it once:
//   * one warp per row; a lane holds its share of the row in registers
//     (N vectors of V elements), so the two reductions of a row
//     (mean, then the centred variance; or mean(gw), mean(gw * zhat))
//     are warp shuffles and the row is never re-read;
//   * V = 16 bytes / element size when d % V == 0 and every pointer is
//     16-byte aligned: each load is a full 16-byte vector and a warp
//     reads 512 contiguous bytes per instruction; otherwise V = 1
//     (still coalesced, any d);
//   * N is the smallest power of two with 32 * N * V >= d, chosen at
//     launch: any d up to 4096, no row padding or tiling gate.
// w and b are read through the L1 cache (every row reuses them).
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/layer_norm.py), launched on the caller's
// stream, allocating nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;      // rows (warps) per thread block
constexpr int kMaxD = 4096;

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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T, int V, int N>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ w, const float* __restrict__ b,
                  T* __restrict__ out, T* __restrict__ z,
                  float* __restrict__ mu, float* __restrict__ rs, int rows,
                  int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const long long base = (long long)row * d;
  float v[N][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 + lane) * V;
    if (e < d) {
      const Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + base + e);
      const Vec<T, V> rv = *reinterpret_cast<const Vec<T, V>*>(r + base + e);
      Vec<T, V> zv;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] = to_float(xv.v[j]) + to_float(rv.v[j]);
        zv.v[j] = from_float<T>(v[i][j]);
        sum += v[i][j];
      }
      *reinterpret_cast<Vec<T, V>*>(z + base + e) = zv;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if ((i * 32 + lane) * V < d) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = v[i][j] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 + lane) * V;
    if (e < d) {
      Vec<T, V> ov;
#pragma unroll
      for (int j = 0; j < V; ++j)
        ov.v[j] = from_float<T>((v[i][j] - mean) * rstd * __ldg(w + e + j) +
                                __ldg(b + e + j));
      *reinterpret_cast<Vec<T, V>*>(out + base + e) = ov;
    }
  }
  if (lane == 0) {
    mu[row] = mean;
    rs[row] = rstd;
  }
}

template <typename T, int V, int N>
__global__ void __launch_bounds__(kWarps * 32)
add_ln_bwd_kernel(const T* __restrict__ z, const float* __restrict__ w,
                  const float* __restrict__ mu, const float* __restrict__ rs,
                  const T* __restrict__ g, const T* __restrict__ gz,
                  T* __restrict__ dz, int rows, int d) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const long long base = (long long)row * d;
  const float m = mu[row], rstd = rs[row];
  float zh[N][V], gw[N][V];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 + lane) * V;
    if (e < d) {
      const Vec<T, V> zv = *reinterpret_cast<const Vec<T, V>*>(z + base + e);
      const Vec<T, V> gv = *reinterpret_cast<const Vec<T, V>*>(g + base + e);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        zh[i][j] = (to_float(zv.v[j]) - m) * rstd;
        gw[i][j] = to_float(gv.v[j]) * __ldg(w + e + j);
        s1 += gw[i][j];
        s2 += gw[i][j] * zh[i][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) zh[i][j] = gw[i][j] = 0.f;
    }
  }
  const float m1 = warp_sum(s1) / d;
  const float m2 = warp_sum(s2) / d;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 + lane) * V;
    if (e < d) {
      const Vec<T, V> gzv =
          *reinterpret_cast<const Vec<T, V>*>(gz + base + e);
      Vec<T, V> dv;
#pragma unroll
      for (int j = 0; j < V; ++j)
        dv.v[j] = from_float<T>(rstd * (gw[i][j] - m1 - zh[i][j] * m2) +
                                to_float(gzv.v[j]));
      *reinterpret_cast<Vec<T, V>*>(dz + base + e) = dv;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launches LAUNCH(V, N) for the vector width V and per-lane vector
// count N that cover d (inside a function template over T, with vec_ok
// in scope); an unsupported width falls through to the caller's error.
#define PADDLE_LN_DISPATCH(LAUNCH)                                         \
  constexpr int VV = 16 / sizeof(T);                                       \
  const int V = (vec_ok && d % VV == 0) ? VV : 1;                          \
  const int per_lane = (d + 32 * V - 1) / (32 * V);                        \
  if (V == VV) {                                                           \
    if (per_lane <= 1) return LAUNCH(VV, 1);                               \
    if (per_lane <= 2) return LAUNCH(VV, 2);                               \
    if (per_lane <= 4) return LAUNCH(VV, 4);                               \
    if (per_lane <= 8) return LAUNCH(VV, 8);                               \
    if (per_lane <= 16) return LAUNCH(VV, 16);                             \
    if constexpr (VV == 4) {                                               \
      if (per_lane <= 32) return LAUNCH(4, 32);                            \
    }                                                                      \
  } else {                                                                 \
    if (per_lane <= 1) return LAUNCH(1, 1);                                \
    if (per_lane <= 2) return LAUNCH(1, 2);                                \
    if (per_lane <= 4) return LAUNCH(1, 4);                                \
    if (per_lane <= 8) return LAUNCH(1, 8);                                \
    if (per_lane <= 16) return LAUNCH(1, 16);                              \
    if (per_lane <= 32) return LAUNCH(1, 32);                              \
    if (per_lane <= 64) return LAUNCH(1, 64);                              \
    if (per_lane <= 128) return LAUNCH(1, 128);                            \
  }                                                                        \
  return cudaErrorInvalidValue;

template <typename T, int V, int N>
cudaError_t fwd_launch(const void* x, const void* r, const float* w,
                       const float* b, void* out, void* z, float* mu,
                       float* rs, int rows, int d, float eps,
                       cudaStream_t stream) {
  add_ln_fwd_kernel<T, V, N>
      <<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(r), w, b,
          static_cast<T*>(out), static_cast<T*>(z), mu, rs, rows, d, eps);
  return cudaGetLastError();
}

template <typename T, int V, int N>
cudaError_t bwd_launch(const void* z, const float* w, const float* mu,
                       const float* rs, const void* g, const void* gz,
                       void* dz, int rows, int d, cudaStream_t stream) {
  add_ln_bwd_kernel<T, V, N>
      <<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          static_cast<const T*>(z), w, mu, rs, static_cast<const T*>(g),
          static_cast<const T*>(gz), static_cast<T*>(dz), rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* r, const float* w, const float* b,
                void* out, void* z, float* mu, float* rs, int rows, int d,
                float eps, cudaStream_t stream) {
  const bool vec_ok = aligned16(x) && aligned16(r) && aligned16(out) &&
                      aligned16(z);
#define PADDLE_LN_FWD(VN, NN) \
  fwd_launch<T, VN, NN>(x, r, w, b, out, z, mu, rs, rows, d, eps, stream)
  PADDLE_LN_DISPATCH(PADDLE_LN_FWD)
#undef PADDLE_LN_FWD
}

template <typename T>
cudaError_t bwd(const void* z, const float* w, const float* mu,
                const float* rs, const void* g, const void* gz, void* dz,
                int rows, int d, cudaStream_t stream) {
  const bool vec_ok = aligned16(z) && aligned16(g) && aligned16(gz) &&
                      aligned16(dz);
#define PADDLE_LN_BWD(VN, NN) \
  bwd_launch<T, VN, NN>(z, w, mu, rs, g, gz, dz, rows, d, stream)
  PADDLE_LN_DISPATCH(PADDLE_LN_BWD)
#undef PADDLE_LN_BWD
}

#undef PADDLE_LN_DISPATCH

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (x, r, out, z, g,
// g_z, dz); w, b, mu, rs are float32. Each returns a cudaError_t; 0 when
// the kernel was launched.
extern "C" int paddle_tpu_torch_add_ln_fwd(
    const void* x, const void* r, const void* w, const void* b, void* out,
    void* z, void* mu, void* rs, int rows, int d, int dtype, float eps,
    void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* muf = static_cast<float*>(mu);
  float* rsf = static_cast<float*>(rs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)fwd<float>(x, r, wf, bf, out, z, muf, rsf, rows, d,
                                   eps, st);
    case 1: return (int)fwd<__nv_bfloat16>(x, r, wf, bf, out, z, muf, rsf,
                                           rows, d, eps, st);
    case 2: return (int)fwd<__half>(x, r, wf, bf, out, z, muf, rsf, rows, d,
                                    eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int paddle_tpu_torch_add_ln_bwd(
    const void* z, const void* w, const void* mu, const void* rs,
    const void* g, const void* gz, void* dz, int rows, int d, int dtype,
    void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* muf = static_cast<const float*>(mu);
  const float* rsf = static_cast<const float*>(rs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)bwd<float>(z, wf, muf, rsf, g, gz, dz, rows, d, st);
    case 1: return (int)bwd<__nv_bfloat16>(z, wf, muf, rsf, g, gz, dz, rows,
                                           d, st);
    case 2: return (int)bwd<__half>(z, wf, muf, rsf, g, gz, dz, rows, d, st);
  }
  return (int)cudaErrorInvalidValue;
}
