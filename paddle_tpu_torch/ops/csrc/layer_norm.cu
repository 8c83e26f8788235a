// Fused residual-add + LayerNorm for Hopper (sm_90a), forward and
// backward.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py:_fwd_kernel and
// _bwd_kernel, with the per-feature sums the JAX package leaves to XLA
// ("they fuse into a single f32[d] pass") fused into the backward. Over
// rows of width d:
//   forward   z = x + r (summed in fp32; z is stored in x's dtype),
//             out = (z - mu) * rstd * w + b from the fp32 sum, with
//             mu = mean(z), rstd = rsqrt(mean((z - mu)^2) + eps), both
//             fp32 and kept for the backward;
//   backward  reads the STORED z with the fp32 mu and rstd,
//             zhat = (z - mu) * rstd, gw = g * w,
//             dz = rstd * (gw - mean(gw) - zhat * mean(gw * zhat)) + g_z,
//             and dw = sum over rows of g * zhat, db = sum of g (fp32).
//
// What bounds it: device memory. Per element the forward reads two
// values and writes two, the backward reads three and writes one, and
// each does a handful of flops: far below what the card computes per
// byte. So the design reads each element once, writes it once, and
// keeps loads in flight while a row is reduced:
//   * persistent blocks (as many as fit on the card, a grid the wrapper
//     asks for), whose warps walk rows: a row group of W warps (W = 1 up
//     to d = 1024, 2 up to 2048, 4 up to 4096) owns a row at a time, a
//     lane holding its share (N vectors of V elements, at most 32
//     elements) in registers, so the two reductions of a row (mean, then
//     the centred variance; or mean(gw) with mean(gw * zhat)) are warp
//     shuffles (and, for W > 1, one exchange through shared memory) and
//     the row is never re-read;
//   * loads run ahead of the rows: where a warp owns a row of 16-byte
//     vectors (every d up to 1024 with aligned rows, the train step's
//     case), each lane copies its share of the rows R - 1 ahead into a
//     ring of R rows in shared memory (cp.async; R = 3 where it fits),
//     so two rows a warp are in flight at any time without holding a
//     register; elsewhere the next row's loads are issued before this
//     row's reductions (double-buffered in registers; the backward's
//     g_z at the row's start);
//   * w and b are read once a block into shared memory and from there as
//     16-byte vectors;
//   * z is stored evict-first (st.global.cs): only the backward reads it,
//     much later; out is stored plainly, the next matmul reads it;
//   * V = 16 bytes / element size when d % V == 0 and every row pointer
//     is 16-byte aligned; otherwise V = 1 (still coalesced, any d);
//   * the backward's lanes sum g * zhat and g over their fixed columns
//     and all the rows their group walks, in fp32 registers; the groups
//     of a block then add theirs through shared memory in group order,
//     each block writes its [2, d] partial, and add_ln_bwd_sum_kernel
//     adds the blocks' partials in a fixed order: no atomics, so two
//     launches give the same bits.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/layer_norm.py), launched on the caller's
// stream, allocating nothing (the wrapper passes the partials' scratch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxD = 4096;
// warps a block, forward and backward, and the blocks an SM each is
// compiled to fit (__launch_bounds__)
constexpr int kFwdWarps = 8, kBwdWarps = 8;
constexpr int kFwdMinBlocks = 2, kBwdMinBlocks = 1;
// rows a warp keeps staged in shared memory (at most; fewer where they
// would not fit), forward and backward
constexpr int kFwdRing = 3, kBwdRing = 3;

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

// A vector stored with the evict-first hint (st.global.cs).
template <typename T, int V>
__device__ __forceinline__ void store_cs(T* p, const Vec<T, V>& v) {
  constexpr int kBytes = sizeof(T) * V;
  if constexpr (kBytes == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(&v);
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
                 "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                 : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p),
                 "r"(*reinterpret_cast<const uint32_t*>(&v))
                 : "memory");
  } else {
    static_assert(kBytes == 2, "store_cs: 16, 4 or 2 bytes");
    asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p),
                 "h"(*reinterpret_cast<const unsigned short*>(&v))
                 : "memory");
  }
}

// V floats of shared memory from p (16-byte vectors where V allows).
template <int V>
__device__ __forceinline__ void load_f(float (&o)[V], const float* p) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      o[j] = f.x;
      o[j + 1] = f.y;
      o[j + 2] = f.z;
      o[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = p[j];
  }
}

// The sums of s over a row group of W warps, in a fixed order: warp
// shuffles, then (W > 1) the warps' sums through `red` (this group's W
// slots of the reduction in flight) under named barrier `bar`.
template <int W>
__device__ __forceinline__ float2 group_sum(float2 s, float2* red, int wig,
                                            int lane, int bar) {
  s.x = warp_sum(s.x);
  s.y = warp_sum(s.y);
  if constexpr (W > 1) {
    if (lane == 0) red[wig] = s;
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * W) : "memory");
    s = red[0];
#pragma unroll
    for (int k = 1; k < W; ++k) {
      s.x += red[k].x;
      s.y += red[k].y;
    }
  }
  return s;
}

__host__ __device__ constexpr int pad4(int d) { return (d + 3) / 4 * 4; }

// 16 bytes from global to shared memory, asynchronously (cp.async, kept
// in L2 only); a thread's copies since its last commit are one group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A kernel whose row group is one warp and whose vectors are 16 bytes
// stages the rows ahead in shared memory: per warp a ring of RING rows
// of TENSORS operands, each [N][32] 16-byte vectors (lane-major: a lane
// reads only what it copied), as deep as kRing allows in ~200 KB.
template <typename T, int V, int N, int W, int TENSORS, int WARPS, int RING>
struct Stage {
  static constexpr bool kOn = W == 1 && sizeof(T) * V == 16;
  static constexpr int kRowBytes = TENSORS * N * 32 * 16;
  static constexpr int kFit = 200 * 1024 / (WARPS * kRowBytes);
  static constexpr int kRing = RING < kFit ? RING : kFit > 1 ? kFit : 1;
  static constexpr int kBytes = kOn ? WARPS * kRing * kRowBytes : 0;
};

// A lane's share of a row into its slots of a stage, by cp.async; and
// back into registers.
template <typename T, int V, int N>
__device__ __forceinline__ void stage_row(uint4* st, const T* p, int lane,
                                          int d) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 + lane) * V;
    if (e < d) cp_async16(st + i * 32 + lane, p + e);
  }
}
template <typename T, int V, int N>
__device__ __forceinline__ void read_stage(Vec<T, V> (&a)[N],
                                           const uint4* st, int lane, int d) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if ((i * 32 + lane) * V < d)
      a[i] = *reinterpret_cast<const Vec<T, V>*>(st + i * 32 + lane);
}

// Vector i of a lane's share of a row: elements (i * 32 W + gl) * V ..
// + V - 1, gl the lane's index in its row group.
template <typename T, int V, int N, int W>
__device__ __forceinline__ void load_row(Vec<T, V> (&a)[N], const T* p,
                                         int gl, int d) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 * W + gl) * V;
    if (e < d) a[i] = *reinterpret_cast<const Vec<T, V>*>(p + e);
  }
}

template <typename T, int V, int N, int W>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks)
add_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ w, const float* __restrict__ b,
                  T* __restrict__ out, T* __restrict__ z,
                  float* __restrict__ mu, float* __restrict__ rs, int rows,
                  int d, float eps) {
  constexpr int G = kFwdWarps / W;  // row groups a block
  using St = Stage<T, V, N, W, 2, kFwdWarps, kFwdRing>;
  constexpr int R = St::kRing;
  extern __shared__ float4 smem4[];
  uint4* ring = reinterpret_cast<uint4*>(smem4);  // [warps][R][x, r]
  float* ws = reinterpret_cast<float*>(ring) + St::kBytes / 4;
  float* bs = ws + pad4(d);
  float2* red = reinterpret_cast<float2*>(bs + pad4(d));  // [2][G][W]
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    ws[c] = __ldg(w + c);
    bs[c] = __ldg(b + c);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / W, wig = warp % W, gl = wig * 32 + lane;
  const int stride = gridDim.x * G;
  int row = blockIdx.x * G + group, slot = 0;
  // the warp's stage for its k-th row, operand t
  const auto stage = [&](int k, int t) {
    return ring + ((warp * R + k % R) * 2 + t) * N * 32;
  };
  // the row's vectors: staged R - 1 rows ahead, or loaded a row ahead
  Vec<T, V> xv[N], rv[N];
  if constexpr (St::kOn) {
    for (int k = 0; k < R - 1; ++k) {
      const long long rk = row + (long long)k * stride;
      if (rk < rows) {
        stage_row<T, V, N>(stage(k, 0), x + rk * d, lane, d);
        stage_row<T, V, N>(stage(k, 1), r + rk * d, lane, d);
      }
      cp_async_commit();
    }
  } else if (row < rows) {
    load_row<T, V, N, W>(xv, x + (long long)row * d, gl, d);
    load_row<T, V, N, W>(rv, r + (long long)row * d, gl, d);
  }
  for (int k = 0; row < rows; row += stride, ++k) {
    const long long base = (long long)row * d;
    if constexpr (St::kOn) {
      const long long rn = row + (long long)(R - 1) * stride;
      if (rn < rows) {  // into the stage the last row was read from
        stage_row<T, V, N>(stage(k + R - 1, 0), x + rn * d, lane, d);
        stage_row<T, V, N>(stage(k + R - 1, 1), r + rn * d, lane, d);
      }
      cp_async_commit();
      cp_async_wait<R - 1>();  // this row's group has landed
      read_stage<T, V, N>(xv, stage(k, 0), lane, d);
      read_stage<T, V, N>(rv, stage(k, 1), lane, d);
    }
    float v[N][V];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = (i * 32 * W + gl) * V;
      if (e < d) {
        Vec<T, V> zv;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          v[i][j] = to_float(xv[i].v[j]) + to_float(rv[i].v[j]);
          zv.v[j] = from_float<T>(v[i][j]);
          sum += v[i][j];
        }
        store_cs<T, V>(z + base + e, zv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[i][j] = 0.f;
      }
    }
    if (!St::kOn && row + stride < rows) {  // the next row's loads
      load_row<T, V, N, W>(xv, x + base + (long long)stride * d, gl, d);
      load_row<T, V, N, W>(rv, r + base + (long long)stride * d, gl, d);
    }
    const float mean =
        group_sum<W>(make_float2(sum, 0.f), red + (slot * G + group) * W,
                     wig, lane, 1 + group).x /
        d;
    slot ^= 1;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i * 32 * W + gl) * V < d) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = v[i][j] - mean;
          sq += c * c;
        }
      }
    }
    const float rstd = rsqrtf(
        group_sum<W>(make_float2(sq, 0.f), red + (slot * G + group) * W, wig,
                     lane, 1 + group).x /
            d +
        eps);
    slot ^= 1;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = (i * 32 * W + gl) * V;
      if (e < d) {
        float wv[V], bv[V];
        load_f<V>(wv, ws + e);
        load_f<V>(bv, bs + e);
        Vec<T, V> ov;
#pragma unroll
        for (int j = 0; j < V; ++j)
          ov.v[j] = from_float<T>((v[i][j] - mean) * rstd * wv[j] + bv[j]);
        *reinterpret_cast<Vec<T, V>*>(out + base + e) = ov;
      }
    }
    if (gl == 0) {
      mu[row] = mean;
      rs[row] = rstd;
    }
  }
}

// part: this launch's [gridDim.x, 2, d] scratch, each block's sums of
// g * zhat (dw) and g (db) over its rows.
template <typename T, int V, int N, int W>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks)
add_ln_bwd_kernel(const T* __restrict__ z, const float* __restrict__ w,
                  const float* __restrict__ mu, const float* __restrict__ rs,
                  const T* __restrict__ g, const T* __restrict__ gz,
                  T* __restrict__ dz, float* __restrict__ part, int rows,
                  int d) {
  constexpr int G = kBwdWarps / W;  // row groups a block
  using St = Stage<T, V, N, W, 3, kBwdWarps, kBwdRing>;
  constexpr int R = St::kRing;
  extern __shared__ float4 smem4[];
  uint4* ring = reinterpret_cast<uint4*>(smem4);  // [warps][R][z, g, g_z]
  // after the walk the same bytes take [G][2][d], the groups' dw and db
  float* acc = reinterpret_cast<float*>(smem4);
  const int lead = St::kBytes > 8 * G * pad4(d) ? St::kBytes
                                                 : 8 * G * pad4(d);
  float* ws = reinterpret_cast<float*>(smem4) + lead / 4;
  float2* red = reinterpret_cast<float2*>(ws + pad4(d));
  for (int c = threadIdx.x; c < d; c += blockDim.x) ws[c] = __ldg(w + c);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / W, wig = warp % W, gl = wig * 32 + lane;
  const int stride = gridDim.x * G;
  int row = blockIdx.x * G + group, slot = 0;
  float dwa[N][V], dba[N][V];  // this lane's columns' sums
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) dwa[i][j] = dba[i][j] = 0.f;
  const auto stage = [&](int k, int t) {
    return ring + ((warp * R + k % R) * 3 + t) * N * 32;
  };
  // the row's vectors: staged R - 1 rows ahead, or z and g loaded a row
  // ahead (g_z, read only after the row's reductions, at the row's
  // start); its statistics a row ahead
  Vec<T, V> zv[N], gv[N];
  float m = 0.f, rstd = 0.f;
  if constexpr (St::kOn) {
    for (int k = 0; k < R - 1; ++k) {
      const long long rk = row + (long long)k * stride;
      if (rk < rows) {
        stage_row<T, V, N>(stage(k, 0), z + rk * d, lane, d);
        stage_row<T, V, N>(stage(k, 1), g + rk * d, lane, d);
        stage_row<T, V, N>(stage(k, 2), gz + rk * d, lane, d);
      }
      cp_async_commit();
    }
  } else if (row < rows) {
    load_row<T, V, N, W>(zv, z + (long long)row * d, gl, d);
    load_row<T, V, N, W>(gv, g + (long long)row * d, gl, d);
  }
  if (row < rows) {
    m = mu[row];
    rstd = rs[row];
  }
  for (int k = 0; row < rows; row += stride, ++k) {
    const long long base = (long long)row * d;
    Vec<T, V> zc[N], gc[N], gzc[N];
    if constexpr (St::kOn) {
      const long long rn = row + (long long)(R - 1) * stride;
      if (rn < rows) {  // into the stage the last row was read from
        stage_row<T, V, N>(stage(k + R - 1, 0), z + rn * d, lane, d);
        stage_row<T, V, N>(stage(k + R - 1, 1), g + rn * d, lane, d);
        stage_row<T, V, N>(stage(k + R - 1, 2), gz + rn * d, lane, d);
      }
      cp_async_commit();
      cp_async_wait<R - 1>();  // this row's group has landed
      read_stage<T, V, N>(zc, stage(k, 0), lane, d);
      read_stage<T, V, N>(gc, stage(k, 1), lane, d);
      read_stage<T, V, N>(gzc, stage(k, 2), lane, d);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        zc[i] = zv[i];
        gc[i] = gv[i];
      }
      load_row<T, V, N, W>(gzc, gz + base, gl, d);
    }
    const float mc = m, rc = rstd;
    if (row + stride < rows) {  // the next row's loads, in flight from here
      const long long nb = base + (long long)stride * d;
      if constexpr (!St::kOn) {
        load_row<T, V, N, W>(zv, z + nb, gl, d);
        load_row<T, V, N, W>(gv, g + nb, gl, d);
      }
      m = mu[row + stride];
      rstd = rs[row + stride];
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = (i * 32 * W + gl) * V;
      if (e < d) {
        float wv[V];
        load_f<V>(wv, ws + e);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gf = to_float(gc[i].v[j]);
          const float zh = (to_float(zc[i].v[j]) - mc) * rc;
          const float gw = gf * wv[j];
          s1 += gw;
          s2 += gw * zh;
          dwa[i][j] += gf * zh;
          dba[i][j] += gf;
        }
      }
    }
    const float2 t = group_sum<W>(make_float2(s1, s2),
                                  red + (slot * G + group) * W, wig, lane,
                                  1 + group);
    slot ^= 1;
    const float m1 = t.x / d, m2 = t.y / d;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = (i * 32 * W + gl) * V;
      if (e < d) {
        float wv[V];
        load_f<V>(wv, ws + e);
        Vec<T, V> dv;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float zh = (to_float(zc[i].v[j]) - mc) * rc;
          const float gw = to_float(gc[i].v[j]) * wv[j];
          dv.v[j] = from_float<T>(rc * (gw - m1 - zh * m2) +
                                  to_float(gzc[i].v[j]));
        }
        *reinterpret_cast<Vec<T, V>*>(dz + base + e) = dv;
      }
    }
  }
  // the groups' sums, then the block's: group after group, in order
  // (in the ring's bytes, once every warp has left it)
  if constexpr (St::kOn) cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = (i * 32 * W + gl) * V;
    if (e < d) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[(2 * group) * pad4(d) + e + j] = dwa[i][j];
        acc[(2 * group + 1) * pad4(d) + e + j] = dba[i][j];
      }
    }
  }
  __syncthreads();
  float* pb = part + (long long)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    const int k = c < d ? 0 : 1, col = c - k * d;
    float s = acc[k * pad4(d) + col];
#pragma unroll
    for (int q = 1; q < G; ++q) s += acc[(2 * q + k) * pad4(d) + col];
    pb[c] = s;
  }
}

// dw and db: the blocks' partials [blocks, 2, d] summed in a fixed
// order (slice j of 32 takes blocks j, j + 32, ..., its loads all in
// flight together; the slices are then added in order), 32 of the 2 d
// columns a block.
constexpr int kSumSlices = 32;
__global__ void __launch_bounds__(kSumSlices * 32)
add_ln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                      float* __restrict__ db, int blocks, int d) {
  __shared__ float sl[kSumSlices][33];
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * d) {
#pragma unroll 8
    for (int k = j; k < blocks; k += kSumSlices)
      s += part[(long long)k * 2 * d + c];
  }
  sl[j][lane] = s;
  __syncthreads();
  if (j == 0 && c < 2 * d) {
    float t = sl[0][lane];
#pragma unroll
    for (int q = 1; q < kSumSlices; ++q) t += sl[q][lane];
    if (c < d)
      dw[c] = t;
    else
      db[c - d] = t;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int V, int N, int W>
constexpr int fwd_smem(int d) {
  return Stage<T, V, N, W, 2, kFwdWarps, kFwdRing>::kBytes + 2 * pad4(d) * 4 +
         2 * kFwdWarps * 8;
}
template <typename T, int V, int N, int W>
constexpr int bwd_smem(int d) {
  const int ring = Stage<T, V, N, W, 3, kBwdWarps, kBwdRing>::kBytes;
  const int acc = 2 * (kBwdWarps / W) * pad4(d) * 4;
  return (ring > acc ? ring : acc) + pad4(d) * 4 + 2 * kBwdWarps * 8;
}

// Blocks of KERN that fit on the card at once (with SMEM bytes of
// shared memory), at most those with rows to walk (`groups` rows a
// block); 0 on an error. `smem_set` and `per` are the caller's cache of
// the shared memory KERN was last allowed and its blocks an SM there.
template <typename K>
int grid_for(K kern, int smem, int threads, int rows, int groups,
             int& smem_set, int& per) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return sms = 0;
  }
  if (smem != smem_set) {
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads,
                                                      smem) != cudaSuccess)
      return smem_set = -1, 0;
    smem_set = smem;
  }
  if (per < 1) return 0;
  const long long need = ((long long)rows + groups - 1) / groups;
  return (int)(need < (long long)sms * per ? need : (long long)sms * per);
}

// Calls LAUNCH(V, N, W) for the vector width V, the row group's warps W
// and the vectors a lane N that cover d (inside a function template over
// T, with vec_ok in scope); an unsupported width falls through to the
// caller's error.
#define PADDLE_LN_DISPATCH(LAUNCH)                                         \
  constexpr int VV = 16 / sizeof(T);                                       \
  const int V = (vec_ok && d % VV == 0) ? VV : 1;                          \
  const int W = d <= 1024 ? 1 : d <= 2048 ? 2 : 4;                         \
  const int per_lane = (d + 32 * W * V - 1) / (32 * W * V);                \
  if (V == VV) {                                                           \
    if (W == 2) return LAUNCH(VV, 32 / VV, 2);                             \
    if (W == 4) return LAUNCH(VV, 32 / VV, 4);                             \
    if (per_lane <= 1) return LAUNCH(VV, 1, 1);                            \
    if (per_lane <= 2) return LAUNCH(VV, 2, 1);                            \
    if (per_lane <= 4) return LAUNCH(VV, 4, 1);                            \
    if constexpr (VV == 4) {                                               \
      if (per_lane <= 8) return LAUNCH(4, 8, 1);                           \
    }                                                                      \
  } else {                                                                 \
    if (W == 2) return LAUNCH(1, 32, 2);                                   \
    if (W == 4) return LAUNCH(1, 32, 4);                                   \
    if (per_lane <= 1) return LAUNCH(1, 1, 1);                             \
    if (per_lane <= 2) return LAUNCH(1, 2, 1);                             \
    if (per_lane <= 4) return LAUNCH(1, 4, 1);                             \
    if (per_lane <= 8) return LAUNCH(1, 8, 1);                             \
    if (per_lane <= 16) return LAUNCH(1, 16, 1);                           \
    if (per_lane <= 32) return LAUNCH(1, 32, 1);                           \
  }                                                                        \
  return -(int)cudaErrorInvalidValue;

template <typename T, int V, int N, int W>
int fwd_launch(const void* x, const void* r, const float* w, const float* b,
               void* out, void* z, float* mu, float* rs, int rows, int d,
               float eps, cudaStream_t stream) {
  auto kern = add_ln_fwd_kernel<T, V, N, W>;
  static int smem_set = -1, per = 0;
  const int smem = fwd_smem<T, V, N, W>(d);
  const int grid = grid_for(kern, smem, kFwdWarps * 32, rows, kFwdWarps / W,
                            smem_set, per);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  kern<<<grid, kFwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), w, b,
      static_cast<T*>(out), static_cast<T*>(z), mu, rs, rows, d, eps);
  return (int)cudaGetLastError();
}

// With `blocks` 0: the backward's grid (the partials' rows) or a negative
// error; else the launch's error (0 when both kernels launched).
template <typename T, int V, int N, int W>
int bwd_launch(const void* z, const float* w, const float* mu,
               const float* rs, const void* g, const void* gz, void* dz,
               float* part, float* dw, float* db, int blocks, int rows,
               int d, cudaStream_t stream) {
  auto kern = add_ln_bwd_kernel<T, V, N, W>;
  static int smem_set = -1, per = 0;
  const int smem = bwd_smem<T, V, N, W>(d);
  const int grid = grid_for(kern, smem, kBwdWarps * 32, rows, kBwdWarps / W,
                            smem_set, per);
  if (grid < 1) return -(int)cudaErrorInvalidValue;
  if (blocks == 0) return grid;
  if (blocks != grid) return (int)cudaErrorInvalidValue;
  kern<<<grid, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(z), w, mu, rs, static_cast<const T*>(g),
      static_cast<const T*>(gz), static_cast<T*>(dz), part, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_ln_bwd_sum_kernel<<<(2 * d + 31) / 32, kSumSlices * 32, 0, stream>>>(
      part, dw, db, grid, d);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* r, const float* w, const float* b,
        void* out, void* z, float* mu, float* rs, int rows, int d, float eps,
        cudaStream_t stream) {
  const bool vec_ok = aligned16(x) && aligned16(r) && aligned16(out) &&
                      aligned16(z);
#define PADDLE_LN_FWD(VN, NN, WN) \
  fwd_launch<T, VN, NN, WN>(x, r, w, b, out, z, mu, rs, rows, d, eps, stream)
  PADDLE_LN_DISPATCH(PADDLE_LN_FWD)
#undef PADDLE_LN_FWD
}

template <typename T>
int bwd(const void* z, const float* w, const float* mu, const float* rs,
        const void* g, const void* gz, void* dz, float* part, float* dw,
        float* db, int blocks, int rows, int d, cudaStream_t stream) {
  const bool vec_ok = aligned16(z) && aligned16(g) && aligned16(gz) &&
                      aligned16(dz);
#define PADDLE_LN_BWD(VN, NN, WN)                                            \
  bwd_launch<T, VN, NN, WN>(z, w, mu, rs, g, gz, dz, part, dw, db, blocks, \
                            rows, d, stream)
  PADDLE_LN_DISPATCH(PADDLE_LN_BWD)
#undef PADDLE_LN_BWD
}

#undef PADDLE_LN_DISPATCH

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (x, r, out, z, g,
// g_z, dz); w, b, mu, rs, dw, db and the partials are float32. Each
// returns a cudaError_t; 0 when the kernels were launched.
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
    case 0: return fwd<float>(x, r, wf, bf, out, z, muf, rsf, rows, d, eps,
                              st);
    case 1: return fwd<__nv_bfloat16>(x, r, wf, bf, out, z, muf, rsf, rows, d,
                                      eps, st);
    case 2: return fwd<__half>(x, r, wf, bf, out, z, muf, rsf, rows, d, eps,
                               st);
  }
  return (int)cudaErrorInvalidValue;
}

namespace {

int bwd_any(const void* z, const void* w, const void* mu, const void* rs,
            const void* g, const void* gz, void* dz, void* part, void* dw,
            void* db, int blocks, int rows, int d, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return -(int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* muf = static_cast<const float*>(mu);
  const float* rsf = static_cast<const float*>(rs);
  float* pf = static_cast<float*>(part);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return bwd<float>(z, wf, muf, rsf, g, gz, dz, pf, dwf, dbf,
                              blocks, rows, d, st);
    case 1: return bwd<__nv_bfloat16>(z, wf, muf, rsf, g, gz, dz, pf, dwf,
                                      dbf, blocks, rows, d, st);
    case 2: return bwd<__half>(z, wf, muf, rsf, g, gz, dz, pf, dwf, dbf,
                               blocks, rows, d, st);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// The backward's grid for these operands: the rows of the [blocks, 2, d]
// fp32 partials' scratch the backward takes; a negative cudaError_t when
// it has no kernel for them.
extern "C" int paddle_tpu_torch_add_ln_bwd_blocks(const void* z,
                                                  const void* g,
                                                  const void* gz,
                                                  const void* dz, int rows,
                                                  int d, int dtype) {
  return bwd_any(z, nullptr, nullptr, nullptr, g, gz, const_cast<void*>(dz),
                 nullptr, nullptr, nullptr, 0, rows, d, dtype, nullptr);
}

// dz, and dw and db [d] from `part`, [blocks, 2, d] scratch with
// `blocks` as paddle_tpu_torch_add_ln_bwd_blocks gives.
extern "C" int paddle_tpu_torch_add_ln_bwd(
    const void* z, const void* w, const void* mu, const void* rs,
    const void* g, const void* gz, void* dz, void* part, void* dw, void* db,
    int blocks, int rows, int d, int dtype, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  return bwd_any(z, w, mu, rs, g, gz, dz, part, dw, db, blocks, rows, d,
                 dtype, stream);
}
