// Flash attention for Hopper (sm_90a): causal or full multi-head
// self-attention over [B, H, S, D], forward and backward.
//
// Replaces the TPU's splash attention kernel as the JAX package builds it
// (paddle_tpu/ops/pallas/flash_attention.py:_splash_kernel, entered
// through splash_mha): the forward and its fused dq/dkv backward. The
// query arrives already scaled (and rounded to its dtype) by the
// wrapper, so every kernel here runs with scale 1:
//   forward   s = q k^T (keys j <= i when causal), p = exp(s - lse),
//             out = p v, lse = m + log(sum exp(s - m)) kept in fp32;
//   backward  delta_i = sum_d dout_i * out_i (a pre-pass), then
//             p = exp(q k^T - lse), dp = dout v^T, ds = p (dp - delta),
//             dv = p^T dout, dk = ds^T q (one pass over query tiles per
//             key tile) and dq = ds k (one pass over key tiles per query
//             tile): no atomics, so the result is deterministic.
// Operands are fp32, bf16 or fp16; accumulation and the softmax are
// fp32; outputs take the operands' dtype. D is 64 or 128; any S >= 1.
//
// The same forward also replaces the package's own hand-written forward
// (paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel, entered through
// flash_attention() over the paddle layout [B, S, H, D], D 128 or 256):
// its entry reads q, k and v in place with rows H * D apart (no transpose
// copies), scales the query tile by `scale` and rounds it to its dtype as
// it is staged, divides by max(l, 1e-30) as that kernel does, and keeps
// no logsumexp (its backward is plain tensor code). At D = 256 a 64-row
// tile's output accumulator is 128 fp32 registers a thread; the tile and
// the warp's 16 rows stay as at D = 128.
//
// The splash kernel's segmented variant (_splash_kernel(segmented=True),
// entered through splash_mha(kv_keep=): segment ids q = kv = kv_keep)
// is the same forward with a compile-time switch (kSeg): each key tile's
// int32 segment ids are staged in shared memory beside K and V, each
// thread keeps its query rows' ids in registers, and a score whose key
// lies in another segment is masked like one above the diagonal. So a
// padded query sees only padding and a real one only real tokens. The
// instantiations without the switch compile as before. Masking breaks
// the invariant the plain forward rests on (every visited tile holds a
// visible key for every row): a row can meet a tile with no key of its
// segment, before any that has one, and its running max is then -inf;
// the kernel takes 0 as that row's reference, so the tile adds p = 0 and
// alpha = 0 and no NaN. Every row has at least one key of its segment
// (itself), so the final sum is positive. At BERT-base's shapes
// ([64, 12, 128, 64] and [16, 12, 512, 64] bf16) the work is bound by
// bytes (~50.7 MB, 0.0151 ms at 3.35 TB/s). Key tiles outside a query
// tile's segments are visited all the same; skipping them is speed for
// later.
//
// What bounds it: at the train step's shapes ([8, 16, 1024, 64] bf16)
// the forward moves ~67 MB and does ~1.7e10 flops, the backward ~2.5x
// those flops: the card's bound is set by bytes for the forward and by
// tensor-core flops for the backward. So the work is kept on chip:
//   * a block of 128 threads owns a 64-row tile (queries, or keys in the
//     dk/dv pass) and walks the other operand's 64-row tiles, staged
//     through shared memory, so each q/k/v/dout row is read from device
//     memory once per tile pair and S x S scores never reach device
//     memory;
//   * causal tiles above the diagonal are never visited, and only the
//     diagonal tile (and the ragged last tile) is masked; query tiles are
//     issued heaviest first.
// 16-bit operands take the tensor cores (mma.sync m16n8k16, the path the
// train step runs; described at its kernels below). fp32 operands keep
// fp32 products on the CUDA cores: each thread owns a 4 x 8 block of the
// 64 x 64 score tile (rows rg + 16i, columns cg + 8j) and a 4 x D/8 block
// of the output tile; rows of a tile live in 8 neighbouring lanes, so
// row max and row sum are three shuffles; shared rows, staged as fp32,
// are padded by 4 floats so the 16-byte shared-memory loads are free of
// bank conflicts. Next for speed: wgmma with TMA-fed, double-buffered
// tiles.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/flash_attention.py), launched on the caller's
// stream, allocating nothing (the wrapper passes delta's scratch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;      // rows of a query or key tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kLP = kTile + 4;  // padded row of a 64-wide score tile

// Where head bh's [S, D] slice of the paddle-layout entry's [B, S, H, D]
// operands starts (batch = S * H * D, head = D) and how far apart its
// rows lie (ld = H * D).
struct Layout {
  int H;
  long long batch, head;
  int ld;
  __device__ __forceinline__ long long offset(int bh) const {
    return (long long)(bh / H) * batch + (long long)(bh % H) * head;
  }
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

// x rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}


__device__ __forceinline__ float group_max(float x) {  // over 8 lanes
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {  // over 8 lanes
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// ------------------------------------------------------------------------
// CUDA-core path for fp32 operands.

// Rows [row0, row0 + 64) of an [S, D] slice whose rows lie `ld` elements
// apart into shared memory as fp32 with row stride D + 4, times `scale`
// rounded to T (the query's scaling); rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, int ld, float scale = 1.f) {
  constexpr int LD = D + 4;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < kTile * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    float f[VEC];
    if (row0 + r < S) {
      const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(
          src + (long long)(row0 + r) * ld + c);
#pragma unroll
      for (int t = 0; t < VEC; ++t) f[t] = to_float(x.v[t]);
      if (scale != 1.f) {
#pragma unroll
        for (int t = 0; t < VEC; ++t) f[t] = round_to<T>(f[t] * scale);
      }
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) f[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < VEC; t += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + t) =
          make_float4(f[t], f[t + 1], f[t + 2], f[t + 3]);
  }
}

// s[i][j] = sum_d A[rg + 16i][d] * B[cg + 8j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int rg, int cg, float s[4][8]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (cg + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        s[i][j] = fmaf(a[i].w, b[j].w, x);
      }
  }
}

// acc[i][4jj + t] += sum_k P[rg + 16i][k] * V[k][32jj + 4cg + t], with P
// a staged 64 x 64 tile (stride kLP) and V a staged 64 x D tile.
template <int D>
__device__ __forceinline__ void mul_tile(const float* P, const float* V,
                                         int rg, int cg,
                                         float acc[4][D / 8]) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (rg + 16 * i) * kLP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        const float4 v = *reinterpret_cast<const float4*>(
            V + (k + kk) * LD + 32 * jj + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = kk == 0 ? p[i].x
                           : kk == 1 ? p[i].y
                           : kk == 2 ? p[i].z
                                     : p[i].w;
          acc[i][4 * jj + 0] = fmaf(pk, v.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pk, v.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pk, v.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pk, v.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// Row `row` of a [S, D] output whose rows lie `ld` elements apart: this
// thread's 4 x D/8 values times `f` (divided by `f` with kDiv).
template <typename T, int D, bool kDiv = false>
__device__ __forceinline__ void store_row(T* dst, int row, int cg,
                                          const float* acc, float f, int ld) {
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj) {
    Vec<T, 4> o;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      o.v[t] = from_float<T>(kDiv ? acc[4 * jj + t] / f : acc[4 * jj + t] * f);
    *reinterpret_cast<Vec<T, 4>*>(dst + (long long)row * ld + 32 * jj +
                                  4 * cg) = o;
  }
}

// kPaddle: the paddle-layout entry (rows `lay.ld` apart, q scaled as it
// is staged, out = acc / max(l, 1e-30), no lse); else the splash entry
// (contiguous [BH, S, D], scale 1, out = acc * (1 / l), lse kept).
// kSeg (splash entry only): a query sees a key only where their segment
// ids seg[b, i] and seg[b, j] are equal (lay.H heads a batch entry).
template <typename T, int D, bool kPaddle, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ seg, int S,
                 int causal, Layout lay, float scale) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  int* Segs = reinterpret_cast<int*>(Ps + kTile * kLP);  // the key tile's
  const int ntiles = (S + kTile - 1) / kTile;
  const int qt = ntiles - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const long long off =
      kPaddle ? lay.offset(blockIdx.x) : (long long)blockIdx.x * S * D;
  const int ld = kPaddle ? lay.ld : D;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int* segb =
      kSeg ? seg + (long long)(blockIdx.x / lay.H) * S : nullptr;

  if constexpr (kPaddle)
    load_tile<T, D>(Qs, q + off, q0, S, ld, scale);
  else
    load_tile<T, D>(Qs, q + off, q0, S, D);
  float m[4], l[4], acc[4][D / 8];
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
    if constexpr (kSeg) {
      const int qi = q0 + rg + 16 * i;
      qseg[i] = qi < S ? segb[qi] : 0;
    }
  }
  const int nkt = causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + off, k0, S, ld);
    load_tile<T, D>(Vs, v + off, k0, S, ld);
    if (kSeg && threadIdx.x < kTile)
      Segs[threadIdx.x] = k0 + threadIdx.x < S ? segb[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[4][8];
    dot_tile<D>(Qs, Ks, rg, cg, s);
    if (kSeg || k0 + kTile > S || (causal && k0 + kTile - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = k0 + cg + 8 * j, qi = q0 + rg + 16 * i;
          if (key >= S || (causal && key > qi) ||
              (kSeg && Segs[cg + 8 * j] != qseg[i]))
            s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      // without segments every visited tile holds a visible key for every
      // row (key k0 is never past S nor past a row of a tile on or below
      // the diagonal), so m_new is finite. With them a row may have seen
      // no key of its segment yet: m_new is then -inf, and 0 stands in
      // for it, so that alpha and p are 0 and not NaN.
      const float m_new = fmaxf(m[i], group_max(mx));
      const float m_ref = kSeg && m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_ref);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_ref);
        psum += p;
        Ps[(rg + 16 * i) * kLP + cg + 8 * j] = p;
      }
      l[i] = l[i] * alpha + psum;  // this lane's columns only
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mul_tile<D>(Ps, Vs, rg, cg, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsum = group_sum(l[i]);
    const int qi = q0 + rg + 16 * i;
    if (qi < S) {
      if constexpr (kPaddle) {
        store_row<T, D, true>(out + off, qi, cg, acc[i], fmaxf(lsum, 1e-30f),
                              ld);
      } else {
        store_row<T, D>(out + off, qi, cg, acc[i], 1.f / lsum, D);
        if (cg == 0) lse[(long long)blockIdx.x * S + qi] = m[i] + logf(lsum);
      }
    }
  }
}

// delta[row] = sum_d dout[row][d] * out[row][d] in fp32, a warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    s += to_float(out[row * D + c]) * to_float(dout[row * D + c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

// dk and dv for one key tile, walking the query tiles that see it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int causal) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ts = dOs + kTile * LD;     // p^T, then ds^T
  float* lse_s = Ts + kTile * kLP;  // the query tile's lse and delta
  float* delta_s = lse_s + kTile;
  const int ntiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles
  const int k0 = kt * kTile;
  const long long off = (long long)blockIdx.x * S * D;
  const long long roff = (long long)blockIdx.x * S;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  load_tile<T, D>(Ks, k + off, k0, S, D);
  load_tile<T, D>(Vs, v + off, k0, S, D);
  float adk[4][D / 8], adv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int qt = causal ? kt : 0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Qs, q + off, q0, S, D);
    load_tile<T, D>(dOs, dout + off, q0, S, D);
    if (threadIdx.x < kTile) {
      const bool ok = q0 + threadIdx.x < S;
      lse_s[threadIdx.x] = ok ? lse[roff + q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[roff + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    // rows: keys k0 + rg + 16i; columns: queries q0 + cg + 8j
    float p[4][8], ds[4][8];
    dot_tile<D>(Ks, Qs, rg, cg, p);
    dot_tile<D>(Vs, dOs, rg, cg, ds);
    const bool edge = q0 + kTile > S || k0 + kTile > S ||
                      (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + rg + 16 * i, qi = q0 + cg + 8 * j;
        const bool masked =
            edge && (qi >= S || key >= S || (causal && key > qi));
        const float pv = masked ? 0.f : expf(p[i][j] - lse_s[cg + 8 * j]);
        p[i][j] = pv;
        ds[i][j] = pv * (ds[i][j] - delta_s[cg + 8 * j]);
        Ts[(rg + 16 * i) * kLP + cg + 8 * j] = pv;
      }
    __syncthreads();
    mul_tile<D>(Ts, dOs, rg, cg, adv);  // dv += p^T dout
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Ts[(rg + 16 * i) * kLP + cg + 8 * j] = ds[i][j];
    __syncthreads();
    mul_tile<D>(Ts, Qs, rg, cg, adk);   // dk += ds^T q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg + 16 * i;
    if (key < S) {
      store_row<T, D>(dk + off, key, cg, adk[i], 1.f, D);
      store_row<T, D>(dv + off, key, cg, adv[i], 1.f, D);
    }
  }
}

// dq for one query tile, walking the key tiles it sees.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int causal) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;
  const int ntiles = (S + kTile - 1) / kTile;
  const int qt = ntiles - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const long long off = (long long)blockIdx.x * S * D;
  const long long roff = (long long)blockIdx.x * S;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;

  load_tile<T, D>(Qs, q + off, q0, S, D);
  load_tile<T, D>(dOs, dout + off, q0, S, D);
  float row_lse[4], row_delta[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    row_lse[i] = qi < S ? lse[roff + qi] : 0.f;
    row_delta[i] = qi < S ? delta[roff + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const int nkt = causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + off, k0, S, D);
    load_tile<T, D>(Vs, v + off, k0, S, D);
    __syncthreads();
    float p[4][8], dp[4][8];
    dot_tile<D>(Qs, Ks, rg, cg, p);
    dot_tile<D>(dOs, Vs, rg, cg, dp);
    const bool edge = k0 + kTile > S || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cg + 8 * j, qi = q0 + rg + 16 * i;
        const bool masked = edge && (key >= S || (causal && key > qi));
        const float pv = masked ? 0.f : expf(p[i][j] - row_lse[i]);
        dSs[(rg + 16 * i) * kLP + cg + 8 * j] =
            pv * (dp[i][j] - row_delta[i]);
      }
    __syncthreads();
    mul_tile<D>(dSs, Ks, rg, cg, acc);  // dq += ds k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi < S) store_row<T, D>(dq + off, qi, cg, acc[i], 1.f, D);
  }
}

// ------------------------------------------------------------------------
// Tensor-core path for 16-bit operands (bf16, fp16): the same three
// passes, each 64-row tile split over 4 warps of 16 rows, every product
// an mma.sync m16n8k16 with fp32 accumulation. Tiles are staged in shared
// memory in their own dtype (rows padded by 8 elements, so ldmatrix reads
// them without bank conflicts); a score tile stays in registers in the
// mma accumulator layout and is rounded to the operand dtype where it
// feeds the next product (p before p v, ds before ds k and ds^T q), as the
// splash kernel rounds p to v's dtype. Row max, row sum and the softmax
// stay fp32.

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int D>
__host__ __device__ constexpr int ld16() { return D + 8; }  // padded row

// Rows [row0, row0 + 64) of an [S, D] 16-bit slice whose rows lie `ld`
// elements apart into a shared tile, times `scale` rounded to T (the
// query's scaling; as they are at scale 1); rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile16(T* dst, const T* src, int row0,
                                            int S, int ld,
                                            float scale = 1.f) {
  constexpr int LDS = ld16<D>();
  constexpr int PER_ROW = D / 8;  // 16-byte vectors
  for (int idx = threadIdx.x; idx < kTile * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      x = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + c);
    if (scale != 1.f) {
      T* e = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int t = 0; t < 8; ++t) e[t] = from_float<T>(to_float(e[t]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = x;
  }
}

// s[nt] (16 x 8 accumulator tiles, nt < 8) = this warp's 16 rows of
// the tile As times the 64 rows of the tile Bs, transposed:
// s[i][j] = a_i . b_j over D.
template <typename T, int D>
__device__ __forceinline__ void mma_rows(float s[8][4], const T* As,
                                         const T* Bs, int warp, int lane) {
  constexpr int LDS = ld16<D>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, As + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS +
                   kc * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Bs + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * LDS +
                     kc * 16 + 8 * ((lane >> 3) & 1));
      Mma<T>::run(s[2 * np], a, b[0], b[1]);
      Mma<T>::run(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P (16 x 64, accumulator layout, rounded to T) times the
// 64 x D tile Vs.
template <typename T, int D>
__device__ __forceinline__ void mma_pv(float acc[D / 8][4],
                                       const float p[8][4], const T* Vs,
                                       int lane) {
  constexpr int LDS = ld16<D>();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a[4] = {Mma<T>::pack(p[2 * kc][0], p[2 * kc][1]),
                           Mma<T>::pack(p[2 * kc][2], p[2 * kc][3]),
                           Mma<T>::pack(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           Mma<T>::pack(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Vs + (kc * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDS +
                       (2 * dp + (lane >> 4)) * 8);
      Mma<T>::run(acc[2 * dp], a, b[0], b[1]);
      Mma<T>::run(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Row `row` (this lane's quad share: columns 8nt + 2t, +1) of a [S, D]
// 16-bit output whose rows lie `ld` elements apart, from accumulator half
// h (0: row g, 1: row g + 8), times `f` (divided by `f` with kDiv).
template <typename T, int D, bool kDiv = false>
__device__ __forceinline__ void store_row16(T* dst, int row, int t,
                                            const float acc[D / 8][4], int h,
                                            float f, int ld) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const float lo = acc[nt][2 * h], hi = acc[nt][2 * h + 1];
    *reinterpret_cast<uint32_t*>(dst + (long long)row * ld + nt * 8 + 2 * t) =
        kDiv ? Mma<T>::pack(lo / f, hi / f) : Mma<T>::pack(lo * f, hi * f);
  }
}

// kPaddle and kSeg as flash_fwd_kernel's.
template <typename T, int D, bool kPaddle, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ seg,
                     int S, int causal, Layout lay, float scale) {
  constexpr int LDS = ld16<D>();
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + kTile * LDS;
  T* Vs = Ks + kTile * LDS;
  int* Segs = reinterpret_cast<int*>(Vs + kTile * LDS);  // the key tile's
  const int ntiles = (S + kTile - 1) / kTile;
  const int qt = ntiles - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const long long off =
      kPaddle ? lay.offset(blockIdx.x) : (long long)blockIdx.x * S * D;
  const int ld = kPaddle ? lay.ld : D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int* segb =
      kSeg ? seg + (long long)(blockIdx.x / lay.H) * S : nullptr;

  if constexpr (kPaddle)
    load_tile16<T, D>(Qs, q + off, q0, S, ld, scale);
  else
    load_tile16<T, D>(Qs, q + off, q0, S, D);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[D / 8][4];
  int qseg[2];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  if constexpr (kSeg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + warp * 16 + g + 8 * h;
      qseg[h] = qi < S ? segb[qi] : 0;
    }
  }
  const int nkt = causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile16<T, D>(Ks, k + off, k0, S, ld);
    load_tile16<T, D>(Vs, v + off, k0, S, ld);
    if (kSeg && threadIdx.x < kTile)
      Segs[threadIdx.x] = k0 + threadIdx.x < S ? segb[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[8][4];
    mma_rows<T, D>(s, Qs, Ks, warp, lane);
    if (kSeg || k0 + kTile > S || (causal && k0 + kTile - 1 > q0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int key = k0 + col;
          const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
          if (key >= S || (causal && key > qi) ||
              (kSeg && Segs[col] != qseg[e >> 1]))
            s[nt][e] = -INFINITY;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // finite without segments (every visited tile holds a visible key
      // for every row); with them -inf stands for no key yet, as in
      // flash_fwd_kernel
      const float m_new = fmaxf(m[h], mx);
      const float m_ref = kSeg && m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[h] - m_ref);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * h] = expf(s[nt][2 * h] - m_ref);
        s[nt][2 * h + 1] = expf(s[nt][2 * h + 1] - m_ref);
        psum += s[nt][2 * h] + s[nt][2 * h + 1];
      }
      l[h] = l[h] * alpha + psum;  // this lane's columns only
      m[h] = m_new;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][2 * h] *= alpha;
        acc[nt][2 * h + 1] *= alpha;
      }
    }
    mma_pv<T, D>(acc, s, Vs, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int qi = q0 + warp * 16 + g + 8 * h;
    if (qi < S) {
      if constexpr (kPaddle) {
        store_row16<T, D, true>(out + off, qi, t, acc, h, fmaxf(lsum, 1e-30f),
                                ld);
      } else {
        store_row16<T, D>(out + off, qi, t, acc, h, 1.f / lsum, D);
        if (t == 0) lse[(long long)blockIdx.x * S + qi] = m[h] + logf(lsum);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int S,
                          int causal) {
  constexpr int LDS = ld16<D>();
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + kTile * LDS;
  T* Qs = Vs + kTile * LDS;
  T* dOs = Qs + kTile * LDS;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * LDS);
  float* delta_s = lse_s + kTile;
  const int ntiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles
  const int k0 = kt * kTile;
  const long long off = (long long)blockIdx.x * S * D;
  const long long roff = (long long)blockIdx.x * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile16<T, D>(Ks, k + off, k0, S, D);
  load_tile16<T, D>(Vs, v + off, k0, S, D);
  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  for (int qt = causal ? kt : 0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile16<T, D>(Qs, q + off, q0, S, D);
    load_tile16<T, D>(dOs, dout + off, q0, S, D);
    if (threadIdx.x < kTile) {
      const bool ok = q0 + threadIdx.x < S;
      lse_s[threadIdx.x] = ok ? lse[roff + q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[roff + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    // rows: this warp's 16 keys; columns: the tile's 64 queries
    float p[8][4], ds[8][4];
    mma_rows<T, D>(p, Ks, Qs, warp, lane);
    mma_rows<T, D>(ds, Vs, dOs, warp, lane);
    const bool edge = q0 + kTile > S || k0 + kTile > S ||
                      (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int key = k0 + warp * 16 + g + 8 * (e >> 1), qi = q0 + col;
        const bool masked =
            edge && (qi >= S || key >= S || (causal && key > qi));
        const float pv = masked ? 0.f : expf(p[nt][e] - lse_s[col]);
        p[nt][e] = pv;
        ds[nt][e] = pv * (ds[nt][e] - delta_s[col]);
      }
    mma_pv<T, D>(adv, p, dOs, lane);   // dv += p^T dout
    mma_pv<T, D>(adk, ds, Qs, lane);   // dk += ds^T q
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    if (key < S) {
      store_row16<T, D>(dk + off, key, t, adk, h, 1.f, D);
      store_row16<T, D>(dv + off, key, t, adv, h, 1.f, D);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int causal) {
  constexpr int LDS = ld16<D>();
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* dOs = Qs + kTile * LDS;
  T* Ks = dOs + kTile * LDS;
  T* Vs = Ks + kTile * LDS;
  const int ntiles = (S + kTile - 1) / kTile;
  const int qt = ntiles - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const long long off = (long long)blockIdx.x * S * D;
  const long long roff = (long long)blockIdx.x * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile16<T, D>(Qs, q + off, q0, S, D);
  load_tile16<T, D>(dOs, dout + off, q0, S, D);
  float row_lse[2], row_delta[2], acc[D / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    row_lse[h] = qi < S ? lse[roff + qi] : 0.f;
    row_delta[h] = qi < S ? delta[roff + qi] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int nkt = causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile16<T, D>(Ks, k + off, k0, S, D);
    load_tile16<T, D>(Vs, v + off, k0, S, D);
    __syncthreads();
    float p[8][4], ds[8][4];
    mma_rows<T, D>(p, Qs, Ks, warp, lane);
    mma_rows<T, D>(ds, dOs, Vs, warp, lane);
    const bool edge = k0 + kTile > S || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int qi = q0 + warp * 16 + g + 8 * (e >> 1);
        const bool masked = edge && (key >= S || (causal && key > qi));
        const float pv =
            masked ? 0.f : expf(p[nt][e] - row_lse[e >> 1]);
        ds[nt][e] = pv * (ds[nt][e] - row_delta[e >> 1]);
      }
    mma_pv<T, D>(acc, ds, Ks, lane);  // dq += ds k
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    if (qi < S) store_row16<T, D>(dq + off, qi, t, acc, h, 1.f, D);
  }
}

template <int D, bool kSeg>
constexpr int fwd_smem() {
  return (3 * kTile * (D + 4) + kTile * kLP + (kSeg ? kTile : 0)) * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return (4 * kTile * (D + 4) + kTile * kLP + 2 * kTile) * 4;
}
template <int D>
constexpr int dq_smem() { return (4 * kTile * (D + 4) + kTile * kLP) * 4; }
template <int D, bool kSeg>
constexpr int fwd_smem16() {
  return 3 * kTile * ld16<D>() * 2 + (kSeg ? kTile * 4 : 0);
}
template <int D>
constexpr int bwd_smem16() { return 4 * kTile * ld16<D>() * 2 + 2 * kTile * 4; }

// Raises the kernel's dynamic shared memory limit to SMEM and launches
// it on `grid`; returns from the caller on any error.
#define PADDLE_FLASH_LAUNCH(KERN, SMEM, ...)                                \
  do {                                                                     \
    auto kern_ = KERN;                                                     \
    cudaError_t e_ = cudaFuncSetAttribute(                                 \
        kern_, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);         \
    if (e_ != cudaSuccess) return e_;                                      \
    kern_<<<grid, kThreads, SMEM, stream>>>(__VA_ARGS__);                  \
    e_ = cudaGetLastError();                                               \
    if (e_ != cudaSuccess) return e_;                                      \
  } while (0)

template <typename T, int D, bool kPaddle, bool kSeg>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* seg, int BH, int S, int causal,
                Layout lay, float scale, cudaStream_t stream) {
  const dim3 grid(BH, (S + kTile - 1) / kTile);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if constexpr (sizeof(T) == 4) {
    PADDLE_FLASH_LAUNCH((flash_fwd_kernel<T, D, kPaddle, kSeg>),
                        (fwd_smem<D, kSeg>()), qp, kp, vp, op, lse, seg, S,
                        causal, lay, scale);
  } else {
    PADDLE_FLASH_LAUNCH((flash_fwd_mma_kernel<T, D, kPaddle, kSeg>),
                        (fwd_smem16<D, kSeg>()), qp, kp, vp, op, lse, seg, S,
                        causal, lay, scale);
  }
  return cudaSuccess;
}

// One forward over dtype code `dtype`: the splash entry at head_dim 64 or
// 128, with segment ids where `seg` is given, the paddle-layout entry
// (`paddle`) at 128 or 256.
cudaError_t fwd_any(const void* q, const void* k, const void* v, void* out,
                    float* lse, const int* seg, int BH, int S, int D,
                    int dtype, int causal, bool paddle, Layout lay,
                    float scale, cudaStream_t st) {
#define PADDLE_FLASH_FWD(T, HD, P, SG)                                    \
  return fwd<T, HD, P, SG>(q, k, v, out, lse, seg, BH, S, causal, lay,   \
                           scale, st)
#define PADDLE_FLASH_FWD_DTYPES(HD, P, SG)                    \
  if (dtype == 0) PADDLE_FLASH_FWD(float, HD, P, SG);         \
  if (dtype == 1) PADDLE_FLASH_FWD(__nv_bfloat16, HD, P, SG); \
  if (dtype == 2) PADDLE_FLASH_FWD(__half, HD, P, SG);
  if (!paddle && D == 64 && seg) {
    PADDLE_FLASH_FWD_DTYPES(64, false, true)
  } else if (!paddle && D == 128 && seg) {
    PADDLE_FLASH_FWD_DTYPES(128, false, true)
  } else if (!paddle && D == 64) {
    PADDLE_FLASH_FWD_DTYPES(64, false, false)
  } else if (!paddle && D == 128) {
    PADDLE_FLASH_FWD_DTYPES(128, false, false)
  } else if (paddle && D == 128) {
    PADDLE_FLASH_FWD_DTYPES(128, true, false)
  } else if (paddle && D == 256) {
    PADDLE_FLASH_FWD_DTYPES(256, true, false)
  }
#undef PADDLE_FLASH_FWD_DTYPES
#undef PADDLE_FLASH_FWD
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int BH, int S, int causal,
                cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = (long long)BH * S;
  flash_delta_kernel<T, D>
      <<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads,
         0, stream>>>(static_cast<const T*>(out), dop, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (S + kTile - 1) / kTile);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  if constexpr (sizeof(T) == 4) {
    PADDLE_FLASH_LAUNCH((flash_bwd_dkdv_kernel<T, D>), dkdv_smem<D>(), qp,
                        kp, vp, dop, lse, delta, dkp, dvp, S, causal);
    PADDLE_FLASH_LAUNCH((flash_bwd_dq_kernel<T, D>), dq_smem<D>(), qp, kp,
                        vp, dop, lse, delta, dqp, S, causal);
  } else {
    PADDLE_FLASH_LAUNCH((flash_bwd_dkdv_mma_kernel<T, D>), bwd_smem16<D>(),
                        qp, kp, vp, dop, lse, delta, dkp, dvp, S, causal);
    PADDLE_FLASH_LAUNCH((flash_bwd_dq_mma_kernel<T, D>), bwd_smem16<D>(), qp,
                        kp, vp, dop, lse, delta, dqp, S, causal);
  }
  return cudaSuccess;
}

#undef PADDLE_FLASH_LAUNCH

bool valid(int BH, int S) {
  return BH > 0 && S > 0 && (S + kTile - 1) / kTile <= 65535;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. The splash
// entries take head_dim 64 or 128 and contiguous [BH, S, head_dim]
// operands with scale 1 (the query arrives scaled), lse and delta fp32
// [BH, S]. Each returns a cudaError_t; 0 when every kernel launched.
extern "C" int paddle_tpu_torch_flash_fwd(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int BH, int S,
                                          int head_dim, int dtype,
                                          int causal, void* stream) {
  if (!valid(BH, S) || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  return (int)fwd_any(q, k, v, out, static_cast<float*>(lse), nullptr, BH,
                      S, head_dim, dtype, causal, false, Layout{}, 1.f,
                      static_cast<cudaStream_t>(stream));
}

// The segmented forward (splash_mha(kv_keep=)'s K1c): the splash entry's
// operands and lse over B * H heads, with int32 segment ids [B, S] of
// queries and keys alike; a query sees a key only of its own segment.
extern "C" int paddle_tpu_torch_flash_fwd_seg(const void* q, const void* k,
                                              const void* v, const void* seg,
                                              void* out, void* lse, int B,
                                              int H, int S, int head_dim,
                                              int dtype, int causal,
                                              void* stream) {
  if (B <= 0 || H <= 0 || !valid(B * H, S) || seg == nullptr ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const Layout lay{H, 0, 0, 0};
  return (int)fwd_any(q, k, v, out, static_cast<float*>(lse),
                      static_cast<const int*>(seg), B * H, S, head_dim,
                      dtype, causal, false, lay, 1.f,
                      static_cast<cudaStream_t>(stream));
}

// The paddle-layout forward (flash_attention()'s K1b): contiguous
// [B, S, H, head_dim] operands read in place (rows H * head_dim apart),
// head_dim 128 or 256; the query is scaled by `scale` and rounded to its
// dtype as its tile is staged; no logsumexp is kept.
extern "C" int paddle_tpu_torch_flash_fwd_bshd(const void* q, const void* k,
                                               const void* v, void* out,
                                               int B, int S, int H,
                                               int head_dim, int dtype,
                                               int causal, float scale,
                                               void* stream) {
  if (B <= 0 || H <= 0 || !valid(B * H, S) ||
      (head_dim != 128 && head_dim != 256))
    return (int)cudaErrorInvalidValue;
  const Layout lay{H, (long long)S * H * head_dim, head_dim, H * head_dim};
  return (int)fwd_any(q, k, v, out, nullptr, nullptr, B * H, S, head_dim,
                      dtype, causal, true, lay, scale,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int paddle_tpu_torch_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int BH, int S, int head_dim, int dtype, int causal,
    void* stream) {
  if (!valid(BH, S)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PADDLE_FLASH_BWD(T, D)                                             \
  return (int)bwd<T, D>(q, k, v, out, dout, l, dl, dq, dk, dv, BH, S,    \
                        causal, st)
  if (head_dim == 64) {
    if (dtype == 0) PADDLE_FLASH_BWD(float, 64);
    if (dtype == 1) PADDLE_FLASH_BWD(__nv_bfloat16, 64);
    if (dtype == 2) PADDLE_FLASH_BWD(__half, 64);
  } else if (head_dim == 128) {
    if (dtype == 0) PADDLE_FLASH_BWD(float, 128);
    if (dtype == 1) PADDLE_FLASH_BWD(__nv_bfloat16, 128);
    if (dtype == 2) PADDLE_FLASH_BWD(__half, 128);
  }
#undef PADDLE_FLASH_BWD
  return (int)cudaErrorInvalidValue;
}
