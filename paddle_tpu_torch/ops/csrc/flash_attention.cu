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
// The package's own hand-written forward (paddle_tpu/ops/pallas/
// flash_attention.py:_fwd_kernel, entered through flash_attention() over
// the paddle layout [B, S, H, D], D 128 or 256) is replaced by the same
// arithmetic: its entry reads q, k and v in place with rows H * D apart
// (no transpose copies), scales the query tile by `scale` and rounds it
// to its dtype before its products, divides by max(l, 1e-30) as that
// kernel does, and keeps no logsumexp (its backward is plain tensor
// code). bf16 and fp16 take flash_fwd_bshd_wgmma_kernel (TMA + wgmma,
// described at it below); fp32 the CUDA-core forward with a layout
// template argument (kPaddle).
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
// bytes (~50.7 MB, 0.0151 ms at 3.35 TB/s). In fp32 that is the CUDA-core
// forward below; in bf16 and fp16 it is K1a's TMA + wgmma forward with
// kSeg, which never loads a key tile whose segment range cannot meet a
// query tile's (described at bshd:: below).
//
// Its backward in fp32 is the CUDA-core backward below with the same
// switch: the fixed tile's ids (keys in the dk/dv pass, queries in the
// dq pass) in registers, the walked tile's 64 ids in shared memory
// beside its lse and delta, and every tile taking the masked branch (an
// interior tile may pair two segments). A pair of two segments gets
// p = 0 exactly, never exp(-inf - lse): every row's lse is finite (each
// row sees its own key), so nothing stands in for a missing score. In
// bf16 and fp16 it is bwd16::flash_bwd_wgmma_kernel (TMA + wgmma, two
// passes, tile pairs whose segment ranges cannot meet skipped; described
// at it below). At BERT-base's shapes it moves ~101 MB ([64, 12, 128,
// 64], bytes bound) or does ~32 GFLOP over visible pairs at most
// ([16, 12, 512, 64]).
//
// What bounds it: at the train step's shapes ([8, 16, 1024, 64] bf16)
// the forward moves ~67 MB and does ~1.7e10 flops, the backward ~2.5x
// those flops: the card's bound is set by bytes for the forward and by
// tensor-core flops for the backward. So the work is kept on chip: a
// block owns a tile of queries (or keys in the backward's dk/dv pass)
// and walks the other operand's tiles, staged through shared memory, so
// each q/k/v/dout row is read from device memory once per tile pair and
// S x S scores never reach device memory; causal tiles above the
// diagonal are never visited, and only tiles that cross it (or hold rows
// past S) are masked; the heaviest causal tiles are issued first.
// 16-bit operands of the splash entry without segments (K1a, the path
// the train step runs) take the Hopper kernels: the forward is the
// paddle-layout forward's TMA + wgmma kernel (bshd::, kLse) over K1a's
// [BH, S, D] read as [B = BH, S, H = 1, D], storing the logsumexp; the
// backward is bwd16's persistent TMA + wgmma kernel without segments
// (kSeg false), its items in an order that balances causal walks. K1c's
// 16-bit forward is the same forward with kSeg. fp32 operands keep
// fp32 products on the CUDA cores: each thread owns a 4 x 8 block of the
// 64 x 64 score tile (rows rg + 16i, columns cg + 8j) and a 4 x D/8 block
// of the output tile; rows of a tile live in 8 neighbouring lanes, so
// row max and row sum are three shuffles; shared rows, staged as fp32,
// are padded by 4 floats so the 16-byte shared-memory loads are free of
// bank conflicts (64-row tiles of 128 threads).
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/flash_attention.py), launched on the caller's
// stream, allocating nothing (the wrapper passes delta's scratch).

#include <algorithm>

#include "hopper.cuh"

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
// kSeg: a key sees a query only where their segment ids seg[b, i] and
// seg[b, j] are equal (H heads a batch entry).
template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, const int* __restrict__ seg, int S,
                      int H, int causal) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ts = dOs + kTile * LD;     // p^T, then ds^T
  float* lse_s = Ts + kTile * kLP;  // the query tile's lse, delta, ids
  float* delta_s = lse_s + kTile;
  int* Segs = reinterpret_cast<int*>(delta_s + kTile);
  const int ntiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // low key tiles see the most query tiles
  const int k0 = kt * kTile;
  const long long off = (long long)blockIdx.x * S * D;
  const long long roff = (long long)blockIdx.x * S;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int* segb = kSeg ? seg + (long long)(blockIdx.x / H) * S : nullptr;

  load_tile<T, D>(Ks, k + off, k0, S, D);
  load_tile<T, D>(Vs, v + off, k0, S, D);
  float adk[4][D / 8], adv[4][D / 8];
  int kseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) adk[i][c] = adv[i][c] = 0.f;
    if constexpr (kSeg) {
      const int key = k0 + rg + 16 * i;
      kseg[i] = key < S ? segb[key] : 0;
    }
  }

  for (int qt = causal ? kt : 0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Qs, q + off, q0, S, D);
    load_tile<T, D>(dOs, dout + off, q0, S, D);
    if (threadIdx.x < kTile) {
      const bool ok = q0 + threadIdx.x < S;
      lse_s[threadIdx.x] = ok ? lse[roff + q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[roff + q0 + threadIdx.x] : 0.f;
      if constexpr (kSeg) Segs[threadIdx.x] = ok ? segb[q0 + threadIdx.x] : 0;
    }
    __syncthreads();
    // rows: keys k0 + rg + 16i; columns: queries q0 + cg + 8j
    float p[4][8], ds[4][8];
    dot_tile<D>(Ks, Qs, rg, cg, p);
    dot_tile<D>(Vs, dOs, rg, cg, ds);
    // with segments every tile may hold pairs of two segments
    const bool edge = kSeg || q0 + kTile > S || k0 + kTile > S ||
                      (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + rg + 16 * i, qi = q0 + cg + 8 * j;
        const bool masked =
            edge && (qi >= S || key >= S || (causal && key > qi) ||
                     (kSeg && Segs[cg + 8 * j] != kseg[i]));
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

// dq for one query tile, walking the key tiles it sees (with kSeg,
// every key tile, as the forward does).
template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ seg, int S, int H, int causal) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;
  int* Segs = reinterpret_cast<int*>(dSs + kTile * kLP);  // the key tile's
  const int ntiles = (S + kTile - 1) / kTile;
  const int qt = ntiles - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kTile;
  const long long off = (long long)blockIdx.x * S * D;
  const long long roff = (long long)blockIdx.x * S;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int* segb = kSeg ? seg + (long long)(blockIdx.x / H) * S : nullptr;

  load_tile<T, D>(Qs, q + off, q0, S, D);
  load_tile<T, D>(dOs, dout + off, q0, S, D);
  float row_lse[4], row_delta[4], acc[4][D / 8];
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    row_lse[i] = qi < S ? lse[roff + qi] : 0.f;
    row_delta[i] = qi < S ? delta[roff + qi] : 0.f;
    if constexpr (kSeg) qseg[i] = qi < S ? segb[qi] : 0;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const int nkt = causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + off, k0, S, D);
    load_tile<T, D>(Vs, v + off, k0, S, D);
    if (kSeg && threadIdx.x < kTile)
      Segs[threadIdx.x] = k0 + threadIdx.x < S ? segb[k0 + threadIdx.x] : 0;
    __syncthreads();
    float p[4][8], dp[4][8];
    dot_tile<D>(Qs, Ks, rg, cg, p);
    dot_tile<D>(dOs, Vs, rg, cg, dp);
    const bool edge =
        kSeg || k0 + kTile > S || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cg + 8 * j, qi = q0 + rg + 16 * i;
        const bool masked = edge && (key >= S || (causal && key > qi) ||
                                     (kSeg && Segs[cg + 8 * j] != qseg[i]));
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
// Two fp32 values rounded to a 16-bit T and packed into one 32-bit word
// (the low half first): the register operands of the wgmma kernels.

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <int D, bool kSeg>
constexpr int fwd_smem() {
  return (3 * kTile * (D + 4) + kTile * kLP + (kSeg ? kTile : 0)) * 4;
}
template <int D, bool kSeg>
constexpr int dkdv_smem() {
  return (4 * kTile * (D + 4) + kTile * kLP + (kSeg ? 3 : 2) * kTile) * 4;
}
template <int D, bool kSeg>
constexpr int dq_smem() {
  return (4 * kTile * (D + 4) + kTile * kLP + (kSeg ? kTile : 0)) * 4;
}

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

// The least and greatest segment id of the 64-row tile t of seg [B, S]
// (tile t: batch t / ceil(S / 64); rows at or past S left out), reduced
// over the 32 lanes of a warp: the ranges K1c's 16-bit kernels skip by.
__device__ __forceinline__ int2 tile_range(const int* __restrict__ seg, int S,
                                           int t, int lane) {
  const int nt = (S + 63) / 64, b = t / nt, r0 = (t % nt) * 64;
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int r = r0 + lane; r < min(r0 + 64, S); r += 32) {
    const int v = seg[(long long)b * S + r];
    lo = min(lo, v);
    hi = max(hi, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// ------------------------------------------------------------------------
// The paddle-layout forward for 16-bit operands (K1b), and K1a's: TMA +
// wgmma.
//
// q, k and v stay in place as [B, S, H, D]: one 4-D tensor map each over
// (D, H, S, B), boxes of 64 columns (128 bytes) x rows, zeros past S. A
// block owns a 128-row query tile of one (b, h): two consumer warpgroups
// of 64 rows each, and a producer warpgroup whose one thread loads the
// query tile once and the key and value tiles through two rings, one
// for K and one for V, each slot with its mbarrier pair: a key tile is freed as
// soon as its scores are in, a value tile once its P V is done, so the
// loads ahead are not held up by the tile whose P V is still in flight.
// S = Q K^T is a wgmma with both operands in shared memory (K K-major);
// p = exp(s - running max) stays in registers, rounded to T, as the A
// operand of the P V wgmma (V MN-major). A warpgroup issues the next
// tile's S = Q K^T and this tile's P V together and runs the next tile's
// softmax while P V is in flight; only then does it rescale the output
// and pack the next p. The warpgroups take turns to issue, so one's
// softmax overlaps the other's products. Before its first product a
// warpgroup multiplies its query rows by `scale` and rounds them to T in
// shared memory, as the TPU kernel scales q in its dtype. The output is
// acc / max(l, 1e-30), staged through the query tile's shared memory and
// stored in 16-byte rows; no logsumexp is kept. Causal blocks load only
// key tiles at or below the diagonal and a warpgroup skips a tile wholly
// above its rows; only tiles that hold keys past S or above a row take
// the mask (`-Xptxas -v` shows no wgmma serialized by that branch, which
// sits while P V is in flight). Blocks take heads in groups whose keys
// and values fit L2 together (16 MB: 32 heads at S = 1024, D = 128), a
// group's query tiles heaviest first: with every head's tile in flight
// at once, each wave would read all keys and values again from memory.
//
// Key tiles: 128 rows and 3 slots a ring at D = 128 (Q 32 KB + 3 x 2 x
// 32 KB), 64 rows and 2 slots at D = 256 (64 KB + 2 x 2 x 32 KB). The
// producer warpgroup gives its registers to the consumers (setmaxnreg 40
// / 232): the output accumulator is 64 (D = 128) or 128 (D = 256) fp32
// registers a thread beside the scores and p, past the 168 a thread that
// every thread of a block of 288 or 384 gets (with those 168, ptxas
// spills and serializes the wgmmas, C7512).
//
// K1a (the splash entry's contiguous [BH, S, D] without segments, bf16
// and fp16) is the same kernel with kLse: its operands are the paddle
// layout with B = BH and H = 1 (4-D maps over (D, 1, S, BH)), the query
// arrives scaled and rounded (no scaling pass), the output is acc *
// (1 / l) (l > 0: every row sees key 0) and each row's logsumexp m +
// log l, in the natural log, goes to the fp32 [BH, S] buffer from the
// same m and l that scaled the output. Its blocks are persistent (a
// block an SM walking the items in K1b's order, heads grouped for L2 and
// the heaviest query tiles first, so the static round robin stays
// balanced): the ring runs on across items, and with two query buffers
// (D = 64) the producer loads the next item's queries while the
// consumers finish this one and store its output, which hides the
// fixed cost a block an item pays at every item (tools/torch_flash_ab.py
// --sweep on an H100, [8, 16, 1024, 64] causal bf16: 0.0803 ms a block
// an item, 0.0743 persistent). At D = 64 the key tiles, ring depth
// and consumer warpgroups are K1a's own (kBN64, kStages64, kWG64;
// tools/torch_flash_ab.py --sweep times the others); at D = 128 K1a
// takes K1b's, with one query buffer.
//
// K1c (the segmented forward, splash_mha(kv_keep=), bf16 and fp16) is
// K1a's kernel with kSeg. A pre-pass (seg_ranges_kernel) writes each
// (batch, 64-row tile)'s least and greatest segment id. The producer is
// a warp: from those ranges (the next item's loaded while it issues this
// one's) it decides, for each key tile and each consumer warpgroup,
// whether the warpgroup needs the tile (the ranges of its 64 query rows
// and of the tile overlap, and causality allows it) and whether it must
// mask it (unless both ranges are one and the same id, and the tile
// holds no key past S and none above a row). A key tile no warpgroup
// needs is never loaded: its p would be exactly 0 for every row. A
// loaded tile's kBN ids travel with its K tile, in the same ring slot on
// the same full barrier (cp.async by the producer's lanes, zeros past
// S), with a header word: both warpgroups' flags, the tile's index and
// whether it is the item's last. The query tile's ids come the same way
// with the query tile. A warpgroup walks the loaded tiles, releases
// unread those it does not need (issuing first the P V it holds, so it
// never keeps a value slot across a tile it skips), and masks a score
// whose key lies at or past S, above the row (causal) or in another
// segment. Masking breaks K1a's invariant (every visited tile holds a
// visible key for every row): a row can meet a visited tile with no key
// of its segment before any that has one, and its running max is then
// -inf; 0 is then the reference, so the tile adds p = 0 and alpha = 0
// and no NaN. Every row sees its own key, so l > 0 at the end and the
// logsumexp of every row, padded ones too, is finite (K1c's backward
// reads it). The ids past S arrive as 0, a padding id: they never
// count, since a tile that holds keys past S takes the mask, whose test
// keeps key < S.

namespace bshd {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
// Bytes of keys and values the blocks in flight may share in L2 (of
// its 50 MB): heads are grouped to fit.
constexpr long long kL2Budget = 16LL << 20;
// K1a's blocks: persistent (a block an SM, walking items) or a block an
// item as K1b's
constexpr bool kLsePersist = true;
// K1a at D = 64: keys a tile, slots of each ring, consumer warpgroups
constexpr int kBN64 = 128, kStages64 = 4, kWG64 = 2;
// K1c's forward: keys a tile, and its blocks (persistent, or a block an
// item: the hardware balances items that skipping made unequal)
constexpr int kBNSeg = 128;
constexpr bool kSegPersist = true;
// K1c's producer warp's registers (setmaxnreg)
constexpr int kProdRegsSeg = 56;

template <int D, bool kSeg = false>
struct Cfg {
  static constexpr int kD = D;
  // consumer warpgroups, 64 query rows each, and a producer warpgroup
  // (K1c: two, the flags its producer writes)
  static constexpr int kWG = kSeg ? 2 : D == 64 ? kWG64 : 2;
  static constexpr int kBM = 64 * kWG;  // query rows a block
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;
  // registers a producer thread keeps (setmaxnreg), and a consumer
  // thread's: the rest of what the block holds (a thread's share of the
  // SM's 65536, in 8s, times kThreads), as setmaxnreg.inc waits until the
  // block has the registers it asks for: 232, or 160 with three consumer
  // warpgroups; K1c's producer warp, which decides which tiles to load,
  // keeps 56 and its consumers get 224
  static constexpr int kProdRegs = kSeg ? kProdRegsSeg : kWG == 3 ? 32 : 40;
  static constexpr int kRegs =
      (65536 / kThreads / 8 * 8 * kThreads - kProdRegs * 128) / kConsumers /
      8 * 8;
  static_assert(kProdRegs * 128 + kRegs * kConsumers <=
                    65536 / kThreads / 8 * 8 * kThreads,
                "setmaxnreg: the block's registers");
  // keys a tile
  static constexpr int kBN =
      kSeg ? kBNSeg : D == 64 ? kBN64 : D == 128 ? 128 : 64;
  // slots of each ring (K1c: four, and two at D = 128 beside its ids)
  static constexpr int kStages =
      kSeg ? (D == 128 ? 2 : 4) : D == 64 ? kStages64 : D == 128 ? 3 : 2;
  static constexpr int kChunks = D / 64;           // 128-byte column boxes
  static constexpr int kQChunk = kBM * 128;
  static constexpr int kKVChunk = kBN * 128;
  static constexpr int kTileBytes = kChunks * kKVChunk;  // K or V
  static constexpr int kQBytes = kChunks * kQChunk;
  // K1c: a key slot's ids and header word (padded to 16 bytes), and a
  // query buffer's ids
  static constexpr int kIdStride = kBN + 4;
  static constexpr int kKIdBytes = kSeg ? kStages * kIdStride * 4 : 0;
  static constexpr int kQIdBytes = kSeg ? kBM * 4 : 0;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                               (4 * kStages + 1) * 8 + kKIdBytes;
  static_assert(kSmem <= 232448, "shared memory of one block");
  // K1a's query tile buffers (two where they fit, so that a persistent
  // block loads its next item's queries while it finishes this one),
  // each with a full and an empty barrier, and its shared memory
  static constexpr int kLseQBufs =
      kSmem + kQBytes + 24 + 2 * kQIdBytes <= 232448 ? 2 : 1;
  static constexpr int kLseSmem = kSmem + (kLseQBufs - 1) * kQBytes +
                                  (2 * kLseQBufs - 1) * 8 +
                                  kLseQBufs * kQIdBytes;
};

// The softmax step of one key tile over this thread's scores s (rows
// r + 8 hh, r = the thread's first row): with kMask, keys at or past
// lim[hh] (S, or the row + 1 when causal; relative to the thread's first
// column) get -inf, and with kSeg also keys whose id (kid, the tile's
// ids from the thread's first column) is not the row's (qseg); the
// running max m moves to cover the tile, s becomes p = exp(s - m), and
// l = l alpha + sum p. Returns alpha = exp(m_old - m_new) per row, the
// factor the output still has to take.
template <int N, bool kMask, bool kSeg = false>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2],
                                             float (&l)[2],
                                             const int (&lim)[2],
                                             float (&alpha)[2],
                                             const int* __restrict__ kid =
                                                 nullptr,
                                             int2 qseg = int2{}) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      int2 ids{};
      if (kSeg && kMask) ids = *reinterpret_cast<const int2*>(kid + 8 * j);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * j + 2 * hh + u];
        if (kMask) {
          bool vis = 8 * j + u < lim[hh];
          if (kSeg) vis = vis && (u ? ids.y : ids.x) == (hh ? qseg.y : qseg.x);
          x = vis ? x : -INFINITY;
        }
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // finite without segments: key 0, in the first tile, is visible to
    // every row; with them -inf stands for no key of the row's segment
    // yet, and 0 is the reference
    const float m_new = fmaxf(m[hh], mx);
    const float ml = (kSeg && m_new == -INFINITY ? 0.f : m_new) * kLog2e;
    alpha[hh] = exp2_approx(fmaf(m[hh], kLog2e, -ml));
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * j + 2 * hh + u];
        x = exp2_approx(fmaf(x, kLog2e, -ml));
        psum += x;
      }
    l[hh] = l[hh] * alpha[hh] + psum;  // this lane's columns only
    m[hh] = m_new;
  }
}

// p (the scores after softmax_tile), rounded to T, as the A operands of
// the P V wgmma's k16 steps.
template <typename T, int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 16][4],
                                       const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      pa[kk][u] = Mma<T>::pack(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
}

// s = Q K^T over the warpgroup's query rows (at qs) and the key tile at
// ks.
template <typename T, typename C>
__device__ __forceinline__ void s_gemm(float (&s)[C::kBN / 2], uint32_t qs,
                                       uint32_t ks) {
#pragma unroll
  for (int st = 0; st < C::kD / 16; ++st)
    wgmma_ss<T, C::kBN, 0>(
        s, desc_k(qs + (st >> 2) * C::kQChunk + (st & 3) * 32),
        desc_k(ks + (st >> 2) * C::kKVChunk + (st & 3) * 32), st > 0);
}

// o += p V over the value tile at vs.
template <typename T, typename C>
__device__ __forceinline__ void pv_gemm(float (&o)[C::kD / 2],
                                        const uint32_t (&pa)[C::kBN / 16][4],
                                        uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk)
    wgmma_rs<T, C::kD, 1>(o, pa[kk], desc_mn(vs + kk * 2048, C::kKVChunk),
                          1);
}

// K1c's walk decision for warpgroup `wg` (first query row q0 + 64 wg,
// ids in [a.x, a.y]) and the key tile from key k0 (ids in [c.x, c.y]):
// 1 it needs the tile, 3 it needs it masked, 0 it does not.
template <int kBN>
__device__ __forceinline__ int seg_flags(int wg, int q0, int k0, int S,
                                         int causal, int2 a, int2 c) {
  const int r0 = q0 + 64 * wg;
  if (r0 >= S) return 0;
  const bool visit = (!causal || k0 <= min(r0 + 63, S - 1)) &&
                     a.x <= c.y && c.x <= a.y;
  const bool mask = k0 + kBN > S || (causal && k0 + kBN - 1 > r0) ||
                    !(a.x == a.y && c.x == c.y && a.x == c.x);
  return visit ? (mask ? 3 : 1) : 0;
}

// kLse: K1a (see above), lse its [BH, S] logsumexp, else unused. kSeg
// (with kLse): K1c, seg its [BH / nh, S] ids and ranges their
// [BH / nh, ceil(S / 64)] (least, greatest) ids a 64-row tile.
template <typename T, int D, bool kLse, bool kSeg>
__global__ void __launch_bounds__(Cfg<D, kSeg>::kThreads, 1)
flash_fwd_bshd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            T* __restrict__ out, float* __restrict__ lse,
                            const int* __restrict__ seg,
                            const int2* __restrict__ ranges, int nh, int S,
                            int H, int BH, int group, int causal,
                            float scale) {
  static_assert(kLse || !kSeg, "K1c keeps the logsumexp");
  using C = Cfg<D, kSeg>;
  constexpr int kBN = C::kBN, kStages = C::kStages, kBM = C::kBM;
  constexpr int kWG = C::kWG, kConsumers = C::kConsumers;
  constexpr int kQBufs = kLse ? C::kLseQBufs : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs =  // the query tile's buffers
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Kr = Qs + kQBufs * C::kQBytes;      // the key ring
  unsigned char* Vr = Kr + kStages * C::kTileBytes;  // the value ring
  uint64_t* kfull = reinterpret_cast<uint64_t*>(Vr + kStages * C::kTileBytes);
  uint64_t* kempty = kfull + kStages;
  uint64_t* vfull = kempty + kStages;
  uint64_t* vempty = vfull + kStages;
  uint64_t* qfull = vempty + kStages;
  uint64_t* qempty = qfull + kQBufs;  // K1a's only
  // K1c: each key slot's ids and header, each query buffer's ids
  int* Kid = reinterpret_cast<int*>(qempty + (kLse ? kQBufs : 0));
  int* Qid = Kid + kStages * C::kIdStride;
  // Item -> (head, query tile): heads in groups of `group` whose keys
  // and values fit L2 together, each group's query tiles heaviest first.
  // Block b takes items b, b + gridDim.x, ... below BH * nq: K1b's grid
  // has a block an item, K1a's may be persistent.
  const int nq = (S + kBM - 1) / kBM, items = BH * nq;
  struct Item {
    int bh, q0, nkt;
  };
  const auto item_of = [&](int item) {
    const int g0 = item / (group * nq) * group;  // the group's first
    const int in = item - g0 * nq, gh = min(group, BH - g0);
    Item it;
    it.bh = g0 + in % gh;
    it.q0 = (nq - 1 - in / gh) * kBM;  // heaviest causal tiles first
    const int kend = causal ? min(it.q0 + kBM, S) : S;  // keys it sees
    it.nkt = (kend + kBN - 1) / kBN;
    return it;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      // K1c: the producer lanes' id copies, and lane 0
      mbar_init(&kfull[i], kSeg ? 33 : 1);
      mbar_init(&kempty[i], kConsumers);
      mbar_init(&vfull[i], 1);
      mbar_init(&vempty[i], kConsumers);
    }
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&qfull[i], kSeg ? 33 : 1);
      if (kLse) mbar_init(&qempty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------- producer warpgroup
    setmaxnreg_dec<C::kProdRegs>();
    if constexpr (kSeg) {
      // a warp: lane l decides for the key tile of the 64-row tile
      // base + l (kBN / 64 lanes a key tile), and the warp issues the
      // needed ones in order, each once the next is known (the last is
      // marked so)
      if (threadIdx.x >= kConsumers + 32) return;
      const int lane = threadIdx.x & 31;
      constexpr int R = kBN / 64;  // 64-row tiles a key tile
      const int nt = (S + 63) / 64;
      struct Rg {
        int2 a0, a1, c;  // the warpgroups' ranges, the lane's tile's
      };
      const auto ranges_of = [&](const Item& it, int t) {
        const int2* rb = ranges + (long long)(it.bh / nh) * nt;
        Rg r;
        r.a0 = rb[it.q0 / 64];
        r.a1 = rb[min(it.q0 / 64 + 1, nt - 1)];
        r.c = rb[min(t, nt - 1)];
        return r;
      };
      Rg next{};
      if ((int)blockIdx.x < items) next = ranges_of(item_of(blockIdx.x), lane);
      int i = 0;  // key and value tiles loaded so far
      for (int item = blockIdx.x, n = 0; item < items;
           item += gridDim.x, ++n) {
        const Item it = item_of(item);
        const int* segb = seg + (long long)(it.bh / nh) * S;
        const Rg first = next;
        if (item + (int)gridDim.x < items)
          next = ranges_of(item_of(item + gridDim.x), lane);
        const int qb = n % kQBufs;
        mbar_wait(&qempty[qb], ((n / kQBufs) & 1) ^ 1);
        for (int r = lane; r < kBM; r += 32) {
          const int row = it.q0 + r;
          cp_async_4(Qid + qb * kBM + r, segb + (row < S ? row : 0),
                     row < S);
        }
        mbar_arrive_cp_async(&qfull[qb]);
        if (lane == 0) {
          mbar_arrive_tx(&qfull[qb], C::kQBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            tma_load_4d(Qs + qb * C::kQBytes + c * C::kQChunk, &qmap, 64 * c,
                        0, it.q0, it.bh, &qfull[qb]);
        }
        // key tile kt with flags fl (and, for the item's last, 16)
        const auto issue = [&](int kt, int fl) {
          const int slot = i % kStages, parity = ((i / kStages) & 1) ^ 1;
          const int k0 = kt * kBN;
          int* kid = Kid + slot * C::kIdStride;
          mbar_wait(&kempty[slot], parity);
          for (int r = lane; r < kBN; r += 32)
            cp_async_4(kid + r, segb + (k0 + r < S ? k0 + r : 0),
                       k0 + r < S);
          mbar_arrive_cp_async(&kfull[slot]);
          if (lane == 0) {
            kid[kBN] = fl | kt << 5;
            mbar_arrive_tx(&kfull[slot], C::kTileBytes);
#pragma unroll
            for (int c = 0; c < C::kChunks; ++c)
              tma_load_4d(Kr + slot * C::kTileBytes + c * C::kKVChunk, &kmap,
                          64 * c, 0, k0, it.bh, &kfull[slot]);
            mbar_wait(&vempty[slot], parity);
            mbar_arrive_tx(&vfull[slot], C::kTileBytes);
#pragma unroll
            for (int c = 0; c < C::kChunks; ++c)
              tma_load_4d(Vr + slot * C::kTileBytes + c * C::kKVChunk, &vmap,
                          64 * c, 0, k0, it.bh, &vfull[slot]);
          }
          ++i;
        };
        int pend = -1, pfl = 0;  // the needed tile not yet issued
        for (int base = 0; base < R * it.nkt; base += 32) {
          const Rg rg = base == 0 ? first : ranges_of(it, base + lane);
          // the key tile's range: its R 64-row tiles'
          int2 c = rg.c;
          if (R == 2) {
            c.x = min(c.x, __shfl_xor_sync(0xffffffffu, c.x, 1));
            c.y = max(c.y, __shfl_xor_sync(0xffffffffu, c.y, 1));
          }
          const int kt = (base + lane) / R;
          const int fl =
              lane % R == 0 && kt < it.nkt
                  ? seg_flags<kBN>(0, it.q0, kt * kBN, S, causal, rg.a0, c) |
                        seg_flags<kBN>(1, it.q0, kt * kBN, S, causal, rg.a1,
                                       c) << 2
                  : 0;
          for (unsigned need = __ballot_sync(0xffffffffu, fl != 0); need;
               need &= need - 1) {
            const int k = __ffs(need) - 1;
            const int flk = __shfl_sync(0xffffffffu, fl, k);
            if (pend >= 0) issue(pend, pfl);
            pend = (base + k) / R;
            pfl = flk;
          }
        }
        // every row sees its own key, so an item needs a tile; were it
        // otherwise, tile 0 unread keeps the consumers' walk whole
        if (pend < 0) pend = 0;
        issue(pend, pfl | 16);
      }
      return;
    }
    if (threadIdx.x != kConsumers) return;
    int i = 0;  // key and value tiles loaded so far
    for (int item = blockIdx.x, n = 0; item < items;
         item += gridDim.x, ++n) {
      const Item it = item_of(item);
      const int b = it.bh / H, h = it.bh % H, qb = n % kQBufs;
      if constexpr (kLse)  // the buffer's last item is stored
        mbar_wait(&qempty[qb], ((n / kQBufs) & 1) ^ 1);
      mbar_arrive_tx(&qfull[qb], C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_4d(Qs + qb * C::kQBytes + c * C::kQChunk, &qmap, 64 * c, h,
                    it.q0, b, &qfull[qb]);
      for (int kt = 0; kt < it.nkt; ++kt, ++i) {
        const int slot = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(&kempty[slot], parity);
        mbar_arrive_tx(&kfull[slot], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(Kr + slot * C::kTileBytes + c * C::kKVChunk, &kmap,
                      64 * c, h, kt * kBN, b, &kfull[slot]);
        mbar_wait(&vempty[slot], parity);
        mbar_arrive_tx(&vfull[slot], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(Vr + slot * C::kTileBytes + c * C::kKVChunk, &vmap,
                      64 * c, h, kt * kBN, b, &vfull[slot]);
      }
    }
    return;
  }

  // -------------------------------------------- consumer warpgroups
  setmaxnreg_inc<C::kRegs>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const uint32_t ks = smem_u32(Kr), vs = smem_u32(Vr);
  // K1b's warpgroups take turns to issue their products (barrier 4 + wg
  // each, the first turn warpgroup 0's), so one's softmax runs beside
  // another's products; each takes nkt + 1 turns an item, one a tile and
  // one for the last P V, idle ones for tiles above its rows. K1a's
  // issue as they go: at D = 64 the turns cost more than they gain
  // (tools/torch_flash_ab.py --probe on an H100, [8, 16, 1024, 64]
  // causal bf16: 0.0730 ms with them, 0.0711 without).
  constexpr bool kTurns = !kLse;
  const int turn = 4 + wg, next = 4 + (wg + 1) % kWG;
  if (kTurns && wg == kWG - 1) named_arrive(4, 256);
  int i0 = 0;  // key and value tiles of the earlier items
  for (int item = blockIdx.x, n = 0; item < items;
       item += gridDim.x, ++n) {
    const Item it = item_of(item);
    const int bh = it.bh, b = bh / H, h = bh % H, nkt = it.nkt;
    const int qb = n % kQBufs;
    const int w0 = it.q0 + 64 * wg;  // the warpgroup's first query row
    // The warpgroup's query rows: 8 KB of each column box.
    unsigned char* Qw = Qs + qb * C::kQBytes + wg * 64 * 128;
    mbar_wait(&qfull[qb], (n / kQBufs) & 1);
    if constexpr (!kLse) {  // K1b scales the query; K1a's arrives scaled
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        for (int i = tid; i < 64 * 8; i += 128) {
          uint4* p = reinterpret_cast<uint4*>(Qw + c * C::kQChunk) + i;
          uint4 x = *p;
          T* e = reinterpret_cast<T*>(&x);
#pragma unroll
          for (int t = 0; t < 8; ++t)
            e[t] = from_float<T>(to_float(e[t]) * scale);
          *p = x;
        }
      fence_proxy_async();
      named_sync(1 + wg, 128);
    }

    const uint32_t qs = smem_u32(Qw);
    // Keys visible to the thread's rows: below lim_row, counted from
    // column 2 qd of each tile.
    const int row = w0 + 16 * warp + g;
    const int lim_row[2] = {causal ? min(row + 1, S) : S,
                            causal ? min(row + 9, S) : S};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    float o[D / 2], s[kBN / 2];
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    if constexpr (kSeg) {
      // the loaded tiles, to the one marked last: p of the tile at ring
      // index ip waits (pend) for its P V, issued beside the next needed
      // tile's scores or, before a tile this warpgroup skips, alone
      const int2 qseg = make_int2(Qid[qb * kBM + 64 * wg + 16 * warp + g],
                                  Qid[qb * kBM + 64 * wg + 16 * warp + g + 8]);
      int ik = i0, ip = 0;
      bool pend = false;
      for (;;) {
        const int slot = ik % kStages, parity = (ik / kStages) & 1;
        const int prev = ip % kStages, pparity = (ip / kStages) & 1;
        mbar_wait(&kfull[slot], parity);
        const int* kid = Kid + slot * C::kIdStride;
        const int hdr = kid[kBN];
        const int fl = (hdr >> (2 * wg)) & 3;
        if (fl == 0) {
          if (pend) {
            mbar_wait(&vfull[prev], pparity);
            wgmma_fence();
            pv_gemm<T, C>(o, pa, vs + prev * C::kTileBytes);
            wgmma_commit();
            wgmma_wait<0>();
            mbar_arrive(&vempty[prev]);
            pend = false;
          }
          mbar_arrive(&kempty[slot]);
          mbar_wait(&vfull[slot], parity);
          mbar_arrive(&vempty[slot]);
        } else {
          const int k0 = (hdr >> 5) * kBN;
          const int lim[2] = {lim_row[0] - k0 - 2 * qd,
                              lim_row[1] - k0 - 2 * qd};
          if (pend) {
            mbar_wait(&vfull[prev], pparity);
            wgmma_fence();
            s_gemm<T, C>(s, qs, ks + slot * C::kTileBytes);
            wgmma_commit();
            pv_gemm<T, C>(o, pa, vs + prev * C::kTileBytes);
            wgmma_commit();
            wgmma_wait<1>();  // the scores are in
            if (fl & 2)
              softmax_tile<kBN, true, true>(s, m, l, lim, alpha, kid + 2 * qd,
                                            qseg);
            else
              softmax_tile<kBN, false, true>(s, m, l, lim, alpha);
            mbar_arrive(&kempty[slot]);  // its ids are read
            wgmma_wait<0>();  // P V is done: its value tile and p are free
            mbar_arrive(&vempty[prev]);
          } else {
            wgmma_fence();
            s_gemm<T, C>(s, qs, ks + slot * C::kTileBytes);
            wgmma_commit();
            wgmma_wait<0>();
            if (fl & 2)
              softmax_tile<kBN, true, true>(s, m, l, lim, alpha, kid + 2 * qd,
                                            qseg);
            else
              softmax_tile<kBN, false, true>(s, m, l, lim, alpha);
            mbar_arrive(&kempty[slot]);
          }
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              o[4 * j + 2 * hh] *= alpha[hh];
              o[4 * j + 2 * hh + 1] *= alpha[hh];
            }
          pack_p<T, kBN>(pa, s);
          ip = ik;
          pend = true;
        }
        ++ik;
        if (hdr & 16) break;
      }
      if (pend) {
        const int prev = ip % kStages;
        mbar_wait(&vfull[prev], (ip / kStages) & 1);
        wgmma_fence();
        pv_gemm<T, C>(o, pa, vs + prev * C::kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        mbar_arrive(&vempty[prev]);
      }
      i0 = ik;
    } else {
      // the tiles the warpgroup reads; only a tile that holds keys past
      // S, or above the warpgroup's first row when causal, takes the mask
      const int nkw = causal ? (min(w0 + 64, S) + kBN - 1) / kBN : nkt;
      const auto masked = [&](int kt) {
        return (kt + 1) * kBN > S || (causal && (kt + 1) * kBN - 1 > w0);
      };
      // The first tile: its scores, softmax and p.
      {
        const int slot = i0 % kStages;
        mbar_wait(&kfull[slot], (i0 / kStages) & 1);
        if (kTurns) named_sync(turn, 256);
        wgmma_fence();
        s_gemm<T, C>(s, qs, ks + slot * C::kTileBytes);
        wgmma_commit();
        if (kTurns) named_arrive(next, 256);
        wgmma_wait<0>();
        mbar_arrive(&kempty[slot]);
        const int lim[2] = {lim_row[0] - 2 * qd, lim_row[1] - 2 * qd};
        if (masked(0))
          softmax_tile<kBN, true>(s, m, l, lim, alpha);
        else
          softmax_tile<kBN, false>(s, m, l, lim, alpha);
      }
      pack_p<T, kBN>(pa, s);
      // Tile kt's scores beside tile kt - 1's P V.
      for (int kt = 1; kt < nkw; ++kt) {
        const int slot = (i0 + kt) % kStages, prev = (i0 + kt - 1) % kStages;
        const int lim[2] = {lim_row[0] - kt * kBN - 2 * qd,
                            lim_row[1] - kt * kBN - 2 * qd};
        mbar_wait(&kfull[slot], ((i0 + kt) / kStages) & 1);
        mbar_wait(&vfull[prev], ((i0 + kt - 1) / kStages) & 1);
        if (kTurns) named_sync(turn, 256);
        wgmma_fence();
        s_gemm<T, C>(s, qs, ks + slot * C::kTileBytes);
        wgmma_commit();
        pv_gemm<T, C>(o, pa, vs + prev * C::kTileBytes);
        wgmma_commit();
        if (kTurns) named_arrive(next, 256);
        wgmma_wait<1>();  // the scores are in: the key tile is free
        mbar_arrive(&kempty[slot]);
        if (masked(kt))
          softmax_tile<kBN, true>(s, m, l, lim, alpha);
        else
          softmax_tile<kBN, false>(s, m, l, lim, alpha);
        wgmma_wait<0>();  // P V is done: its value tile and p are free
        mbar_arrive(&vempty[prev]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            o[4 * j + 2 * hh] *= alpha[hh];
            o[4 * j + 2 * hh + 1] *= alpha[hh];
          }
        pack_p<T, kBN>(pa, s);
      }
      {
        const int last = (i0 + nkw - 1) % kStages;
        mbar_wait(&vfull[last], ((i0 + nkw - 1) / kStages) & 1);
        if (kTurns) named_sync(turn, 256);
        wgmma_fence();
        pv_gemm<T, C>(o, pa, vs + last * C::kTileBytes);
        wgmma_commit();
        if (kTurns) named_arrive(next, 256);
        wgmma_wait<0>();
        mbar_arrive(&vempty[last]);
      }
      // Tiles wholly above the warpgroup's rows (causal): released unread.
      for (int kt = nkw; kt < nkt; ++kt) {
        const int slot = (i0 + kt) % kStages;
        const int parity = ((i0 + kt) / kStages) & 1;
        mbar_wait(&kfull[slot], parity);
        mbar_arrive(&kempty[slot]);
        mbar_wait(&vfull[slot], parity);
        mbar_arrive(&vempty[slot]);
        if (kTurns) named_sync(turn, 256);
        if (kTurns) named_arrive(next, 256);
      }
      i0 += nkt;
    }

    // Epilogue: acc / max(l, 1e-30) (kLse: acc * (1 / l), and the rows'
    // logsumexp) into the warpgroup's query rows of shared memory (the
    // 128-byte swizzle: conflict-free), then 16-byte rows of out.
    float f[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lsum = l[hh];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if constexpr (kLse) {
        f[hh] = 1.f / lsum;
        const int qrow = row + 8 * hh;
        if (qd == 0 && qrow < S)
          lse[(long long)bh * S + qrow] = m[hh] + logf(lsum);
      } else {
        f[hh] = fmaxf(lsum, 1e-30f);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + g + 8 * hh;
        *reinterpret_cast<uint32_t*>(Qw + (j >> 3) * C::kQChunk + r * 128 +
                                     (((j & 7) ^ (r & 7)) << 4) + 4 * qd) =
            kLse ? Mma<T>::pack(o[4 * j + 2 * hh] * f[hh],
                                o[4 * j + 2 * hh + 1] * f[hh])
                 : Mma<T>::pack(o[4 * j + 2 * hh] / f[hh],
                                o[4 * j + 2 * hh + 1] / f[hh]);
      }
    named_sync(1 + wg, 128);
    for (int i = tid; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), cc = i % (D / 8), qrow = w0 + r;
      if (qrow < S)
        *reinterpret_cast<uint4*>(out +
                                  (((long long)b * S + qrow) * H + h) * D +
                                  8 * cc) =
            *reinterpret_cast<const uint4*>(Qw + (cc >> 3) * C::kQChunk +
                                            r * 128 +
                                            (((cc & 7) ^ (r & 7)) << 4));
    }
    if constexpr (kLse) {  // the buffer may take the next query tile
      fence_proxy_async();
      mbar_arrive(&qempty[qb]);
    }
  }
  if (kTurns && wg == 0) named_sync(turn, 256);  // the last one's last turn
}

// K1c's pre-pass: each (batch, 64-row tile)'s least and greatest
// segment id of seg [tiles / ceil(S / 64), S] (rows at or past S left
// out), a warp a tile.
__global__ void __launch_bounds__(128)
seg_ranges_kernel(const int* __restrict__ seg, int2* __restrict__ ranges,
                  int S, int tiles) {
  const int t = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (t < tiles) {
    const int2 r = tile_range(seg, S, t, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) ranges[t] = r;
  }
}

// K1b over [B, S, H, D]; with kLse K1a over [BH, S, D] as B = BH, H = 1,
// its logsumexp into lse; with kSeg K1c, K1a's operands with the ids seg
// [B / nh, S] and the pre-pass's ranges scratch of B / nh * ceil(S / 64)
// pairs.
template <typename T, int D, bool kLse, bool kSeg = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const int* seg, int2* ranges, int nh, int B,
                   int S, int H, int causal, float scale,
                   cudaStream_t stream) {
  using C = Cfg<D, kSeg>;
  cudaError_t err;
  if constexpr (kSeg) {
    const int tiles = B / nh * ((S + 63) / 64);
    seg_ranges_kernel<<<(tiles + 3) / 4, 128, 0, stream>>>(seg, ranges, S,
                                                           tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long dims[4] = {D, H, S, B};
  const long long strides[3] = {D, (long long)H * D, (long long)S * H * D};
  CUtensorMap qmap, kmap, vmap;
  err = make_map<T, 4>(&qmap, q, dims, strides, {64, 1, C::kBM, 1});
  if (err != cudaSuccess) return err;
  err = make_map<T, 4>(&kmap, k, dims, strides, {64, 1, C::kBN, 1});
  if (err != cudaSuccess) return err;
  err = make_map<T, 4>(&vmap, v, dims, strides, {64, 1, C::kBN, 1});
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_bshd_wgmma_kernel<T, D, kLse, kSeg>;
  constexpr int smem = kLse ? C::kLseSmem : C::kSmem;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const long long kv_bytes = 4LL * S * D;  // a head's keys and values
  const int group = (int)std::max(
      1LL, std::min<long long>(B * H, kL2Budget / kv_bytes));
  const long long items = (long long)B * H * ((S + C::kBM - 1) / C::kBM);
  if (items > 2147483647LL) return cudaErrorInvalidValue;
  long long blocks = items;
  if (kSeg ? kSegPersist : kLse && kLsePersist) {
    static int sms = 0;
    if (!sms) {
      int dev = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return err;
    }
    blocks = std::min(items, (long long)sms);
  }
  kern<<<(unsigned)blocks, C::kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(out), lse, seg, ranges, nh, S, H,
      B * H, group, causal, scale);
  return cudaGetLastError();
}

}  // namespace bshd

// ------------------------------------------------------------------------
// The segmented backward for 16-bit operands (K1c's backward): TMA +
// wgmma, the deterministic two passes of the backward above, with the
// tile pairs that segments keep apart skipped.
//
// A pre-pass (flash_delta_seg_kernel) writes delta and, for every
// (batch, 64-row tile), the least and greatest segment id of its rows.
// Two tiles whose [min, max] ranges do not overlap hold only pairs of
// two segments: their p is exactly 0, so a pass skips them and no value
// changes. A pair whose tiles each hold one id, the same, takes no mask;
// others, and tiles that cross the diagonal (causal) or hold rows past
// S, take the masked branch.
//
// Both passes run as one persistent launch (a block an SM, walking a
// fixed list of items). An item is 128 fixed rows of one head, two
// consumer warpgroups of 64 rows each, walking 64-row tiles of the
// other operand: a dK/dV item fixes keys (X = K, Y = V, with their ids)
// and walks queries (U = Q, W = dO, with their lse, delta and ids); a dQ
// item fixes queries (X = Q, Y = dO, with their lse, delta and ids) and
// walks keys (U = K, W = V, with their ids). A producer warp loads each
// item's fixed tiles into one of two buffers (the next item's while the
// consumers finish this one) and keeps a ring of walked tiles full
// through TMA (3-D maps over [BH, S, D], 64-column boxes under the
// 128-byte swizzle, zeros past S); the rows' scalars come by cp.async,
// tracked by the same barriers. It decides which walked tiles each
// warpgroup needs, from the ranges (the next item's loaded while it
// issues this one's), causality and S, and writes that into the stage
// beside the walked rows' scalars; a tile no warpgroup needs is never
// loaded, and a stage without a tile ends the item. Per
// walked tile a warpgroup issues S = X U^T and dP = Y W^T (wgmma
// m64n64k16, both operands K-major in shared memory), turns S into p =
// exp(s - lse) (fp32, masked where the stage says so) while dP is in
// flight, then ds = p (dp - delta); p and ds, rounded to T, are the
// register A operands of dV += P^T dO and dK += dS^T Q (or dQ += dS K),
// whose B operands are the walked tiles read MN-major. No atomics: two
// launches give the same bits. The producer warpgroup gives its
// registers to the consumers (setmaxnreg 40 / 232): at D = 128 the dK
// and dV accumulators are 128 fp32 registers a thread beside S and dP.
//
// The kernel takes the causal switch and compiles without segments
// (kSeg false: no ranges, no ids) for K1a's backward. Its causal items
// walk from 2 to S / 64 tiles, and a block takes every gridDim.x-th
// item: in K1c's order (a head's items adjacent) the heaviest ones fall
// on some blocks together (at [128 heads, S = 1024] on 132 blocks, the
// most loaded block walks 1.38x the mean). Without segments a block
// takes units instead, a dK/dV item and the dQ item that walks as far,
// longest walks first (see decode_item): the blocks' mean idle share of
// the kernel's span falls from 26% to 6% (tools/torch_flash_ab.py
// --probe on an H100, [8, 16, 1024, 64] causal bf16).

namespace bwd16 {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
// Bytes of q, k, v and dO that the items in flight may share in L2
// without segments: heads are grouped to fit.
constexpr long long kItemL2Budget = 64LL << 20;

constexpr int kPrepThreads = 128;

// The pre-pass: delta[row] = sum_d dout[row][d] * out[row][d] in fp32,
// D / 8 lanes a row reading 16 bytes each; with kSeg the blocks past
// `dblocks` write each (batch, 64-row tile)'s least and greatest segment
// id (rows at or past S left out), a warp a tile.
template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kPrepThreads)
flash_delta_seg_kernel(const T* __restrict__ out,
                       const T* __restrict__ dout, float* __restrict__ delta,
                       long long rows, long long dblocks,
                       const int* __restrict__ seg, int2* __restrict__ ranges,
                       int S, int tiles) {
  if (kSeg && blockIdx.x >= dblocks) {
    const int t = (int)(blockIdx.x - dblocks) * 4 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (t >= tiles) return;
    const int2 r = tile_range(seg, S, t, lane);
    if (lane == 0) ranges[t] = r;
    return;
  }
  constexpr int kLanes = D / 8;  // lanes a row
  const long long row =
      (long long)blockIdx.x * (kPrepThreads / kLanes) + threadIdx.x / kLanes;
  const int c = (threadIdx.x % kLanes) * 8;
  float s = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(out + row * D + c);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + row * D + c);
    const T* ea = reinterpret_cast<const T*>(&a);
    const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += to_float(ea[i]) * to_float(eb[i]);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  if (row < rows && threadIdx.x % kLanes == 0) delta[row] = s;
}

template <int D>
struct Cfg {
  static constexpr int kBM = 128;  // fixed rows a block, 64 a warpgroup
  static constexpr int kBN = 64;   // rows a walked tile
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;
  // registers a consumer thread: all the producer's but 40
  static constexpr int kRegs = (65536 / 128 - 40) / 2 / 8 * 8;
  static constexpr int kChunks = D / 64;  // 128-byte column boxes
  static constexpr int kFixChunk = kBM * 128;
  static constexpr int kWalkChunk = kBN * 128;
  static constexpr int kFixBytes = kChunks * kFixChunk;    // X or Y
  static constexpr int kWalkBytes = kChunks * kWalkChunk;  // U or W
  static constexpr int kStages = D == 64 ? 4 : 2;
  // buffers of the fixed tiles: the producer loads the next item's
  // while the consumers finish this one
  static constexpr int kFixBufs = 2;
  // a stage: U, W, then its header (the walked tile's first row, or -1
  // for the end; the warpgroups' flags) and the walked rows' lse, delta
  // and ids, padded so the next stage stays 1024-byte aligned
  static constexpr int kScalars = 1024;
  static constexpr int kStageBytes = 2 * kWalkBytes + kScalars;
  // a fixed buffer's rows' lse, delta and ids
  static constexpr int kFixScalars = 3 * kBM * 4;
  // the buffers of X and Y, the ring, the fixed rows' scalars, the
  // ring's barriers and the buffers'
  static constexpr int kSmem = 1024 + 2 * kFixBufs * kFixBytes +
                               kStages * kStageBytes +
                               kFixBufs * kFixScalars +
                               (2 * kStages + 2 * kFixBufs) * 8;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// The segment ranges one walk decision reads: the item's two fixed
// 64-row tiles' (a0, a1) and the walked tile's (c).
struct Ranges {
  int2 a0, a1, c;
};

template <bool kSeg>
__device__ __forceinline__ Ranges load_ranges(const int2* __restrict__ rb,
                                              int f0, int t, int nt) {
  Ranges r{};
  if constexpr (kSeg) {
    r.a0 = rb[f0 / 64];
    r.a1 = rb[min(f0 / 64 + 1, nt - 1)];
    r.c = rb[min(t, nt - 1)];
  }
  return r;
}

// The walk's flags for warpgroup `wg` and the walked 64-row tile `t`: 1
// it needs the tile, 3 it needs it masked, 0 it does not. `a`, `c`: the
// warpgroup's and the walked tile's segment ranges.
template <bool kSeg>
__device__ __forceinline__ int wg_flags(bool dq, int wg, int t, int f0,
                                        int S, int causal, int2 a, int2 c) {
  const int r0 = f0 + 64 * wg, w0 = 64 * t;  // first fixed / walked row
  if (r0 >= S) return 0;
  // causal: a key is seen by the queries at or after it
  bool visit = !causal || (dq ? w0 <= r0 + 63 : w0 + 63 >= r0);
  bool mask = w0 + 64 > S || r0 + 64 > S ||
              (causal && (dq ? w0 + 63 > r0 : r0 + 63 > w0));
  if constexpr (kSeg) {
    visit = visit && a.x <= c.y && c.x <= a.y;
    mask = mask || !(a.x == a.y && c.x == c.y && a.x == c.x);
  }
  return visit ? (mask ? 3 : 1) : 0;
}

// Both warpgroups' flags for tile t (0 at or past te), from its ranges.
template <bool kSeg>
__device__ __forceinline__ int tile_flags(bool dq, int t, int te, int f0,
                                          int S, int causal,
                                          const Ranges& r) {
  if (t >= te) return 0;
  return wg_flags<kSeg>(dq, 0, t, f0, S, causal, r.a0, r.c) |
         wg_flags<kSeg>(dq, 1, t, f0, S, causal, r.a1, r.c) << 2;
}

// p = exp(s - lse) over one tile's scores, in place: rows are the
// thread's fixed rows fr + 8 hh, columns the walked rows w0 + 8 j +
// 2 qd + u (the wgmma accumulator layout). The lse is the walked row's
// (dK/dV: queries walk; `wl` in the stage) or the fixed row's (dQ;
// `fl2`, times log2(e)). With kMask a pair that is not visible (a walked
// row past S, a key after its query when causal, two segments) gets
// p = 0 exactly.
template <bool kMask, bool kSeg, bool kDQ>
__device__ __forceinline__ void probs(float (&s)[32],
                                      const float* __restrict__ wl,
                                      const float (&fl2)[2],
                                      const int* __restrict__ wseg,
                                      const int (&fseg)[2], int fr, int w0,
                                      int S, int causal, int qd) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 8 * j + 2 * qd + u, wr = w0 + c;
      const float lw = kDQ ? 0.f : wl[c] * kLog2e;
      const int sw = kSeg && kMask ? wseg[c] : 0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float& x = s[4 * j + 2 * hh + u];
        const float p =
            exp2_approx(fmaf(x, kLog2e, -(kDQ ? fl2[hh] : lw)));
        if constexpr (kMask) {
          const int f = fr + 8 * hh;
          const bool vis = wr < S &&
                           (!causal || (kDQ ? wr <= f : f <= wr)) &&
                           (!kSeg || sw == fseg[hh]);
          x = vis ? p : 0.f;
        } else {
          x = p;
        }
      }
    }
}

// A 64 x 64 tile of fp32 values in the accumulator layout, rounded to T,
// as the register A operands of four k16 steps.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a[kk][u] = Mma<T>::pack(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
}

// acc (64 x 64) = the warpgroup's 64 fixed rows at `fs` (in 128-row
// boxes of 64 columns) times the walked tile at `ws`, transposed.
template <typename T, int D>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t fs,
                                       uint32_t ws) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T, 64, 0>(
        acc, desc_k(fs + (kk >> 2) * Cfg<D>::kFixChunk + (kk & 3) * 32),
        desc_k(ws + (kk >> 2) * Cfg<D>::kWalkChunk + (kk & 3) * 32), kk > 0);
}

// acc (64 x D) += a (64 x 64 in registers) times the walked tile at ws
// read MN-major (its rows along K).
template <typename T, int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t ws) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<T, D, 1>(acc, a[kk],
                      desc_mn(ws + kk * 2048, Cfg<D>::kWalkChunk), 1);
}

// Rows fr + 8 hh (those below S) of a contiguous [S, D] gradient, from
// the accumulator layout.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ g,
                                           const float (&acc)[D / 2], int fr,
                                           int S, int qd) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = fr + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(g + (long long)row * D + 8 * j + 2 * qd) =
          Mma<T>::pack(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// One walked tile of one warpgroup's item: S and dP from shared memory,
// p and ds in registers, then dV += P^T dO and dK += dS^T Q (acc1,
// acc0), or dQ += dS K (acc0). `st`: the stage; fl & 2: masked.
template <typename T, int D, bool kSeg, bool kDQ>
__device__ __forceinline__ void walk_tile(float (&acc0)[D / 2],
                                          float (&acc1)[D / 2], uint32_t xs,
                                          uint32_t ys,
                                          const unsigned char* st, int fl,
                                          const float (&fl2)[2],
                                          const float (&fdl)[2],
                                          const int (&fseg)[2], int fr, int S,
                                          int causal, int qd) {
  using C = Cfg<D>;
  const int* hdr = reinterpret_cast<const int*>(st + 2 * C::kWalkBytes);
  const int w0 = hdr[0];
  const float* sl = reinterpret_cast<const float*>(hdr + 16);
  const float* sd = sl + 64;
  const int* ss = reinterpret_cast<const int*>(sd + 64);
  const uint32_t us = smem_u32(st), ws = us + C::kWalkBytes;
  float s[32], dp[32];
  wgmma_fence();
  scores<T, D>(s, xs, us);   // S^T = K Q^T, or S = Q K^T
  wgmma_commit();
  scores<T, D>(dp, ys, ws);  // dP^T = V dO^T, or dP = dO V^T
  wgmma_commit();
  wgmma_wait<1>();
  if (fl & 2)
    probs<true, kSeg, kDQ>(s, sl, fl2, ss, fseg, fr, w0, S, causal, qd);
  else
    probs<false, kSeg, kDQ>(s, sl, fl2, ss, fseg, fr, w0, S, causal, qd);
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float dw = kDQ ? 0.f : sd[8 * j + 2 * qd + u];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = 4 * j + 2 * hh + u;
        dp[x] = s[x] * (dp[x] - (kDQ ? fdl[hh] : dw));  // ds
      }
    }
  uint32_t da[4][4];
  pack_a<T>(da, dp);
  if constexpr (kDQ) {
    wgmma_fence();
    accumulate<T, D>(acc0, da, us);  // dQ += dS K
  } else {
    uint32_t pa[4][4];
    pack_a<T>(pa, s);
    wgmma_fence();
    accumulate<T, D>(acc1, pa, ws);  // dV += P^T dO
    accumulate<T, D>(acc0, da, us);  // dK += dS^T Q
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// Item `item` of the launch: whether it is a dQ item, its head, its
// first fixed row, and the walked tiles [tb, te) it can need (fewer when
// causal). With segments (K1c): the dK/dV pass's (bh, key tile) items
// first, a head's tiles adjacent from key tile 0, then the dQ pass's
// from the last query tile (the heaviest causal tiles first). Without
// (K1a): a unit is a head's dK/dV item of key tile r with its dQ item of
// query tile nf - 1 - r, which walk as many tiles when causal; a block
// takes its units b, b + gridDim.x, ... each as its dK/dV item and then
// its dQ item, so every block does both kinds alike; units go in head
// groups of `group`, rank-major in a group (the longest walks first).
// Past a block's last unit, bh is -1.
struct Item {
  bool dq;
  int bh, f0, tb, te;
};

template <bool kSeg>
__device__ __forceinline__ Item decode_item(int item, int per, int nf,
                                            int nt, int causal, int group) {
  Item it;
  if constexpr (kSeg) {
    it.dq = item >= per;
    const int k = it.dq ? item - per : item;
    it.bh = k / nf;
    it.f0 = (it.dq ? nf - 1 - k % nf : k % nf) * 128;
  } else {
    const int j = item / gridDim.x;  // the block's j-th item
    const int u = item % gridDim.x + gridDim.x * (j >> 1);  // its unit
    it.dq = j & 1;
    it.bh = -1;
    if (u >= per) return it;
    const int g0 = u / (nf * group) * group;  // the group's first
    const int gh = min(group, per / nf - g0);
    const int in = u - nf * g0, r = in / gh;
    it.bh = g0 + in % gh;
    it.f0 = (it.dq ? nf - 1 - r : r) * 128;
  }
  it.tb = !it.dq && causal ? it.f0 / 64 : 0;
  it.te = it.dq && causal ? min(nt, it.f0 / 64 + 2) : nt;
  return it;
}

// Both passes (see above) in one persistent launch: block b takes items
// first + b, + gridDim.x, ... below `last` of the 2 x `per` (BH x
// ceil(S / 128) a pass). Maps: q, dO, k, v in 128-row boxes (fixed)
// and 64-row boxes (walked). dq, dk, dv: the gradients; ranges:
// [BH / H, ceil(S / 64)] (min, max) ids. The fixed tiles are
// double-buffered, so a block waits for them only at its first item.
template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qf,
                       const __grid_constant__ CUtensorMap of,
                       const __grid_constant__ CUtensorMap kf,
                       const __grid_constant__ CUtensorMap vf,
                       const __grid_constant__ CUtensorMap qw,
                       const __grid_constant__ CUtensorMap ow,
                       const __grid_constant__ CUtensorMap kw,
                       const __grid_constant__ CUtensorMap vw,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ seg,
                       const int2* __restrict__ ranges, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv, int S, int H,
                       int causal, int per, int first, int last) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages, kBufs = C::kFixBufs;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the buffers of the fixed tiles (X then Y), the ring, the buffers of
  // the fixed rows' scalars, the barriers
  unsigned char* fix =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = fix + 2 * kBufs * C::kFixBytes;
  unsigned char* fsc = ring + kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(fsc + kBufs * C::kFixScalars);
  uint64_t* empty = full + kStages;
  uint64_t* fixfull = empty + kStages;
  uint64_t* fixempty = fixfull + kBufs;
  const int nf = (S + C::kBM - 1) / C::kBM, nt = (S + 63) / 64;
  // without segments, heads in groups whose q, k, v and dO fit L2
  const int group =
      kSeg ? 1
           : (int)max(1LL, min((long long)(per / nf),
                               kItemL2Budget / (8LL * S * D)));
  if (threadIdx.x == 0) {
    // full barriers: the producer lanes' copies, and lane 0
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 33);
      mbar_init(&empty[i], C::kConsumers);
    }
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&fixfull[i], 33);
      mbar_init(&fixempty[i], C::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {
    // ----------------------------------------------- producer warp
    setmaxnreg_dec<40>();
    if (threadIdx.x >= C::kConsumers + 32) return;
    const int lane = threadIdx.x & 31;
    // An item's walk takes its tiles tb .. te - 1, 32 at a time: lane l
    // decides for tile base + l, and the warp issues the needed ones in
    // order. The ranges of the next item's first 32 are loaded while
    // this item's tiles are issued.
    const auto ranges_of = [&](const Item& it, int t) {
      return load_ranges<kSeg>(kSeg ? ranges + (long long)(it.bh / H) * nt
                                    : nullptr,
                               it.f0, t, nt);
    };
    Ranges next{};
    if (first + (int)blockIdx.x < last) {
      const Item it =
          decode_item<kSeg>(first + blockIdx.x, per, nf, nt, causal, group);
      next = ranges_of(it, it.tb + lane);
    }
    int i = 0, n = 0;  // stages filled, items begun
    for (int item = first + blockIdx.x; item < last;
         item += gridDim.x, ++n) {
      const Item it = decode_item<kSeg>(item, per, nf, nt, causal, group);
      if (!kSeg && it.bh < 0) break;  // past the block's last unit
      const long long roff = (long long)it.bh * S;
      const int* segb = kSeg ? seg + (long long)(it.bh / H) * S : nullptr;
      const Ranges first_ranges = next;
      if (item + (int)gridDim.x < last) {
        const Item nx =
            decode_item<kSeg>(item + gridDim.x, per, nf, nt, causal, group);
        next = ranges_of(nx, nx.tb + lane);
      }
      // the fixed tiles, with their rows' ids (and, for dQ, lse and
      // delta), into buffer fb
      const int fb = n % kBufs;
      mbar_wait(&fixempty[fb], ((n / kBufs) & 1) ^ 1);
      float* fl_s = reinterpret_cast<float*>(fsc + fb * C::kFixScalars);
      float* fd_s = fl_s + C::kBM;
      int* fs_s = reinterpret_cast<int*>(fd_s + C::kBM);
      for (int r = lane; r < C::kBM; r += 32) {
        const int row = it.f0 + r;
        const bool ok = row < S;
        const long long at = roff + (ok ? row : 0);
        if (it.dq) {
          cp_async_4(fl_s + r, lse + at, ok);
          cp_async_4(fd_s + r, delta + at, ok);
        }
        if constexpr (kSeg) cp_async_4(fs_s + r, segb + (ok ? row : 0), ok);
      }
      mbar_arrive_cp_async(&fixfull[fb]);
      if (lane == 0) {
        unsigned char* xt = fix + 2 * fb * C::kFixBytes;
        mbar_arrive_tx(&fixfull[fb], 2 * C::kFixBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_3d(xt + c * C::kFixChunk, it.dq ? &qf : &kf, 64 * c,
                      it.f0, it.bh, &fixfull[fb]);
          tma_load_3d(xt + C::kFixBytes + c * C::kFixChunk,
                      it.dq ? &of : &vf, 64 * c, it.f0, it.bh, &fixfull[fb]);
        }
      }
      for (int base = it.tb; base < it.te; base += 32) {
        const Ranges rg =
            base == it.tb ? first_ranges : ranges_of(it, base + lane);
        const int fl = tile_flags<kSeg>(it.dq, base + lane, it.te, it.f0, S,
                                        causal, rg);
        for (unsigned need = __ballot_sync(0xffffffffu, fl & 5); need;
             need &= need - 1) {
          const int k = __ffs(need) - 1, w0 = 64 * (base + k);
          const int flk = __shfl_sync(0xffffffffu, fl, k);
          const int slot = i % kStages;
          mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
          unsigned char* st = ring + slot * C::kStageBytes;
          int* hdr = reinterpret_cast<int*>(st + 2 * C::kWalkBytes);
          float* sl = reinterpret_cast<float*>(hdr + 16);
          float* sd = sl + 64;
          int* ss = reinterpret_cast<int*>(sd + 64);
          // the walked rows' lse, delta and ids (zeros past S)
          for (int r = lane; r < 64; r += 32) {
            const int row = w0 + r;
            const bool ok = row < S;
            const long long at = roff + (ok ? row : 0);
            if (!it.dq) {
              cp_async_4(sl + r, lse + at, ok);
              cp_async_4(sd + r, delta + at, ok);
            }
            if constexpr (kSeg) cp_async_4(ss + r, segb + (ok ? row : 0), ok);
          }
          mbar_arrive_cp_async(&full[slot]);
          if (lane == 0) {
            hdr[0] = w0;
            hdr[1] = flk;
            mbar_arrive_tx(&full[slot], 2 * C::kWalkBytes);
#pragma unroll
            for (int c = 0; c < C::kChunks; ++c) {
              tma_load_3d(st + c * C::kWalkChunk, it.dq ? &kw : &qw, 64 * c,
                          w0, it.bh, &full[slot]);
              tma_load_3d(st + C::kWalkBytes + c * C::kWalkChunk,
                          it.dq ? &vw : &ow, 64 * c, w0, it.bh, &full[slot]);
            }
          }
          ++i;
        }
      }
      const int slot = i % kStages;  // the end of the item's walk
      mbar_wait(&empty[slot], ((i / kStages) & 1) ^ 1);
      mbar_arrive_cp_async(&full[slot]);
      if (lane == 0) {
        reinterpret_cast<int*>(ring + slot * C::kStageBytes +
                               2 * C::kWalkBytes)[0] = -1;
        mbar_arrive(&full[slot]);
      }
      ++i;
    }
    return;
  }

  // ------------------------------------------- consumer warpgroups
  setmaxnreg_inc<C::kRegs>();
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int qd = lane & 3;
  const int rr = 64 * wg + 16 * warp + (lane >> 2);  // first row in item
  int i = 0, n = 0;  // stages used, items begun
  for (int item = first + blockIdx.x; item < last;
       item += gridDim.x, ++n) {
    const Item it = decode_item<kSeg>(item, per, nf, nt, causal, group);
    if (!kSeg && it.bh < 0) break;  // past the block's last unit
    const long long roff = (long long)it.bh * S;
    const int fr = it.f0 + rr;
    float acc0[D / 2], acc1[D / 2];  // dK and dV, or dQ
#pragma unroll
    for (int c = 0; c < D / 2; ++c) acc0[c] = acc1[c] = 0.f;
    const int fb = n % kBufs;
    const uint32_t xs = smem_u32(fix + 2 * fb * C::kFixBytes) + wg * 8192;
    const uint32_t ys = xs + C::kFixBytes;
    mbar_wait(&fixfull[fb], (n / kBufs) & 1);
    // the fixed rows' ids, and (dQ) their lse * log2(e) and delta
    const float* fl_s = reinterpret_cast<const float*>(
        fsc + fb * C::kFixScalars);
    const float* fd_s = fl_s + C::kBM;
    const int* fs_s = reinterpret_cast<const int*>(fd_s + C::kBM);
    int fseg[2];
    float fl2[2], fdl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      fseg[hh] = kSeg ? fs_s[rr + 8 * hh] : 0;
      fl2[hh] = it.dq ? fl_s[rr + 8 * hh] * kLog2e : 0.f;
      fdl[hh] = it.dq ? fd_s[rr + 8 * hh] : 0.f;
    }
    for (;; ++i) {
      const int slot = i % kStages;
      mbar_wait(&full[slot], (i / kStages) & 1);
      const unsigned char* st = ring + slot * C::kStageBytes;
      const int* hdr = reinterpret_cast<const int*>(st + 2 * C::kWalkBytes);
      const int w0 = hdr[0];
      const int fl = (hdr[1] >> (2 * wg)) & 3;
      if (w0 >= 0 && (fl & 1)) {
        if (it.dq)
          walk_tile<T, D, kSeg, true>(acc0, acc1, xs, ys, st, fl, fl2, fdl,
                                      fseg, fr, S, causal, qd);
        else
          walk_tile<T, D, kSeg, false>(acc0, acc1, xs, ys, st, fl, fl2, fdl,
                                       fseg, fr, S, causal, qd);
      }
      mbar_arrive(&empty[slot]);
      if (w0 < 0) break;
    }
    ++i;
    mbar_arrive(&fixempty[fb]);
    store_rows<T, D>((it.dq ? dq : dk) + roff * D, acc0, fr, S, qd);
    if (!it.dq) store_rows<T, D>(dv + roff * D, acc1, fr, S, qd);
  }
}

template <typename T, int D, bool kSeg>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, const int* seg, int* ranges, void* dq,
                   void* dk, void* dv, int BH, int H, int S, int causal,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  const long long rows = (long long)BH * S;
  constexpr int kRowsABlock = kPrepThreads / (D / 8);
  const long long dblocks = (rows + kRowsABlock - 1) / kRowsABlock;
  const int tiles = kSeg ? BH / H * ((S + 63) / 64) : 0;
  const long long blocks = dblocks + (tiles + 3) / 4;
  const long long per = (long long)BH * ((S + C::kBM - 1) / C::kBM);
  if (blocks > 2147483647LL || 2 * per + 65536 > 2147483647LL)
    return cudaErrorInvalidValue;
  flash_delta_seg_kernel<T, D, kSeg>
      <<<(unsigned)blocks, kPrepThreads, 0, stream>>>(
          static_cast<const T*>(out), static_cast<const T*>(dout), delta,
          rows, dblocks, seg, reinterpret_cast<int2*>(ranges), S, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // q, dout, k, v as [BH, S, D]: boxes of 128 rows where a pass fixes
  // the operand, 64 where it walks it
  const long long dims[3] = {D, S, BH};
  const long long strides[2] = {D, (long long)S * D};
  const void* base[4] = {q, dout, k, v};
  CUtensorMap fixm[4], walkm[4];
  for (int i = 0; i < 4; ++i) {
    err = make_map<T, 3>(&fixm[i], base[i], dims, strides, {64, C::kBM, 1});
    if (err != cudaSuccess) return err;
    err = make_map<T, 3>(&walkm[i], base[i], dims, strides, {64, C::kBN, 1});
    if (err != cudaSuccess) return err;
  }
  auto kern = flash_bwd_wgmma_kernel<T, D, kSeg>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  // the items: both passes. Without segments a block takes its units
  // (per of them) in turn, two items each (see decode_item): its range
  // runs a round past its last unit.
  const int units = kSeg ? (int)(2 * per) : (int)per;
  const int grid = std::min(units, sms);
  const int first = 0, last = kSeg ? units : 2 * units + grid;
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      fixm[0], fixm[1], fixm[2], fixm[3], walkm[0], walkm[1], walkm[2],
      walkm[3], lse, delta, seg, reinterpret_cast<const int2*>(ranges),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      causal, (int)per, first, last);
  return cudaGetLastError();
}

}  // namespace bwd16

template <typename T, int D, bool kPaddle, bool kSeg>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* seg, int* ranges, int BH, int S,
                int causal, Layout lay, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2 && kPaddle) {
    return bshd::launch<T, D, false>(q, k, v, out, nullptr, nullptr, nullptr,
                                     1, BH / lay.H, S, lay.H, causal, scale,
                                     stream);
  } else if constexpr (sizeof(T) == 2) {  // K1a, or with kSeg K1c
    return bshd::launch<T, D, true, kSeg>(
        q, k, v, out, lse, seg, reinterpret_cast<int2*>(ranges),
        kSeg ? lay.H : 1, BH, S, 1, causal, 1.f, stream);
  } else {
    const dim3 grid(BH, (S + kTile - 1) / kTile);
    PADDLE_FLASH_LAUNCH((flash_fwd_kernel<T, D, kPaddle, kSeg>),
                        (fwd_smem<D, kSeg>()), static_cast<const T*>(q),
                        static_cast<const T*>(k), static_cast<const T*>(v),
                        static_cast<T*>(out), lse, seg, S, causal, lay,
                        scale);
    return cudaSuccess;
  }
}

// One forward over dtype code `dtype`: the splash entry at head_dim 64 or
// 128, with segment ids where `seg` is given, the paddle-layout entry
// (`paddle`) at 128 or 256.
cudaError_t fwd_any(const void* q, const void* k, const void* v, void* out,
                    float* lse, const int* seg, int* ranges, int BH, int S,
                    int D, int dtype, int causal, bool paddle, Layout lay,
                    float scale, cudaStream_t st) {
#define PADDLE_FLASH_FWD(T, HD, P, SG)                                     \
  return fwd<T, HD, P, SG>(q, k, v, out, lse, seg, ranges, BH, S, causal, \
                           lay, scale, st)
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

// kSeg: with segment ids `seg` [BH / H, S] (and `ranges`, the 16-bit
// kernels' scratch of [BH / H, ceil(S / 64)] int2). 16-bit operands take
// bwd16's kernel, fp32 the CUDA-core kernels.
template <typename T, int D, bool kSeg>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, const int* seg, int* ranges, int BH,
                int H, int S, int causal, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return bwd16::launch<T, D, kSeg>(q, k, v, out, dout, lse, delta, seg,
                                     ranges, dq, dk, dv, BH, H, S, causal,
                                     stream);
  } else {
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
    PADDLE_FLASH_LAUNCH((flash_bwd_dkdv_kernel<T, D, kSeg>),
                        (dkdv_smem<D, kSeg>()), qp, kp, vp, dop, lse, delta,
                        static_cast<T*>(dk), static_cast<T*>(dv), seg, S, H,
                        causal);
    PADDLE_FLASH_LAUNCH((flash_bwd_dq_kernel<T, D, kSeg>),
                        (dq_smem<D, kSeg>()), qp, kp, vp, dop, lse, delta,
                        static_cast<T*>(dq), seg, S, H, causal);
    return cudaSuccess;
  }
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
  return (int)fwd_any(q, k, v, out, static_cast<float*>(lse), nullptr,
                      nullptr, BH, S, head_dim, dtype, causal, false,
                      Layout{}, 1.f,
                      static_cast<cudaStream_t>(stream));
}

// The segmented forward (splash_mha(kv_keep=)'s K1c): the splash entry's
// operands and lse over B * H heads, with int32 segment ids [B, S] of
// queries and keys alike; a query sees a key only of its own segment.
// `ranges`: scratch of B * ceil(S / 64) int32 pairs (8-byte aligned),
// each 64-row tile's least and greatest id, which bf16 and fp16 write
// (seg_ranges_kernel) and read (flash_fwd_bshd_wgmma_kernel); fp32 runs
// the CUDA-core flash_fwd_kernel and leaves it alone.
extern "C" int paddle_tpu_torch_flash_fwd_seg(const void* q, const void* k,
                                              const void* v, const void* seg,
                                              void* ranges, void* out,
                                              void* lse, int B, int H, int S,
                                              int head_dim, int dtype,
                                              int causal, void* stream) {
  if (B <= 0 || H <= 0 || !valid(B * H, S) || seg == nullptr ||
      ranges == nullptr || (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  const Layout lay{H, 0, 0, 0};
  return (int)fwd_any(q, k, v, out, static_cast<float*>(lse),
                      static_cast<const int*>(seg), static_cast<int*>(ranges),
                      B * H, S, head_dim, dtype, causal, false, lay, 1.f,
                      static_cast<cudaStream_t>(stream));
}

// The paddle-layout forward (flash_attention()'s K1b): contiguous
// [B, S, H, head_dim] operands read in place (rows H * head_dim apart),
// head_dim 128 or 256; the query is scaled by `scale` and rounded to its
// dtype before its products; no logsumexp is kept. fp32 runs
// flash_fwd_kernel, bf16 and fp16 flash_fwd_bshd_wgmma_kernel (an error
// where the driver refuses its tensor maps).
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
  return (int)fwd_any(q, k, v, out, nullptr, nullptr, nullptr, B * H, S,
                      head_dim, dtype, causal, true, lay, scale,
                      static_cast<cudaStream_t>(stream));
}

namespace {

// One backward over dtype code `dtype` at head_dim 64 or 128, with
// segment ids [BH / H, S] where `seg` is given.
cudaError_t bwd_any(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const void* lse,
                    void* delta, const int* seg, int* ranges, void* dq,
                    void* dk, void* dv, int BH, int H, int S, int D,
                    int dtype, int causal, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define PADDLE_FLASH_BWD(T, HD, SG)                                         \
  return bwd<T, HD, SG>(q, k, v, out, dout, l, dl, dq, dk, dv, seg, ranges, \
                        BH, H, S, causal, st)
#define PADDLE_FLASH_BWD_DTYPES(HD, SG)                    \
  if (dtype == 0) PADDLE_FLASH_BWD(float, HD, SG);         \
  if (dtype == 1) PADDLE_FLASH_BWD(__nv_bfloat16, HD, SG); \
  if (dtype == 2) PADDLE_FLASH_BWD(__half, HD, SG);
  if (D == 64 && seg) {
    PADDLE_FLASH_BWD_DTYPES(64, true)
  } else if (D == 128 && seg) {
    PADDLE_FLASH_BWD_DTYPES(128, true)
  } else if (D == 64) {
    PADDLE_FLASH_BWD_DTYPES(64, false)
  } else if (D == 128) {
    PADDLE_FLASH_BWD_DTYPES(128, false)
  }
#undef PADDLE_FLASH_BWD_DTYPES
#undef PADDLE_FLASH_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paddle_tpu_torch_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int BH, int S, int head_dim, int dtype, int causal,
    void* stream) {
  if (!valid(BH, S)) return (int)cudaErrorInvalidValue;
  return (int)bwd_any(q, k, v, out, dout, lse, delta, nullptr, nullptr, dq,
                      dk, dv, BH, 1, S, head_dim, dtype, causal,
                      static_cast<cudaStream_t>(stream));
}

// The segmented backward (splash_mha(kv_keep=)'s K1c): the splash
// backward's operands over B * H heads, with the forward's int32 segment
// ids [B, S]; a pair (i, j) adds to the gradients only where
// seg[b, i] == seg[b, j]. `ranges`: scratch of B * ceil(S / 64) int32
// pairs (8-byte aligned), each 64-row tile's least and greatest id, which
// bf16 and fp16 write and read (flash_bwd_wgmma_kernel); fp32 runs the
// CUDA-core kernels and leaves it alone.
extern "C" int paddle_tpu_torch_flash_bwd_seg(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, const void* seg,
    void* ranges, void* dq, void* dk, void* dv, int B, int H, int S,
    int head_dim, int dtype, int causal, void* stream) {
  if (B <= 0 || H <= 0 || !valid(B * H, S) || seg == nullptr ||
      ranges == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)bwd_any(q, k, v, out, dout, lse, delta,
                      static_cast<const int*>(seg), static_cast<int*>(ranges),
                      dq, dk, dv, B * H, H, S, head_dim, dtype, causal,
                      static_cast<cudaStream_t>(stream));
}
