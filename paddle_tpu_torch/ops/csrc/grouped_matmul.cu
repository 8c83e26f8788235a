// Grouped expert matmul for Hopper (sm_90a): out[e] = x[e] @ deq(w[e]),
// x [E, C, D], w [E, D, F] -> out [E, C, F], fp32 accumulation, out in
// x's dtype.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/grouped_matmul.py:
//   _gmm_kernel        (w float, the operand dtype of x)       format 0,
//   _gmm_kernel_quant  (w int8 [E, D, F], scales [E, F])        format 1,
//   _gmm_kernel_quant4 (w packed int4 [E, D/2, F] int8 bytes,   format 2,
//                       low nibble = even row, high = odd row,
//                       sign-extended; scales [E, F]).
// Quantized weights dequantize as q * scale / qmax per (expert, column).
//
// Rounding: the plain version (ops/grouped_matmul.py) dequantizes in
// the compute dtype T = x's dtype: s_c = round_T(round_T(scale) / qmax)
// and w = round_T(q * s_c), then multiplies in T with fp32 sums. The
// kernel rounds at exactly those places, so kernel and plain differ only
// in summation order. (The TPU kernel dequantizes in fp32 instead; that
// departure is below one bf16 spacing per weight.)
//
// What bounds it: at the serving shapes (E = 8, C = 80 capacity rows,
// D x F = 1024 x 4096 or 4096 x 1024) the weights are 67 MB in bf16,
// 34 MB in int8, 17 MB in int4, and the flops 1.3e10: ~5 flops per
// weight byte, far below the card's ~295, so the weight bytes bound it.
// So a block owns one (expert, 64-column tile) and ALL C rows (128 at a
// time, looping beyond), and every weight byte is read from device
// memory once. It walks D in 32-row tiles through a 4-stage ring in
// shared memory filled by cp.async (16-byte copies that bypass the
// registers), so three tiles of x and w stay in flight while one is
// multiplied: the bytes in flight, not the math, set the pace here.
// Quantized tiles arrive as raw int8 / packed-int4 bytes and are
// dequantized into an operand tile in shared memory just before the
// product. 16-bit operands multiply on the tensor cores (mma.sync
// m16n8k16, ldmatrix fragments; 4 warps x 32 rows x 64 columns); fp32
// operands on the CUDA cores (each thread an 8 x 8 block of the
// 128 x 64 tile). Edges are masked: any E, C, D and F (int4 needs an even
// D); rows of x and w whose length or alignment does not allow 16-byte
// copies are loaded element by element instead. Next for speed: TMA and
// wgmma, and split-K where E x F / 64 blocks cannot fill the card.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/grouped_matmul.py), launched on the caller's
// stream, allocating nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kRows = 128;   // x rows (capacity slots) per pass
constexpr int kCols = 64;    // output columns per block
constexpr int kDepth = 32;   // contraction rows per tile
constexpr int kStages = 4;   // tiles in the shared-memory ring
constexpr int kThreads = 128;

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

// x rounded to T and back: the compute dtype's rounding.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Shared-memory layout of one (T, format) instantiation: a ring of
// kStages (x tile, raw w tile) stages, the dequantized operand w tile of
// the quantized formats, and the block's column scales. Rows are padded
// by 16 bytes: ldmatrix rows of a 16-bit tile (80 and 144 bytes apart)
// and the fp32 path's column reads then fall on distinct banks, and
// every row stays 16-byte aligned for cp.async.
template <typename T, int FMT>
struct Layout {
  using W = typename std::conditional<FMT == 0, T, int8_t>::type;  // raw w
  static constexpr int kLdx = kDepth + 16 / sizeof(T);    // x tile row
  static constexpr int kLdw = kCols + 16 / sizeof(T);     // operand w row
  static constexpr int kWRows = FMT == 2 ? kDepth / 2 : kDepth;
  static constexpr int kLdr = kCols + 16 / sizeof(W);     // raw w row
  static constexpr int kXBytes = kRows * kLdx * sizeof(T);
  static constexpr int kStageBytes = kXBytes + kWRows * kLdr * sizeof(W);
  static constexpr int kDqBytes = FMT == 0 ? 0 : kDepth * kLdw * sizeof(T);
  static constexpr int kSmem = kStages * kStageBytes + kDqBytes + kCols * 4;
};

// ---------------------------------------------------------------- loads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile k0 of x (rows [r0, r0 + live), columns [k0, k0 + kDepth)) and of
// the raw w (contraction rows from k0, columns [n0, n0 + kCols)) into a
// ring stage; zeros past D and F. With `vec_x` / `vec_w` the rows allow
// 16-byte copies (row length a multiple of 16 bytes, 16-byte aligned
// base), so each chunk lies wholly inside or outside an edge; otherwise
// element by element. x rows at or past `live` are not loaded: their
// products land in output rows that are never stored.
template <typename T, int FMT>
__device__ __forceinline__ void load_stage(
    unsigned char* stage, const T* __restrict__ x,
    const typename Layout<T, FMT>::W* __restrict__ w, int r0, int live,
    int k0, int n0, int D, int F, int vec_x, int vec_w) {
  using L = Layout<T, FMT>;
  using W = typename L::W;
  T* xs = reinterpret_cast<T*>(stage);
  W* ws = reinterpret_cast<W*>(stage + L::kXBytes);
  constexpr int XE = 16 / sizeof(T), XC = kDepth / XE;  // chunks per row
  if (vec_x) {
    for (int c = threadIdx.x; c < live * XC; c += kThreads) {
      const int r = c / XC, kc = (c % XC) * XE, k = k0 + kc;
      const bool in = k < D;
      cp_async16(xs + r * L::kLdx + kc,
                 in ? x + (long long)(r0 + r) * D + k : x, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < live * kDepth; i += kThreads) {
      const int r = i / kDepth, kk = i % kDepth, k = k0 + kk;
      xs[r * L::kLdx + kk] = k < D ? x[(long long)(r0 + r) * D + k] : T{};
    }
  }
  const int wrows = FMT == 2 ? D / 2 : D;
  const int p0 = FMT == 2 ? k0 / 2 : k0;
  constexpr int WE = 16 / sizeof(W), WC = kCols / WE;
  if (vec_w) {
    for (int c = threadIdx.x; c < L::kWRows * WC; c += kThreads) {
      const int r = c / WC, nc = (c % WC) * WE, p = p0 + r, n = n0 + nc;
      const bool in = p < wrows && n < F;
      cp_async16(ws + r * L::kLdr + nc, in ? w + (long long)p * F + n : w,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < L::kWRows * kCols; i += kThreads) {
      const int r = i / kCols, nn = i % kCols, p = p0 + r, n = n0 + nn;
      ws[r * L::kLdr + nn] =
          (p < wrows && n < F) ? w[(long long)p * F + n] : W{};
    }
  }
}

// The block's column scales, dequantized as the plain version does:
// s_c = round_T(round_T(scale) / qmax); zero past F.
template <typename T>
__device__ __forceinline__ void col_scales(float* s_col, const void* scale,
                                           int scale_dtype, float qmax, int e,
                                           int n0, int F) {
  if (threadIdx.x >= kCols) return;
  const int col = n0 + threadIdx.x;
  float s = 0.f;
  if (col < F) {
    const long long i = (long long)e * F + col;
    s = scale_dtype == 0
            ? static_cast<const float*>(scale)[i]
            : scale_dtype == 1
                  ? to_float(static_cast<const __nv_bfloat16*>(scale)[i])
                  : to_float(static_cast<const __half*>(scale)[i]);
    s = round_to<T>(round_to<T>(s) / qmax);
  }
  s_col[threadIdx.x] = s;
}

// A stage's raw int8 (format 1) or packed int4 (format 2) w tile into the
// operand tile: w = round_T(q * s_c). Four bytes of a row at a time.
template <typename T, int FMT>
__device__ __forceinline__ void dequant(T* dq, const unsigned char* stage,
                                        const float* s_col) {
  using L = Layout<T, FMT>;
  const int8_t* raw = reinterpret_cast<const int8_t*>(stage + L::kXBytes);
  constexpr int kQuads = kCols / 4;
  for (int i = threadIdx.x; i < L::kWRows * kQuads; i += kThreads) {
    const int r = i / kQuads, c = (i % kQuads) * 4;
    const char4 q = *reinterpret_cast<const char4*>(raw + r * L::kLdr + c);
    const int b[4] = {q.x, q.y, q.z, q.w};  // sign-extended bytes
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float s = s_col[c + t];
      if constexpr (FMT == 1) {
        dq[r * L::kLdw + c + t] = from_float<T>((float)b[t] * s);
      } else {
        const int lo = (int)(int8_t)(b[t] << 4) >> 4;  // even row
        const int hi = b[t] >> 4;                       // odd row
        dq[(2 * r) * L::kLdw + c + t] = from_float<T>((float)lo * s);
        dq[(2 * r + 1) * L::kLdw + c + t] = from_float<T>((float)hi * s);
      }
    }
  }
}

// ------------------------------------------------------------ products

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
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

// 16-bit operands, tensor cores: acc[mt][nt] (16 x 8 tiles: rows
// 32 warp + 16 mt, columns 8 nt) += the x tile times the w tile (row
// strides LDX, LDW). m-tiles starting at or past `live` rows hold no
// capacity row and are skipped.
template <typename T, int LDX, int LDW>
__device__ __forceinline__ void mma_tile(float acc[2][8][4], const T* xs,
                                         const T* ws, int live) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < kDepth / 16; ++kc) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(a[mt],
              xs + (warp * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                       LDX +
                  kc * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, ws + (kc * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDW +
                       (2 * np + (lane >> 4)) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (warp * 32 + mt * 16 >= live) continue;
        Mma<T>::run(acc[mt][2 * np], a[mt], b[0], b[1]);
        Mma<T>::run(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// fp32 operands, CUDA cores: thread (tr, tc) of 16 x 8 owns rows
// tr + 16 i and columns tc + 8 j (i, j < 8), kept in acc as element
// (i, j) -> acc[i / 4][2 (i % 4) + j / 4][j % 4].
template <int LDX, int LDW>
__device__ __forceinline__ void fma_tile(float acc[2][8][4], const float* xs,
                                         const float* ws) {
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
#pragma unroll 4
  for (int k = 0; k < kDepth; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = xs[(tr + 16 * i) * LDX + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = ws[k * LDW + tc + 8 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float& c = acc[i / 4][2 * (i % 4) + j / 4][j % 4];
        c = fmaf(a[i], b[j], c);
      }
  }
}

// ----------------------------------------------------------- the kernel

template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const T* __restrict__ x, const void* __restrict__ w_,
           const void* __restrict__ scale, int scale_dtype, float qmax,
           T* __restrict__ out, int C, int D, int F, int vec_x, int vec_w) {
  using L = Layout<T, FMT>;
  using W = typename L::W;
  constexpr bool kMma = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* dq = reinterpret_cast<T*>(smem + kStages * L::kStageBytes);
  float* s_col =
      reinterpret_cast<float*>(smem + kStages * L::kStageBytes + L::kDqBytes);
  const int e = blockIdx.y, n0 = blockIdx.x * kCols;
  const long long wrows = FMT == 2 ? D / 2 : D;
  const T* xe = x + (long long)e * C * D;
  const W* we = static_cast<const W*>(w_) + (long long)e * wrows * F;
  T* oe = out + (long long)e * C * F;
  if (FMT != 0) col_scales<T>(s_col, scale, scale_dtype, qmax, e, n0, F);
  const int nk = (D + kDepth - 1) / kDepth;
  for (int r0 = 0; r0 < C; r0 += kRows) {
    const int live = min(kRows, C - r0);
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk)
        load_stage<T, FMT>(smem + s * L::kStageBytes, xe, we, r0, live,
                           s * kDepth, n0, D, F, vec_x, vec_w);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();  // this thread's copies of tile kt
      __syncthreads();               // everyone's; tile kt - 1 is done
      const int nxt = kt + kStages - 1;
      if (nxt < nk)
        load_stage<T, FMT>(smem + (nxt % kStages) * L::kStageBytes, xe, we,
                           r0, live, nxt * kDepth, n0, D, F, vec_x, vec_w);
      cp_async_commit();
      const unsigned char* stage = smem + (kt % kStages) * L::kStageBytes;
      const T* xs = reinterpret_cast<const T*>(stage);
      const T* ws = reinterpret_cast<const T*>(stage + L::kXBytes);
      if constexpr (FMT != 0) {
        dequant<T, FMT>(dq, stage, s_col);
        __syncthreads();
        ws = dq;
      }
      if constexpr (kMma)
        mma_tile<T, L::kLdx, L::kLdw>(acc, xs, ws, live);
      else
        fma_tile<L::kLdx, L::kLdw>(acc, xs, ws);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int row, col;
          if constexpr (kMma) {
            const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
            row = warp * 32 + mt * 16 + (lane >> 2) + 8 * (q >> 1);
            col = nt * 8 + 2 * (lane & 3) + (q & 1);
          } else {  // the inverse of fma_tile's (i, j) -> acc mapping
            row = (threadIdx.x >> 3) + 16 * (4 * mt + nt / 2);
            col = (threadIdx.x & 7) + 8 * (4 * (nt % 2) + q);
          }
          row += r0;
          col += n0;
          if (row < C && col < F)
            oe[(long long)row * F + col] = from_float<T>(acc[mt][nt][q]);
        }
    cp_async_wait<0>();  // only empty groups remain; the ring is reused
    __syncthreads();
  }
}

template <typename T, int FMT>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   int scale_dtype, float qmax, void* out, int E, int C,
                   int D, int F, int vec_x, int vec_w, cudaStream_t st) {
  constexpr int smem = Layout<T, FMT>::kSmem;
  auto kern = gmm_kernel<T, FMT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kCols - 1) / kCols, E);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), w, scale,
                                     scale_dtype, qmax, static_cast<T*>(out),
                                     C, D, F, vec_x, vec_w);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t dispatch(int x_dtype, const void* x, const void* w,
                     const void* scale, int scale_dtype, float qmax,
                     void* out, int E, int C, int D, int F, int vec_x,
                     int vec_w, cudaStream_t st) {
  switch (x_dtype) {
    case 0:
      return launch<float, FMT>(x, w, scale, scale_dtype, qmax, out, E, C, D,
                                F, vec_x, vec_w, st);
    case 1:
      return launch<__nv_bfloat16, FMT>(x, w, scale, scale_dtype, qmax, out,
                                        E, C, D, F, vec_x, vec_w, st);
    case 2:
      return launch<__half, FMT>(x, w, scale, scale_dtype, qmax, out, E, C, D,
                                 F, vec_x, vec_w, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype / scale_dtype: 0 fp32, 1 bf16, 2 fp16. w_format: 0 float of
// x's dtype, 1 int8, 2 packed int4. vec_x / vec_w: the rows of x / w
// allow 16-byte copies (row length a multiple of 16 bytes, pointers
// 16-byte aligned).
extern "C" int paddle_tpu_torch_grouped_matmul(
    const void* x, const void* w, const void* scale, void* out, int E, int C,
    int D, int F, int x_dtype, int w_format, int scale_dtype, float qmax,
    int vec_x, int vec_w, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (w_format == 2 && D % 2) return (int)cudaErrorInvalidValue;
  if (E > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_format) {
    case 0:
      return (int)dispatch<0>(x_dtype, x, w, scale, scale_dtype, qmax, out, E,
                              C, D, F, vec_x, vec_w, st);
    case 1:
      return (int)dispatch<1>(x_dtype, x, w, scale, scale_dtype, qmax, out, E,
                              C, D, F, vec_x, vec_w, st);
    case 2:
      return (int)dispatch<2>(x_dtype, x, w, scale, scale_dtype, qmax, out, E,
                              C, D, F, vec_x, vec_w, st);
  }
  return (int)cudaErrorInvalidValue;
}
