// Fused QKV projection for Hopper (sm_90a): x [B, S, d] times w_qkv
// [d, 3 H hd] plus b_qkv [3 H hd], written straight into q, k and v, each
// [B, H, S, hd] with hd = 64:
//   out_i[b, h, s, :] = round_T(fp32(x[b, s, :] @ w_i[:, h hd:(h+1) hd])
//                               + fp32(b_i[h hd:(h+1) hd]))
// for each third i of w_qkv (q, k, v), with fp32 accumulation and ONE
// rounding to x's dtype T (fp32, bf16 or fp16), as the TPU kernel adds the
// bias to its fp32 accumulator before its single cast.
//
// Replaces paddle_tpu/ops/pallas/qkv_proj.py:_kernel (entered through
// _qkv_proj_fwd_impl / qkv_proj): the train step's Q/K/V projection under
// GPTConfig.qkv_kernel. Its backward stays plain tensor code, as it is
// XLA's in JAX.
//
// What bounds it: at the train step's shape (x [8, 1024, 1024] bf16,
// w_qkv [1024, 3072]) the product is 2 * 8192 * 1024 * 3072 = 5.2e10
// flops against 7.3e7 bytes moved once: ~700 flops a byte, above the
// card's ~295, so the tensor cores bound it (0.052 ms at 989 TFLOP/s).
// So a block owns a 128-row tile of the B * S rows times one head pair
// (128 columns) of one third, as the TPU kernel computes a head pair per
// pass, and walks d in 32-deep tiles through a 4-stage cp.async ring in
// shared memory (16-byte copies that bypass the registers). 16-bit
// operands multiply on the tensor cores (mma.sync m16n8k16 from ldmatrix
// fragments; 8 warps, each 32 rows x 64 columns = one head); fp32
// operands on the CUDA cores (each of 256 threads an 8 x 8 block). The
// epilogue adds the bias in fp32, rounds once and stores each head's 64
// columns into its own [S, 64] plane, so no transpose copy follows. Head
// pairs of a row tile are neighbouring blocks, so the x tile is re-read
// from L2. Rows past B * S are masked; d must be a multiple of 16 bytes
// of T. Next for speed: TMA and wgmma.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/qkv_proj.py), launched on the caller's stream,
// allocating nothing.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kHd = 64;        // head_dim
constexpr int kRows = 128;     // rows of x (B * S) per block
constexpr int kCols = 2 * kHd;  // one head pair
constexpr int kDepth = 32;     // contraction rows per tile
constexpr int kStages = 4;     // tiles in the shared-memory ring
constexpr int kThreads = 256;  // 8 warps

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

// Shared-memory layout: kStages (x tile, w tile) stages, then the block's
// 128 bias values in fp32. Rows are padded by 16 bytes, so ldmatrix rows
// and the fp32 path's reads fall on distinct banks and every row stays
// 16-byte aligned for cp.async.
template <typename T>
struct Layout {
  static constexpr int kLdx = kDepth + 16 / sizeof(T);
  static constexpr int kLdw = kCols + 16 / sizeof(T);
  static constexpr int kXBytes = kRows * kLdx * sizeof(T);
  static constexpr int kStageBytes = kXBytes + kDepth * kLdw * sizeof(T);
  static constexpr int kSmem = kStages * kStageBytes + kCols * 4;
};

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

// Tile k0 of x (rows [r0, r0 + kRows), columns [k0, k0 + kDepth)) and of
// w (rows from k0, columns [n0, n0 + kCols)) into a ring stage; zeros past
// M rows and past d (d is a multiple of 16 bytes, so a 16-byte chunk lies
// wholly inside or outside).
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w, int r0,
                                           int M, int k0, int n0, int d,
                                           int N) {
  using L = Layout<T>;
  T* xs = reinterpret_cast<T*>(stage);
  T* ws = reinterpret_cast<T*>(stage + L::kXBytes);
  constexpr int E = 16 / sizeof(T);
  constexpr int XC = kDepth / E, WC = kCols / E;  // chunks per row
  for (int c = threadIdx.x; c < kRows * XC; c += kThreads) {
    const int r = c / XC, kc = (c % XC) * E, k = k0 + kc;
    const bool in = r0 + r < M && k < d;
    cp_async16(xs + r * L::kLdx + kc, in ? x + (long long)(r0 + r) * d + k : x,
               in ? 16 : 0);
  }
  for (int c = threadIdx.x; c < kDepth * WC; c += kThreads) {
    const int r = c / WC, nc = (c % WC) * E, k = k0 + r;
    const bool in = k < d;
    cp_async16(ws + r * L::kLdw + nc, in ? w + (long long)k * N + n0 + nc : w,
               in ? 16 : 0);
  }
}

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

// 16-bit operands, tensor cores: warp (wm, wn) = (warp % 4, warp / 4)
// accumulates rows 32 wm + 16 mt and columns 64 wn + 8 nt as
// acc[(8 mt + nt) * 4 + e] (the m16n8 accumulator layout).
template <typename T>
__device__ __forceinline__ void mma_tile(float acc[64], const T* xs,
                                         const T* ws) {
  using L = Layout<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int kc = 0; kc < kDepth / 16; ++kc) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldsm_x4(a[mt],
              xs + (wm * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                       L::kLdx +
                  kc * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, ws + (kc * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                            L::kLdw +
                       wn * kHd + (2 * np + (lane >> 4)) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        Mma<T>::run(acc + (8 * mt + 2 * np) * 4, a[mt], b[0], b[1]);
        Mma<T>::run(acc + (8 * mt + 2 * np + 1) * 4, a[mt], b[2], b[3]);
      }
    }
  }
}

// fp32 operands, CUDA cores: thread (tr, tc) = (tid / 16, tid % 16) owns
// rows tr + 16 i and columns tc + 16 j as acc[8 i + j].
template <typename T>
__device__ __forceinline__ void fma_tile(float acc[64], const float* xs,
                                         const float* ws) {
  using L = Layout<T>;
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < kDepth; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = xs[(tr + 16 * i) * L::kLdx + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = ws[k * L::kLdw + tc + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[8 * i + j] = fmaf(a[i], b[j], acc[8 * i + j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_proj_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ q,
                T* __restrict__ k, T* __restrict__ v, int S, int M, int d,
                int H) {
  using L = Layout<T>;
  constexpr bool kMma = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem + kStages * L::kStageBytes);
  const int pairs = H / 2;
  const int third = blockIdx.x / pairs, hp = blockIdx.x % pairs;
  const int th = H * kHd, N = 3 * th;
  const int n0 = third * th + hp * kCols;
  const int r0 = blockIdx.y * kRows;
  T* out = third == 0 ? q : third == 1 ? k : v;
  if (threadIdx.x < kCols) bs[threadIdx.x] = to_float(bias[n0 + threadIdx.x]);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int nk = (d + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T>(smem + s * L::kStageBytes, x, w, r0, M, s * kDepth, n0, d,
                    N);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt
    __syncthreads();               // everyone's; tile kt - 1 is done
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_stage<T>(smem + (nxt % kStages) * L::kStageBytes, x, w, r0, M,
                    nxt * kDepth, n0, d, N);
    cp_async_commit();
    const unsigned char* stage = smem + (kt % kStages) * L::kStageBytes;
    const T* xs = reinterpret_cast<const T*>(stage);
    const T* ws = reinterpret_cast<const T*>(stage + L::kXBytes);
    if constexpr (kMma)
      mma_tile<T>(acc, xs, ws);
    else
      fma_tile<T>(acc, xs, ws);
  }
  cp_async_wait<0>();

  // epilogue: + bias in fp32, one rounding, into [B, H, S, 64]
  const int h0 = 2 * hp;
  if constexpr (kMma) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = r0 + wm * 32 + mt * 16 + g + 8 * hh;
        if (m >= M) continue;
        const int b = m / S, s = m % S;
        T* row = out + (((long long)b * H + h0 + wn) * S + s) * kHd;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * t;  // column within the head
          const float* a = acc + (8 * mt + nt) * 4 + 2 * hh;
          const T lo = from_float<T>(a[0] + bs[wn * kHd + c]);
          const T hi = from_float<T>(a[1] + bs[wn * kHd + c + 1]);
          uint32_t packed = (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
                            ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi))
                             << 16);
          *reinterpret_cast<uint32_t*>(row + c) = packed;
        }
      }
  } else {
    const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = r0 + tr + 16 * i;
      if (m >= M) continue;
      const int b = m / S, s = m % S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 16 * j;  // column within the pair
        out[(((long long)b * H + h0 + c / kHd) * S + s) * kHd + c % kHd] =
            from_float<T>(acc[8 * i + j] + bs[c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* q,
                   void* k, void* v, int B, int S, int d, int H,
                   cudaStream_t st) {
  constexpr int smem = Layout<T>::kSmem;
  auto kern = qkv_proj_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * S;
  const dim3 grid(3 * (H / 2), (M + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(q), static_cast<T*>(k),
      static_cast<T*>(v), S, M, d, H);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16. x [B, S, d], w [d, 3 H 64], b [3 H 64],
// q/k/v [B, H, S, 64], all contiguous and 16-byte aligned; H even; d a
// multiple of 16 bytes of the dtype. Returns a cudaError_t; 0 when the
// kernel launched.
extern "C" int paddle_tpu_torch_qkv_proj(const void* x, const void* w,
                                         const void* b, void* q, void* k,
                                         void* v, int B, int S, int d, int H,
                                         int dtype, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (B <= 0 || S <= 0 || d <= 0 || H <= 0 || H % 2 || d % vec)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * S > 2147483647LL ||
      ((long long)B * S + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, w, b, q, k, v, B, S, d, H, st);
    case 1:
      return (int)launch<__nv_bfloat16>(x, w, b, q, k, v, B, S, d, H, st);
    case 2:
      return (int)launch<__half>(x, w, b, q, k, v, B, S, d, H, st);
  }
  return (int)cudaErrorInvalidValue;
}
