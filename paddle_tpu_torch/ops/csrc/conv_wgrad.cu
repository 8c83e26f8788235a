// Split-K 1x1-convolution weight gradient for Hopper (sm_90a):
//   dW[Ci, Co] (fp32) = x[N, Ci]^T @ dy[N, Co]
// over fp32, bf16 or fp16 inputs (x and dy of one dtype), products and
// sums in fp32.
//
// Replaces paddle_tpu/ops/pallas/conv_wgrad.py:wgrad_1x1 (its kernel
// `kern`): the TPU grid walks N in `chunk`-row steps in order on one core
// and adds each chunk's [Ci, Co] product into one fp32 output block. Here
// blocks run in parallel and in no order, so the sum across chunks is a
// second pass: pass 1 gives one block to each (64 x 64 output tile,
// N-chunk) and writes that chunk's fp32 partial product; pass 2 sums the
// partials of each output element in chunk order 0, 1, 2, ..., the TPU
// grid's order. No atomics: a run gives the same bits as the one before,
// and kernel and plain version differ only in the order of the sums
// inside a chunk.
//
// What bounds it: at the ResNet-50 shape the JAX docstring measures
// ([N = 401408, Ci = 256, Co = 64] bf16) x and dy are 257 MB read once
// against 3.4e9 flops: ~13 flops a byte, so device-memory bytes bound it
// (0.077 ms at 3.35 TB/s). So pass 1 streams its chunk's rows of x (the
// tile's 64 columns) and dy through a 4-stage cp.async ring of 32-row
// tiles in shared memory; the 4 output tiles of one chunk are neighbouring
// blocks, so a chunk of dy comes from device memory once and from L2 for
// the others. The partials are 6.4 MB (98 chunks of [256, 64] fp32) and
// pass 2 reads them once. 16-bit operands multiply on the tensor cores
// (mma.sync m16n8k16; x's tile is [n][ci] in shared memory, so its
// fragments come through ldmatrix.trans; 4 warps of 16 output rows x 64
// columns); fp32 on the CUDA cores (each thread a 4 x 8 block). Ci and Co
// must be multiples of 16 bytes of the dtype; any N, chunk dividing N.
// Next for speed: bigger tiles so dy is read from L2 fewer times, and
// TMA.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/conv_wgrad.py), launched on the caller's stream,
// allocating nothing (the wrapper passes the partials' scratch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;      // output rows (Ci) and columns (Co) a block
constexpr int kDepth = 32;     // rows of N per staged tile
constexpr int kStages = 4;     // tiles in the shared-memory ring
constexpr int kThreads = 128;  // 4 warps

template <typename T>
struct Layout {
  static constexpr int kLd = kTile + 16 / sizeof(T);  // padded tile row
  static constexpr int kTileBytes = kDepth * kLd * sizeof(T);
  static constexpr int kStageBytes = 2 * kTileBytes;  // x tile, dy tile
  static constexpr int kSmem = kStages * kStageBytes;
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

// Rows [n0, n0 + kDepth) of x (columns [c0, c0 + 64)) and of dy (columns
// [o0, o0 + 64)) into a ring stage; zeros at or past row `end` and past
// Ci / Co (multiples of 16 bytes, so a 16-byte chunk lies wholly inside
// or outside).
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const T* __restrict__ x,
                                           const T* __restrict__ dy,
                                           long long n0, long long end,
                                           int c0, int o0,
                                           int Ci, int Co) {
  using L = Layout<T>;
  T* xs = reinterpret_cast<T*>(stage);
  T* ds = reinterpret_cast<T*>(stage + L::kTileBytes);
  constexpr int E = 16 / sizeof(T), C = kTile / E;  // chunks per row
  for (int i = threadIdx.x; i < 2 * kDepth * C; i += kThreads) {
    const int which = i / (kDepth * C), j = i % (kDepth * C);
    const int r = j / C, cc = (j % C) * E;
    const long long n = (long long)n0 + r;
    if (which == 0) {
      const bool in = n < end && c0 + cc < Ci;
      cp_async16(xs + r * L::kLd + cc, in ? x + n * Ci + c0 + cc : x,
                 in ? 16 : 0);
    } else {
      const bool in = n < end && o0 + cc < Co;
      cp_async16(ds + r * L::kLd + cc, in ? dy + n * Co + o0 + cc : dy,
                 in ? 16 : 0);
    }
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-bit operands, tensor cores: warp w accumulates output rows 16 w + g
// (+ 8) and columns 8 nt + 2 t (+ 1) in acc[nt] (the m16n8 accumulator
// layout) from A = xs^T (xs is [n][ci], so A's fragments are loaded
// transposed) and B = ds ([n][co]).
template <typename T>
__device__ __forceinline__ void mma_tile(float acc[8][4], const T* xs,
                                         const T* ds) {
  constexpr int LD = Layout<T>::kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < kDepth / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4_t(a, xs + (kc * 16 + 8 * (lane >> 4) + (lane & 7)) * LD +
                     warp * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, ds + (kc * 16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * LD +
                       (2 * np + (lane >> 4)) * 8);
      Mma<T>::run(acc[2 * np], a, b[0], b[1]);
      Mma<T>::run(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// fp32 operands, CUDA cores: thread (tr, tc) = (tid / 8, tid % 8) owns
// output rows tr + 16 i (i < 4) and columns tc + 8 j (j < 8) as
// acc[i][j] (acc viewed as [4][8]).
__device__ __forceinline__ void fma_tile(float acc[8][4], const float* xs,
                                         const float* ds) {
  constexpr int LD = Layout<float>::kLd;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  float* a2 = &acc[0][0];
#pragma unroll 4
  for (int k = 0; k < kDepth; ++k) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[k * LD + tr + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = ds[k * LD + tc + 8 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) a2[8 * i + j] = fmaf(a[i], b[j], a2[8 * i + j]);
  }
}

// Pass 1: block (tile, chunk) writes part[chunk][Ci][Co] over its tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ part, int Ci, int Co, int chunk) {
  using L = Layout<T>;
  constexpr bool kMma = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles_co = (Co + kTile - 1) / kTile;
  const int c0 = (blockIdx.x / tiles_co) * kTile;
  const int o0 = (blockIdx.x % tiles_co) * kTile;
  const long long start = (long long)blockIdx.y * chunk, end = start + chunk;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int nk = (chunk + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T>(smem + s * L::kStageBytes, x, dy, start + s * kDepth, end,
                    c0, o0, Ci, Co);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt
    __syncthreads();               // everyone's; tile kt - 1 is done
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_stage<T>(smem + (nxt % kStages) * L::kStageBytes, x, dy,
                    start + (long long)nxt * kDepth, end, c0, o0, Ci, Co);
    cp_async_commit();
    const unsigned char* stage = smem + (kt % kStages) * L::kStageBytes;
    const T* xs = reinterpret_cast<const T*>(stage);
    const T* ds = reinterpret_cast<const T*>(stage + L::kTileBytes);
    if constexpr (kMma)
      mma_tile<T>(acc, xs, ds);
    else
      fma_tile(acc, xs, ds);
  }
  cp_async_wait<0>();
  float* out = part + (long long)blockIdx.y * Ci * Co;
  if constexpr (kMma) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c0 + warp * 16 + g + 8 * h;
      if (row >= Ci) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = o0 + nt * 8 + 2 * t;  // Co is even: col + 1 < Co
        if (col < Co)
          *reinterpret_cast<float2*>(out + (long long)row * Co + col) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  } else {
    const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
    const float* a2 = &acc[0][0];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = c0 + tr + 16 * i;
      if (row >= Ci) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = o0 + tc + 8 * j;
        if (col < Co) out[(long long)row * Co + col] = a2[8 * i + j];
      }
    }
  }
}

// Pass 2: dw[e] = ((part[0][e] + part[1][e]) + part[2][e]) + ..., in chunk
// order, one thread an element.
__global__ void __launch_bounds__(256)
wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                 long long elems, int chunks) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= elems) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(long long)c * elems + e];
  dw[e] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* part, float* dw,
                   long long N, int Ci, int Co, int chunk, cudaStream_t st) {
  constexpr int smem = Layout<T>::kSmem;
  auto kern = wgrad_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (int)(N / chunk);
  const dim3 grid(((Ci + kTile - 1) / kTile) * ((Co + kTile - 1) / kTile),
                  chunks);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(dy), part, Ci, Co,
                                     chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long elems = (long long)Ci * Co;
  wgrad_sum_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(
      part, dw, elems, chunks);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (x and dy alike). x [N, Ci], dy [N, Co]
// contiguous and 16-byte aligned; Ci and Co multiples of 16 bytes of the
// dtype; chunk divides N, N / chunk <= 65535; part fp32 [N / chunk, Ci,
// Co] scratch; dw fp32 [Ci, Co]. Returns a cudaError_t; 0 when both
// passes launched.
extern "C" int paddle_tpu_torch_wgrad_1x1(const void* x, const void* dy,
                                          void* part, void* dw, long long N,
                                          int Ci, int Co, int chunk,
                                          int dtype, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (N <= 0 || Ci <= 0 || Co <= 0 || chunk <= 0 || N % chunk ||
      N / chunk > 65535 || Ci % vec || Co % vec)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, dy, p, o, N, Ci, Co, chunk, st);
    case 1:
      return (int)launch<__nv_bfloat16>(x, dy, p, o, N, Ci, Co, chunk, st);
    case 2:
      return (int)launch<__half>(x, dy, p, o, N, Ci, Co, chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}
