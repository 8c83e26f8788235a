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
//
// Two kernels.
//
// qkv_proj_wgmma_kernel, bf16 and fp16: x [M = B S, d] is wgmma's K-major
// A operand and w_qkv, N-contiguous, its MN-major B operand, both brought
// into shared memory by TMA in the 128-byte swizzle (zeros past d and past
// M). A block computes 128 x 256 tiles of [M, N = 3 H 64]: two consumer
// warpgroups of 64 rows each issue wgmma m64n256k16 (128 fp32 sums a
// thread) on the stages of a 4-deep ring (128 x 64 of x and 64 x 256 of
// w, 48 KB a stage) that one producer warp keeps filled, each stage's fill
// and release tracked by an mbarrier pair. The grid is persistent (the
// wrapper's `plan`: a block on each SM walking tiles along N first, so
// the blocks in flight share x's row tiles in L2), and a block's producer
// fills the next tile's stages while its consumers store the last. The
// epilogue walks the tile's 64-column slabs: each is one head of one third
// (a tile may straddle the thirds), its bias added in fp32 before the one
// rounding, staged in shared memory and written by a TMA store into its
// [S, 64] plane, which runs on while the consumers go ahead (rows of a
// slab that cross a batch, where S % 64 != 0, are stored row by row).
// Measured on an H100 (tools/torch_qkv_ab.py --probe): the tile loads
// from L2 take most of the time (48 KB a stage for 4 MFLOP); w tiles
// multicast to clusters of two blocks would cut them by a third but ran
// slower.
//
// qkv_proj_kernel, fp32: a block owns a 128-row tile of the B * S rows
// times one head pair (128 columns) of one third, walks d in 32-deep
// tiles through a 4-stage cp.async ring, and multiplies on the CUDA
// cores (each of 256 threads an 8 x 8 block). Rows past B * S are masked.
//
// d must be a multiple of 16 bytes of T (TMA's row pitch, cp.async's
// chunk). Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/qkv_proj.py), launched on the caller's stream,
// allocating nothing.

#include <algorithm>

#include "hopper.cuh"

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

// Shared-memory layout of the fp32 kernel: kStages (x tile, w tile)
// stages, then the block's 128 bias values in fp32. Rows are padded by 16
// bytes, so the column reads fall on distinct banks and every row stays
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
    fma_tile<T>(acc, xs, ws);
  }
  cp_async_wait<0>();

  // epilogue: + bias in fp32, one rounding, into [B, H, S, 64]
  const int h0 = 2 * hp;
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

// ------------------------------------------- bf16 / fp16: TMA + wgmma

namespace wg {

using namespace hopper;

constexpr int kBM = 128;                   // rows of x (B * S) a tile
constexpr int kBN = 256;                   // columns of w_qkv a tile
constexpr int kBK = 64;                    // depth a stage: 128-byte rows
constexpr int kStages = 4;                 // stages in the ring
constexpr int kConsumers = 256;            // two warpgroups, 64 rows each
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kABytes = kBM * kBK * 2;     // the x tile
constexpr int kBoxBytes = kBK * 128;       // 64 columns of the w tile
constexpr int kBoxes = kBN / 64;
constexpr int kStageBytes = kABytes + kBoxes * kBoxBytes;
constexpr int kRing = kStages * kStageBytes;
constexpr int kSlabBytes = 64 * 128;  // a staged 64 x 64 output slab
constexpr int kStaging = 2 * 2 * kSlabBytes;  // two a warpgroup
constexpr int kSmem = 1024 + kRing + kStaging + 2 * kStages * 8;
static_assert(kBN % 64 == 0 && kBN <= 256, "a wgmma's N");
static_assert(kSmem <= 232448, "shared memory of one block");

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const T a = from_float<T>(lo), b = from_float<T>(hi);
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&a)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(&b)) << 16);
}

// Tile t of the ceil(M / kBM) x ncol tiles, along N first.
__device__ __forceinline__ void tile_origin(int t, int ncol, int& m0,
                                            int& n0) {
  m0 = (t / ncol) * kBM;
  n0 = (t % ncol) * kBN;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
qkv_proj_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const T* __restrict__ bias, T* __restrict__ q,
                      T* __restrict__ k, T* __restrict__ v, int S, int M,
                      int d, int H) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing + kStaging);
  uint64_t* empty = full + kStages;
  const int slabs = 3 * H;  // 64-column slabs of w_qkv: (third, head)
  const int ncol = (slabs * kHd + kBN - 1) / kBN;
  const int tiles = ((M - 1) / kBM + 1) * ncol;
  const int nk = (d + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ producer warp
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, ncol, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int stage = it % kStages;
          mbar_wait(&empty[stage], ((it / kStages) & 1) ^ 1);
          unsigned char* st = ring + stage * kStageBytes;
          mbar_arrive_tx(&full[stage], kStageBytes);
          tma_load_2d(st, &xmap, kt * kBK, m0, &full[stage]);
#pragma unroll
          for (int bx = 0; bx < kBoxes; ++bx)
            tma_load_2d(st + kABytes + bx * kBoxBytes, &wmap, n0 + 64 * bx,
                        kt * kBK, &full[stage]);
        }
      }
    }
  } else {
    // ------------------------------------------ consumer warpgroups
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    unsigned char* stg = ring + kRing + wg * 2 * kSlabBytes;
    float acc[kBN / 2];
    int it = 0, staged = 0;  // stages and slabs so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      tile_origin(t, ncol, m0, n0);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int stage = it % kStages;
        mbar_wait(&full[stage], (it / kStages) & 1);
        const uint32_t xs =
            smem_u32(ring + stage * kStageBytes) + wg * 64 * 128;
        const uint32_t ws = smem_u32(ring + stage * kStageBytes + kABytes);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kBK / 16; ++s)
          wgmma_ss<T, kBN, 1>(acc, desc_k(xs + 32 * s),
                              desc_mn(ws + 2048 * s, kBoxBytes), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (kt > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      mbar_arrive(&empty[(it - 1) % kStages]);

      // Epilogue, one 64-column slab (one head of one third) at a time:
      // the bias added in fp32, rounded once, staged in one of the
      // warpgroup's two buffers (the 128-byte swizzle) and stored by TMA,
      // whose writes run on while the next slab and tile go ahead.
#pragma unroll
      for (int sl = 0; sl < kBoxes; ++sl) {
        const int slab = n0 / kHd + sl;
        if (slab < slabs) {  // the same for the whole block
          unsigned char* buf = stg + (staged++ & 1) * kSlabBytes;
          if (tid == 0) bulk_wait_read<1>();  // its last store has read it
          named_sync(1 + wg, 128);
          const T* bs = bias + slab * kHd;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = 8 * j + 2 * qd, a = 4 * (8 * sl + j);
            const float b0 = to_float(bs[c]), b1 = to_float(bs[c + 1]);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 16 * warp + g + 8 * hh;
              *reinterpret_cast<uint32_t*>(buf + r * 128 +
                                           ((j ^ (r & 7)) << 4) + 4 * qd) =
                  pack2<T>(acc[a + 2 * hh] + b0, acc[a + 2 * hh + 1] + b1);
            }
          }
          fence_proxy_async();
          named_sync(1 + wg, 128);
          // Row m of x is row m % S of plane (m / S, head): one TMA store
          // where the slab's rows lie in one batch, else (S not a multiple
          // of 64) 16-byte stores row by row.
          const int third = slab / H, head = slab % H;
          const int mb = m0 + 64 * wg, me = min(mb + 64, M) - 1;
          if (mb / S == me / S) {
            if (tid == 0 && mb <= me)
              tma_store_3d(third == 0 ? &qmap : third == 1 ? &kmap : &vmap,
                           buf, 0, mb % S, mb / S * H + head);
          } else {
            T* out = third == 0 ? q : third == 1 ? k : v;
            for (int i = tid; i < 64 * 8; i += 128) {
              const int r = i >> 3, ch = i & 7, m = mb + r;
              if (m <= me)
                *reinterpret_cast<uint4*>(
                    out + (((long long)(m / S) * H + head) * S + m % S) * kHd +
                    8 * ch) = *reinterpret_cast<const uint4*>(
                    buf + r * 128 + ((ch ^ (r & 7)) << 4));
            }
          }
          if (tid == 0) bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait<0>();  // the stores are done with the buffers
  }
}

// `grid`: blocks (at most one a tile are launched).
template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* q,
                   void* k, void* v, int B, int S, int d, int H, int grid,
                   cudaStream_t st) {
  if (grid <= 0) return cudaErrorInvalidValue;
  const long long M = (long long)B * S, N = 3LL * H * kHd;
  CUtensorMap xmap, wmap;
  cudaError_t err = make_map<T, 2>(&xmap, x, {d, M}, {d}, {kBK, kBM});
  if (err != cudaSuccess) return err;
  err = make_map<T, 2>(&wmap, w, {N, d}, {N}, {64, kBK});
  if (err != cudaSuccess) return err;
  CUtensorMap omap[3];  // q, k and v as B * H planes of [S, 64]
  void* const outs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    err = make_map<T, 3>(&omap[i], outs[i], {kHd, S, (long long)B * H},
                         {kHd, (long long)S * kHd}, {64, 64, 1});
    if (err != cudaSuccess) return err;
  }
  auto kern = qkv_proj_wgmma_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  kern<<<(unsigned)std::min<long long>(grid, tiles), kThreads, kSmem, st>>>(
      xmap, wmap, omap[0], omap[1], omap[2], static_cast<const T*>(b),
      static_cast<T*>(q), static_cast<T*>(k), static_cast<T*>(v), S, (int)M,
      d, H);
  return cudaGetLastError();
}

}  // namespace wg

bool valid(int B, int S, int d, int H, int vec) {
  return B > 0 && S > 0 && d > 0 && H > 0 && H % 2 == 0 && d % vec == 0 &&
         (long long)B * S <= 2147483647LL &&
         ((long long)B * S + kRows - 1) / kRows <= 65535;
}

}  // namespace

// x [B, S, d], w [d, 3 H 64], b [3 H 64], q/k/v [B, H, S, 64], all
// contiguous and 16-byte aligned; H even; d a multiple of 16 bytes of the
// dtype. Each entry returns a cudaError_t; 0 when the kernel launched.

// qkv_proj_kernel: fp32 operands.
extern "C" int paddle_tpu_torch_qkv_proj(const void* x, const void* w,
                                         const void* b, void* q, void* k,
                                         void* v, int B, int S, int d, int H,
                                         void* stream) {
  if (!valid(B, S, d, H, 4)) return (int)cudaErrorInvalidValue;
  return (int)launch<float>(x, w, b, q, k, v, B, S, d, H,
                            static_cast<cudaStream_t>(stream));
}

// qkv_proj_wgmma_kernel: dtype 1 bf16, 2 fp16; `grid` blocks walk the
// tiles (`plan` in ops/qkv_proj.py).
extern "C" int paddle_tpu_torch_qkv_proj_wgmma(const void* x, const void* w,
                                               const void* b, void* q,
                                               void* k, void* v, int B, int S,
                                               int d, int H, int dtype,
                                               int grid, void* stream) {
  if (!valid(B, S, d, H, 8)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)wg::launch<__nv_bfloat16>(x, w, b, q, k, v, B, S, d, H, grid,
                                          st);
  if (dtype == 2)
    return (int)wg::launch<__half>(x, w, b, q, k, v, B, S, d, H, grid, st);
  return (int)cudaErrorInvalidValue;
}
