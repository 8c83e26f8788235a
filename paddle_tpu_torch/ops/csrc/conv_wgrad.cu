// Split-K 1x1-convolution weight gradient for Hopper (sm_90a):
//   dW[Ci, Co] (fp32) = x[N, Ci]^T @ dy[N, Co]
// over fp32, bf16 or fp16 inputs (x and dy of one dtype), products and
// sums in fp32.
//
// Replaces paddle_tpu/ops/pallas/conv_wgrad.py:wgrad_1x1 (its kernel
// `kern`): the TPU grid walks N in `chunk`-row steps in order on one core
// and adds each chunk's [Ci, Co] product into one fp32 output block. Here
// blocks run in parallel and in no order, so N is cut into splits, each
// split's product is an fp32 partial, and the partials of an output
// element are added in a fixed order: a launch gives the same bits as the
// one before. The kernel's split does not follow `chunk`; kernel and plain
// version differ only in the order of the fp32 sums.
//
// What bounds it: at the ResNet-50 shape the JAX docstring measures
// ([N = 401408, Ci = 256, Co = 64] bf16) x and dy are 257 MB read once
// against 2 N Ci Co = 1.32e10 flops: ~51 flops a byte, under the ~295 at
// which the tensor cores would bound it, so device-memory bytes bound it
// (0.077 ms at 3.35 TB/s). The design streams x and dy once, in whole
// rows, at as much of the card's bandwidth as it can keep in flight.
//
// wgrad_wgmma_kernel, 16-bit operands:
//   * M is the wider of Ci and Co (x, or dy with the output stored
//     transposed), N the other; K is the rows of N. A block owns a tile
//     of 256 M x BN (64 or 128) outputs: two consumer warpgroups, each
//     two m64nBNk16 accumulators, both operands read from shared memory
//     MN-major (`desc_mn`, as TMA stores 64-value rows under the 128-byte
//     swizzle). At ResNet-50's shape the tile is all of dW, so x and dy
//     each come from device memory exactly once.
//   * A producer warp keeps a ring of 32-row stages in flight by TMA (2-D
//     maps over the A and B tensors: four 64-column boxes of A and BN/64
//     of B a stage, 20 or 24 KB, 8 stages), L2 evict-first, each stage's
//     fill and release tracked by an mbarrier pair. TMA zero-fills rows
//     past N and columns past Ci and Co; the epilogue masks its stores.
//     The consumers need at most 128 accumulator registers, inside the
//     224 a thread of this block may hold, so no setmaxnreg split is
//     needed.
//   * Persistent: `grid` blocks (at most one an SM) walk the items
//     (output tile, split of N) in item order, splits-major, so the
//     blocks in flight at a time read the same rows (L2 serves the
//     repeats where there are several tiles); the ring runs on across a
//     block's items. Split s takes every splits-th 32-row tile from s, so
//     the blocks sweep N together; the splits' counts of row tiles differ
//     by at most one. `plan` in ops/conv_wgrad.py picks BN, the splits
//     and the grid; `split_rows` spells out each split's tiles.
//   * One launch, one finish: with more than one split a tile, each item
//     stores its fp32 partial, the grid synchronises (a cooperative
//     launch: every block is resident), and every block then sums a share
//     of dW's elements over the splits in a fixed order (runs of
//     consecutive splits, each in split order, then the runs in order; 8
//     runs at 132 splits, one at 16), each thread keeping its run's loads
//     in flight. With one split a tile the items store dW directly.
//   * Measured on an H100 (PERF.md; tools/torch_wgrad_ab.py --sweep
//     --probe): the loads alone take the kernel's time; 64 or 128 rows a
//     stage, 4 to 6 stages, and contiguous ranges a split instead of
//     interleaved row tiles were no faster.
// wgrad_fp32_kernel, fp32 operands (wgmma's TF32 takes only K-major
// operands and keeps ~3 digits): CUDA cores, a block per (64 x 64 output
// tile, range of 32-row tiles) through a 4-stage cp.async ring, each
// thread a 4 x 8 block; wgrad_sum_kernel adds the ranges' partials in
// range order (a second launch).
// Ci and Co must be multiples of 16 bytes of the dtype (TMA strides);
// any N.
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/conv_wgrad.py), launched on the caller's stream,
// allocating nothing (the wrapper passes the partials' scratch).

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------ 16-bit: TMA + wgmma

namespace wg {

using namespace hopper;

constexpr int kBM = 256;                   // output rows (M) a tile
constexpr int kRows = 32;                  // rows of N a stage
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBox = kRows * 128;          // kRows rows of 64 16-bit values

template <int BN>
struct Cfg {
  static constexpr int kABytes = (kBM / 64) * kBox;
  static constexpr int kBBytes = (BN / 64) * kBox;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = BN == 64 ? 8 : 8;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kRing + 2 * kStages * 8;
};
static_assert(Cfg<64>::kRing >= kConsumers * 16, "finish fits the ring");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Item i's output tile (tm, tn) and split s: row tiles s, s + splits,
// ... < r1.
struct Item {
  int tm, tn;
  long long r0, r1, step;
};
__device__ __forceinline__ Item item_of(int i, int tiles_n, int tiles,
                                        int splits, long long row_tiles) {
  const int s = i / tiles, t = i % tiles;
  return {t / tiles_n, t % tiles_n, s, row_tiles, splits};
}

// Grid: `grid` blocks walk items blockIdx.x, + gridDim.x, ... of
// splits x tiles (item = split * tiles + tile). A is [N, M], B [N, Nd]
// (maps amap / bmap); output element (m, n) is dW[m][n], or dW[n][m]
// with `trans`; `part` [splits][M x Nd] fp32 when splits > 1.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   float* __restrict__ part, float* __restrict__ dw,
                   long long N, int M, int Nd, int trans, int splits) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kRing);
  uint64_t* empty = full + C::kStages;
  const int tiles_n = (Nd + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
  const int items = tiles * splits;
  const long long row_tiles = (N + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ producer warp
    if (threadIdx.x == kConsumers) {
      const uint64_t once = l2_evict_first();  // x and dy: read once
      long long it = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item w = item_of(i, tiles_n, tiles, splits, row_tiles);
        for (long long r = w.r0; r < w.r1; r += w.step, ++it) {
          const int stage = (int)(it % C::kStages);
          mbar_wait(&empty[stage], (int)((it / C::kStages) & 1) ^ 1);
          unsigned char* st = ring + stage * C::kStageBytes;
          mbar_arrive_tx(&full[stage], C::kStageBytes);
          const int row = (int)(r * kRows);
#pragma unroll
          for (int b = 0; b < kBM / 64; ++b)
            tma_load_2d(st + b * kBox, &amap, w.tm * kBM + 64 * b, row,
                        &full[stage], once);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(st + C::kABytes + b * kBox, &bmap, w.tn * BN + 64 * b,
                        row, &full[stage], once);
        }
      }
    }
  } else {
    // ---------------------------------------- two consumer warpgroups
    const int wgi = threadIdx.x >> 7;           // rows 128 wgi + [0, 128)
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    long long it = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item w = item_of(i, tiles_n, tiles, splits, row_tiles);
      float acc[2][BN / 2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[j][e] = 0.f;
      for (long long r = w.r0; r < w.r1; r += w.step, ++it) {
        const int stage = (int)(it % C::kStages);
        mbar_wait(&full[stage], (int)((it / C::kStages) & 1));
        const uint32_t as =
            smem_u32(ring + stage * C::kStageBytes) + 2 * wgi * kBox;
        const uint32_t bs = smem_u32(ring + stage * C::kStageBytes) +
                            C::kABytes;
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < kRows / 16; ++st) {
          const uint64_t b = desc_mn(bs + st * 2048, kBox);
          wgmma_ss<T, BN, 1, 1>(acc[0], desc_mn(as + st * 2048, kBox), b, 1);
          wgmma_ss<T, BN, 1, 1>(acc[1], desc_mn(as + kBox + st * 2048, kBox),
                                b, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the stage before this one is read: free it
        if (r > w.r0) mbar_arrive(&empty[(int)((it - 1) % C::kStages)]);
      }
      wgmma_wait<0>();
      if (w.r1 > w.r0) mbar_arrive(&empty[(int)((it - 1) % C::kStages)]);
      // thread (warp, lane) of warpgroup wgi holds, of m-tile j, rows
      // 16 warp + lane / 4 (+ 8) and columns 8 k + 2 (lane % 4) (+ 1)
      float* out = splits > 1 ? part + (long long)(i / tiles) * M * Nd : dw;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = w.tm * kBM + 128 * wgi + 64 * j + 16 * warp +
                        (lane >> 2) + 8 * h;
          if (m >= M) continue;
#pragma unroll
          for (int k = 0; k < BN / 8; ++k) {
            const int n = w.tn * BN + 8 * k + 2 * (lane & 3);  // Nd even
            if (n >= Nd) continue;
            const float v0 = acc[j][4 * k + 2 * h];
            const float v1 = acc[j][4 * k + 2 * h + 1];
            if (trans) {
              out[(long long)n * M + m] = v0;
              out[(long long)(n + 1) * M + m] = v1;
            } else {
              *reinterpret_cast<float2*>(out + (long long)m * Nd + n) =
                  make_float2(v0, v1);
            }
          }
        }
    }
  }
  if (splits == 1) return;

  // ------------------------------------------------------------ finish
  cooperative_groups::this_grid().sync();  // every partial is stored
  if (threadIdx.x >= kConsumers) return;
  // dW's float4 elements over the splits in runs of consecutive splits
  // (8 runs at 128 splits or more, fewer below, so that a thread keeps
  // its run's loads in flight): consumer thread (run, e) sums its run of
  // element e in split order, then the runs are added in order
  const int runs = splits >= 128 ? 8 : splits >= 64 ? 4 : splits >= 32 ? 2
                                                                      : 1;
  const int per = kConsumers / runs;  // elements a block a pass
  const int run = threadIdx.x / per, e_in = threadIdx.x % per;
  float4* red = reinterpret_cast<float4*>(ring);  // [runs][per]
  const long long e4 = (long long)M * Nd / 4;     // Nd % 4 == 0
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4* d4 = reinterpret_cast<float4*>(dw);
  const int s0 = run * splits / runs, s1 = (run + 1) * splits / runs;
  for (long long base = (long long)blockIdx.x * per; base < e4;
       base += (long long)gridDim.x * per) {
    const long long e = base + e_in;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < e4) {
#pragma unroll 8
      for (int r = s0; r < s1; ++r) {
        const float4 v = p4[(long long)r * e4 + e];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    if (runs == 1) {
      if (e < e4) d4[e] = s;
      continue;
    }
    red[threadIdx.x] = s;
    consumers_sync();
    if (run == 0 && e < e4) {
      float4 t = s;
      for (int g = 1; g < runs; ++g) {
        const float4 v = red[g * per + e_in];
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
      d4[e] = t;
    }
    consumers_sync();
  }
}

template <typename T, int BN>
cudaError_t launch(const void* x, const void* dy, float* part, float* dw,
                   long long N, int Ci, int Co, int splits, int grid,
                   cudaStream_t st) {
  const bool trans = Co > Ci;  // A is the wider operand
  const void* a = trans ? dy : x;
  const void* b = trans ? x : dy;
  const int M = trans ? Co : Ci, Nd = trans ? Ci : Co;
  CUtensorMap amap = {}, bmap = {};
  cudaError_t err = make_map<T, 2>(&amap, a, {(long long)M, N},
                                   {(long long)M}, {64, kRows});
  if (err != cudaSuccess) return err;
  err = make_map<T, 2>(&bmap, b, {(long long)Nd, N}, {(long long)Nd},
                       {64, kRows});
  if (err != cudaSuccess) return err;
  auto kern = wgrad_wgmma_kernel<T, BN>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<BN>::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<BN>::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // the finish's grid sync
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, amap, bmap, part, dw, N, M, Nd,
                           (int)trans, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wg

// ------------------------------------------------- fp32: CUDA cores

namespace f32 {

constexpr int kTile = 64;      // output rows (Ci) and columns (Co) a block
constexpr int kDepth = 32;     // rows of N per staged tile
constexpr int kStages = 4;     // tiles in the shared-memory ring
constexpr int kThreads = 128;  // 4 warps
constexpr int kLd = kTile + 4;  // padded tile row, in floats
constexpr int kTileBytes = kDepth * kLd * 4;
constexpr int kStageBytes = 2 * kTileBytes;  // x tile, dy tile
constexpr int kSmem = kStages * kStageBytes;

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
// [o0, o0 + 64)) into a ring stage; zeros at or past row N and past Ci /
// Co (multiples of 4, so a 16-byte chunk lies wholly inside or outside).
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const float* __restrict__ x,
                                           const float* __restrict__ dy,
                                           long long n0, long long N, int c0,
                                           int o0, int Ci, int Co) {
  float* xs = reinterpret_cast<float*>(stage);
  float* ds = reinterpret_cast<float*>(stage + kTileBytes);
  constexpr int C = kTile / 4;  // chunks per row
  for (int i = threadIdx.x; i < 2 * kDepth * C; i += kThreads) {
    const int which = i / (kDepth * C), j = i % (kDepth * C);
    const int r = j / C, cc = (j % C) * 4;
    const long long n = n0 + r;
    if (which == 0) {
      const bool in = n < N && c0 + cc < Ci;
      cp_async16(xs + r * kLd + cc, in ? x + n * Ci + c0 + cc : x,
                 in ? 16 : 0);
    } else {
      const bool in = n < N && o0 + cc < Co;
      cp_async16(ds + r * kLd + cc, in ? dy + n * Co + o0 + cc : dy,
                 in ? 16 : 0);
    }
  }
}

// Thread (tr, tc) = (tid / 8, tid % 8) owns output rows tr + 16 i (i < 4)
// and columns tc + 8 j (j < 8) as acc[8 i + j].
__device__ __forceinline__ void fma_tile(float acc[32], const float* xs,
                                         const float* ds) {
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
#pragma unroll 4
  for (int k = 0; k < kDepth; ++k) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = xs[k * kLd + tr + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = ds[k * kLd + tc + 8 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[8 * i + j] = fmaf(a[i], b[j], acc[8 * i + j]);
  }
}

// Block (tile, split) writes part[split][Ci][Co] over its tile: the
// product of row tiles [split R / S, (split + 1) R / S) of R = N / 32.
__global__ void __launch_bounds__(kThreads)
wgrad_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ part, long long N, int Ci, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles_co = (Co + kTile - 1) / kTile;
  const int c0 = (blockIdx.x / tiles_co) * kTile;
  const int o0 = (blockIdx.x % tiles_co) * kTile;
  const long long row_tiles = (N + kDepth - 1) / kDepth;
  const long long t0 = blockIdx.y * row_tiles / gridDim.y;
  const int nk = (int)((blockIdx.y + 1) * row_tiles / gridDim.y - t0);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(smem + s * kStageBytes, x, dy, (t0 + s) * kDepth, N, c0, o0,
                 Ci, Co);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt
    __syncthreads();               // everyone's; tile kt - 1 is done
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_stage(smem + (nxt % kStages) * kStageBytes, x, dy,
                 (t0 + nxt) * kDepth, N, c0, o0, Ci, Co);
    cp_async_commit();
    const unsigned char* stage = smem + (kt % kStages) * kStageBytes;
    fma_tile(acc, reinterpret_cast<const float*>(stage),
             reinterpret_cast<const float*>(stage + kTileBytes));
  }
  cp_async_wait<0>();
  float* out = part + (long long)blockIdx.y * Ci * Co;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + tr + 16 * i;
    if (row >= Ci) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = o0 + tc + 8 * j;
      if (col < Co) out[(long long)row * Co + col] = acc[8 * i + j];
    }
  }
}

// dw[e] = ((part[0][e] + part[1][e]) + part[2][e]) + ..., in range
// order, one thread an element.
__global__ void __launch_bounds__(256)
wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                 long long elems, int splits) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= elems) return;
  float s = 0.f;
  for (int c = 0; c < splits; ++c) s += part[(long long)c * elems + e];
  dw[e] = s;
}

cudaError_t launch(const void* x, const void* dy, float* part, float* dw,
                   long long N, int Ci, int Co, int splits,
                   cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Ci + kTile - 1) / kTile) * ((Co + kTile - 1) / kTile),
                  splits);
  wgrad_fp32_kernel<<<grid, kThreads, kSmem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), part, N,
      Ci, Co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long elems = (long long)Ci * Co;
  wgrad_sum_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(
      part, dw, elems, splits);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (x and dy alike). x [N, Ci], dy [N, Co]
// contiguous and 16-byte aligned; Ci and Co multiples of 16 bytes of the
// dtype; any N >= 1 (16-bit: below 2^31, TMA's coordinates). `bn`
// (16-bit: 64 or 128, the output tile's width along min(Ci, Co)),
// `splits` (splits of N a tile) and `grid` (16-bit: persistent blocks, at
// most one an SM) are ops/conv_wgrad.py:plan's.
// part: fp32 [splits, Ci, Co] scratch (16-bit with splits == 1: unused,
// may be null); dw fp32 [Ci, Co]. Returns a cudaError_t; 0 when the
// kernels launched.
extern "C" int paddle_tpu_torch_wgrad_1x1(const void* x, const void* dy,
                                          void* part, void* dw, long long N,
                                          int Ci, int Co, int dtype, int bn,
                                          int splits, int grid,
                                          void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (N <= 0 || Ci <= 0 || Co <= 0 || Ci % vec || Co % vec || splits <= 0 ||
      grid <= 0 || (splits > 1 && part == nullptr) ||
      (dtype == 0 && splits > 65535) || (dtype != 0 && N > 2147483647LL))
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32::launch(x, dy, p, o, N, Ci, Co, splits, st);
  if (dtype == 1 && bn == 64)
    return (int)wg::launch<__nv_bfloat16, 64>(x, dy, p, o, N, Ci, Co, splits,
                                              grid, st);
  if (dtype == 1 && bn == 128)
    return (int)wg::launch<__nv_bfloat16, 128>(x, dy, p, o, N, Ci, Co,
                                               splits, grid, st);
  if (dtype == 2 && bn == 64)
    return (int)wg::launch<__half, 64>(x, dy, p, o, N, Ci, Co, splits, grid,
                                       st);
  if (dtype == 2 && bn == 128)
    return (int)wg::launch<__half, 128>(x, dy, p, o, N, Ci, Co, splits, grid,
                                        st);
  return (int)cudaErrorInvalidValue;
}
