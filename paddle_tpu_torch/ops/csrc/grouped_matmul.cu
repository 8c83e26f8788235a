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
// and w = round_T(q * s_c), then multiplies in T with fp32 sums. Both
// kernels round at exactly those places, so kernel and plain differ only
// in summation order. (The TPU kernel dequantizes in fp32 instead; that
// departure is below one bf16 spacing per weight.)
//
// What bounds it: at the serving shapes (E = 8, C = 80 capacity rows,
// D x F = 1024 x 4096 or 4096 x 1024) the weights are 67 MB in bf16,
// 34 MB in int8, 17 MB in int4, and the flops 5.4e9: ~80-320 flops per
// weight byte, below the card's ~295 for int8 and bf16, so the weight
// bytes bound it; int4 meets the tensor cores' peak at about the same
// time as its bytes.
//
// Two kernels.
//
// gmm_q16_kernel, every weight format under bf16 / fp16 activations
// (the serving path). It computes the transposed product out[e]^T =
// deq(w[e])^T . x[e]^T with wgmma: 128 weight columns are M (two m64
// tiles of one consumer warpgroup), 80 capacity rows are N (m64n80k16;
// more rows take more blocks along grid z), D is K. x is the
// shared-memory B operand, stored K-contiguous with the 128-byte swizzle
// by TMA. One producer warp keeps a ring of stages in flight through TMA,
// each stage's fill and release tracked by an mbarrier pair; rows whose
// length is not a multiple of 16 bytes (TMA cannot describe them) are
// copied by the producer lanes instead. Two blocks share an SM.
//   * Float weights (format 0): the weight tile is the shared-memory A
//     operand as TMA stores it. w is [D, F] row-major, so a stage's 64
//     rows of 128 columns arrive as two boxes of 64 columns (128-byte
//     rows, 16 KB with the x tile's 10 KB), and wgmma reads them
//     MN-major (`desc_mn`): nothing passes through the registers, and a
//     stage is 8 wgmmas behind one barrier wait (4 stages). The weights
//     are loaded with an L2 evict-first policy and x evict-last: each x
//     tile is read again by every column tile of its expert, and
//     without the hints the streaming weights pushed it out of L2
//     (on an H100, ffn1 0.0376 -> 0.0330 ms; tools/torch_gmm_ab.py).
//   * int8 and int4 weights (formats 1, 2): the weights are the register
//     operand: each thread loads one 32-bit word per stored row that
//     holds every column its fragments need (the M rows of a tile are
//     ordered so that a thread's four columns are adjacent, and each
//     warp's loads fall on 32 banks), and dequantizes it in registers:
//     int8 bytes pair up row by row with byte permutes, a packed int4
//     byte already is a row pair (d, d + 1); magic-exponent tricks turn
//     bytes and nibbles into exact 16-bit q, and one packed multiply by
//     the column's s_c rounds each weight once. There is no dequantized
//     tile and no barrier per k-tile. A stage is 64 int8 rows, or 128
//     rows as 64 packed int4 rows: 8 KB of weights, with the x tiles of
//     the same depth; 5 / 3 stages.
// Where E x F / 128 x C / 80 tiles cannot give every SM a block (ffn2:
// 64 tiles), D is split, at most in 4 parts (`plan`: int8 and int4 into
// the fewest parts that give every SM a block, 3 at ffn2; float weights
// into the most that leave no SM two blocks, 2 at ffn2); the parts of a
// tile form a thread-block cluster, and each block adds the fp32
// partials of its share of the tile's rows through distributed shared
// memory in rank order, so two launches give the same bits. The accumulator is staged through shared memory and written
// in 16-byte stores along F. The wrapper's `plan` chooses the split.
// Measured on an H100 (tools/torch_gmm_ab.py): the quantized kernel is
// bound by moving its tiles, not by the dequant or the wgmma (a copy
// without either keeps ~90% of the time); two column tiles that
// multicast one x tile, and 256-column blocks of two warpgroups that
// share it, were both slower or no faster. setmaxnreg is not used: the
// consumers fit in 168 registers with two blocks an SM, so the producer
// warp's share would buy nothing.
//
// gmm_kernel, every weight format under fp32 activations: a block owns
// one (expert, 64-column tile) and all C rows (128 at a time, looping
// beyond), and walks D in 32-row tiles through a 4-stage cp.async ring.
// Quantized tiles are dequantized into an operand tile in shared memory
// just before the product. fp32 operands multiply on the CUDA cores
// (each thread an 8 x 8 block of the 128 x 64 tile).
//
// Both mask their edges: any E, C, D and F (int4 needs an even D).
//
// Built with nvcc into a shared library with a plain C interface
// (paddle_tpu_torch/ops/grouped_matmul.py), launched on the caller's
// stream, allocating nothing.

#include "hopper.cuh"

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
// by 16 bytes: the column reads then fall on distinct banks, and every
// row stays 16-byte aligned for cp.async.
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
      fma_tile<L::kLdx, L::kLdw>(acc, xs, ws);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // the inverse of fma_tile's (i, j) -> acc mapping
          const int row = r0 + (threadIdx.x >> 3) + 16 * (4 * mt + nt / 2);
          const int col = n0 + (threadIdx.x & 7) + 8 * (4 * (nt % 2) + q);
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
  if (x_dtype != 0) return cudaErrorInvalidValue;  // 16-bit x: q16
  return launch<float, FMT>(x, w, scale, scale_dtype, qmax, out, E, C, D, F,
                            vec_x, vec_w, st);
}

// ----------------------------------------- the wgmma kernel, 16-bit x

namespace q16 {

using namespace hopper;

constexpr int kM = 128;                    // weight columns a block (M)
constexpr int kN = 80;                     // capacity rows a block (N)
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kWRows = 64;                 // stored weight rows a stage
constexpr int kXBytes = kN * 128;          // 80 rows x 64 16-bit values
constexpr int kBox = kWRows * 128;         // a 64-row box of 128-byte rows

template <int FMT>
struct Cfg {
  static constexpr int kDepth = FMT == 2 ? 128 : 64;  // contraction rows
  static constexpr int kXBoxes = kDepth / 64;          // x tiles a stage
  static constexpr int kSteps = kDepth / 16;           // k16 steps a stage
  // the weight tile: 128 columns of 16-bit floats as two 64-column
  // boxes, or 128 int8 bytes a row as one
  static constexpr int kWBytes = FMT == 0 ? 2 * kBox : kBox;
  static constexpr int kStages = FMT == 0 ? 4 : FMT == 1 ? 5 : 3;
  static constexpr int kStageBytes = kWBytes + kXBoxes * kXBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kRing + 2 * kStages * 8;
  // the staged output row, in elements: 16-bit floats store single
  // values (a row 68 words, so a warp's four row pairs fall on distinct
  // banks), the quantized formats a thread's four adjacent columns
  static constexpr int kOutLd = FMT == 0 ? kM + 8 : kM + 16;
};
static_assert(Cfg<0>::kRing >= kN * kM * 4, "partials fit the ring");
static_assert(Cfg<2>::kRing >= kN * kM * 4, "partials fit the ring");
static_assert(Cfg<2>::kRing >= kN * Cfg<2>::kOutLd * 2,
              "staging fits the ring");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// p's counterpart in the shared memory of the cluster's block `rank`,
// as a generic pointer: plain loads through it batch.
__device__ __forceinline__ const float* peer(const float* p, uint32_t rank) {
  uint64_t a;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(a)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(a);
}

#define Q16_ACC                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),     \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define Q16_MMA(TY)                                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"                             \
  "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " "              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "               \
  "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"

// d (64 x 80, fp32) += a (64 x 16, registers) . B (16 x 80, shared).
template <typename T>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(Q16_MMA("bf16")
                 : Q16_ACC
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                   "r"(1));
  }
};
template <>
struct Wgmma<__half> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(Q16_MMA("f16")
                 : Q16_ACC
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
                   "r"(1));
  }
};
#undef Q16_MMA
#undef Q16_ACC

template <typename T>
__device__ __forceinline__ uint32_t bits(T v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Exact 16-bit q pairs from stored bytes: each returns the packed pair
// (low half: row d, high half: row d + 1) of byte J's column.
//
// int8: `a` and `b` hold rows d and d + 1 of four columns, biased to
// unsigned (^ 0x80). bf16: the byte becomes the low mantissa byte of
// 2^23 (fp32); minus 2^23 + 128 that is q, whose upper 16 bits are its
// bf16. fp16: the byte becomes the low byte of 1024.0; minus 1152 is q.
template <typename T, int J>
__device__ __forceinline__ uint32_t q8_pair(uint32_t a, uint32_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const float fa =
        __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7650 | J)) -
        8388736.f;
    const float fb =
        __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650 | J)) -
        8388736.f;
    return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
  } else {
    const uint32_t t =
        (__byte_perm(a, b, J | ((4 + J) << 8)) & 0x00FF00FFu) | 0x64006400u;
    return bits(__hsub2(*reinterpret_cast<const __half2*>(&t),
                        __halves2half2(__ushort_as_half(0x6480),
                                       __ushort_as_half(0x6480))));
  }
}

// int4: `a` holds one packed row (rows d, d + 1) of four columns, biased
// (^ 0x88888888), and `s` is a >> 4. Byte J's low nibble goes to the low
// half and its high nibble to the high half, each as the low mantissa
// bits of 128.0 (bf16) or 1024.0 (fp16); minus 136 or 1032 is q.
template <typename T, int J>
__device__ __forceinline__ uint32_t q4_pair(uint32_t a, uint32_t s) {
  const uint32_t t = __byte_perm(a, s, J | ((4 + J) << 8)) & 0x000F000Fu;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t m = t | 0x43004300u;
    return bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                        __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                           __ushort_as_bfloat16(0x4308))));
  } else {
    const uint32_t m = t | 0x64006400u;
    return bits(__hsub2(*reinterpret_cast<const __half2*>(&m),
                        __halves2half2(__ushort_as_half(0x6408),
                                       __ushort_as_half(0x6408))));
  }
}

// round_T(q * s_c) of both halves: one rounding, the plain version's.
template <typename T>
__device__ __forceinline__ uint32_t scaled(uint32_t q, uint32_t s) {
  using T2 = typename std::conditional<std::is_same<T, __half>::value,
                                       __half2, __nv_bfloat162>::type;
  return bits(__hmul2(*reinterpret_cast<const T2*>(&q),
                      *reinterpret_cast<const T2*>(&s)));
}

// The offset of (row r, byte c) in a tile of 128-byte rows under the
// 128-byte swizzle, as TMA writes it: 16-byte chunk (c / 16) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// The thread's column group G: M row (tile mt, half h) of warp w, lane l
// is the block's column 4 G(w, l / 4) + 2 mt + h, so one 32-bit load of
// a stored row holds all four columns of a thread. The order keeps each
// warp's loads on 32 distinct banks under the swizzle: int8 threads read
// rows 2 (l % 4) + {0, 1} (+ 8) of a step, int4 threads packed rows
// l % 4 (+ 4).
template <int FMT>
__device__ __forceinline__ int col_group(int warp, int g) {
  return FMT == 1 ? 8 * warp + g : 4 * warp + 16 * (g >> 2) + (g & 3);
}

// The stored words of k16 step `st` of a stage that a thread's fragments
// need: int8 rows 16 st + 2 q + {0, 1, 8, 9}, int4 packed rows
// 8 st + q + {0, 4}, each the 32-bit word of its four columns from cb.
template <int FMT>
__device__ __forceinline__ void load_words(uint32_t (&r)[4],
                                           const unsigned char* wt, int st,
                                           int q, int cb) {
  if constexpr (FMT == 1) {
    const int k = 16 * st + 2 * q;
    r[0] = *reinterpret_cast<const uint32_t*>(wt + swz(k, cb));
    r[1] = *reinterpret_cast<const uint32_t*>(wt + swz(k + 1, cb));
    r[2] = *reinterpret_cast<const uint32_t*>(wt + swz(k + 8, cb));
    r[3] = *reinterpret_cast<const uint32_t*>(wt + swz(k + 9, cb));
  } else {
    const int p = 8 * st + q;
    r[0] = *reinterpret_cast<const uint32_t*>(wt + swz(p, cb));
    r[1] = *reinterpret_cast<const uint32_t*>(wt + swz(p + 4, cb));
  }
}

// The A operands of a k16 step from its words, dequantized: a[mt] holds
// the weights of columns cb + 2 mt + {0, 1} (the fragment's rows r and
// r + 8), depths 2 q + {0, 1} and 2 q + 8 + {0, 1}.
template <typename T, int FMT>
__device__ __forceinline__ void dequant_frags(uint32_t (&a)[2][4],
                                              const uint32_t (&r)[4],
                                              const uint32_t (&s2)[4]) {
  if constexpr (FMT == 1) {
    const uint32_t xa = r[0] ^ 0x80808080u, xb = r[1] ^ 0x80808080u;
    const uint32_t xc = r[2] ^ 0x80808080u, xd = r[3] ^ 0x80808080u;
    a[0][0] = scaled<T>(q8_pair<T, 0>(xa, xb), s2[0]);
    a[0][1] = scaled<T>(q8_pair<T, 1>(xa, xb), s2[1]);
    a[0][2] = scaled<T>(q8_pair<T, 0>(xc, xd), s2[0]);
    a[0][3] = scaled<T>(q8_pair<T, 1>(xc, xd), s2[1]);
    a[1][0] = scaled<T>(q8_pair<T, 2>(xa, xb), s2[2]);
    a[1][1] = scaled<T>(q8_pair<T, 3>(xa, xb), s2[3]);
    a[1][2] = scaled<T>(q8_pair<T, 2>(xc, xd), s2[2]);
    a[1][3] = scaled<T>(q8_pair<T, 3>(xc, xd), s2[3]);
  } else {
    const uint32_t xa = r[0] ^ 0x88888888u, xc = r[1] ^ 0x88888888u;
    const uint32_t sa = xa >> 4, sc = xc >> 4;
    a[0][0] = scaled<T>(q4_pair<T, 0>(xa, sa), s2[0]);
    a[0][1] = scaled<T>(q4_pair<T, 1>(xa, sa), s2[1]);
    a[0][2] = scaled<T>(q4_pair<T, 0>(xc, sc), s2[0]);
    a[0][3] = scaled<T>(q4_pair<T, 1>(xc, sc), s2[1]);
    a[1][0] = scaled<T>(q4_pair<T, 2>(xa, sa), s2[2]);
    a[1][1] = scaled<T>(q4_pair<T, 3>(xa, sa), s2[3]);
    a[1][2] = scaled<T>(q4_pair<T, 2>(xc, sc), s2[2]);
    a[1][3] = scaled<T>(q4_pair<T, 3>(xc, sc), s2[3]);
  }
}

// What TMA cannot describe (rows not a multiple of 16 bytes), copied by
// producer lanes 1..31 in the layout TMA would have written: the raw
// weight tile (stored rows from p0, columns from f0; zero past Dw, F)
// and an x tile (capacity rows from c0, depths from k0; zero past C, D).
// Float weights fill two 64-column boxes, int8 bytes one.
template <typename T, int FMT>
__device__ __forceinline__ void copy_w(unsigned char* wt,
                                       const int8_t* __restrict__ we_,
                                       int p0, int f0, int Dw, int F,
                                       int lane) {
  if constexpr (FMT == 0) {
    const T* we = reinterpret_cast<const T*>(we_);
    for (int i = lane - 1; i < 2 * kWRows * 32; i += 31) {
      const int b = i / (kWRows * 32), r = (i >> 5) % kWRows;
      const int c = (i & 31) * 2, p = p0 + r, f = f0 + 64 * b + c;
      T v[2] = {T{}, T{}};
      if (p < Dw) {
        if (f < F) v[0] = we[(long long)p * F + f];
        if (f + 1 < F) v[1] = we[(long long)p * F + f + 1];
      }
      *reinterpret_cast<uint32_t*>(wt + b * kBox + swz(r, 2 * c)) =
          *reinterpret_cast<const uint32_t*>(v);
    }
  } else {
    for (int i = lane - 1; i < kWRows * 32; i += 31) {
      const int r = i >> 5, c = (i & 31) * 4, p = p0 + r;
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int f = f0 + c + b;
        if (p < Dw && f < F)
          v |= (uint32_t)(uint8_t)we_[(long long)p * F + f] << (8 * b);
      }
      *reinterpret_cast<uint32_t*>(wt + swz(r, c)) = v;
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_x(unsigned char* xt,
                                       const T* __restrict__ xe, int c0,
                                       int k0, int C, int D, int lane) {
  for (int i = lane - 1; i < kN * 32; i += 31) {
    const int n = i >> 5, k = k0 + (i & 31) * 2, c = c0 + n;
    T v[2] = {T{}, T{}};
    if (c < C) {
      if (k < D) v[0] = xe[(long long)c * D + k];
      if (k + 1 < D) v[1] = xe[(long long)c * D + k + 1];
    }
    *reinterpret_cast<uint32_t*>(xt + swz(n, (i & 31) * 4)) =
        *reinterpret_cast<const uint32_t*>(v);
  }
}

// Grid (F / 128 tiles x split, E, C / 80 chunks). With split > 1 the
// `split` blocks of one output tile form a cluster, rank = the part of D
// each walks. Each writes its fp32 partial to its shared memory; then
// block r adds, for its share of the tile's rows (8-row groups
// [10 r / split, 10 (r + 1) / split)), the partials of ranks 0, 1, ... in
// that order and stores those rows: the same sums in the same order on
// every launch. `w` is T [E, D, F] (FMT 0) or int8 bytes.
template <typename T, int FMT>
__global__ void __launch_bounds__(kThreads, 2)
gmm_q16_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const T* __restrict__ x, const int8_t* __restrict__ w,
               const void* __restrict__ scale, int scale_dtype, float qmax,
               T* __restrict__ out, int C, int D, int F, int split,
               int tma_x, int tma_w) {
  using K = Cfg<FMT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K::kRing);
  uint64_t* empty = full + K::kStages;
  const int part = blockIdx.x % split, e = blockIdx.y;
  const int f0 = (blockIdx.x / split) * kM, c0 = blockIdx.z * kN;
  const int Dw = FMT == 2 ? D / 2 : D;        // stored weight rows
  const int kt = (Dw + kWRows - 1) / kWRows;  // stages over all of D
  const int t0 = part * kt / split, nt = (part + 1) * kt / split - t0;
  const bool all_tma = tma_x && tma_w;
  if (threadIdx.x == 0) {
    for (int i = 0; i < K::kStages; ++i) {
      mbar_init(&full[i], all_tma ? 1 : 32);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ producer warp
    const int lane = threadIdx.x & 31;
    const long long wsz = FMT == 0 ? (long long)sizeof(T) : 1;
    const int8_t* we = w + (long long)e * Dw * F * wsz;
    const T* xe = x + (long long)e * C * D;
    const uint32_t tx =
        (tma_w ? K::kWBytes : 0) + (tma_x ? K::kXBoxes * kXBytes : 0);
    // Float weights stream through once; x is read again by every
    // column tile of its expert, so it is the one kept in L2.
    const uint64_t once = FMT == 0 ? l2_evict_first() : 0;
    const uint64_t again = FMT == 0 ? l2_evict_last() : 0;
    for (int i = 0; i < nt; ++i) {
      const int stage = i % K::kStages, t = t0 + i;
      mbar_wait(&empty[stage], ((i / K::kStages) & 1) ^ 1);
      unsigned char* wt = ring + stage * K::kStageBytes;
      if (lane == 0) {
        mbar_arrive_tx(&full[stage], tx);
        if (tma_w) {
          if constexpr (FMT == 0) {
            tma_load_3d(wt, &wmap, f0, t * kWRows, e, &full[stage], once);
            tma_load_3d(wt + kBox, &wmap, f0 + 64, t * kWRows, e,
                        &full[stage], once);
          } else {
            tma_load_3d(wt, &wmap, f0, t * kWRows, e, &full[stage]);
          }
        }
        if (tma_x)
          for (int b = 0; b < K::kXBoxes; ++b) {
            if constexpr (FMT == 0)
              tma_load_3d(wt + K::kWBytes + b * kXBytes, &xmap,
                          t * K::kDepth + 64 * b, c0, e, &full[stage], again);
            else
              tma_load_3d(wt + K::kWBytes + b * kXBytes, &xmap,
                          t * K::kDepth + 64 * b, c0, e, &full[stage]);
          }
      } else if (!all_tma) {
        if (!tma_w) copy_w<T, FMT>(wt, we, t * kWRows, f0, Dw, F, lane);
        if (!tma_x)
          for (int b = 0; b < K::kXBoxes; ++b)
            copy_x<T>(wt + K::kWBytes + b * kXBytes, xe, c0,
                      t * K::kDepth + 64 * b, C, D, lane);
        fence_proxy_async();
        mbar_arrive(&full[stage]);
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---------------------------------------------- consumer warpgroup
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane & 3;
  // The thread's first column: float weights keep M rows in column
  // order (rows 16 warp + lane / 4 (+ 8) of each 64-column tile);
  // quantized ones group a thread's four columns.
  const int cb = FMT == 0 ? 16 * warp + (lane >> 2)
                          : 4 * col_group<FMT>(warp, lane >> 2);
  float acc[2][40];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 40; ++i) acc[mt][i] = 0.f;
  if constexpr (FMT == 0) {
    for (int i = 0; i < nt; ++i) {
      const int stage = i % K::kStages;
      mbar_wait(&full[stage], (i / K::kStages) & 1);
      const uint32_t ws = smem_u32(ring + stage * K::kStageBytes);
      const uint32_t xs = ws + K::kWBytes;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < K::kSteps; ++st) {
        const uint64_t b = desc_k(xs + st * 32);
        wgmma_ss<T, kN, 0, 1>(acc[0], desc_mn(ws + st * 2048, kBox), b, 1);
        wgmma_ss<T, kN, 0, 1>(acc[1], desc_mn(ws + kBox + st * 2048, kBox),
                              b, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage i - 1's products are done: free it
      if (i > 0) mbar_arrive(&empty[(i - 1) % K::kStages]);
    }
  } else {
    uint32_t s2[4];  // (s_c, s_c) of the thread's four columns, in T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + cb + j;
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
      const T h = from_float<T>(s);
      const uint32_t b = *reinterpret_cast<const uint16_t*>(&h);
      s2[j] = b | (b << 16);
    }
    uint32_t frag[2][2][4];  // two steps' fragments: one fills, one read
    for (int i = 0; i < nt; ++i) {
      const int stage = i % K::kStages;
      mbar_wait(&full[stage], (i / K::kStages) & 1);
      const unsigned char* wt = ring + stage * K::kStageBytes;
      const uint32_t xs = smem_u32(wt + K::kWBytes);
      uint32_t words[4];
      load_words<FMT>(words, wt, 0, q, cb);
#pragma unroll
      for (int st = 0; st < K::kSteps; ++st) {
        uint32_t(&a)[2][4] = frag[st & 1];
        dequant_frags<T, FMT>(a, words, s2);
        // The next step's loads go out now and land behind this wgmma.
        if (st + 1 < K::kSteps) load_words<FMT>(words, wt, st + 1, q, cb);
        wgmma_fence();
        const uint64_t desc =
            desc_k(xs + (st >> 2) * kXBytes + (st & 3) * 32);
        Wgmma<T>::run(acc[0], a[0], desc);
        Wgmma<T>::run(acc[1], a[1], desc);
        wgmma_commit();
        wgmma_wait<1>();  // step st - 1 is done: its fragments and x free
        if (st == 0 && i > 0) mbar_arrive(&empty[(i - 1) % K::kStages]);
      }
    }
  }
  wgmma_wait<0>();
  consumers_sync();  // every consumer is done with the ring

  // This block stores rows 8 jn .. 8 jn + 7 for jn in [j0, j1).
  const int j0 = part * (kN / 8) / split;
  const int j1 = (part + 1) * (kN / 8) / split;
  const int tid = threadIdx.x;
  if (split > 1) {
    float* part_s = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 40; ++i) {
        part_s[(mt * 40 + i) * kConsumers + tid] = acc[mt][i];
        acc[mt][i] = 0.f;
      }
    cluster_sync();  // every partial is written
    for (int r = 0; r < split; ++r) {
      const float* src = peer(part_s, r) + tid;
#pragma unroll
      for (int jn = 0; jn < kN / 8; ++jn) {
        if (jn < j0 || jn >= j1) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[mt][4 * jn + u] += src[(mt * 40 + 4 * jn + u) * kConsumers];
      }
    }
    cluster_sync();  // every block has read the partials it needs
  }

  // Epilogue: [80 rows][128 columns] staged in T, then 16-byte stores.
  constexpr int kLd = K::kOutLd;
  T* stg = reinterpret_cast<T*>(ring);
#pragma unroll
  for (int jn = 0; jn < kN / 8; ++jn)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int n = 8 * jn + 2 * q + b;
      if constexpr (FMT == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            stg[n * kLd + 64 * mt + cb + 8 * h] =
                from_float<T>(acc[mt][4 * jn + 2 * h + b]);
      } else {
        T v[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            v[2 * mt + h] = from_float<T>(acc[mt][4 * jn + 2 * h + b]);
        *reinterpret_cast<uint2*>(stg + n * kLd + cb) =
            *reinterpret_cast<const uint2*>(v);
      }
    }
  consumers_sync();
  T* oe = out + (long long)e * C * F;
  const bool vec = F % 8 == 0;
  for (int i = 8 * j0 * (kM / 8) + tid; i < 8 * j1 * (kM / 8);
       i += kConsumers) {
    const int n = i / (kM / 8), cc = (i % (kM / 8)) * 8;
    const int c = c0 + n, f = f0 + cc;
    if (c >= C || f >= F) continue;
    const T* src = stg + n * kLd + cc;
    T* dst = oe + (long long)c * F + f;
    if (vec)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      for (int j = 0; j < 8 && f + j < F; ++j) dst[j] = src[j];
  }
}

// A 3-D map over [d2][d1][d0] elements of `bytes` each: boxes of
// (b0, b1, 1) in the 128-byte swizzle, zeros outside the tensor.
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType dt, int bytes,
                     const void* base, long long d0, long long d1,
                     long long d2, int b0, int b1) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * bytes),
                                 (cuuint64_t)(d0 * d1 * bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, dt, 3, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int FMT>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   int scale_dtype, float qmax, void* out, int E, int C,
                   int D, int F, int split, int tma_x, int tma_w,
                   cudaStream_t st) {
  using K = Cfg<FMT>;
  CUtensorMap xmap = {}, wmap = {};
  cudaError_t err;
  if (tma_x) {
    err = make_map(&xmap, tma_type<T>(), 2, x, D, C, E, 64, kN);
    if (err != cudaSuccess) return err;
  }
  if (tma_w) {
    err = FMT == 0 ? make_map(&wmap, tma_type<T>(), 2, w, F, D, E, 64,
                              kWRows)
                   : make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, F,
                              FMT == 2 ? D / 2 : D, E, kM, kWRows);
    if (err != cudaSuccess) return err;
  }
  auto kern = gmm_q16_kernel<T, FMT>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((F + kM - 1) / kM) * split, E, (C + kN - 1) / kN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = K::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, static_cast<const T*>(x),
                           static_cast<const int8_t*>(w), scale, scale_dtype,
                           qmax, static_cast<T*>(out), C, D, F, split,
                           tma_x, tma_w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace q16

}  // namespace

// gmm_kernel. x_dtype / scale_dtype: 0 fp32, 1 bf16, 2 fp16. w_format:
// 0 float of x's dtype, 1 int8 or 2 packed int4; x_dtype 0 only (16-bit
// x takes the q16 entry). vec_x / vec_w: the rows of x / w allow 16-byte
// copies (row length a multiple of 16 bytes, pointers 16-byte aligned).
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

// gmm_q16_kernel: x_dtype 1 bf16 or 2 fp16, w_format 0 float of x's
// dtype, 1 int8 or 2 packed int4, scale_dtype as above (unused for
// format 0); split: the parts of D (1-4), one cluster of `split` blocks
// per output tile. tma_x / tma_w: the rows of x / w can be described to
// TMA (row length a multiple of 16 bytes, pointers 16-byte aligned);
// otherwise the producer copies them.
extern "C" int paddle_tpu_torch_grouped_matmul_q16(
    const void* x, const void* w, const void* scale, void* out, int E, int C,
    int D, int F, int x_dtype, int w_format, int scale_dtype, float qmax,
    int split, int tma_x, int tma_w, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (w_format == 2 && D % 2) return (int)cudaErrorInvalidValue;
  if (E > 65535 || (C + q16::kN - 1) / q16::kN > 65535)
    return (int)cudaErrorInvalidValue;
  if (split < 1 || split > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PADDLE_GMM_Q16(T, FMT)                                             \
  return (int)q16::launch<T, FMT>(x, w, scale, scale_dtype, qmax, out, E, \
                                  C, D, F, split, tma_x, tma_w, st)
  if (x_dtype == 1 && w_format == 0) PADDLE_GMM_Q16(__nv_bfloat16, 0);
  if (x_dtype == 1 && w_format == 1) PADDLE_GMM_Q16(__nv_bfloat16, 1);
  if (x_dtype == 1 && w_format == 2) PADDLE_GMM_Q16(__nv_bfloat16, 2);
  if (x_dtype == 2 && w_format == 0) PADDLE_GMM_Q16(__half, 0);
  if (x_dtype == 2 && w_format == 1) PADDLE_GMM_Q16(__half, 1);
  if (x_dtype == 2 && w_format == 2) PADDLE_GMM_Q16(__half, 2);
#undef PADDLE_GMM_Q16
  return (int)cudaErrorInvalidValue;
}
