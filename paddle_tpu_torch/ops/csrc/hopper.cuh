// Hopper (sm_90a) primitives shared by the port's TMA + wgmma kernels
// (qkv_proj.cu, flash_attention.cu, grouped_matmul.cu, conv_wgrad.cu)
// and the paged kernel's verify walk (paged_attention.cu): mbarriers,
// TMA tensor maps, bulk tensor loads and stores, plain bulk copies,
// named barriers, setmaxnreg, and warpgroup matrix multiplies (wgmma)
// with their shared-memory descriptors.
//
// The layouts these kernels use: TMA writes a box whose inner extent is
// 64 16-bit values (128 bytes) as rows of 128 bytes under the 128-byte
// swizzle (16-byte chunk c of row r lands at chunk c ^ (r % 8)), so a
// tile's 8-row groups are 1024 bytes apart. Such a tile is a wgmma
// operand two ways:
//   * K-major (rows = M or N, the 64 values of a row along K):
//     `desc_k`, advanced by 32 bytes a k16 step inside the row;
//   * MN-major (rows = K, the 64 values of a row along M or N):
//     `desc_mn`, 16 rows (2048 bytes) a k16 step, with the next 64
//     values of M or N in the next box `mn_stride` bytes on.
// Every tile a descriptor points into starts 1024-byte aligned.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// ------------------------------------------------------------------ TMA

// One box of a tensor map (coordinates innermost first) into shared
// memory; its bytes (the whole box, zeros outside the tensor included)
// complete the barrier's transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// The same with an L2 cache policy (`l2_evict_first` / `l2_evict_last`).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory by the TMA unit, completing
// that many bytes of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// The same with an L2 cache policy (`l2_evict_first` / `l2_evict_last`).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// L2 policies for data read once (evicted first) and data read again
// by other blocks (kept).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// 4 bytes from global to shared memory, asynchronously (zeros where
// `ok` is false, reading nothing); `mbar_arrive_cp_async` makes their
// completion one arrival on a barrier.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// One arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// A box from shared memory into a tensor (coordinates innermost first,
// negative or past the end where the box overhangs: those elements are
// not written), in this thread's current bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- warpgroups

// The registers of each thread of the executing warpgroup lowered to
// (dec) or raised to (inc) N: a producer warpgroup hands its share to the
// consumers. Every warp of the warpgroup executes it, and the producer's
// and consumers' paths must not meet again.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x by the special-function unit (denormal results flushed to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads: wait
// for all of them, or only arrive.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A map over a RANK-dimensional tensor of 16-bit T: `dims` innermost
// first, `strides` in elements for dims 1.. (dim 0 is contiguous), boxes
// of `box` in the 128-byte swizzle (box[0] * 2 <= 128), zeros outside the
// tensor. cudaErrorInvalidValue when the driver refuses the encoding.
template <typename T, int RANK>
cudaError_t make_map(CUtensorMap* map, const void* base,
                     const long long (&dims)[RANK],
                     const long long (&strides)[RANK - 1],
                     const int (&box)[RANK]) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  cuuint64_t d[RANK], s[RANK > 1 ? RANK - 1 : 1];
  cuuint32_t b[RANK], unit[RANK];
  for (int i = 0; i < RANK; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    unit[i] = 1;
    if (i + 1 < RANK) s[i] = (cuuint64_t)strides[i] * sizeof(T);
  }
  const CUresult r =
      fn(map, tma_type<T>(), RANK, const_cast<void*>(base), d, s, b, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of a K-major operand tile at `saddr` (see the top).
__device__ __forceinline__ uint64_t desc_k(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major operand tile at `saddr`, its 64-value
// slices of M or N `mn_stride` bytes apart (see the top).
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr,
                                            uint32_t mn_stride) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)(mn_stride >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The accumulator operands of an m64nNk16 wgmma: N / 2 fp32 values a
// thread (thread l of warp w of the warpgroup holds rows 16 w + l / 4
// and + 8, columns 8 j + 2 (l % 4) + {0, 1}: d[4 j + {0, 1}] and
// d[4 j + {2, 3}]), and their place-holders in the instruction.
#define HOPPER_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define HOPPER_LIST32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31}"

#define HOPPER_ACC40 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
#define HOPPER_LIST40 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39}"

#define HOPPER_ACC64 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_LIST64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63}"

#define HOPPER_ACC128 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define HOPPER_LIST128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x N) += A (64 x 16) . B (16 x N), fp32 sums of 16-bit T: A from
// shared memory (descriptor `a`; MN-major when TA is 1, else K-major),
// B from shared memory (descriptor `b`; MN-major when TB is 1); with
// scale_d 0 the sum starts from zero instead of d.
#define HOPPER_SS(N, TY, LIST, A, B, SC, TA, TB)                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"                       \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " LIST  \
  ", " A ", " B ", p, 1, 1, " TA ", " TB ";\n}\n"
// The same with A from registers: a[0..3] hold the thread's values of
// rows 16 w + l / 4 (a[0], a[2]) and + 8 (a[1], a[3]), columns
// 2 (l % 4) + {0, 1} (a[0], a[1]) and + 8 (a[2], a[3]), two T a word.
#define HOPPER_RS(N, TY, LIST, A0, B, SC, TB)                            \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"                       \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " LIST  \
  ", " A0 ", " B ", p, 1, 1, " TB ";\n}\n"

template <typename T, int N, int TB, int TA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 80 || N == 128 || N == 256, "wgmma_ss: N");
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kHalf)
      asm volatile(HOPPER_SS("64", "f16", HOPPER_LIST32, "%32", "%33",
                             "%34", "%35", "%36")
                   : HOPPER_ACC32
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    else
      asm volatile(HOPPER_SS("64", "bf16", HOPPER_LIST32, "%32", "%33",
                             "%34", "%35", "%36")
                   : HOPPER_ACC32
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 80) {
    if constexpr (kHalf)
      asm volatile(HOPPER_SS("80", "f16", HOPPER_LIST40, "%40", "%41",
                             "%42", "%43", "%44")
                   : HOPPER_ACC40
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    else
      asm volatile(HOPPER_SS("80", "bf16", HOPPER_LIST40, "%40", "%41",
                             "%42", "%43", "%44")
                   : HOPPER_ACC40
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    if constexpr (kHalf)
      asm volatile(HOPPER_SS("128", "f16", HOPPER_LIST64, "%64", "%65",
                             "%66", "%67", "%68")
                   : HOPPER_ACC64
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    else
      asm volatile(HOPPER_SS("128", "bf16", HOPPER_LIST64, "%64", "%65",
                             "%66", "%67", "%68")
                   : HOPPER_ACC64
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    if constexpr (kHalf)
      asm volatile(HOPPER_SS("256", "f16", HOPPER_LIST128, "%128", "%129",
                             "%130", "%131", "%132")
                   : HOPPER_ACC128
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    else
      asm volatile(HOPPER_SS("256", "bf16", HOPPER_LIST128, "%128", "%129",
                             "%130", "%131", "%132")
                   : HOPPER_ACC128
                   : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: N");
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kHalf)
      asm volatile(HOPPER_RS("64", "f16", HOPPER_LIST32,
                             "{%32, %33, %34, %35}", "%36", "%37", "%38")
                   : HOPPER_ACC32
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                     "r"(scale_d), "n"(TB));
    else
      asm volatile(HOPPER_RS("64", "bf16", HOPPER_LIST32,
                             "{%32, %33, %34, %35}", "%36", "%37", "%38")
                   : HOPPER_ACC32
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                     "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    if constexpr (kHalf)
      asm volatile(HOPPER_RS("128", "f16", HOPPER_LIST64,
                             "{%64, %65, %66, %67}", "%68", "%69", "%70")
                   : HOPPER_ACC64
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                     "r"(scale_d), "n"(TB));
    else
      asm volatile(HOPPER_RS("128", "bf16", HOPPER_LIST64,
                             "{%64, %65, %66, %67}", "%68", "%69", "%70")
                   : HOPPER_ACC64
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                     "r"(scale_d), "n"(TB));
  } else {
    if constexpr (kHalf)
      asm volatile(HOPPER_RS("256", "f16", HOPPER_LIST128,
                             "{%128, %129, %130, %131}", "%132", "%133",
                             "%134")
                   : HOPPER_ACC128
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                     "r"(scale_d), "n"(TB));
    else
      asm volatile(HOPPER_RS("256", "bf16", HOPPER_LIST128,
                             "{%128, %129, %130, %131}", "%132", "%133",
                             "%134")
                   : HOPPER_ACC128
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                     "r"(scale_d), "n"(TB));
  }
}

#undef HOPPER_SS
#undef HOPPER_RS
#undef HOPPER_ACC32
#undef HOPPER_LIST32
#undef HOPPER_ACC40
#undef HOPPER_LIST40
#undef HOPPER_ACC64
#undef HOPPER_LIST64
#undef HOPPER_ACC128
#undef HOPPER_LIST128

}  // namespace hopper
