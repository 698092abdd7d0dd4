// Hopper building blocks of the port's bf16 and fp16 flash kernels
// (flash_fwd.cu, flash_bwd.cu): TMA tensor maps and loads, mbarriers,
// shared-memory matrix descriptors and warpgroup matrix multiplies
// (wgmma), as inline PTX for sm_90a. No library kernel is called; the
// tensor-map encoder is libcuda's, looked up through the runtime so the
// libraries need not link libcuda.
//
// Conventions the kernels rely on:
//   * the kernels are templates on the 16-bit element type T (__nv_bfloat16
//     or __half): the two share every layout below, and differ only in the
//     wgmma instruction's type name (wgmma_ops.cuh), the rounding of fp32
//     pairs (pack2<T>) and the tensor maps' element type (make_map<T>);
//   * every tile is stored as "panels" of 64 16-bit columns (128 bytes a row),
//     written by TMA with 128-byte swizzle, each panel 1024-byte aligned:
//     16-byte chunk c of row r sits at chunk c ^ (r % 8);
//   * a K-major operand (the contraction runs along the 128-byte rows:
//     Q, K, V as the left operand, or the right operand of Q K^T) steps
//     through K by adding 32 bytes to the descriptor's start address inside
//     a panel, and by a whole panel every 4 steps;
//   * an MN-major operand (the contraction runs down the rows: V in P V,
//     dO in P^T dO, Q in dS^T Q) steps through K by 16 rows (2048 bytes);
//     its N columns cross panels at the leading byte offset (LBO);
//   * the fp32 accumulator of a 64 x N wgmma gives thread t of the
//     warpgroup rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8, register
//     i holding row (i & 2 ? r0 + 8 : r0), column 8 (i / 4) + 2 (t % 4) +
//     (i & 1). Converted to 16-bit pairs, registers 8k .. 8k + 7 are exactly
//     the A fragment of the k-th 16-column slice for a register-A wgmma,
//     so P and dS feed the next product without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace stoke {
namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;

// the kernels' 16-bit element type: __half (fp16) or __nv_bfloat16
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 128-byte swizzled tiles must start on 1024-byte boundaries; dynamic
// shared memory is only 16-byte aligned, so kernels ask for 1 KB more
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// announce `bytes` of TMA traffic without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that outlasts
// 2^32 SM cycles (seconds; the kernels take milliseconds) is a deadlock:
// trap, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 32)) {
      __trap();
    }
  }
}

// ----------------------------------------------------------------------- TMA

// Box (c0 = column, c1 = row, c2 = head) of a 3-D tensor map into shared
// memory; the box's bytes complete on the barrier's transaction count.
// Rows past the tensor's end are filled with zeros (and still counted).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// --------------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout
// type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

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

// Pin an accumulator's registers at this point of the program, so the
// compiler neither reads them before the wgmma_wait above nor moves writes
// past the wgmma that follows.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two fp32 values as one register of two T (bf16x2 or f16x2), the first
// in the low half, each rounded to nearest even (cvt.rn.bf16x2.f32 or
// cvt.rn.f16x2.f32; an fp16 value past 65504 becomes inf)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The 16-column slice k of a 64 x N fp32 accumulator (registers 8k ..
// 8k + 7), rounded to T, as the A fragment of a register-A wgmma.
template <typename T, int R>
__device__ __forceinline__ void to_a_frag(const float (&d)[R], int k,
                                          uint32_t (&a)[4]) {
  a[0] = pack2<T>(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack2<T>(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack2<T>(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack2<T>(d[8 * k + 6], d[8 * k + 7]);
}

// The power of two that scales a |dS| <= bound to at most 2^14, clamped
// to 2^-30 .. 2^30. The 16-bit backward kernels multiply dS by it before
// rounding dS to their type and divide their fp32 sums by it after, both
// exactly. In fp16 (largest 65504, normal from 6.1e-5) this keeps dS from
// overflowing under a large loss scale and, where dS is tiny, from
// rounding in the subnormal range; bf16 has fp32's range and gets no bound
// (a scale of 1). A bound of 0 gives 2^30, inf or NaN 2^-30.
__device__ __forceinline__ float ds_scale_for(float bound) {
  const float e = floorf(log2f(16384.f / bound));
  return ldexpf(1.f, static_cast<int>(fminf(fmaxf(e, -30.f), 30.f)));
}

namespace mma_bf16 {
#define STOKE_MMA_TYPE "bf16"
#include "wgmma_ops.cuh"
#undef STOKE_MMA_TYPE
}  // namespace mma_bf16

namespace mma_f16 {
#define STOKE_MMA_TYPE "f16"
#include "wgmma_ops.cuh"
#undef STOKE_MMA_TYPE
}  // namespace mma_f16

// D[64 x N] (+)= A[64 x 16] B[16 x N] in the operand type T (bf16 or
// fp16), A and B from shared memory, both K-major; N = 2 R, R the
// accumulator's registers a thread: 16 (N=32), 32 (N=64) or 64 (N=128).
template <typename T, int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kIsHalf<T>)
    mma_f16::wgmma_ss(d, da, db, scale_d);
  else
    mma_bf16::wgmma_ss(d, da, db, scale_d);
}

// D[64 x N] += A[64 x 16] B[16 x N] in the operand type T, A from
// registers (to_a_frag<T>), B from shared memory, MN-major; R = 32 or 64.
template <typename T, int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (kIsHalf<T>)
    mma_f16::wgmma_rs(d, a, db, scale_d);
  else
    mma_bf16::wgmma_rs(d, a, db, scale_d);
}

// ----------------------------------------------------------- host: tensor maps

// codes the C entries return besides CUDA's own errors
constexpr int kErrUnsupported = -1;
constexpr int kErrTensorMap = -2;

inline const char* error_string(int code) {
  if (code == kErrUnsupported) return "unsupported dtype or head dim";
  if (code == kErrTensorMap)
    return "cannot make a TMA tensor map (no cuTensorMapEncodeTiled in the "
           "CUDA library, or a tensor not 16-byte aligned)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once; null if missing.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a contiguous [BH, L, D] tensor of T (bf16 or fp16) whose
// box is one 64-column panel of `rows` rows of one head, 128-byte
// swizzled; rows past L read as zeros. Returns false if the encoder is
// missing or refuses.
template <typename T>
inline bool make_map(CUtensorMap* map, const void* ptr, int BH, int L, int D,
                     int rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(L) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  constexpr CUtensorMapDataType type = kIsHalf<T>
                                           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace stoke
