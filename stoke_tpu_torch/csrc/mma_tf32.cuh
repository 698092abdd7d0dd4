// Warp-level tensor-core building blocks of the port's fp32 flash kernels
// (flash_fwd.cu, flash_bwd.cu): TF32 `mma.sync` products with the 3xTF32
// split, fragment loads from shared tiles in either orientation, and
// `cp.async` copies, as inline PTX for sm_80 and later (the port builds
// them for sm_90a).
//
// Why 3xTF32: a TF32 operand keeps 10 of fp32's 23 mantissa bits, a
// relative error of up to 2^-11 per operand, which a gradient of order 1
// held to 1e-4 absolute does not survive. Each fp32 operand x is written as
// big + small, big = tf32(x) and small = tf32(x - big), so x is kept to
// ~2^-21; a product is a_small b_big + a_big b_small + a_big b_big (the
// small-by-small term, ~2^-22 relative, is dropped), all summed in the fp32
// accumulator: fp32 accuracy at a third of the TF32 tensor-core rate.
//
// Fragments of mma.sync.m16n8k8 (tf32), with g = lane / 4, t = lane % 4:
//   A (16 x 8, m by k): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k by n):  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C (16 x 8):         c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// The accumulator of one product feeds the next as A without moving between
// lanes: a product sums over k in any order, so the k index of a 16 x 8
// accumulator slice is taken as its columns in the order 0, 2, 4, 6, 1, 3,
// 5, 7 (A = {c0, c2, c1, c3}: k = t is column 2t, k = t + 4 column 2t + 1),
// and the B operand is read in the same order (`load_b_kn`: rows 2t and
// 2t + 1 of its 8-row slice).
//
// Shared tiles are row-major fp32 with a row stride S = width + 4 floats.
// S % 32 == 4 makes every fragment load conflict-free: A and B with the k
// index along a row touch bank 4g + t, B with k down the rows (rows 2t,
// 2t + 1) banks 8t + g and 8t + g + 4. The stride keeps rows 16-byte
// aligned for `cp.async`.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace stoke {
namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to ~2^-21 relative (x - big is exact in fp32)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with an fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to ~fp32 accuracy: the two small terms first, then the big one
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// A from rows [0, 16) and columns [0, 8) of a tile at p (k along a row),
// split into big and small
template <int S>
__device__ __forceinline__ void load_a(const float* p, int lane,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const int g = lane >> 2, t = lane & 3;
  split(p[g * S + t], big[0], small[0]);
  split(p[(g + 8) * S + t], big[1], small[1]);
  split(p[g * S + t + 4], big[2], small[2]);
  split(p[(g + 8) * S + t + 4], big[3], small[3]);
}

// B whose n index runs down rows [0, 8) of a tile at p and k along a row
// (columns [0, 8)): the right operand of X Y^T, Y row-major
template <int S>
__device__ __forceinline__ void load_b_nk(const float* p, int lane,
                                          uint32_t (&big)[2],
                                          uint32_t (&small)[2]) {
  const int g = lane >> 2, t = lane & 3;
  split(p[g * S + t], big[0], small[0]);
  split(p[g * S + t + 4], big[1], small[1]);
}

// B whose k index runs down rows [0, 8) of a tile at p, in the order of
// `acc_as_a` (k = t is row 2t, k = t + 4 row 2t + 1), and n along a row
// (columns [0, 8)): the right operand of X Y, Y row-major
template <int S>
__device__ __forceinline__ void load_b_kn(const float* p, int lane,
                                          uint32_t (&big)[2],
                                          uint32_t (&small)[2]) {
  const int g = lane >> 2, t = lane & 3;
  split(p[2 * t * S + g], big[0], small[0]);
  split(p[(2 * t + 1) * S + g], big[1], small[1]);
}

// a 16 x 8 accumulator slice as the A operand of the next product, split
__device__ __forceinline__ void acc_as_a(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// acc += A B over one streamed tile: A is a warp's 16 x K slab of an
// earlier product's accumulator (a[j] its j-th 16 x 8 slice, fed by
// `acc_as_a`), B the K x N tile at b (row stride S, k down the rows). A sum
// carried in the tensor cores' accumulator through a walk of hundreds of
// products drifted by up to 8e-5 on gradients of order 1 (their fp32
// accumulation truncates); so each tile is summed in a fresh accumulator,
// 32 columns at a time (fewer registers than 64), and added to acc with
// one rounded fp32 add.
template <int K, int N, int S>
__device__ __forceinline__ void mma_acc_tile(float (&acc)[N / 8][4],
                                             const float (&a)[K / 8][4],
                                             const float* b, int lane) {
  constexpr int kChunk = 4;  // column slices of a part sum: 32 columns
#pragma unroll
  for (int c0 = 0; c0 < N / 8; c0 += kChunk) {
    float part[kChunk][4] = {};
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a(a[j], ab, as);
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        uint32_t bb[2], bs[2];
        load_b_kn<S>(b + 8 * j * S + 8 * (c0 + n), lane, bb, bs);
        mma_tf32x3(part[n], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < kChunk; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + n][e] += part[n][e];
  }
}

// ------------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or 16 zero bytes if !valid (src
// is then not read but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes if !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async copies 16 bytes at a time: true if every pointer allows it
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// rows [r0, r0 + R) of a row-major [L, D] fp32 slab at src into a shared
// [R, D + 4] tile, rows past L zero; the block's NT threads share the
// 16-byte chunks (src must be 16-byte aligned)
template <int R, int D, int NT>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int L, int tid) {
  constexpr int kChunks = D / 4;  // per row
  static_assert(R * kChunks % NT == 0, "the threads share the chunks");
#pragma unroll
  for (int i = 0; i < R * kChunks / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / kChunks, c = 4 * (e % kChunks);
    const bool ok = r0 + r < L;
    cp_async16(dst + r * (D + 4) + c,
               src + (ok ? static_cast<size_t>(r0 + r) * D + c : 0), ok);
  }
}

}  // namespace tf32
}  // namespace stoke
