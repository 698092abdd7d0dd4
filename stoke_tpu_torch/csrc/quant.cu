// Per-chunk absmax int8 quantization of a flat fp32 vector, and its inverse,
// for Hopper (sm_90a).
//
// Stands for `quantize_chunks` and `dequantize_chunks` of
// stoke_tpu/parallel/collectives.py (:61, :91), which are jnp code, not
// Pallas: the gradient transports' wire format (CommConfig(dtype="int8"))
// and the int8 serving weights (stoke_tpu/serving/quant.py) ride them.
// Elements [i*chunk, (i+1)*chunk) share one fp32 scale absmax / 127;
// v = x / scale (1 where the scale is 0) rounds to floor(v + u) with u the
// JAX package's jax.random.uniform under the bucket's key (stochastic), or
// to the nearest integer, ties to even (jnp.round); then clipped to +-127.
//
// Numbers: bit for bit the plain PyTorch version (ops/quant.py), which is
// the JAX function's. Division is IEEE (no --use_fast_math); u is
// Threefry-2x32 of the counter (hi, lo) = the 64-bit flat index (plus the
// caller's offset) under the key, bits1 ^ bits2, (bits >> 9) | 0x3F800000
// read as a float minus 1: the partitionable jax.random.uniform. The key is
// read from device memory (int64 words holding uint32 values), so a CUDA
// graph that replays the launch draws from the key's current value, and up
// to two fold_in's (jax.random.fold_in: the hash of the counter (0, d)) are
// applied per thread before the draws, which saves the ~170 tiny launches a
// plain int64 fold_in costs.
//
// What bounds it on the H100: bytes, for the wire format. Quantize reads 4
// bytes and writes 1 an element (plus 4 a chunk), dequantize the reverse, so
// GPT-base's 124.4M gradient elements take ~0.19 ms each way at 3.35 TB/s.
// The stochastic draw adds ~100 integer operations an element (20 Threefry
// rounds), which the SMs' integer rate may make the real limit; the bound
// reported beside it counts bytes only (PERF.md §6).
//
// Design: a simple kernel first. One warp a chunk, eight warps a block; a
// lane walks the chunk's elements 32 apart (coalesced loads), reduces the
// absmax by shuffles (NaN propagates, as jnp.max does), then quantizes the
// same elements on its second pass (the chunk is still in L1/L2). The
// dequantize kernel is a grid-stride loop writing fp32, bf16 or fp16 (the
// serving leaves' dtype; rounded to nearest even, as torch's cast), and
// only the first n_out elements (a serving leaf drops its padding).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr float kInt8Max = 127.0f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, the rotation schedule of jax/_src/prng.py.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k1, uint32_t k2,
                                              uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x1, x2);
}

// max that propagates NaN from either side (jnp.max's semantics)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
    quantize_chunks_kernel(const float* __restrict__ x,
                           int8_t* __restrict__ q,
                           float* __restrict__ scales, long long n_chunks,
                           int chunk, const long long* __restrict__ key,
                           int n_folds, unsigned fold0, unsigned fold1,
                           long long offset, int stochastic) {
  const int lane = threadIdx.x & 31;
  const long long c =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const long long base = c * chunk;
  float m = 0.0f;
  for (int i = lane; i < chunk; i += 32) m = nan_max(fabsf(x[base + i]), m);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    m = nan_max(__shfl_xor_sync(0xffffffffu, m, s), m);
  const float scale = m / kInt8Max;
  const float safe = scale > 0.0f ? scale : 1.0f;
  if (lane == 0) scales[c] = scale;
  uint32_t k1 = 0, k2 = 0;
  if (stochastic) {
    k1 = static_cast<uint32_t>(key[0]);
    k2 = static_cast<uint32_t>(key[1]);
    if (n_folds > 0) {
      const uint2 k = threefry2x32(k1, k2, 0u, fold0);
      k1 = k.x;
      k2 = k.y;
    }
    if (n_folds > 1) {
      const uint2 k = threefry2x32(k1, k2, 0u, fold1);
      k1 = k.x;
      k2 = k.y;
    }
  }
  for (int i = lane; i < chunk; i += 32) {
    const long long idx = base + i;
    const float v = x[idx] / safe;
    float r;
    if (stochastic) {
      const unsigned long long ctr =
          static_cast<unsigned long long>(idx + offset);
      const uint2 b = threefry2x32(k1, k2, static_cast<uint32_t>(ctr >> 32),
                                   static_cast<uint32_t>(ctr));
      const uint32_t bits = b.x ^ b.y;
      const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      r = floorf(v + u);
    } else {
      r = rintf(v);
    }
    r = fminf(fmaxf(r, -kInt8Max), kInt8Max);
    q[idx] = static_cast<int8_t>(static_cast<int>(r));
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dequantize_chunks_kernel(const int8_t* __restrict__ q,
                             const float* __restrict__ scales,
                             T* __restrict__ out, long long n_out,
                             int chunk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_out; i += stride)
    out[i] = from_float<T>(static_cast<float>(q[i]) * scales[i / chunk]);
}

}  // namespace

extern "C" {

// x: fp32 [n_chunks * chunk]; q: int8, same length; scales: fp32
// [n_chunks]; key: int64 [2] on the device (uint32 words), read only when
// stochastic; n_folds (0..2) fold_in's of fold0 then fold1 are applied to
// it; offset: the counter of x[0] in the draw. Returns the CUDA error of
// the launch (0 on success), or -1 for arguments it does not take.
int stoke_quantize_chunks(const float* x, int8_t* q, float* scales,
                          long long n_chunks, int chunk,
                          const long long* key, int n_folds, unsigned fold0,
                          unsigned fold1, long long offset, int stochastic,
                          void* stream) {
  if (chunk < 1 || n_chunks < 0 || n_folds < 0 || n_folds > 2 ||
      (stochastic && key == nullptr))
    return -1;
  if (n_chunks == 0) return 0;
  const long long blocks = (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -1;
  quantize_chunks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, q, scales, n_chunks, chunk, key, n_folds, fold0, fold1, offset,
      stochastic);
  return static_cast<int>(cudaGetLastError());
}

// q: int8 [>= n_out, a whole number of chunks]; scales: fp32 [chunks];
// out: [n_out] in out_dtype (0 float32, 1 bfloat16, 2 float16).
int stoke_dequantize_chunks(const int8_t* q, const float* scales, void* out,
                            long long n_out, int chunk, int out_dtype,
                            void* stream) {
  if (chunk < 1 || n_out < 0 || out_dtype < 0 || out_dtype > 2) return -1;
  if (n_out == 0) return 0;
  long long blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    dequantize_chunks_kernel<float><<<static_cast<unsigned>(blocks), kThreads,
                                      0, s>>>(q, scales,
                                              static_cast<float*>(out), n_out,
                                              chunk);
  else if (out_dtype == 1)
    dequantize_chunks_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            q, scales, static_cast<__nv_bfloat16*>(out), n_out, chunk);
  else
    dequantize_chunks_kernel<__half>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            q, scales, static_cast<__half*>(out), n_out, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* stoke_quant_error(int code) {
  return code < 0 ? "unsupported arguments"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
