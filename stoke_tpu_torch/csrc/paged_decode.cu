// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces `_paged_decode_kernel` of stoke_tpu/ops/flash_attention.py
// (called through `paged_decode_attention_pallas`): each decode slot's one
// query attends over its cached keys and values, which live scattered over
// a pool of [NB, BS, H, D] pages addressed by the slot's row of a [B, MB]
// block table; positions >= context_lens[b] are masked; the output is in
// the query's dtype while the pool may be float32 or bfloat16.
//
// What bounds it on the H100: bytes. Every cached K and V element is used
// for two FLOPs, so the least time is the slots' cached K/V bytes over the
// 3.35 TB/s of device memory; at the serve path's shapes (B=8, H=12, D=64,
// contexts of a few hundred tokens) that is a few microseconds, so launch
// latency and the latency of dependent loads matter as much as bandwidth.
//
// Design. The TPU kernel gets the block table by SMEM scalar prefetch and
// double-buffers `pages_per_block` pages through VMEM. Here:
//   * one thread block (4 warps) per (slot, head); the block loads its own
//     table row into shared memory and its own context length;
//   * the block walks the pages only up to ceil(ctx / BS). The TPU version
//     walks all MB table entries and masks the tail; masked positions give
//     p == 0 exactly, so the early stop reads fewer bytes for the same
//     result;
//   * each warp takes 4 token positions at a time, issuing the 8 row loads
//     (K and V) before any arithmetic so they are in flight together; a
//     lane owns dims lane + 32*e, so each row load is one coalesced 128- or
//     256-byte access of the head's D contiguous elements;
//   * scores reduce across the warp with shuffles and fold into the warp's
//     fp32 online softmax (m, l, acc in registers); the 4 warps' states
//     merge once through shared memory at the end;
//   * no split over long contexts yet: one block walks a slot's whole
//     context.
// Inactive slots arrive with context_len 1 on an all-scratch table; they
// read scratch block 0 and give a finite output that the caller discards.
// Table entries are clamped into [0, NB) so no entry can read outside the
// pool.
#include "common.cuh"

namespace {

using stoke::from_float;
using stoke::kNegInf;
using stoke::to_float;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;  // token positions a warp loads at once

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ lens, TQ* __restrict__ out,
                        int H, int NB, int BS, int MB, float scale) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  extern __shared__ int table[];  // [MB]
  __shared__ float w_m[kWarps], w_l[kWarps], w_acc[kWarps][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < MB; i += kThreads)
    table[i] = min(max(tables[static_cast<size_t>(b) * MB + i], 0), NB - 1);
  const int ctx = max(0, min(lens[b], MB * BS));
  __syncthreads();

  const size_t qoff = (static_cast<size_t>(b) * H + h) * D;
  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = to_float(q[qoff + lane + 32 * e]) * scale;

  const size_t tok_stride = static_cast<size_t>(H) * D;
  float m = kNegInf, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int t0 = warp * kGroup; t0 < ctx; t0 += kWarps * kGroup) {
    float kr[kGroup][EPL], vr[kGroup][EPL];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int pos = t0 + g;
      if (pos < ctx) {
        const size_t row =
            (static_cast<size_t>(table[pos / BS]) * BS + pos % BS) *
                tok_stride +
            static_cast<size_t>(h) * D;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[g][e] = to_float(kp[row + lane + 32 * e]);
          vr[g][e] = to_float(vp[row + lane + 32 * e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[g][e] = vr[g][e] = 0.f;
      }
    }
    float s[kGroup];
    float mx = kNegInf;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part += qv[e] * kr[g][e];
      part = warp_sum(part);
      s[g] = t0 + g < ctx ? part : kNegInf;
      mx = fmaxf(mx, s[g]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float p = s[g] > 0.5f * kNegInf ? expf(s[g] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] += p * vr[g][e];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) w_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();

  float big = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) big = fmaxf(big, w_m[w]);
  float total = 0.f, wt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = w_l[w] > 0.f ? expf(w_m[w] - big) : 0.f;
    total += w_l[w] * wt[w];
  }
  const float inv = 1.f / (total > 0.f ? total : 1.f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += w_acc[w][d] * wt[w];
    out[qoff + d] = from_float<TQ>(o * inv);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lens, void* out, int B,
                   int H, int NB, int BS, int MB, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_decode_kernel<TQ, TKV, D>
      <<<grid, kThreads, sizeof(int) * MB, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
          static_cast<const TKV*>(vp), tables, lens, static_cast<TQ*>(out), H,
          NB, BS, MB, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp,
                     const int* tables, const int* lens, void* out, int B,
                     int H, int NB, int BS, int MB, float scale,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<TQ, TKV, 64>(q, kp, vp, tables, lens, out, B, H, NB, BS,
                               MB, scale, stream);
  return launch<TQ, TKV, 128>(q, kp, vp, tables, lens, out, B, H, NB, BS, MB,
                              scale, stream);
}

}  // namespace

extern "C" {

// q, out: [B, H, D] contiguous in q_dtype; k_pages, v_pages: [NB, BS, H, D]
// contiguous in kv_dtype (0 = float32, 1 = bfloat16); tables: [B, MB]
// int32; lens: [B] int32. Returns the CUDA error of the launch (0 on
// success), or -1 for a dtype or head dim it does not take.
int stoke_paged_decode(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* lens, void* out, int B,
                       int H, int D, int NB, int BS, int MB, int q_dtype,
                       int kv_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 ||
      kv_dtype > 1)
    return -1;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_d<float, float>(D, q, kp, vp, tables, lens, out, B, H, NB,
                                  BS, MB, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_d<float, __nv_bfloat16>(D, q, kp, vp, tables, lens, out, B,
                                          H, NB, BS, MB, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_d<__nv_bfloat16, float>(D, q, kp, vp, tables, lens, out, B,
                                          H, NB, BS, MB, scale, s);
  return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, kp, vp, tables, lens,
                                                out, B, H, NB, BS, MB, scale,
                                                s);
}

const char* stoke_paged_decode_error(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
