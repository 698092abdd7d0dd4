// Paged speculative-verify attention for Hopper (sm_90a).
//
// Replaces `_paged_verify_kernel` of stoke_tpu/ops/flash_attention.py
// (called through `paged_verify_attention_pallas`): each slot scores S =
// k+1 queries (its pending token and k drafts) against its cached keys and
// values, which live scattered over a pool of [NB, BS, H, D] pages
// addressed by the slot's row of a [B, MB] block table. Query s of slot b
// sees cache position w iff w <= positions[b, s] (the chunk-attention
// predicate); the softmax is fp32 and online; the output is in the query's
// dtype while the pool may be float32 or bfloat16.
//
// What bounds it on the H100: bytes. Every cached K and V element is read
// once and used for 2*S FLOPs, so at the serve shapes (S = 5, D = 64,
// contexts of a few hundred tokens) the least time is the slots' K/V bytes
// over the 3.35 TB/s of device memory, a few microseconds; launch latency
// and dependent-load latency matter as much.
//
// Design. The TPU kernel streams `pages_per_block` pages per grid step
// through a double-buffered VMEM landing zone and folds each page into all
// S query rows. Here, from csrc/paged_decode.cu's schedule:
//   * one thread block (4 warps) per (slot, head); the block loads its own
//     table row into shared memory and its S positions;
//   * the block walks positions only up to max_s positions[b, s], so at
//     most ceil((max_pos + 1) / BS) pages. The TPU version walks all MB
//     table entries; masked positions give p == 0 exactly, so the early
//     stop reads fewer bytes for the same result;
//   * each warp takes 4 positions at a time and issues their 8 row loads
//     (K and V) before any arithmetic; a lane owns dims lane + 32*e, so a
//     row load is one coalesced access of the head's D elements;
//   * each loaded row is folded into the online-softmax state of every
//     query row: per lane m, l and acc[D/32] for each of the S rows, in
//     registers. S is a runtime value up to a compile-time maximum (8 or
//     16); the wrapper raises above 16;
//   * the 4 warps' states merge once through shared memory at the end.
// Idle and still-prefilling slots arrive with all-scratch tables and
// positions 0..S-1; short drafts' padding rows carry clamped positions.
// Table entries are clamped into [0, NB), so every read is legal, and
// every row attends at least position 0, so the output is finite; the
// caller discards those rows.
#include "common.cuh"

namespace {

using stoke::from_float;
using stoke::kNegInf;
using stoke::to_float;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;  // cache positions a warp loads at once

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename TKV, int D, int SMAX>
__global__ void __launch_bounds__(kThreads)
    paged_verify_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp,
                        const int* __restrict__ tables,
                        const int* __restrict__ positions,
                        TQ* __restrict__ out, int H, int S, int NB, int BS,
                        int MB, float scale) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  extern __shared__ int table[];  // [MB]
  __shared__ float w_m[kWarps][SMAX], w_l[kWarps][SMAX];
  __shared__ float w_acc[kWarps][SMAX][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < MB; i += kThreads)
    table[i] = min(max(tables[static_cast<size_t>(b) * MB + i], 0), NB - 1);
  // each query's last visible position, and how far the block walks
  int qpos[SMAX];
  int n_tok = 0;
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    qpos[s] = s < S ? positions[static_cast<size_t>(b) * S + s] : -1;
    n_tok = max(n_tok, qpos[s] + 1);
  }
  n_tok = min(n_tok, MB * BS);
  __syncthreads();

  const size_t qoff = (static_cast<size_t>(b) * H + h) * S * D;
  float qv[SMAX][EPL];
#pragma unroll
  for (int s = 0; s < SMAX; ++s)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[s][e] = s < S ? to_float(q[qoff + s * D + lane + 32 * e]) * scale
                       : 0.f;

  const size_t tok_stride = static_cast<size_t>(H) * D;
  float m[SMAX], l[SMAX], acc[SMAX][EPL];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    m[s] = kNegInf;
    l[s] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[s][e] = 0.f;
  }

  for (int t0 = warp * kGroup; t0 < n_tok; t0 += kWarps * kGroup) {
    float kr[kGroup][EPL], vr[kGroup][EPL];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int pos = t0 + g;
      if (pos < n_tok) {
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
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      if (s >= S) break;
      float sc[kGroup];
      float mx = kNegInf;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qv[s][e] * kr[g][e];
        part = warp_sum(part);
        sc[g] = t0 + g <= qpos[s] ? part : kNegInf;
        mx = fmaxf(mx, sc[g]);
      }
      const float m_new = fmaxf(m[s], mx);
      const float corr = expf(m[s] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[s][e] *= corr;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float p = sc[g] > 0.5f * kNegInf ? expf(sc[g] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[s][e] += p * vr[g][e];
      }
      l[s] = l[s] * corr + psum;
      m[s] = m_new;
    }
  }

#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s >= S) break;
    if (lane == 0) {
      w_m[warp][s] = m[s];
      w_l[warp][s] = l[s];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) w_acc[warp][s][lane + 32 * e] = acc[s][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int s = i / D, d = i % D;
    float big = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, w_m[w][s]);
    float total = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = w_l[w][s] > 0.f ? expf(w_m[w][s] - big) : 0.f;
      total += w_l[w][s] * wt;
      o += w_acc[w][s][d] * wt;
    }
    out[qoff + i] = from_float<TQ>(o / (total > 0.f ? total : 1.f));
  }
}

template <typename TQ, typename TKV, int D, int SMAX>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* positions, void* out, int B,
                   int H, int S, int NB, int BS, int MB, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  paged_verify_kernel<TQ, TKV, D, SMAX>
      <<<grid, kThreads, sizeof(int) * MB, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
          static_cast<const TKV*>(vp), tables, positions,
          static_cast<TQ*>(out), H, S, NB, BS, MB, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_ds(int D, const void* q, const void* kp, const void* vp,
                      const int* tables, const int* positions, void* out,
                      int B, int H, int S, int NB, int BS, int MB, float scale,
                      cudaStream_t stream) {
  if (D == 64 && S <= 8)
    return launch<TQ, TKV, 64, 8>(q, kp, vp, tables, positions, out, B, H, S,
                                  NB, BS, MB, scale, stream);
  if (D == 64)
    return launch<TQ, TKV, 64, 16>(q, kp, vp, tables, positions, out, B, H,
                                   S, NB, BS, MB, scale, stream);
  if (S <= 8)
    return launch<TQ, TKV, 128, 8>(q, kp, vp, tables, positions, out, B, H,
                                   S, NB, BS, MB, scale, stream);
  return launch<TQ, TKV, 128, 16>(q, kp, vp, tables, positions, out, B, H, S,
                                  NB, BS, MB, scale, stream);
}

}  // namespace

extern "C" {

// q, out: [B, H, S, D] contiguous in q_dtype; k_pages, v_pages: [NB, BS, H,
// D] contiguous in kv_dtype (0 = float32, 1 = bfloat16); tables: [B, MB]
// int32; positions: [B, S] int32. Returns the CUDA error of the launch (0
// on success), or -1 for a dtype, head dim or query count (1..16) it does
// not take.
int stoke_paged_verify(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* positions, void* out,
                       int B, int H, int S, int D, int NB, int BS, int MB,
                       int q_dtype, int kv_dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || S < 1 || S > 16 || q_dtype < 0 ||
      q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return -1;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_ds<float, float>(D, q, kp, vp, tables, positions, out, B, H,
                                   S, NB, BS, MB, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_ds<float, __nv_bfloat16>(D, q, kp, vp, tables, positions,
                                           out, B, H, S, NB, BS, MB, scale,
                                           st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_ds<__nv_bfloat16, float>(D, q, kp, vp, tables, positions,
                                           out, B, H, S, NB, BS, MB, scale,
                                           st);
  return launch_ds<__nv_bfloat16, __nv_bfloat16>(
      D, q, kp, vp, tables, positions, out, B, H, S, NB, BS, MB, scale, st);
}

const char* stoke_paged_verify_error(int code) {
  return code < 0 ? "unsupported dtype, head dim or query count"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
