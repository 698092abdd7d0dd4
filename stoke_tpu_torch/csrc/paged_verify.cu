// Paged speculative-verify attention for Hopper (sm_90a).
//
// Replaces `_paged_verify_kernel` of stoke_tpu/ops/flash_attention.py
// (called through `paged_verify_attention_pallas`): each slot scores S =
// k+1 queries (its pending token and k drafts) against its cached keys and
// values, which live scattered over a pool of [NB, BS, H, D] pages
// addressed by the slot's row of a [B, MB] block table. Query s of slot b
// sees cache position w iff w <= positions[b, s] (the chunk-attention
// predicate); the softmax is fp32; the output is in the query's dtype while
// the pool may be float32 or bfloat16.
//
// What bounds it on the H100: bytes. Every cached K and V element is read
// once and used for 2*S FLOPs, so at the serve shapes (S = 5, D = 64,
// contexts of a few hundred tokens) the least time is the slots' K/V bytes
// over the 3.35 TB/s of device memory, a few microseconds. A design whose
// time grows with the longest slot's serial walk (one block per (slot,
// head), a dependent table lookup and row load per step) spends ~17x that.
//
// Design. The TPU kernel streams `pages_per_block` pages per grid step
// through a double-buffered VMEM landing zone and folds each page into all
// S query rows. Here the walk is split across blocks:
//   * paged_verify_chunk_kernel: the grid is (H, B, chunks); a block (4
//     warps) takes kChunk = 64 consecutive cache positions of one (slot,
//     head). It walks nothing past the slot's last visible position
//     max_s positions[b, s] (the TPU version walks all MB table entries;
//     masked positions give p == 0 exactly, so the early stop reads fewer
//     bytes for the same result): a block whose chunk starts past it exits
//     at once;
//   * the block copies its chunk's K and V rows into shared memory by
//     cp.async, 16 bytes a lane (4 fp32 or 8 bf16 elements; neighbouring
//     lanes on neighbouring addresses, so a row of a page is one coalesced
//     access), rows padded by 16 bytes against bank conflicts, all issued
//     before any is waited on; bf16 elements are converted after the load.
//     The block is a chain of dependent loads (positions, table, rows), so
//     its table entries are read together with the positions (a lane a
//     query row, one load) rather than after them;
//   * scores: a thread takes one position and every other query row, and
//     computes each score as a whole dot product (q rows, pre-scaled fp32,
//     broadcast from shared memory): no reduction across lanes per (row,
//     position). The rows' max and sum over the chunk then reduce once per
//     row in a warp; P V: a thread owns one 16-byte vector of dims of a few
//     rows and sums over the chunk's positions;
//   * a slot whose visible positions fit in one chunk writes its output
//     directly. Otherwise each block writes, per row, its max m, sum l and
//     unnormalised P V to an fp32 workspace, and paged_verify_merge_kernel
//     (grid (H, B)) combines a (slot, head)'s chunks by their log-sum-exp:
//     O = sum_c exp(m_c - M) acc_c / sum_c exp(m_c - M) l_c, each row's
//     chunk weights computed once into shared memory. A chunk that
//     lies wholly past one row's last position leaves that row with l = 0,
//     and the merge gives it weight 0 (tested on l, so no exp of the
//     sentinel difference enters).
// Idle and still-prefilling slots arrive with all-scratch tables and
// positions 0..S-1; short drafts' padding rows carry clamped positions.
// Table entries are clamped into [0, NB), so every read is legal, and
// every row attends at least position 0, so the output is finite; the
// caller discards those rows.
#include "common.cuh"
#include "mma_tf32.cuh"
#include "paged.cuh"

namespace {

using stoke::from_float;
using stoke::kNegInf;
using stoke::paged::load_vec;
using stoke::paged::warp_max;
using stoke::paged::warp_sum;
using stoke::to_float;
using stoke::tf32::aligned16;
using stoke::tf32::cp_async16;
using stoke::tf32::cp_async_commit;
using stoke::tf32::cp_async_wait;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;  // cache positions of a block
constexpr int kScoreGroups = kThreads / kChunk;  // threads on a position

template <typename TKV, int D, int SMAX>
struct Cfg {
  static constexpr int V = 16 / sizeof(TKV);  // elements of a 16-byte vector
  static constexpr int NV = D / V;             // vectors of a row
  static constexpr int SK = D + V;  // row stride of the K and V tiles
  static constexpr int kRowGroups = kThreads / NV;  // of the P V phase
  static constexpr int kRowsPV = (SMAX + kRowGroups - 1) / kRowGroups;
  static constexpr int SP = kChunk + 1;  // row stride of the P tile
  // K [kChunk][SK] | V [kChunk][SK] (TKV) | q [SMAX][D] | P [SMAX][SP] |
  // m, l [SMAX] (float) | positions [SMAX] (int)
  static constexpr size_t kKVBytes = 2 * kChunk * SK * sizeof(TKV);
  static constexpr size_t kSmem =
      kKVBytes + sizeof(float) * (SMAX * D + SMAX * SP + 2 * SMAX) +
      sizeof(int) * SMAX;
};

// the slot's number of walked positions: up to its last visible one. A
// lane a query row (S <= 16), so the positions are one load, not S
__device__ __forceinline__ int visible_tokens(const int* positions, int b,
                                              int S, int limit) {
  const int lane = threadIdx.x % 32;
  const int n =
      lane < S ? positions[static_cast<size_t>(b) * S + lane] + 1 : 0;
  return min(__reduce_max_sync(0xffffffffu, n), limit);
}

template <typename TQ, typename TKV, int D, int SMAX>
__global__ void __launch_bounds__(kThreads)
    paged_verify_chunk_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ kp,
                              const TKV* __restrict__ vp,
                              const int* __restrict__ tables,
                              const int* __restrict__ positions,
                              TQ* __restrict__ out, float* __restrict__ ws,
                              int S, int NB, int BS, int MB, float scale) {
  using C = Cfg<TKV, D, SMAX>;
  constexpr int V = C::V, NV = C::NV, SK = C::SK, SP = C::SP;
  extern __shared__ float4 smem_f4[];  // 16-byte aligned for cp.async
  TKV* ks = reinterpret_cast<TKV*>(smem_f4);
  TKV* vs = ks + kChunk * SK;
  float* qs = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem_f4) + C::kKVBytes);
  float* ps = qs + SMAX * D;
  float* ms = ps + SMAX * SP;
  float* ls = ms + SMAX;
  int* pos_s = reinterpret_cast<int*>(ls + SMAX);

  const int h = blockIdx.x, b = blockIdx.y, chunk = blockIdx.z;
  const int H = gridDim.x, n_chunks_max = gridDim.z;
  const int c0 = chunk * kChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this thread's 16-byte copies of the chunk's rows, and their table
  // entries, read before the positions decide how much of the chunk is
  // walked: the two loads overlap instead of following each other
  constexpr int kCopies = kChunk * NV / kThreads;
  static_assert(kChunk * NV % kThreads == 0, "the threads share the copies");
  int blk[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int pos = min(c0 + (tid + i * kThreads) / NV, MB * BS - 1);
    blk[i] = tables[static_cast<size_t>(b) * MB + pos / BS];
  }
  const int n_tok = visible_tokens(positions, b, S, MB * BS);
  if (c0 >= n_tok) return;  // nothing of this chunk is visible
  const int n_valid = min(kChunk, n_tok - c0);

  // the chunk's K and V rows, all copies in flight at once; rows past the
  // walk are zero-filled
  const size_t tok_stride = static_cast<size_t>(H) * D;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / NV, c = (e % NV) * V;
    const bool ok = r < n_valid;
    const int pos = c0 + r;
    const size_t off =
        ok ? (static_cast<size_t>(min(max(blk[i], 0), NB - 1)) * BS +
              pos % BS) * tok_stride + static_cast<size_t>(h) * D + c
           : 0;
    cp_async16(ks + r * SK + c, kp + off, ok);
    cp_async16(vs + r * SK + c, vp + off, ok);
  }
  cp_async_commit();
  const size_t qoff = (static_cast<size_t>(b) * H + h) * S * D;
#pragma unroll
  for (int j = 0; j < (SMAX * D + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (i < S * D) qs[i] = to_float(q[qoff + i]) * scale;
  }
  if (tid < S) pos_s[tid] = positions[static_cast<size_t>(b) * S + tid];
  cp_async_wait<0>();
  __syncthreads();

  // scores: position p of the chunk against rows sg, sg + 2, ... as whole
  // dot products; the key row is read once for all of them
  {
    constexpr int kRows = SMAX / kScoreGroups;
    const int p = tid % kChunk, sg = tid / kChunk;
    float sc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += V) {
      float kv[V];
      load_vec(ks + p * SK + c, kv);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int s = sg + kScoreGroups * j;
        if (s < S) {
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + s * D + c + e);
            sc[j] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
                     qv.w * kv[e + 3];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int s = sg + kScoreGroups * j;
      if (s < S)
        ps[s * SP + p] = p < n_valid && c0 + p <= pos_s[s] ? sc[j] : kNegInf;
    }
  }
  __syncthreads();

  // each row's max and sum over the chunk, P in place of the scores
  for (int s = warp; s < S; s += kWarps) {
    float x[kChunk / 32];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      x[i] = ps[s * SP + lane + 32 * i];
      mx = fmaxf(mx, x[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const float pv = x[i] > 0.5f * kNegInf ? expf(x[i] - mx) : 0.f;
      ps[s * SP + lane + 32 * i] = pv;
      sum += pv;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ms[s] = mx;
      ls[s] = sum;
    }
  }
  __syncthreads();

  // P V: this thread's 16-byte vector of dims for rows rg, rg + kRowGroups
  const int cv = tid % NV, rg = tid / NV;
  float acc[C::kRowsPV][V];
#pragma unroll
  for (int j = 0; j < C::kRowsPV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
#pragma unroll 4
  for (int p = 0; p < n_valid; ++p) {
    float vv[V];
    load_vec(vs + p * SK + cv * V, vv);
#pragma unroll
    for (int j = 0; j < C::kRowsPV; ++j) {
      const int s = rg + C::kRowGroups * j;
      if (s < S) {
        const float pj = ps[s * SP + p];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] += pj * vv[e];
      }
    }
  }

  const int n_chunks = (n_tok + kChunk - 1) / kChunk;
  if (n_chunks == 1) {
    // the whole walk: normalise and write the output. l >= 1 (the row's
    // max term is 1), so the fast division (2 ulp) is exact enough
#pragma unroll
    for (int j = 0; j < C::kRowsPV; ++j) {
      const int s = rg + C::kRowGroups * j;
      if (s >= S) continue;
      const float inv = __fdividef(1.f, ls[s] > 0.f ? ls[s] : 1.f);
#pragma unroll
      for (int e = 0; e < V; ++e)
        out[qoff + s * D + cv * V + e] = from_float<TQ>(acc[j][e] * inv);
    }
    return;
  }
  // a partial: acc [B, H, chunks, S, D], then m, l [B, H, chunks, S, 2]
  const size_t slab = (static_cast<size_t>(b) * H + h) * n_chunks_max + chunk;
  float* w_acc = ws + slab * S * D;
  float* w_ml = ws + static_cast<size_t>(gridDim.y) * H * n_chunks_max * S * D +
                slab * S * 2;
  if (tid < S) {
    w_ml[2 * tid] = ms[tid];
    w_ml[2 * tid + 1] = ls[tid];
  }
#pragma unroll
  for (int j = 0; j < C::kRowsPV; ++j) {
    const int s = rg + C::kRowGroups * j;
    if (s >= S) continue;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(w_acc + s * D + cv * V + e) =
          make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
  }
}

// combine a (slot, head)'s chunk partials by their log-sum-exp; slots
// walked in one chunk were written by the chunk kernel
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
    paged_verify_merge_kernel(const int* __restrict__ positions,
                              const float* __restrict__ ws,
                              TQ* __restrict__ out, int S, int BS, int MB,
                              int n_chunks_max) {
  // the chunks' (m, l) [n_chunks][S][2], then each chunk's weight for each
  // row [S][n_chunks]
  extern __shared__ float merge_smem[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int n_chunks =
      (visible_tokens(positions, b, S, MB * BS) + kChunk - 1) / kChunk;
  if (n_chunks <= 1) return;
  const size_t slab = (static_cast<size_t>(b) * H + h) * n_chunks_max;
  const float* w_acc = ws + slab * S * D;
  const float* w_ml =
      ws + static_cast<size_t>(gridDim.y) * H * n_chunks_max * S * D +
      slab * S * 2;
  float* ml = merge_smem;
  float* wts = ml + n_chunks * S * 2;
  for (int i = threadIdx.x; i < n_chunks * S * 2; i += kThreads)
    ml[i] = w_ml[i];
  __syncthreads();
  // a thread a row: chunk c weighs exp(m_c - M) / sum_c' exp(m_c' - M) l_c',
  // M the largest m of the chunks that hold any of the row's positions; a
  // chunk past the row's last position (l == 0) weighs nothing. The total
  // is >= 1 (the chunk holding the row's max has weight 1 and l >= 1), so
  // the fast division is exact enough
  for (int s = threadIdx.x; s < S; s += kThreads) {
    float big = kNegInf;
    for (int c = 0; c < n_chunks; ++c) {
      const float* p = ml + (c * S + s) * 2;
      if (p[1] > 0.f) big = fmaxf(big, p[0]);
    }
    float total = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* p = ml + (c * S + s) * 2;
      const float wt = p[1] > 0.f ? expf(p[0] - big) : 0.f;
      wts[s * n_chunks + c] = wt;
      total += p[1] * wt;
    }
    const float inv = __fdividef(1.f, total > 0.f ? total : 1.f);
    for (int c = 0; c < n_chunks; ++c) wts[s * n_chunks + c] *= inv;
  }
  __syncthreads();
  const size_t qoff = (static_cast<size_t>(b) * H + h) * S * D;
  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const float* wt = wts + (i / D) * n_chunks;
    float o = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_chunks; ++c) o += w_acc[c * S * D + i] * wt[c];
    out[qoff + i] = from_float<TQ>(o);
  }
}

// the chunks of a table: the grid's third dimension
inline int grid_chunks(int BS, int MB) {
  return (MB * BS + kChunk - 1) / kChunk;
}

template <typename TQ, typename TKV, int D, int SMAX>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* positions, void* out,
                   float* ws, int B, int H, int S, int NB, int BS, int MB,
                   float scale, cudaStream_t stream) {
  using C = Cfg<TKV, D, SMAX>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_verify_chunk_kernel<TQ, TKV, D, SMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const int nc = grid_chunks(BS, MB);
  paged_verify_chunk_kernel<TQ, TKV, D, SMAX>
      <<<dim3(H, B, nc), kThreads, C::kSmem, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
          static_cast<const TKV*>(vp), tables, positions,
          static_cast<TQ*>(out), ws, S, NB, BS, MB, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return err;
  paged_verify_merge_kernel<TQ, D>
      <<<dim3(H, B), kThreads, sizeof(float) * 3 * S * nc, stream>>>(
          positions, ws, static_cast<TQ*>(out), S, BS, MB, nc);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_ds(int D, const void* q, const void* kp, const void* vp,
                      const int* tables, const int* positions, void* out,
                      float* ws, int B, int H, int S, int NB, int BS, int MB,
                      float scale, cudaStream_t stream) {
  if (D == 64 && S <= 8)
    return launch<TQ, TKV, 64, 8>(q, kp, vp, tables, positions, out, ws, B,
                                  H, S, NB, BS, MB, scale, stream);
  if (D == 64)
    return launch<TQ, TKV, 64, 16>(q, kp, vp, tables, positions, out, ws, B,
                                   H, S, NB, BS, MB, scale, stream);
  if (S <= 8)
    return launch<TQ, TKV, 128, 8>(q, kp, vp, tables, positions, out, ws, B,
                                   H, S, NB, BS, MB, scale, stream);
  return launch<TQ, TKV, 128, 16>(q, kp, vp, tables, positions, out, ws, B,
                                  H, S, NB, BS, MB, scale, stream);
}

}  // namespace

extern "C" {

// Floats of the workspace that stoke_paged_verify needs at these shapes
// (the chunk partials: m, l and P V per slot, head, chunk and query row).
long long stoke_paged_verify_workspace_floats(int B, int H, int S, int D,
                                              int BS, int MB) {
  return static_cast<long long>(B) * H * grid_chunks(BS, MB) * S *
         (D + 2);
}

// q, out: [B, H, S, D] contiguous in q_dtype; k_pages, v_pages: [NB, BS, H,
// D] contiguous in kv_dtype (0 = float32, 1 = bfloat16), 16-byte aligned;
// tables: [B, MB] int32; positions: [B, S] int32; ws: float32 scratch of
// stoke_paged_verify_workspace_floats elements. Returns the CUDA error of
// the launches (0 on success; cudaErrorMisalignedAddress for pools that are
// not 16-byte aligned), or -1 for a dtype, head dim or query count (1..16)
// it does not take.
int stoke_paged_verify(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* positions, void* out,
                       float* ws, int B, int H, int S, int D, int NB, int BS,
                       int MB, int q_dtype, int kv_dtype, float scale,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || S < 1 || S > 16 || q_dtype < 0 ||
      q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1)
    return -1;
  if (!aligned16({kp, vp})) return cudaErrorMisalignedAddress;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_ds<float, float>(D, q, kp, vp, tables, positions, out, ws,
                                   B, H, S, NB, BS, MB, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_ds<float, __nv_bfloat16>(D, q, kp, vp, tables, positions,
                                           out, ws, B, H, S, NB, BS, MB,
                                           scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_ds<__nv_bfloat16, float>(D, q, kp, vp, tables, positions,
                                           out, ws, B, H, S, NB, BS, MB,
                                           scale, st);
  return launch_ds<__nv_bfloat16, __nv_bfloat16>(
      D, q, kp, vp, tables, positions, out, ws, B, H, S, NB, BS, MB, scale,
      st);
}

const char* stoke_paged_verify_error(int code) {
  return code < 0 ? "unsupported dtype, head dim or query count"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
