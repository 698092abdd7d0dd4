// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces `_paged_decode_kernel` of stoke_tpu/ops/flash_attention.py
// (called through `paged_decode_attention_pallas`): each decode slot's one
// query attends over its cached keys and values, which live scattered over
// a pool of [NB, BS, H, D] pages addressed by the slot's row of a [B, MB]
// block table; positions >= context_lens[b] are masked; the softmax is
// fp32; the output is in the query's dtype while the pool may be float32
// or bfloat16.
//
// What bounds it on the H100: bytes. Every cached K and V element is read
// once and used for two FLOPs, so the least time is the slots' cached K/V
// bytes over the 3.35 TB/s of device memory; at the serve path's shapes
// (B=8, H=12, D=64, contexts of a few hundred tokens) that is a few
// microseconds. A design whose time grows with the longest slot's serial
// walk (one block per (slot, head), a dependent table lookup and row load
// per step, as this file's first kernel did) spends 10-15x that; this one
// about 3x, a quarter of it in the merge (PERF.md §6, NVIDIA H100 80GB HBM3
// at 700 W). One block a slot walking its chunks in turn, with no
// merge, wins only where every slot fits one chunk, which the host cannot
// see: the lengths live on the card.
//
// Design. The TPU kernel streams `pages_per_block` pages per grid step
// through a double-buffered VMEM landing zone into one online-softmax row.
// Here the walk is split across blocks, as in paged_verify.cu with one
// query row:
//   * paged_decode_chunk_kernel: the grid is (H, B, chunks); a block (4
//     warps) takes kChunk = 64 consecutive cache positions of one (slot,
//     head). It walks nothing at or past ctx = clamp(context_lens[b], 0,
//     MB * BS) (the TPU version walks all MB table entries; masked
//     positions give p == 0 exactly, so the early stop reads fewer bytes
//     for the same result): a block whose chunk starts there exits at
//     once. The block is a chain of dependent loads (length, table, rows),
//     so its table entries are read together with the length, not after;
//   * the block copies its chunk's K and V rows into shared memory by
//     cp.async, 16 bytes a lane (4 fp32 or 8 bf16 elements; neighbouring
//     lanes on neighbouring addresses, so a row of a page is one coalesced
//     access), rows padded by 16 bytes against bank conflicts, every copy
//     issued before any is waited on, K and V in two groups so the scores
//     start while V lands; bf16 elements are converted after the load;
//   * scores: kThreads / kChunk threads share a position, each a slice of
//     its dims (16-byte vectors, a quarter-warp on eight rows, so the
//     padded rows meet no bank conflict); the slices combine by one
//     shuffle, the chunk's max by one warp reduction and one read of the
//     warps' maxima;
//   * P V: a thread owns one 16-byte vector of dims and every
//     (kThreads / (D / vector))-th position of the chunk, computing its
//     p = exp(s - m) where it uses it; the slices' partial sums and l
//     combine once through shared memory (over the K tile, read by then);
//   * a slot whose walk fits in one chunk writes its output directly.
//     Otherwise each block writes its max m, sum l and unnormalised P V to
//     an fp32 workspace, and paged_decode_merge_kernel (grid (H, B))
//     combines a (slot, head)'s chunks by their log-sum-exp: O = sum_c
//     exp(m_c - M) acc_c / sum_c exp(m_c - M) l_c, one warp computing the
//     weights, a lane a chunk. Every walked chunk holds a visible position
//     (l >= 1), but a chunk with l == 0 would weigh nothing.
// A slot at context 0 gets exactly 0, as the JAX kernel gives it (its
// chunk-0 block writes zeros; the merge has nothing to combine). Inactive
// slots arrive with context_len 1 on an all-scratch table; they read
// scratch block 0 and give a finite output that the caller discards.
// Table entries are clamped into [0, NB) so no entry can read outside the
// pool.
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

template <typename TKV, int D>
struct Cfg {
  static constexpr int V = 16 / sizeof(TKV);  // elements of a 16-byte vector
  static constexpr int NV = D / V;             // vectors of a row
  static constexpr int SK = D + V;  // row stride of the K and V tiles
  // scores: threads on a position, and the positions of a warp
  static constexpr int kSlices = kThreads / kChunk;
  static constexpr int kWarpPos = 32 / kSlices;
  // P V: threads on a vector of dims, each on every kPosGroups-th position
  static constexpr int kPosGroups = kThreads / NV;
  static constexpr int kCopies = kChunk * NV / kThreads;  // of K, a thread
  static_assert(kSlices >= 1 && NV % kSlices == 0, "a slice is whole vectors");
  static_assert(kCopies * kThreads == kChunk * NV, "the threads share copies");
  static_assert(kPosGroups * NV == kThreads, "the threads share the dims");
  // K [kChunk][SK] (then the P V partials [kPosGroups][D] and their l
  // [kPosGroups], as floats) | V [kChunk][SK] (TKV) | q [D] | scores
  // [kChunk] | the warps' maxima [kWarps] (float)
  static constexpr size_t kTileBytes = kChunk * SK * sizeof(TKV);
  static_assert(sizeof(float) * kPosGroups * (D + 1) <= kTileBytes,
                "the partials fit in the K tile");
  static constexpr size_t kSmem =
      2 * kTileBytes + sizeof(float) * (D + kChunk + kWarps);
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_chunk_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ kp,
                              const TKV* __restrict__ vp,
                              const int* __restrict__ tables,
                              const int* __restrict__ lens,
                              TQ* __restrict__ out, float* __restrict__ ws,
                              int NB, int BS, int MB, float scale) {
  using C = Cfg<TKV, D>;
  constexpr int V = C::V, NV = C::NV, SK = C::SK;
  extern __shared__ float4 smem_f4[];  // 16-byte aligned for cp.async
  TKV* ks = reinterpret_cast<TKV*>(smem_f4);
  TKV* vs = ks + kChunk * SK;
  float* qs = reinterpret_cast<float*>(vs + kChunk * SK);
  float* ss = qs + D;
  float* wmax = ss + kChunk;
  float* part = reinterpret_cast<float*>(smem_f4);  // over K, after scores
  float* lpart = part + C::kPosGroups * D;

  const int h = blockIdx.x, b = blockIdx.y, chunk = blockIdx.z;
  const int H = gridDim.x, n_chunks_max = gridDim.z;
  const int c0 = chunk * kChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qoff = (static_cast<size_t>(b) * H + h) * D;
  // this thread's copies' table entries, read together with the length
  int blk[C::kCopies];
#pragma unroll
  for (int i = 0; i < C::kCopies; ++i) {
    const int pos = min(c0 + (tid + i * kThreads) / NV, MB * BS - 1);
    blk[i] = tables[static_cast<size_t>(b) * MB + pos / BS];
  }
  const int ctx = max(0, min(lens[b], MB * BS));
  if (c0 >= ctx) {
    // nothing of this chunk is visible; a slot with no visible position
    // at all gets 0
    if (ctx == 0 && chunk == 0)
      for (int d = tid; d < D; d += kThreads)
        out[qoff + d] = from_float<TQ>(0.f);
    return;
  }
  const int n_valid = min(kChunk, ctx - c0);

  // the chunk's K rows, then its V rows, all copies in flight at once;
  // rows past the walk are zero-filled
  const size_t tok_stride = static_cast<size_t>(H) * D;
  size_t off[C::kCopies];
#pragma unroll
  for (int i = 0; i < C::kCopies; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / NV, c = (e % NV) * V;
    off[i] = r < n_valid
                 ? (static_cast<size_t>(min(max(blk[i], 0), NB - 1)) * BS +
                    (c0 + r) % BS) * tok_stride + static_cast<size_t>(h) * D +
                       c
                 : 0;
    cp_async16(ks + r * SK + c, kp + off[i], r < n_valid);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < C::kCopies; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / NV, c = (e % NV) * V;
    cp_async16(vs + r * SK + c, vp + off[i], r < n_valid);
  }
  cp_async_commit();
  for (int d = tid; d < D; d += kThreads)
    qs[d] = to_float(q[qoff + d]) * scale;
  cp_async_wait<1>();  // this thread's K copies
  __syncthreads();

  // scores: position p of the chunk, this thread's slice of its vectors
  // (vectors sl, sl + kSlices, ...); the slices combine by shuffles
  {
    const int p = warp * C::kWarpPos + lane % C::kWarpPos;
    const int sl = lane / C::kWarpPos;
    float sc = 0.f;
#pragma unroll
    for (int j = 0; j < NV / C::kSlices; ++j) {
      const int c = (sl + C::kSlices * j) * V;
      float kv[V];
      load_vec(ks + p * SK + c, kv);
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + c + e);
        sc += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
              qv.w * kv[e + 3];
      }
    }
#pragma unroll
    for (int o = C::kWarpPos; o < 32; o <<= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, o);
    sc = p < n_valid ? sc : kNegInf;
    const float mx = warp_max(sc);
    if (sl == 0) ss[p] = sc;
    if (lane == 0) wmax[warp] = mx;
  }
  cp_async_wait<0>();  // this thread's V copies
  __syncthreads();

  float m = wmax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w]);
  // P V: this thread's 16-byte vector of dims over positions pg,
  // pg + kPosGroups, ...
  const int cv = tid % NV, pg = tid / NV;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  float l = 0.f;
#pragma unroll 4
  for (int p = pg; p < n_valid; p += C::kPosGroups) {
    const float pv = expf(ss[p] - m);
    float vv[V];
    load_vec(vs + p * SK + cv * V, vv);
    l += pv;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += pv * vv[e];
  }
#pragma unroll
  for (int e = 0; e < V; e += 4)
    *reinterpret_cast<float4*>(part + pg * D + cv * V + e) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  if (cv == 0) lpart[pg] = l;
  __syncthreads();

  float l_sum = 0.f;
#pragma unroll
  for (int g = 0; g < C::kPosGroups; ++g) l_sum += lpart[g];
  const int n_chunks = (ctx + kChunk - 1) / kChunk;
  // the whole walk: normalise and write the output. l >= 1 (the max
  // term is 1), so the fast division (2 ulp) is exact enough
  const float inv = n_chunks == 1 ? __fdividef(1.f, l_sum) : 1.f;
  // a partial: acc [B, H, chunks, D], then m, l [B, H, chunks, 2]
  const size_t slab = (static_cast<size_t>(b) * H + h) * n_chunks_max + chunk;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < C::kPosGroups; ++g) o += part[g * D + d];
    if (n_chunks == 1)
      out[qoff + d] = from_float<TQ>(o * inv);
    else
      ws[slab * D + d] = o;
  }
  if (n_chunks > 1 && tid == 0) {
    float* w_ml = ws + static_cast<size_t>(gridDim.y) * H * n_chunks_max * D +
                  slab * 2;
    w_ml[0] = m;
    w_ml[1] = l_sum;
  }
}

// combine a (slot, head)'s chunk partials by their log-sum-exp; slots
// walked in one chunk (or none) were written by the chunk kernel
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const int* __restrict__ lens,
                              const float* __restrict__ ws,
                              TQ* __restrict__ out, int BS, int MB,
                              int n_chunks_max) {
  extern __shared__ float wts[];  // [n_chunks]
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int ctx = max(0, min(lens[b], MB * BS));
  const int n_chunks = (ctx + kChunk - 1) / kChunk;
  if (n_chunks <= 1) return;
  const size_t slab = (static_cast<size_t>(b) * H + h) * n_chunks_max;
  const float* w_acc = ws + slab * D;
  const float* w_ml =
      ws + static_cast<size_t>(gridDim.y) * H * n_chunks_max * D + slab * 2;
  if (threadIdx.x < 32) {
    // chunk c weighs exp(m_c - M) / sum_c' exp(m_c' - M) l_c', M the
    // largest m of the chunks with l > 0; the total is >= 1 (the chunk
    // holding the max has weight 1 and l >= 1), so the fast division is
    // exact enough
    const int lane = threadIdx.x;
    float big = kNegInf;
    for (int c = lane; c < n_chunks; c += 32)
      if (w_ml[2 * c + 1] > 0.f) big = fmaxf(big, w_ml[2 * c]);
    big = warp_max(big);
    float total = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const float l = w_ml[2 * c + 1];
      const float wt = l > 0.f ? expf(w_ml[2 * c] - big) : 0.f;
      wts[c] = wt;
      total += l * wt;
    }
    total = warp_sum(total);
    const float inv = __fdividef(1.f, total > 0.f ? total : 1.f);
    for (int c = lane; c < n_chunks; c += 32) wts[c] *= inv;
  }
  __syncthreads();
  const size_t qoff = (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_chunks; ++c) o += w_acc[c * D + d] * wts[c];
    out[qoff + d] = from_float<TQ>(o);
  }
}

// the chunks of a table: the grid's third dimension
inline int grid_chunks(int BS, int MB) {
  return (MB * BS + kChunk - 1) / kChunk;
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* tables, const int* lens, void* out, float* ws,
                   int B, int H, int NB, int BS, int MB, float scale,
                   cudaStream_t stream) {
  using C = Cfg<TKV, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_chunk_kernel<TQ, TKV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const int nc = grid_chunks(BS, MB);
  paged_decode_chunk_kernel<TQ, TKV, D>
      <<<dim3(H, B, nc), kThreads, C::kSmem, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
          static_cast<const TKV*>(vp), tables, lens, static_cast<TQ*>(out),
          ws, NB, BS, MB, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nc == 1) return err;
  paged_decode_merge_kernel<TQ, D>
      <<<dim3(H, B), kThreads, sizeof(float) * nc, stream>>>(
          lens, ws, static_cast<TQ*>(out), BS, MB, nc);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp,
                     const int* tables, const int* lens, void* out,
                     float* ws, int B, int H, int NB, int BS, int MB,
                     float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<TQ, TKV, 64>(q, kp, vp, tables, lens, out, ws, B, H, NB,
                               BS, MB, scale, stream);
  return launch<TQ, TKV, 128>(q, kp, vp, tables, lens, out, ws, B, H, NB, BS,
                              MB, scale, stream);
}

}  // namespace

extern "C" {

// Floats of the workspace that stoke_paged_decode needs at these shapes
// (the chunk partials: m, l and P V per slot, head and chunk).
long long stoke_paged_decode_workspace_floats(int B, int H, int D, int BS,
                                              int MB) {
  return static_cast<long long>(B) * H * grid_chunks(BS, MB) * (D + 2);
}

// q, out: [B, H, D] contiguous in q_dtype; k_pages, v_pages: [NB, BS, H, D]
// contiguous in kv_dtype (0 = float32, 1 = bfloat16), 16-byte aligned;
// tables: [B, MB] int32; lens: [B] int32; ws: float32 scratch of
// stoke_paged_decode_workspace_floats elements. Returns the CUDA error of
// the launches (0 on success; cudaErrorMisalignedAddress for pools that are
// not 16-byte aligned), or -1 for a dtype or head dim it does not take.
int stoke_paged_decode(const void* q, const void* kp, const void* vp,
                       const int* tables, const int* lens, void* out,
                       float* ws, int B, int H, int D, int NB, int BS, int MB,
                       int q_dtype, int kv_dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((D != 64 && D != 128) || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 ||
      kv_dtype > 1)
    return -1;
  if (!aligned16({kp, vp})) return cudaErrorMisalignedAddress;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_d<float, float>(D, q, kp, vp, tables, lens, out, ws, B, H,
                                  NB, BS, MB, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_d<float, __nv_bfloat16>(D, q, kp, vp, tables, lens, out,
                                          ws, B, H, NB, BS, MB, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_d<__nv_bfloat16, float>(D, q, kp, vp, tables, lens, out,
                                          ws, B, H, NB, BS, MB, scale, s);
  return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, kp, vp, tables, lens,
                                                out, ws, B, H, NB, BS, MB,
                                                scale, s);
}

const char* stoke_paged_decode_error(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
