// Flash attention backward for Hopper (sm_90a): the dQ and dK/dV kernels.
//
// Replaces `_dq_kernel` and `_dkv_kernel` of stoke_tpu/ops/flash_attention.py
// (both called from `_flash_backward`). Given q, k, v, dO [B*H, L, D], the
// forward's fp32 logsumexp rows and delta = rowsum(dO * O) (- dlse) [B*H, L]
// (delta is computed by the wrapper with torch ops, as the JAX package
// computes it outside Pallas), both kernels recompute, tile by tile,
//   s  = q k^T * scale, kNegInf where the key mask or the causal rule forbids,
//   p  = exp(s - lse) where allowed, else 0,
//   dp = dO v^T,  ds = p * (dp - delta),
// and accumulate in fp32 registers
//   dq kernel:  dQ = scale * sum over k tiles of ds K,
//   dkv kernel: dV = sum over q tiles of p^T dO, dK = scale * sum of ds^T Q,
// writing dQ, dK and dV in the input dtype. A fully masked query row has
// LSE = kNegInf and no allowed key, so its p is 0 everywhere: it gets a
// zero dQ row and adds nothing to dK or dV; a masked key row gets zero dK
// and dV.
//
// What bounds it on the H100: at the training shapes (B=8, H=12, L=1024,
// D=64, causal) the pair does 7*L*L*D FLOPs per head (14*L*L*D without the
// causal half) against ~10*L*D elements moved, so it is bound by
// operations, and only the tensor cores come near that bound: 989 TFLOP/s
// in bf16 and fp16, and for fp32 a third of the 495 TFLOP/s TF32 rate (3xTF32,
// below); neither the score matrix nor P leaves the SM.
//
// Dispatch by dtype: bfloat16 and float16 run the wgmma kernels
// (flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel, namespace tc,
// templates on the element type T: the two types differ only in the wgmma
// type and the rounding to T, hopper.cuh), float32 the warp-level
// mma.sync kernels (flash_bwd_dq_tf32x3_kernel and
// flash_bwd_dkv_tf32x3_kernel, namespace f32).
//
// The two 16-bit kernels are FlashAttention-3's backward split in two, as
// the TPU package splits it, without its fp32 dQ atomics. On the TPU the
// walked axis is a sequential grid axis whose VMEM accumulators carry
// across grid steps; here each CTA owns 64 rows of the output of one head,
// so nothing is summed across CTAs, no atomics are needed and the result is
// deterministic. A CTA is one consumer warpgroup and one producer warp. The
// producer loads the CTA's own tiles once by TMA (they stay resident), then
// streams the other axis's tiles through a 2-stage ring of 128-byte-
// swizzled shared memory under "full"/"empty" mbarriers.
//
// dK/dV: K and V resident, Q and dO streamed in tiles of BQ rows (64 at
// D=64, 32 at D=128, which keeps the four accumulators in registers); the
// producer's lanes copy each tile's 64 LSE (in log2 units) and delta values
// beside it. Under causal the walk starts at the diagonal q tile. Per q
// tile, by wgmma with fp32 accumulators in registers:
//   S^T  = K Q^T           (K and Q K-major from shared memory),
//   dP^T = V dO^T          (V and dO K-major),
//   P^T  = exp2(S^T scale log2e - lse log2e) where allowed, else 0
//          (key mask, range and causal rule tested before the exponential),
//   dS^T = P^T (dP^T - delta),
//   dV  += P^T dO          (P^T as T register A, dO MN-major),
//   dK  += dS^T Q          (dS^T as T register A, Q MN-major);
// dK is scaled once at the end.
//
// dQ: the same with the roles swapped. Q and dO resident, K and V streamed
// in tiles of BK rows (64 at D=64, 32 at D=128: S, dP and dQ stay in
// registers); the producer warp writes a 64-bit word beside each tile, one
// bit per key (in range and not masked). Each thread keeps its two rows' LSE (log2
// units) and delta in registers. Under causal the walk ends at the last k
// tile that touches the diagonal, and the grid runs the q tiles with the
// longest walks first. Per k tile:
//   S  = Q K^T, dP = dO V^T  (all operands K-major, both groups in flight),
//   P  = exp2(S scale log2e - lse log2e) where allowed, else 0,
//   dS = P (dP - delta),
//   dQ += dS K               (dS as T register A, K MN-major);
// dQ is scaled once at the end.
//
// P^T, dS^T and dS are rounded to T for the register products, which
// the TPU kernels (fp32 operands) do not do. Each rounding is at most 2^-9
// relative per element in bf16 (2^-12 in fp16), and every product sums
// >= 32 such terms in fp32, so dQ, dK and dV move by ~0.1-0.5% of a row's
// norm in bf16, far inside the contract BWD_RTOL_BF16 = 5% and the row
// bound BWD_ROW_RTOL_BF16 = 2%, which fp16 is held to as well (shown on
// the CPU by tests/test_torch_flash_tc_numerics.py against the JAX
// kernels). In fp16 the risk is range, not mantissa: dO, and so dS, carry
// the dynamic loss scale, so a |dS| past 65504 would round to inf, and in
// the GPT-base step at the starting scale of 2^16 |dS| stays under 2.3e-4,
// where fp16 is subnormal (below 6.1e-5) and rounds to a fixed 6e-8: the
// row error against the TPU kernel's fp32 dS grows to 3-6% (PERF.md).
// So dS is scaled by a power of two before the rounding and the fp32 sums
// of dQ and dK divided by it at the end, both exact: the wrapper passes a
// bound on |dS| = P |dP - delta| <= max |dO row| max |V row| + max |delta|
// (P <= 1, Cauchy-Schwarz) as one float on the card (no host sync), and
// ds_scale_for (hopper.cuh) maps it to at most 2^14. bf16, with fp32's
// range, gets no bound and is unchanged.
//
// The two fp32 kernels have the same split and walks (K and V resident
// with Q, dO and their LSE and delta streamed for dK/dV; Q and dO resident
// with K, V and a 64-bit key word streamed for dQ; the same causal walks
// and CTA order) on TF32 mma.sync.m16n8k8 instead of wgmma: TF32 wgmma
// reads a shared B operand only K-major, and three of the products need B
// the other way (dO^T in dV, Q^T in dK, K^T in dQ). A warp loads its own
// fragments from shared memory, so one fp32 tile (rows padded to D + 4
// floats, conflict-free in both orientations) serves both, and nothing is
// transposed: no descriptor, TMA map or mbarrier, a 2-stage cp.async ring
// instead. Four warps a CTA, each owning 16 of the 64 output rows; the
// streamed tiles are 32 rows at D=64 and 128 (at D=64, 2 dK/dV or 3 dQ
// CTAs an SM: both ran 4-10% faster than with 64-row tiles at 2 CTAs,
// PERF.md). Every product is 3xTF32 (mma_tf32.cuh: each operand split
// into two TF32 terms, three products, ~fp32 accuracy, held to FP32_ATOL =
// 1e-4 against the plain version; one TF32 rounding alone moves gradients
// by ~1e-3). P^T, dS^T and dS feed the second product from registers as
// the A operand, their k index permuted to match the accumulator layout
// (mma_tf32.cuh). Each tile's dV, dK or dQ is summed in a fresh
// accumulator and added to the running sum with an fp32 add: the running
// sum carried through hundreds of products drifted by up to 8e-5.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

// --------------------------------------------------------------------------
// fp32 dQ and dK/dV: 3xTF32 warp-level mma.sync over cp.async-loaded tiles

namespace f32 {

using namespace stoke::tf32;
using stoke::hopper::kLog2e;

constexpr int kRows = 64;  // output rows of a CTA, 16 for each of 4 warps
constexpr int kThreads = 128;

template <int D>
struct DkvCfg {
  static constexpr int BQ = 32;  // q rows of a streamed tile
  static constexpr int S = D + 4;  // row stride of a shared tile (floats)
  // a stage: Q [BQ][S] | dO [BQ][S] | lse [BQ] | delta [BQ]
  static constexpr int kStage = 2 * BQ * S + 2 * BQ;
  // K [kRows][S] | V [kRows][S] | 2 stages
  static constexpr size_t kSmem = sizeof(float) * (2 * kRows * S + 2 * kStage);
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const int* __restrict__ mask,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int H, int L,
                                float scale, int causal) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, S = C::S;
  extern __shared__ float4 smem_f4[];  // 16-byte aligned for cp.async
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* vs = ks + kRows * S;
  float* stages = vs + kRows * S;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int first = causal ? k0 / BQ : 0;  // start at the diagonal
  const int n_tiles = (L + BQ - 1) / BQ - first;
  const size_t head = static_cast<size_t>(bh) * L;
  const float* qh = q + head * D;
  const float* doh = dout + head * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the stage of q tile i: Q and dO rows, their lse and delta beside them
  auto load_q_tile = [&](int i) {
    float* st = stages + (i & 1) * C::kStage;
    const int q0 = (first + i) * BQ;
    load_rows<BQ, D, kThreads>(st, qh, q0, L, tid);
    load_rows<BQ, D, kThreads>(st + BQ * S, doh, q0, L, tid);
    for (int j = tid; j < 2 * BQ; j += kThreads) {
      const int qr = q0 + j % BQ;
      const bool ok = qr < L;
      const float* src = j < BQ ? lse : delta;
      cp_async4(st + 2 * BQ * S + j, src + (ok ? head + qr : 0), ok);
    }
    cp_async_commit();
  };
  load_rows<kRows, D, kThreads>(ks, k + head * D, k0, L, tid);
  load_rows<kRows, D, kThreads>(vs, v + head * D, k0, L, tid);
  load_q_tile(0);  // one group with K and V

  // this thread's key rows: g and g + 8 of the warp's 16
  const int r0 = 16 * warp;
  const int g = lane / 4, t = lane % 4;
  int kpos[2];
  bool kok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kpos[h] = k0 + r0 + g + 8 * h;
    kok[h] = kpos[h] < L &&
             (mask == nullptr ||
              mask[static_cast<size_t>(bh / H) * L + kpos[h]] > 0);
  }
  const float scale_log2 = scale * kLog2e;
  // [n][e]: columns 8n + 2t + (e & 1) of rows g (e < 2) and g + 8
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    // tile i has landed for every thread, and every warp is done with
    // tile i - 1, whose stage the next load overwrites
    __syncthreads();
    if (i + 1 < n_tiles) load_q_tile(i + 1);
    const float* qs = stages + (i & 1) * C::kStage;
    const float* dos = qs + BQ * S;
    const float* st_lse = dos + BQ * S;
    const float* st_delta = st_lse + BQ;
    const int q0 = (first + i) * BQ;

    // S^T = K Q^T and dP^T = V dO^T over the head dim, 8 columns a step
    float sc[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      load_a<S>(ks + r0 * S + 8 * kk, lane, kb, ksm);
      load_a<S>(vs + r0 * S + 8 * kk, lane, vb, vsm);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        uint32_t bb[2], bs[2];
        load_b_nk<S>(qs + 8 * n * S + 8 * kk, lane, bb, bs);
        mma_tf32x3(sc[n], kb, ksm, bb, bs);
        load_b_nk<S>(dos + 8 * n * S + 8 * kk, lane, bb, bs);
        mma_tf32x3(dp[n], vb, vsm, bb, bs);
      }
    }
    // P^T where the key mask, the range and the causal rule allow (tested
    // before the exponential: a fully masked query row's LSE is kNegInf),
    // else 0; dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int qr = q0 + col;
        const bool ok = kok[h] && qr < L && (!causal || qr >= kpos[h]);
        const float p =
            ok ? exp2f(sc[n][e] * scale_log2 - st_lse[col] * kLog2e) : 0.f;
        sc[n][e] = p;
        dp[n][e] = p * (dp[n][e] - st_delta[col]);
      }
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as A from registers
    mma_acc_tile<BQ, D, S>(dv_acc, sc, dos, lane);
    mma_acc_tile<BQ, D, S>(dk_acc, dp, qs, lane);
  }

  // rows past L write nothing; a masked key row writes zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= L) continue;
    float* dko = dk + (head + kpos[h]) * D;
    float* dvo = dv + (head + kpos[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dko + col) =
          make_float2(dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dvo + col) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <int D>
struct DqCfg {
  static constexpr int BK = 32;  // k rows of a streamed tile
  static constexpr int S = D + 4;  // row stride of a shared tile (floats)
  // a stage: K [BK][S] | V [BK][S]
  static constexpr int kStage = 2 * BK * S;
  // Q [kRows][S] | dO [kRows][S] | 2 stages | key bits [2]
  static constexpr int kBitsOff = 2 * kRows * S + 2 * kStage;  // floats
  static constexpr size_t kSmem =
      sizeof(float) * kBitsOff + 2 * sizeof(uint64_t);
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
    flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ mask,
                               float* __restrict__ dq, int H, int L,
                               float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int BK = C::BK, S = C::S;
  extern __shared__ float4 smem_f4[];  // 16-byte aligned for cp.async
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* dos = qs + kRows * S;
  float* stages = dos + kRows * S;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(qs + C::kBitsOff);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest walks first
  // under causal, stop at the last k tile that touches the diagonal
  const int n_tiles = ((causal ? min(L, q0 + kRows) : L) + BK - 1) / BK;
  const size_t head = static_cast<size_t>(bh) * L;
  const float* kh = k + head * D;
  const float* vh = v + head * D;
  const int* mrow =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(bh / H) * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the stage of k tile i: K and V rows; warp 0 packs the tile's key flags
  // (in range and not masked) into one word beside it, bit j for key k0 + j
  auto load_k_tile = [&](int i) {
    float* st = stages + (i & 1) * C::kStage;
    const int k0 = i * BK;
    load_rows<BK, D, kThreads>(st, kh, k0, L, tid);
    load_rows<BK, D, kThreads>(st + BK * S, vh, k0, L, tid);
    cp_async_commit();
    if (warp == 0) {
      uint64_t bits = 0;
#pragma unroll
      for (int w = 0; w < BK / 32; ++w) {
        const int kr = k0 + 32 * w + lane;
        const bool ok = kr < L && (mrow == nullptr || mrow[kr] > 0);
        bits |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, ok))
                << (32 * w);
      }
      if (lane == 0) kbits[i & 1] = bits;
    }
  };
  load_rows<kRows, D, kThreads>(qs, q + head * D, q0, L, tid);
  load_rows<kRows, D, kThreads>(dos, dout + head * D, q0, L, tid);
  load_k_tile(0);  // one group with Q and dO

  // this thread's query rows: g and g + 8 of the warp's 16, with their LSE
  // (log2 units) and delta in registers
  const int r0 = 16 * warp;
  const int g = lane / 4, t = lane % 4;
  int qpos[2];
  bool qok[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = q0 + r0 + g + 8 * h;
    qok[h] = qpos[h] < L;
    lse2[h] = qok[h] ? lse[head + qpos[h]] * kLog2e : 0.f;
    dlt[h] = qok[h] ? delta[head + qpos[h]] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  // [n][e]: columns 8n + 2t + (e & 1) of rows g (e < 2) and g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<0>();
    // tile i and its key word have landed for every thread, and every warp
    // is done with tile i - 1, whose stage the next load overwrites
    __syncthreads();
    if (i + 1 < n_tiles) load_k_tile(i + 1);
    const float* ks = stages + (i & 1) * C::kStage;
    const float* vs = ks + BK * S;
    // the key flags as one word, read before the products
    const uint64_t bits = kbits[i & 1];
    const int k0 = i * BK;

    // S = Q K^T and dP = dO V^T over the head dim, 8 columns a step
    float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qb[4], qsm[4], ob[4], osm[4];
      load_a<S>(qs + r0 * S + 8 * kk, lane, qb, qsm);
      load_a<S>(dos + r0 * S + 8 * kk, lane, ob, osm);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bb[2], bs[2];
        load_b_nk<S>(ks + 8 * n * S + 8 * kk, lane, bb, bs);
        mma_tf32x3(sc[n], qb, qsm, bb, bs);
        load_b_nk<S>(vs + 8 * n * S + 8 * kk, lane, bb, bs);
        mma_tf32x3(dp[n], ob, osm, bb, bs);
      }
    }
    // P where the key word, the range and the causal rule allow (tested
    // before the exponential: a fully masked row's LSE is kNegInf), else
    // 0; dS = P (dP - delta)
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const bool ok = qok[h] && ((bits >> col) & 1) &&
                        (!causal || qpos[h] >= k0 + col);
        const float p = ok ? exp2f(sc[n][e] * scale_log2 - lse2[h]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dlt[h]);
      }
    // dQ += dS K, dS as A from registers, K read down its rows
    mma_acc_tile<BK, D, S>(acc, dp, ks, lane);
  }

  // rows past L write nothing; a fully masked row writes zeros
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!qok[h]) continue;
    float* out = dq + (head + qpos[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* mask, void* dq,
              int BH, int H, int L, float scale, int causal,
              cudaStream_t stream) {
  using C = DqCfg<D>;
  if (!aligned16({q, k, v, dout, dq})) return cudaErrorMisalignedAddress;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  flash_bwd_dq_tf32x3_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, static_cast<float*>(dq), H, L, scale, causal);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* mask,
               void* dk, void* dv, int BH, int H, int L, float scale,
               int causal, cudaStream_t stream) {
  using C = DkvCfg<D>;
  if (!aligned16({q, k, v, dout, dk, dv})) return cudaErrorMisalignedAddress;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32x3_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);  // the longest walks first
  flash_bwd_dkv_tf32x3_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), H, L,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace f32

// --------------------------------------------------------------------------
// bf16 and fp16 dQ and dK/dV: warpgroup MMA over TMA-loaded tiles

namespace tc {

using namespace stoke::hopper;
using stoke::kNegInf;

constexpr int kRows = 64;        // output rows of a CTA: one consumer warpgroup
constexpr int kConsumers = 128;  // the warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;

template <int D>
struct DqCfg {
  static constexpr int BK = D == 64 ? 64 : 32;  // k rows of a streamed tile
  static constexpr int kPanels = D / 64;        // 64-column panels of a row
  static constexpr int kQBytes = kRows * D * 2;  // the Q or the dO tile
  static constexpr int kKBytes = BK * D * 2;     // one K or V tile
  // Q | dO | K0 | V0 | K1 | V1 | key bits [kStages] | barriers
  static constexpr int kStageOff = 2 * kQBytes;
  static constexpr int kBitsOff = kStageOff + 2 * kStages * kKBytes;
  static constexpr int kBarsOff = kBitsOff + kStages * 8;
  static constexpr size_t kSmem = 1024 + kBarsOff + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ mask,
                              const float* __restrict__ ds_bound,
                              T* __restrict__ dq, int H, int L,
                              float scale, int causal) {
  using C = DqCfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* qs = sm;
  uint8_t* dos = sm + C::kQBytes;
  uint64_t* kbits = reinterpret_cast<uint64_t*>(sm + C::kBitsOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::kBarsOff);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest walks first
  // under causal, stop at the last k tile that touches the diagonal
  const int n_tiles = ((causal ? min(L, q0 + kRows) : L) + BK - 1) / BK;
  const size_t head = static_cast<size_t>(bh) * L;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: TMA for Q and dO once, then K and V tiles into the ring
    const int lane = tid - kConsumers;
    const int* mrow = mask == nullptr ? nullptr : mask + (bh / H) * L;
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      tma_prefetch_map(&domap);
      mbar_arrive_tx(qbar, 2 * C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load_3d(qs + p * kRows * 128, &qmap, qbar, p * 64, q0, bh);
        tma_load_3d(dos + p * kRows * 128, &domap, qbar, p * 64, q0, bh);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * BK;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      uint8_t* ks = sm + C::kStageOff + 2 * s * C::kKBytes;
      uint8_t* vs = ks + C::kKBytes;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::kKBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_3d(ks + p * BK * 128, &kmap, &full[s], p * 64, k0, bh);
          tma_load_3d(vs + p * BK * 128, &vmap, &full[s], p * 64, k0, bh);
        }
      }
      // bit j: key k0 + j is in range and not masked
      uint64_t bits = 0;
#pragma unroll
      for (int w = 0; w < BK / 32; ++w) {
        const int kr = k0 + 32 * w + lane;
        const bool ok = kr < L && (mrow == nullptr || mrow[kr] > 0);
        bits |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, ok))
                << (32 * w);
      }
      if (lane == 0) kbits[s] = bits;
      mbar_arrive(&full[s]);
    }
  } else {
    // consumer warpgroup: q rows r0 and r0 + 8 of the tile, per thread
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int qpos[2] = {q0 + r0, q0 + r0 + 8};
    bool qok[2];
    float lse2[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qok[h] = qpos[h] < L;
      lse2[h] = qok[h] ? lse[head + qpos[h]] * kLog2e : 0.f;
      dlt[h] = qok[h] ? delta[head + qpos[h]] : 0.f;
    }
    const float scale_log2 = scale * kLog2e;
    // dS is rounded to T times ds (a power of two), undone at the end
    const float ds = ds_bound == nullptr ? 1.f : ds_scale_for(*ds_bound);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * BK;
      const uint8_t* ks = sm + C::kStageOff + 2 * s * C::kKBytes;
      const uint8_t* vs = ks + C::kKBytes;
      mbar_wait(&full[s], (t / kStages) & 1);
      // the key bits as one word, read before the products: per-key flags
      // read from shared memory after them were this kernel's largest cost
      // (PERF.md, Findings)
      const uint64_t bits = kbits[s];

      // S = Q K^T and dP = dO V^T, two groups in flight
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<T>(sc,
                    smem_desc(qs + (kk / 4) * kRows * 128 + off, 16, 1024),
                    smem_desc(ks + (kk / 4) * BK * 128 + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<T>(dp,
                    smem_desc(dos + (kk / 4) * kRows * 128 + off, 16, 1024),
                    smem_desc(vs + (kk / 4) * BK * 128 + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      // the rule before the exponential: a fully masked row's LSE is kNegInf
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i / 4) + cq + (i & 1);
        const bool ok = qok[h] & static_cast<bool>((bits >> col) & 1) &
                        (!causal | (qpos[h] >= k0 + col));
        sc[i] = ok ? exp2f(sc[i] * scale_log2 - lse2[h]) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        dp[i] = (sc[i] * ds) * (dp[i] - dlt[(i >> 1) & 1]);

      // dQ += dS K, dS as T registers, K MN-major from the same tile
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_a_frag<T>(dp, kk, dsa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T>(acc, dsa[kk], smem_desc(ks + kk * 2048, BK * 128, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    // rows past L write nothing; a fully masked row writes zeros
    const float out_scale = scale / ds;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!qok[h]) continue;
      T* out = dq + (head + qpos[h]) * D;
#pragma unroll
      for (int i = 2 * h; i < D / 2; i += 4) {
        const int col = 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(out + col) =
            pack2<T>(acc[i] * out_scale, acc[i + 1] * out_scale);
      }
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* mask,
              const float* ds_bound, void* dq, int BH, int H, int L,
              float scale, int causal, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap qm, km, vm, dom;
  if (!make_map<T>(&qm, q, BH, L, D, kRows) ||
      !make_map<T>(&km, k, BH, L, D, C::BK) ||
      !make_map<T>(&vm, v, BH, L, D, C::BK) ||
      !make_map<T>(&dom, dout, BH, L, D, kRows))
    return kErrTensorMap;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  flash_bwd_dq_wgmma_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, dom, lse, delta, mask, ds_bound, static_cast<T*>(dq), H, L,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
struct DkvCfg {
  static constexpr int BQ = D == 64 ? 64 : 32;  // q rows of a streamed tile
  static constexpr int kPanels = D / 64;        // 64-column panels of a row
  static constexpr int kKBytes = kRows * D * 2;  // the K or the V tile
  static constexpr int kQBytes = BQ * D * 2;     // one Q or dO tile
  // K | V | Q0 | dO0 | Q1 | dO1 | stats [kStages][2][BQ] | barriers
  static constexpr int kStageOff = 2 * kKBytes;
  static constexpr int kStatsOff = kStageOff + 2 * kStages * kQBytes;
  static constexpr int kBarsOff = kStatsOff + kStages * 2 * BQ * 4;
  static constexpr size_t kSmem = 1024 + kBarsOff + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ mask,
                               const float* __restrict__ ds_bound,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int H, int L, float scale, int causal) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* ks = sm;
  uint8_t* vs = sm + C::kKBytes;
  float* stats = reinterpret_cast<float*>(sm + C::kStatsOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::kBarsOff);
  uint64_t* kvbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int first = causal ? k0 / BQ : 0;  // start at the diagonal
  const int n_tiles = (L + BQ - 1) / BQ - first;
  const size_t head = static_cast<size_t>(bh) * L;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: TMA for K and V once, then Q and dO tiles into the ring
    const int lane = tid - kConsumers;
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      tma_prefetch_map(&domap);
      mbar_arrive_tx(kvbar, 2 * C::kKBytes);
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load_3d(ks + p * kRows * 128, &kmap, kvbar, p * 64, k0, bh);
        tma_load_3d(vs + p * kRows * 128, &vmap, kvbar, p * 64, k0, bh);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int q0 = (first + t) * BQ;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      uint8_t* qs = sm + C::kStageOff + 2 * s * C::kQBytes;
      uint8_t* dos = qs + C::kQBytes;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::kQBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_3d(qs + p * BQ * 128, &qmap, &full[s], p * 64, q0, bh);
          tma_load_3d(dos + p * BQ * 128, &domap, &full[s], p * 64, q0, bh);
        }
      }
      float* st = stats + s * 2 * BQ;
      for (int j = lane; j < BQ; j += 32) {
        const int qr = q0 + j;
        st[j] = qr < L ? lse[head + qr] * kLog2e : 0.f;
        st[BQ + j] = qr < L ? delta[head + qr] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
  } else {
    // consumer warpgroup: k rows r0 and r0 + 8 of the tile, per thread
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int kpos[2] = {k0 + r0, k0 + r0 + 8};
    bool kok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      kok[h] = kpos[h] < L &&
               (mask == nullptr ||
                mask[static_cast<size_t>(bh / H) * L + kpos[h]] > 0);
    const float scale_log2 = scale * kLog2e;
    // dS^T is rounded to T times ds (a power of two), undone at the end
    const float ds = ds_bound == nullptr ? 1.f : ds_scale_for(*ds_bound);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int q0 = (first + t) * BQ;
      const uint8_t* qs = sm + C::kStageOff + 2 * s * C::kQBytes;
      const uint8_t* dos = qs + C::kQBytes;
      const float* st = stats + s * 2 * BQ;
      mbar_wait(&full[s], (t / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, two groups in flight
      float sc[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<T>(sc,
                    smem_desc(ks + (kk / 4) * kRows * 128 + off, 16, 1024),
                    smem_desc(qs + (kk / 4) * BQ * 128 + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<T>(dp,
                    smem_desc(vs + (kk / 4) * kRows * 128 + off, 16, 1024),
                    smem_desc(dos + (kk / 4) * BQ * 128 + off, 16, 1024),
                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i / 4) + cq + (i & 1);
        const int qr = q0 + col;
        const bool ok = kok[h] && qr < L && (!causal || qr >= kpos[h]);
        sc[i] = ok ? exp2f(sc[i] * scale_log2 - st[col]) : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = 8 * (i / 4) + cq + (i & 1);
        dp[i] = sc[i] * (dp[i] - st[BQ + col]) * ds;
      }

      // dV += P^T dO and dK += dS^T Q, both left operands as T registers
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        to_a_frag<T>(sc, kk, pa[kk]);
        to_a_frag<T>(dp, kk, dsa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<T>(dv_acc, pa[kk],
                    smem_desc(dos + kk * 2048, BQ * 128, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<T>(dk_acc, dsa[kk],
                    smem_desc(qs + kk * 2048, BQ * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);
    }

    const float dk_scale = scale / ds;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (kpos[h] >= L) continue;
      const size_t out = (head + kpos[h]) * D;
#pragma unroll
      for (int i = 2 * h; i < D / 2; i += 4) {
        const int col = 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(dk + out + col) =
            pack2<T>(dk_acc[i] * dk_scale, dk_acc[i + 1] * dk_scale);
        *reinterpret_cast<uint32_t*>(dv + out + col) =
            pack2<T>(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* mask,
               const float* ds_bound, void* dk, void* dv, int BH, int H,
               int L, float scale, int causal, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap qm, km, vm, dom;
  if (!make_map<T>(&qm, q, BH, L, D, C::BQ) ||
      !make_map<T>(&km, k, BH, L, D, kRows) ||
      !make_map<T>(&vm, v, BH, L, D, kRows) ||
      !make_map<T>(&dom, dout, BH, L, D, C::BQ))
    return kErrTensorMap;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  flash_bwd_dkv_wgmma_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, dom, lse, delta, mask, ds_bound, static_cast<T*>(dk),
      static_cast<T*>(dv), H, L, scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: [BH, L, D] contiguous, dtype 0 = float32,
// 1 = bfloat16, 2 = float16; lse, delta: [BH, L] float32; mask: [B, L]
// int32 or null; ds_bound: null, or one float32 on the card bounding |dS|,
// from which the 16-bit kernels pick a power of two to scale dS by before
// rounding it to their type (ds_scale_for; the float32 kernels ignore it).
// Each returns the CUDA error of its launch (0 on success), -1 for a dtype
// or head dim it does not take, or -2 if a TMA tensor map cannot be made.
// bfloat16 and float16 launch the tensor-core kernels
// (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel, instantiated for
// each), float32 the 3xTF32 mma.sync ones
// (flash_bwd_dq_tf32x3_kernel, flash_bwd_dkv_tf32x3_kernel); a float32
// pointer that is not 16-byte aligned returns cudaErrorMisalignedAddress.
int stoke_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* mask, const float* ds_bound, void* dq,
                       int BH, int H, int L, int D, int dtype, float scale,
                       int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return f32::launch_dq<64>(q, k, v, dout, lse, delta, mask, dq, BH, H, L,
                              scale, causal, s);
  if (dtype == 0 && D == 128)
    return f32::launch_dq<128>(q, k, v, dout, lse, delta, mask, dq, BH, H, L,
                               scale, causal, s);
  if (dtype == 1 && D == 64)
    return tc::launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, mask,
                                            ds_bound, dq, BH, H, L, scale,
                                            causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, mask,
                                             ds_bound, dq, BH, H, L, scale,
                                             causal, s);
  if (dtype == 2 && D == 64)
    return tc::launch_dq<__half, 64>(q, k, v, dout, lse, delta, mask,
                                     ds_bound, dq, BH, H, L, scale, causal,
                                     s);
  if (dtype == 2 && D == 128)
    return tc::launch_dq<__half, 128>(q, k, v, dout, lse, delta, mask,
                                      ds_bound, dq, BH, H, L, scale, causal,
                                      s);
  return stoke::hopper::kErrUnsupported;
}

int stoke_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const int* mask,
                        const float* ds_bound, void* dk, void* dv, int BH,
                        int H, int L, int D, int dtype, float scale,
                        int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return f32::launch_dkv<64>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                               H, L, scale, causal, s);
  if (dtype == 0 && D == 128)
    return f32::launch_dkv<128>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                                H, L, scale, causal, s);
  if (dtype == 1 && D == 64)
    return tc::launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, mask,
                                             ds_bound, dk, dv, BH, H, L,
                                             scale, causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                              mask, ds_bound, dk, dv, BH, H,
                                              L, scale, causal, s);
  if (dtype == 2 && D == 64)
    return tc::launch_dkv<__half, 64>(q, k, v, dout, lse, delta, mask,
                                      ds_bound, dk, dv, BH, H, L, scale,
                                      causal, s);
  if (dtype == 2 && D == 128)
    return tc::launch_dkv<__half, 128>(q, k, v, dout, lse, delta, mask,
                                       ds_bound, dk, dv, BH, H, L, scale,
                                       causal, s);
  return stoke::hopper::kErrUnsupported;
}

const char* stoke_flash_bwd_error(int code) {
  return stoke::hopper::error_string(code);
}

}  // extern "C"
