// Flash attention forward for Hopper (sm_90a).
//
// Replaces `_fwd_kernel` of stoke_tpu/ops/flash_attention.py (called through
// `_flash_forward`): softmax(q k^T / sqrt(D)) v over [B*H, L, D] with an
// optional [B, L] key mask and causal masking, in an fp32 online-softmax
// recurrence, writing O in the input dtype and the [B*H, L] fp32 logsumexp
// rows (kNegInf on a fully masked row, whose O is exactly 0). L is any
// length: the ragged edge is masked here, the TPU's block-divisibility rule
// does not apply.
//
// What bounds it on the H100: per head ~4*L*L*D FLOPs (half under causal)
// against 4*L*D elements moved, so at the training shape (B=8, H=12,
// L=1024, D=64) it is bound by operations, and only the tensor cores come
// near that bound: 989 TFLOP/s in bf16 and fp16, and for fp32 a third of
// the 495 TFLOP/s TF32 rate (3xTF32, below); the score matrix never
// leaves the SM.
//
// Dispatch by dtype: bfloat16 and float16 run flash_fwd_wgmma_kernel
// (namespace tc, one instantiation each), float32 flash_fwd_tf32x3_kernel
// (namespace f32). Both walk the k tiles of
// one (b*h, q tile) in a loop of their own (on the TPU the k tiles are a
// sequential grid axis whose VMEM scratch (acc, m, l) carries across grid
// steps); under causal, tiles wholly above the diagonal are never loaded
// (the TPU's `run` predicate becomes the loop bound), and the q tiles with
// the longest walks are launched first. The online softmax runs in
// registers in log2 units (exp2): a thread holds two rows, whose max and
// sum reduce over the 4 lanes sharing them (two shuffles). A score at the
// kNegInf sentinel gets p = 0, tested before the exponential, so a fully
// masked row keeps l == 0 and gives O == 0 and LSE == kNegInf as on the
// TPU. Rows past L are zero-filled on load and never written.
//
// The fp32 kernel (flash_fwd_tf32x3_kernel) is the warp-level mma.sync
// design of the fp32 backward (flash_bwd.cu, helpers in mma_tf32.cuh):
//   * a CTA is 4 warps, each owning 16 of the 64 q rows. Q stays in
//     shared memory (rows padded to D + 4 floats); K and V stream in
//     32-row tiles through a 2-stage cp.async ring, and warp 0 packs each
//     tile's key flags (in range and not masked) into one 32-bit word beside
//     it, read once before the products;
//   * S = Q K^T by TF32 mma.sync.m16n8k8, Q the A operand and K the B
//     operand with k along its rows; every product is 3xTF32 (each operand
//     split into two TF32 terms, three products summed in fp32: ~2^-21 per
//     operand, where one TF32 rounding (2^-11) moves O by ~1e-3 and fails
//     FP32_ATOL = 1e-4; tests/test_torch_flash_tf32_numerics.py);
//   * O += P V with P fed back from the score accumulator as the A operand
//     (its k index in the order 0, 2, 4, 6, 1, 3, 5, 7) and V read down its
//     rows in the same order: P never leaves the registers. Each tile's P V
//     is summed in a fresh accumulator and added to the rescaled O with one
//     fp32 add (mma_acc_tile): a sum carried in the tensor cores'
//     accumulator through a long walk drifts. 32-row q tiles, tried for
//     the serve prefill's small grid (B=1: 96 CTAs of 64 rows at L=512),
//     were slower there too (PERF.md).
// What bounds it: operations, at a third of the 495 TFLOP/s TF32 rate.
//
// The bf16 and fp16 kernel (flash_fwd_wgmma_kernel<T, D>, T __nv_bfloat16
// or __half; the two differ only in the wgmma type and the rounding of P
// and O, hopper.cuh):
//   * a CTA is one consumer warpgroup (the 64 q rows) and one producer
//     warp. One producer thread loads Q once and K, V tiles of BN rows
//     (128 at D=64, 64 at D=128) by TMA into a 2-stage ring of 128-byte-
//     swizzled shared memory; each stage has a "full" mbarrier (the TMA
//     bytes plus the producer lanes, which also write the tile's key-valid
//     flags: in range and unmasked) and an "empty" one the consumers
//     release. 3-D tensor maps over [B*H, L, D] zero-fill rows past L;
//   * S = Q K^T by wgmma m64nBNk16 (Q and K K-major from shared memory,
//     fp32 accumulators in registers), then scale, key mask and, under
//     causal, the diagonal rule;
//   * O += P V by register-A wgmma: P is rounded to T in registers (the
//     accumulator's layout is the A fragment's), V is the MN-major B
//     operand. The rounding is one the TPU kernel does not make (it
//     multiplies fp32 P by V); it costs at most 2^-9 of each p relative in
//     bf16 (2^-12 in fp16, where p < 6e-8 also flushes to 0: harmless, as
//     such a p adds under 2^-24 of a row's weight), and l sums the fp32 p,
//     so O moves by ~1e-3 at most in bf16, well inside FWD_ATOL_BF16 =
//     2e-2, and ~8x less in fp16 (FWD_ATOL_FP16; shown on the CPU by
//     tests/test_torch_flash_tc_numerics.py against the JAX kernel);
//   * the fp32 O accumulator is rescaled by exp2(m_old - m_new) between
//     tiles and written as O / l in T with the LSE rows.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

using stoke::kNegInf;
using stoke::hopper::kLog2e;
constexpr float kLn2 = 0.6931471805599453f;

// --------------------------------------------------------------------------
// fp32: 3xTF32 warp-level mma.sync over cp.async-loaded tiles

namespace f32 {

using namespace stoke::tf32;

constexpr int kRows = 64;  // q rows of a CTA, 16 for each of 4 warps
constexpr int kThreads = 128;
constexpr int kBK = 32;  // k rows of a streamed tile: one 32-bit key word

template <int D>
struct FwdCfg {
  static constexpr int S = D + 4;  // row stride of a shared tile (floats)
  // a stage: K [kBK][S] | V [kBK][S]
  static constexpr int kStage = 2 * kBK * S;
  // Q [kRows][S] | 2 stages | key bits [2]
  static constexpr int kBitsOff = kRows * S + 2 * kStage;  // floats
  static constexpr size_t kSmem =
      sizeof(float) * kBitsOff + 2 * sizeof(uint32_t);
};

// 2 CTAs an SM, up to 255 registers a thread: at D=64 a cap of 170
// (3 CTAs) spilled, at D=128 shared memory allows no more
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ mask,
                            float* __restrict__ o, float* __restrict__ lse,
                            int H, int L, float scale, int causal) {
  using C = FwdCfg<D>;
  constexpr int BK = kBK, S = C::S;
  extern __shared__ float4 smem_f4[];  // 16-byte aligned for cp.async
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* stages = qs + kRows * S;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(qs + C::kBitsOff);

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
      const int kr = k0 + lane;
      const bool ok = kr < L && (mrow == nullptr || mrow[kr] > 0);
      const uint32_t bits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) kbits[i & 1] = bits;
    }
  };
  load_rows<kRows, D, kThreads>(qs, q + head * D, q0, L, tid);
  load_k_tile(0);  // one group with Q

  // this thread's query rows: g and g + 8 of the warp's 16
  const int r0 = 16 * warp;
  const int g = lane / 4, t = lane % 4;
  const int qpos[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
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
    const uint32_t bits = kbits[i & 1];
    const int k0 = i * BK;

    // S = Q K^T over the head dim, 8 columns a step
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t qb[4], qsm[4];
      load_a<S>(qs + r0 * S + 8 * kk, lane, qb, qsm);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bb[2], bs[2];
        load_b_nk<S>(ks + 8 * n * S + 8 * kk, lane, bb, bs);
        mma_tf32x3(sc[n], qb, qsm, bb, bs);
      }
    }
    // scale (log2 units), key word and causal rule, the rows' maxima
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const bool ok =
            ((bits >> col) & 1) && (!causal || qpos[h] >= k0 + col);
        sc[n][e] = ok ? sc[n][e] * scale_log2 : kNegInf;
        mx[h] = fmaxf(mx[h], sc[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    // P in place of S: 0 at the sentinel, tested before the exponential
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        sc[n][e] = sc[n][e] > 0.5f * kNegInf ? exp2f(sc[n][e] - m[h]) : 0.f;
        rs[h] += sc[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    // O += P V, P as A from registers, V read down its rows
    mma_acc_tile<BK, D, S>(acc, sc, vs, lane);
  }

  // rows past L write nothing; a fully masked row writes zeros and kNegInf.
  // l >= 1 where it is not 0 (the row's max term is 1), so the fast
  // division (2 ulp, no slow-path call) is exact enough
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qpos[h] >= L) continue;
    const float inv = __fdividef(1.f, l[h] > 0.f ? l[h] : 1.f);
    float* out = o + (head + qpos[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t == 0)
      lse[head + qpos[h]] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* o, float* lse, int BH, int H, int L, float scale, int causal,
           cudaStream_t stream) {
  using C = FwdCfg<D>;
  if (!aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  flash_fwd_tf32x3_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, H, L,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace f32

// --------------------------------------------------------------------------
// bf16 and fp16: warpgroup MMA over TMA-loaded tiles

namespace tc {

using namespace stoke::hopper;

constexpr int kRows = 64;       // q rows of a CTA: one consumer warpgroup
constexpr int kConsumers = 128;  // the warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;

template <int D>
struct Cfg {
  static constexpr int BN = D == 64 ? 128 : 64;  // k rows of a tile
  static constexpr int kPanels = D / 64;         // 64-column panels of a row
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = BN * D * 2;  // one K or V tile
  // Q | K0 | V0 | K1 | V1 | key-valid flags [kStages][BN] | barriers
  static constexpr int kFlagsOff = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBarsOff = kFlagsOff + kStages * BN * 4;
  static constexpr size_t kSmem = 1024 + kBarsOff + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const int* __restrict__ mask,
                           T* __restrict__ o,
                           float* __restrict__ lse, int H, int L,
                           float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* qs = sm;
  int* flags = reinterpret_cast<int*>(sm + C::kFlagsOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::kBarsOff);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  int n_tiles = (L + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / BN + 1);
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
    // producer warp: TMA for Q once, then K and V tiles into the ring
    const int lane = tid - kConsumers;
    const int* mrow = mask == nullptr ? nullptr : mask + (bh / H) * L;
    if (lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_tx(qbar, C::kQBytes);
      for (int p = 0; p < C::kPanels; ++p)
        tma_load_3d(qs + p * kRows * 128, &qmap, qbar, p * 64, q0, bh);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * BN;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      uint8_t* ks = sm + C::kQBytes + 2 * s * C::kTileBytes;
      uint8_t* vs = ks + C::kTileBytes;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_3d(ks + p * BN * 128, &kmap, &full[s], p * 64, k0, bh);
          tma_load_3d(vs + p * BN * 128, &vmap, &full[s], p * 64, k0, bh);
        }
      }
      for (int j = lane; j < BN; j += 32) {
        const int kr = k0 + j;
        flags[s * BN + j] = kr < L && (mrow == nullptr || mrow[kr] > 0);
      }
      mbar_arrive(&full[s]);
    }
  } else {
    // consumer warpgroup: rows r0 and r0 + 8 of the tile, per thread
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int row[2] = {q0 + r0, q0 + r0 + 8};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(qbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * BN;
      const uint8_t* ks = sm + C::kQBytes + 2 * s * C::kTileBytes;
      const uint8_t* vs = ks + C::kTileBytes;
      mbar_wait(&full[s], (t / kStages) & 1);

      // S = Q K^T
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<T>(sc,
                 smem_desc(qs + (kk / 4) * kRows * 128 + off, 16, 1024),
                 smem_desc(ks + (kk / 4) * BN * 128 + off, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask, scale, online softmax over the thread's two rows
      const int* fl = flags + s * BN;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i / 4) + cq + (i & 1);
        const bool ok = fl[col] && (!causal || row[h] >= k0 + col);
        sc[i] = ok ? sc[i] * scale_log2 : kNegInf;
        mx[h] = fmaxf(mx[h], sc[i]);
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = sc[i] > 0.5f * kNegInf ? exp2f(sc[i] - m[h]) : 0.f;
        rs[h] += sc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        l[h] = l[h] * corr[h] + rs[h];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P V, P rounded to T as the A operand
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) to_a_frag<T>(sc, kk, pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<T>(acc, pa[kk], smem_desc(vs + kk * 2048, BN * 128, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

    const size_t head = static_cast<size_t>(bh) * L;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= L) continue;
      const float inv = 1.f / (l[h] > 0.f ? l[h] : 1.f);
      T* orow = o + (head + row[h]) * D;
#pragma unroll
      for (int i = 2 * h; i < D / 2; i += 4) {
        const int col = 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack2<T>(acc[i] * inv, acc[i + 1] * inv);
      }
      if (lane % 4 == 0)
        lse[head + row[h]] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* o, float* lse, int BH, int H, int L, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  if (!make_map<T>(&qm, q, BH, L, D, kRows) ||
      !make_map<T>(&km, k, BH, L, D, C::BN) ||
      !make_map<T>(&vm, v, BH, L, D, C::BN))
    return kErrTensorMap;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, mask, static_cast<T*>(o), lse, H, L, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v, o: [BH, L, D] contiguous, dtype 0 = float32, 1 = bfloat16,
// 2 = float16; mask: [B, L] int32 or null; lse: [BH, L] float32. bfloat16
// and float16 launch flash_fwd_wgmma_kernel (instantiated for each),
// float32 flash_fwd_tf32x3_kernel. Returns the CUDA
// error of the launch (0 on success; float32 pointers that are not 16-byte
// aligned give cudaErrorMisalignedAddress), -1 for a dtype or head dim it
// does not take, -2 if a TMA tensor map cannot be made (the libcuda lacks
// the encoder, or a 16-bit pointer is not 16-byte aligned).
int stoke_flash_fwd(const void* q, const void* k, const void* v,
                    const int* mask, void* o, float* lse, int BH, int H,
                    int L, int D, int dtype, float scale, int causal,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return f32::launch<64>(q, k, v, mask, o, lse, BH, H, L, scale, causal,
                           s);
  if (dtype == 0 && D == 128)
    return f32::launch<128>(q, k, v, mask, o, lse, BH, H, L, scale, causal,
                            s);
  if (dtype == 1 && D == 64)
    return tc::launch<__nv_bfloat16, 64>(q, k, v, mask, o, lse, BH, H, L,
                                         scale, causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch<__nv_bfloat16, 128>(q, k, v, mask, o, lse, BH, H, L,
                                          scale, causal, s);
  if (dtype == 2 && D == 64)
    return tc::launch<__half, 64>(q, k, v, mask, o, lse, BH, H, L, scale,
                                  causal, s);
  if (dtype == 2 && D == 128)
    return tc::launch<__half, 128>(q, k, v, mask, o, lse, BH, H, L, scale,
                                   causal, s);
  return stoke::hopper::kErrUnsupported;
}

const char* stoke_flash_fwd_error(int code) {
  return stoke::hopper::error_string(code);
}

}  // extern "C"
