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
// L=1024, D=64) it is bound by operations, and only the tensor cores'
// 989 TFLOP/s bf16 come near that bound; the score matrix never leaves the
// SM.
//
// Dispatch by dtype: bfloat16 runs the tensor-core kernel below; float32
// keeps the scalar kernel of the first port (flash_fwd_kernel), since a
// tensor-core float32 path would be TF32 and break the fp32 serve paths'
// 1e-4 tolerance. Its design: one block per (b*h, 64-row q tile) walks 64-
// key tiles staged in shared memory as fp32 (rows padded by one float
// against bank conflicts); 4 adjacent threads share a q row, each with 16
// scores of a tile and D/4 output dims in registers, P going through
// shared memory between the two products as fp32 FMAs.
//
// The bf16 kernel (flash_fwd_wgmma_kernel). On the TPU the k tiles are a
// sequential grid axis whose VMEM scratch (acc, m, l) carries across grid
// steps; here each CTA owns one (b*h, 64-row q tile) and walks the k tiles
// in a loop of its own:
//   * a CTA is one consumer warpgroup (the 64 q rows) and one producer
//     warp. One producer thread loads Q once and K, V tiles of BN rows
//     (128 at D=64, 64 at D=128) by TMA into a 2-stage ring of 128-byte-
//     swizzled shared memory; each stage has a "full" mbarrier (the TMA
//     bytes plus the producer lanes, which also write the tile's key-valid
//     flags: in range and unmasked) and an "empty" one the consumers
//     release. 3-D tensor maps over [B*H, L, D] zero-fill rows past L;
//   * S = Q K^T by wgmma m64nBNk16 (Q and K K-major from shared memory,
//     fp32 accumulators in registers), then scale (in log2 units, for
//     exp2), key mask and, under causal, the diagonal rule; tiles wholly
//     above the diagonal are never loaded (the TPU's `run` predicate
//     becomes the loop bound), and the last q tiles are launched first;
//   * the online softmax runs in registers: a thread holds two rows, whose
//     max and sum reduce over the 4 lanes sharing them (two shuffles). A
//     score at the kNegInf sentinel gets p = 0, tested before the
//     exponential, so a fully masked row keeps l == 0 and gives O == 0 and
//     LSE == kNegInf as on the TPU;
//   * O += P V by register-A wgmma: P is rounded to bf16 in registers (the
//     accumulator's layout is the A fragment's), V is the MN-major B
//     operand. The rounding is one the TPU kernel does not make (it
//     multiplies fp32 P by V); it costs at most 2^-9 of each p relative,
//     and l sums the fp32 p, so O moves by ~1e-3 at most, well inside the
//     bf16 contract FWD_ATOL_BF16 = 2e-2 (shown on the CPU by
//     tests/test_torch_flash_tc_numerics.py against the JAX kernel);
//   * the fp32 O accumulator is rescaled by exp2(m_old - m_new) between
//     tiles and written as O / l in bf16 with the LSE rows.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using stoke::kNegInf;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kThreadsPerRow = kThreads / kBlockQ;  // 4, adjacent lanes

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1)) +
         sizeof(int) * kBlockK;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int L, float scale, int causal) {
  constexpr int SQ = D + 1;        // padded row stride of the Q and K tiles
  constexpr int SP = kBlockK + 1;  // padded row stride of the P tile
  constexpr int CPT = kBlockK / kThreadsPerRow;  // score columns per thread
  constexpr int DPT = D / kThreadsPerRow;        // output dims per thread

  extern __shared__ float smem[];
  float* qs = smem;                // [kBlockQ][SQ]
  float* ks = qs + kBlockQ * SQ;   // [kBlockK][SQ]
  float* vs = ks + kBlockK * SQ;   // [kBlockK][D]
  float* ps = vs + kBlockK * D;    // [kBlockQ][SP]
  int* kvalid = reinterpret_cast<int*>(ps + kBlockQ * SP);  // [kBlockK]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int sub = tid % kThreadsPerRow;
  const int qpos = q0 + row;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int qr = q0 + r;
    qs[r * SQ + c] = qr < L ? q[base + static_cast<size_t>(qr) * D + c] : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int n_tiles = (L + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int kr = k0 + r;
      const bool in = kr < L;
      const size_t g = base + static_cast<size_t>(kr) * D + c;
      ks[r * SQ + c] = in ? k[g] : 0.f;
      vs[r * D + c] = in ? v[g] : 0.f;
    }
    if (tid < kBlockK) {
      const int kr = k0 + tid;
      kvalid[tid] = kr < L &&
                    (mask == nullptr ||
                     mask[static_cast<size_t>(b) * L + kr] > 0);
    }
    __syncthreads();

    float s[CPT];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = sub + j * kThreadsPerRow;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qs[row * SQ + d] * ks[c * SQ + d];
      const bool ok = kvalid[c] && (!causal || qpos >= k0 + c);
      s[j] = ok ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      ps[row * SP + sub + j * kThreadsPerRow] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same 4 lanes

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = ps[row * SP + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] += p * vs[c * D + sub + i * kThreadsPerRow];
    }
  }

  if (qpos < L) {
    const float safe_l = l > 0.f ? l : 1.f;
    const size_t out = base + static_cast<size_t>(qpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      o[out + sub + i * kThreadsPerRow] = acc[i] / safe_l;
    if (sub == 0)
      lse[static_cast<size_t>(bh) * L + qpos] =
          l > 0.f ? m + logf(l) : kNegInf;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, void* o, float* lse, int BH, int H, int L,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, BH);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, H, L,
      scale, causal);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16: warpgroup MMA over TMA-loaded tiles

namespace tc {

using namespace stoke::hopper;

constexpr int kRows = 64;       // q rows of a CTA: one consumer warpgroup
constexpr int kConsumers = 128;  // the warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 2;
constexpr float kLn2 = 0.6931471805599453f;

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

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const int* __restrict__ mask,
                           __nv_bfloat16* __restrict__ o,
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
        wgmma_ss(sc,
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

      // O += P V, P rounded to bf16 as the A operand
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) to_a_frag(sc, kk, pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[kk], smem_desc(vs + kk * 2048, BN * 128, 1024), 1);
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
      __nv_bfloat16* orow = o + (head + row[h]) * D;
#pragma unroll
      for (int i = 2 * h; i < D / 2; i += 4) {
        const int col = 8 * (i / 4) + cq;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[i] * inv, acc[i + 1] * inv);
      }
      if (lane % 4 == 0)
        lse[head + row[h]] = l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : kNegInf;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* o, float* lse, int BH, int H, int L, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, BH, L, D, kRows) || !make_map(&km, k, BH, L, D, C::BN) ||
      !make_map(&vm, v, BH, L, D, C::BN))
    return kErrTensorMap;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(BH, (L + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      qm, km, vm, mask, static_cast<__nv_bfloat16*>(o), lse, H, L,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v, o: [BH, L, D] contiguous, dtype 0 = float32, 1 = bfloat16;
// mask: [B, L] int32 or null; lse: [BH, L] float32. bfloat16 launches the
// tensor-core kernel (flash_fwd_wgmma_kernel), float32 the scalar one.
// Returns the CUDA error of the launch (0 on success), -1 for a dtype or
// head dim it does not take, -2 if a TMA tensor map cannot be made (the
// libcuda lacks the encoder, or a pointer is not 16-byte aligned).
int stoke_flash_fwd(const void* q, const void* k, const void* v,
                    const int* mask, void* o, float* lse, int BH, int H,
                    int L, int D, int dtype, float scale, int causal,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<64>(q, k, v, mask, o, lse, BH, H, L, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<128>(q, k, v, mask, o, lse, BH, H, L, scale, causal, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, mask, o, lse, BH, H, L, scale, causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, mask, o, lse, BH, H, L, scale, causal, s);
  return stoke::hopper::kErrUnsupported;
}

const char* stoke_flash_fwd_error(int code) {
  return stoke::hopper::error_string(code);
}

}  // extern "C"
