// Flash attention forward for Hopper (sm_90a).
//
// Replaces `_fwd_kernel` of stoke_tpu/ops/flash_attention.py (called through
// `_flash_forward`): softmax(q k^T / sqrt(D)) v over [B*H, L, D] with an
// optional [B, L] key mask and causal masking, in an fp32 online-softmax
// recurrence, writing O in the input dtype and the [B*H, L] fp32 logsumexp
// rows (kNegInf on a fully masked row).
//
// What bounds it on the H100: at the serve path's prefill shapes (B=1,
// H=12, L <= 512, D=64) the work is ~2*L*L*D FLOPs per head against 4*L*D
// elements moved, so it is bound by operations, not bytes; the score matrix
// never leaves the SM. This first kernel runs its two products as scalar
// fp32 FMAs out of shared memory (no wgmma, no TMA yet), so it sits well
// below the tensor-core roof; making it fast is later work.
//
// Design. On the TPU the k tiles are a sequential grid axis whose VMEM
// scratch (acc, m, l) carries across grid steps. Here blocks run in
// parallel in no order, so each thread block owns one (b*h, 64-row q tile)
// and walks the k tiles in a loop of its own:
//   * Q, K and V tiles are staged in shared memory as fp32 (rows padded by
//     one float so the 8 rows a warp reads at once fall in distinct banks);
//   * 4 threads share one q row: each computes 16 scores of the 64-key tile
//     and owns D/4 output dims, so m, l and acc stay in fp32 registers and
//     the row max/sum reduce with two shuffles;
//   * under causal, tiles wholly above the diagonal are never loaded
//     (the TPU's `run` predicate becomes the loop bound);
//   * the key mask is read once per tile into shared memory; masked scores
//     get kNegInf and their p is forced to 0, so a fully masked row gives
//     l == 0, O == 0 and LSE == kNegInf exactly as on the TPU;
//   * the ragged edge (L not a multiple of 64) is masked here: the TPU's
//     block-divisibility rule does not apply.
#include "common.cuh"

namespace {

using stoke::from_float;
using stoke::kNegInf;
using stoke::to_float;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse, int H, int L,
                     float scale, int causal) {
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
    qs[r * SQ + c] =
        qr < L ? to_float(q[base + static_cast<size_t>(qr) * D + c]) : 0.f;
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
      ks[r * SQ + c] = in ? to_float(k[g]) : 0.f;
      vs[r * D + c] = in ? to_float(v[g]) : 0.f;
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
      o[out + sub + i * kThreadsPerRow] = from_float<T>(acc[i] / safe_l);
    if (sub == 0)
      lse[static_cast<size_t>(bh) * L + qpos] =
          l > 0.f ? m + logf(l) : kNegInf;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* mask, void* o, float* lse, int BH, int H, int L,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, L, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: [BH, L, D] contiguous, dtype 0 = float32, 1 = bfloat16;
// mask: [B, L] int32 or null; lse: [BH, L] float32. Returns the CUDA error
// of the launch (0 on success), or -1 for a dtype or head dim it does not
// take.
int stoke_flash_fwd(const void* q, const void* k, const void* v,
                    const int* mask, void* o, float* lse, int BH, int H,
                    int L, int D, int dtype, float scale, int causal,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, mask, o, lse, BH, H, L, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, mask, o, lse, BH, H, L, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, mask, o, lse, BH, H, L, scale,
                                     causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, mask, o, lse, BH, H, L, scale,
                                      causal, s);
  return -1;
}

const char* stoke_flash_fwd_error(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
