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
// zero dQ row and adds nothing to dK or dV.
//
// What bounds it on the H100: at the training shapes (B=8, H=12, L=1024,
// D=64, causal) the pair does 7*L*L*D FLOPs per head (14*L*L*D without the
// causal half) against ~10*L*D elements moved, so it is bound by
// operations; neither the score matrix nor P leaves the SM. Like
// flash_fwd.cu, this first version runs its products as scalar fp32 FMAs
// out of shared memory (no wgmma, no TMA), far below the tensor-core roof;
// making it fast is later work.
//
// Design. On the TPU, the dq kernel's k tiles and the dkv kernel's q tiles
// are sequential grid axes whose VMEM scratch accumulators carry across
// grid steps. Here blocks run in parallel in no order, so each block owns
// one output tile and walks the other axis in a loop of its own:
//   * dq: one block per (b*h, 64-row q tile). Its Q and dO rows, LSE and
//     delta stay resident while K and V tiles stream through, stopping at
//     the diagonal under causal;
//   * dkv: one block per (b*h, 64-row k tile). Its K and V rows and key-mask
//     bits stay resident while Q, dO, LSE and delta tiles stream through,
//     starting at the diagonal under causal. Each block owns its k rows, so
//     nothing is summed across blocks and no atomics are needed;
//   * 4 adjacent threads share one row of the owned tile: each computes 16
//     of a tile's 64 scores and owns D/4 output dims in registers. ds (and
//     p, for dV) goes through shared memory between the two products and is
//     read back by the same 4 lanes, so one __syncwarp orders them;
//   * tiles are staged as fp32 with rows padded by one float, so the 8 rows
//     a warp reads at once fall in distinct banks; the ragged edge (L not a
//     multiple of 64) is masked here.
#include "common.cuh"

namespace {

using stoke::from_float;
using stoke::to_float;

constexpr int kTile = 64;  // rows of a q or k tile
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kTile;  // 4 adjacent threads per owned row
constexpr int kCols = kTile / kLanes;     // 16 score columns per thread
constexpr int kSP = kTile + 1;            // padded row stride of a score tile

// Rows [r0, r0 + kTile) of one head's [L, D] slab at `base`, as fp32 into a
// [kTile][D + 1] shared tile; rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, int r0, int L) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] =
        gr < L ? to_float(src[base + static_cast<size_t>(gr) * D + c]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc += a[d] * b[d];
  return acc;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kSP) +
         sizeof(int) * kTile;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kSP + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ mask, T* __restrict__ dq,
                        int H, int L, float scale, int causal) {
  constexpr int S = D + 1;
  constexpr int DPT = D / kLanes;  // output dims per thread

  extern __shared__ float smem[];
  float* qs = smem;             // [kTile][S]
  float* dos = qs + kTile * S;  // [kTile][S]
  float* ks = dos + kTile * S;  // [kTile][S]
  float* vs = ks + kTile * S;   // [kTile][S]
  float* dss = vs + kTile * S;  // [kTile][kSP]
  int* kvalid = reinterpret_cast<int*>(dss + kTile * kSP);  // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int sub = tid % kLanes;
  const int qpos = q0 + row;
  const bool qok = qpos < L;
  const size_t stat = static_cast<size_t>(bh) * L + qpos;
  const float row_lse = qok ? lse[stat] : 0.f;
  const float row_delta = qok ? delta[stat] : 0.f;

  load_tile<T, D>(qs, q, base, q0, L);
  load_tile<T, D>(dos, dout, base, q0, L);

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int n_tiles = (L + kTile - 1) / kTile;
  if (causal) n_tiles = min(n_tiles, q0 / kTile + 1);  // stop at the diagonal

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, k, base, k0, L);
    load_tile<T, D>(vs, v, base, k0, L);
    if (tid < kTile) {
      const int kr = k0 + tid;
      kvalid[tid] = kr < L && (mask == nullptr ||
                               mask[static_cast<size_t>(b) * L + kr] > 0);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + j * kLanes;
      float ds = 0.f;
      if (qok && kvalid[c] && (!causal || qpos >= k0 + c)) {
        const float s = dot_rows<D>(qs + row * S, ks + c * S) * scale;
        const float p = expf(s - row_lse);
        const float dp = dot_rows<D>(dos + row * S, vs + c * S);
        ds = p * (dp - row_delta);
      }
      dss[row * kSP + c] = ds;
    }
    __syncwarp();  // a row's ds is written and read by the same 4 lanes

    for (int c = 0; c < kTile; ++c) {
      const float ds = dss[row * kSP + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += ds * ks[c * S + sub + i * kLanes];
    }
  }

  if (qok) {
    const size_t out = base + static_cast<size_t>(qpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      dq[out + sub + i * kLanes] = from_float<T>(acc[i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ mask, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int L, float scale,
                         int causal) {
  constexpr int S = D + 1;
  constexpr int DPT = D / kLanes;

  extern __shared__ float smem[];
  float* ks = smem;                 // [kTile][S]
  float* vs = ks + kTile * S;       // [kTile][S]
  float* qs = vs + kTile * S;       // [kTile][S]
  float* dos = qs + kTile * S;      // [kTile][S]
  float* pts = dos + kTile * S;     // [kTile][kSP], p^T of the tile
  float* dsts = pts + kTile * kSP;  // [kTile][kSP], ds^T of the tile
  float* qlse = dsts + kTile * kSP;  // [kTile]
  float* qdelta = qlse + kTile;      // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * L * D;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int sub = tid % kLanes;
  const int kpos = k0 + row;
  const bool kok = kpos < L && (mask == nullptr ||
                                mask[static_cast<size_t>(b) * L + kpos] > 0);

  load_tile<T, D>(ks, k, base, k0, L);
  load_tile<T, D>(vs, v, base, k0, L);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const int n_tiles = (L + kTile - 1) / kTile;
  const int first = causal ? k0 / kTile : 0;  // start at the diagonal

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(qs, q, base, q0, L);
    load_tile<T, D>(dos, dout, base, q0, L);
    if (tid < kTile) {
      const int qr = q0 + tid;
      const size_t stat = static_cast<size_t>(bh) * L + qr;
      qlse[tid] = qr < L ? lse[stat] : 0.f;
      qdelta[tid] = qr < L ? delta[stat] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = sub + j * kLanes;
      const int qr = q0 + c;
      float p = 0.f, ds = 0.f;
      if (kok && qr < L && (!causal || qr >= kpos)) {
        const float s = dot_rows<D>(qs + c * S, ks + row * S) * scale;
        p = expf(s - qlse[c]);
        const float dp = dot_rows<D>(dos + c * S, vs + row * S);
        ds = p * (dp - qdelta[c]);
      }
      pts[row * kSP + c] = p;
      dsts[row * kSP + c] = ds;
    }
    __syncwarp();  // a row's p and ds are written and read by the same 4 lanes

    for (int c = 0; c < kTile; ++c) {
      const float p = pts[row * kSP + c];
      const float ds = dsts[row * kSP + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = c * S + sub + i * kLanes;
        dv_acc[i] += p * dos[d];
        dk_acc[i] += ds * qs[d];
      }
    }
  }

  if (kpos < L) {
    const size_t out = base + static_cast<size_t>(kpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[out + sub + i * kLanes] = from_float<T>(dk_acc[i] * scale);
      dv[out + sub + i * kLanes] = from_float<T>(dv_acc[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* mask, void* dq, int BH, int H, int L,
                      float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((L + kTile - 1) / kTile, BH);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dq), H, L, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* mask, void* dk, void* dv, int BH, int H,
                       int L, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((L + kTile - 1) / kTile, BH);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: [BH, L, D] contiguous, dtype 0 = float32,
// 1 = bfloat16; lse, delta: [BH, L] float32; mask: [B, L] int32 or null.
// Each returns the CUDA error of its launch (0 on success), or -1 for a
// dtype or head dim it does not take.
int stoke_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* mask, void* dq, int BH, int H, int L, int D,
                       int dtype, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, mask, dq, BH, H, L,
                                scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, mask, dq, BH, H,
                                 L, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, mask, dq,
                                        BH, H, L, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, mask, dq,
                                         BH, H, L, scale, causal, s);
  return -1;
}

int stoke_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const int* mask, void* dk,
                        void* dv, int BH, int H, int L, int D, int dtype,
                        float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                                 H, L, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, mask, dk, dv, BH,
                                  H, L, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, mask, dk,
                                         dv, BH, H, L, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, mask, dk,
                                          dv, BH, H, L, scale, causal, s);
  return -1;
}

const char* stoke_flash_bwd_error(int code) {
  return code < 0 ? "unsupported dtype or head dim"
                  : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
