// Native host-side batch assembly for the port's data pipeline: a copy of
// the JAX package's batcher, so both packages assemble the same batches.
//
// A GIL-free thread pool does the memory-bound jobs of host batching:
//
//   1. gather_rows:    out[i, :] = src[idx[i], :]        (sampler -> batch)
//   2. u8_to_f32_norm: fused uint8 -> float32 (x/255 - mean)/std per channel
//   3. gather_pad_i32: ragged int32 sequences -> zero-padded [n, max_len]
//                      matrix and 0/1 mask in one pass
//
// Each is data-parallel, so the "pool" is a static partition over
// persistent worker threads (no work queue; wake all, run a slice, wait).
// Exposed through a C ABI for ctypes; stoke_tpu_torch/native/__init__.py
// builds it at first use with
//   g++ -O3 -shared -fPIC -pthread -std=c++17 batcher.cpp -o libstoke_batcher.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

class Pool {
 public:
  explicit Pool(int n_threads) : n_(n_threads > 0 ? n_threads : 1) {
    for (int t = 0; t < n_; ++t) {
      threads_.emplace_back([this, t] { Worker(t); });
    }
  }

  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      epoch_++;
    }
    cv_start_.notify_all();
    for (auto& th : threads_) th.join();
  }

  // Run job(t, n) on every worker t in [0, n) and wait for completion.
  void Run(const std::function<void(int, int)>& job) {
    std::unique_lock<std::mutex> lk(mu_);
    job_ = &job;
    remaining_ = n_;
    epoch_++;
    cv_start_.notify_all();
    cv_done_.wait(lk, [this] { return remaining_ == 0; });
    job_ = nullptr;
  }

  int size() const { return n_; }

 private:
  void Worker(int t) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int, int)>* job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_start_.wait(lk, [&] { return epoch_ != seen; });
        seen = epoch_;
        if (stop_) return;
        job = job_;
      }
      if (job) (*job)(t, n_);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--remaining_ == 0) cv_done_.notify_all();
      }
    }
  }

  int n_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_start_, cv_done_;
  const std::function<void(int, int)>* job_ = nullptr;
  int remaining_ = 0;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

inline void Slice(int t, int n, int64_t total, int64_t* lo, int64_t* hi) {
  int64_t chunk = (total + n - 1) / n;
  *lo = t * chunk;
  *hi = std::min<int64_t>(total, *lo + chunk);
}

}  // namespace

extern "C" {

void* stoke_pool_new(int n_threads) { return new Pool(n_threads); }

void stoke_pool_free(void* pool) { delete static_cast<Pool*>(pool); }

int stoke_pool_size(void* pool) { return static_cast<Pool*>(pool)->size(); }

// out[i, :] = src[idx[i], :] for i in [0, n_idx); rows are row_bytes wide.
void stoke_gather_rows(void* pool, const void* src, const int64_t* idx,
                       int64_t n_idx, int64_t row_bytes, void* out) {
  auto* p = static_cast<Pool*>(pool);
  const char* s = static_cast<const char*>(src);
  char* o = static_cast<char*>(out);
  p->Run([&](int t, int n) {
    int64_t lo, hi;
    Slice(t, n, n_idx, &lo, &hi);
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(o + i * row_bytes, s + idx[i] * row_bytes, row_bytes);
    }
  });
}

// Fused uint8 -> float32 normalize: out[j] = (src[j]/255 - mean[c]) / std[c]
// where c = j % channels (interleaved channel-last layout).
void stoke_u8_to_f32_norm(void* pool, const uint8_t* src, int64_t n,
                          const float* mean, const float* stdv, int channels,
                          float* out) {
  auto* p = static_cast<Pool*>(pool);
  // precompute per-channel scale/shift: out = src * a[c] + b[c]
  std::vector<float> a(channels), b(channels);
  for (int c = 0; c < channels; ++c) {
    a[c] = 1.0f / (255.0f * stdv[c]);
    b[c] = -mean[c] / stdv[c];
  }
  p->Run([&](int t, int nthreads) {
    int64_t lo, hi;
    Slice(t, nthreads, n / channels, &lo, &hi);
    for (int64_t px = lo; px < hi; ++px) {
      int64_t base = px * channels;
      for (int c = 0; c < channels; ++c) {
        out[base + c] = static_cast<float>(src[base + c]) * a[c] + b[c];
      }
    }
  });
}

// Gather + pad 2-D: rows of variable length (lengths[i]) from a ragged
// concatenated int32 buffer (offsets[i] gives start of row i in src);
// out is [n_idx, max_len] zero-padded, mask likewise 0/1.
void stoke_gather_pad_i32(void* pool, const int32_t* src,
                          const int64_t* offsets, const int32_t* lengths,
                          const int64_t* idx, int64_t n_idx, int64_t max_len,
                          int32_t* out, int32_t* mask) {
  auto* p = static_cast<Pool*>(pool);
  p->Run([&](int t, int n) {
    int64_t lo, hi;
    Slice(t, n, n_idx, &lo, &hi);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t row = idx[i];
      int64_t len = lengths[row];
      if (len > max_len) len = max_len;
      const int32_t* s = src + offsets[row];
      int32_t* o = out + i * max_len;
      int32_t* m = mask + i * max_len;
      std::memcpy(o, s, len * sizeof(int32_t));
      std::memset(o + len, 0, (max_len - len) * sizeof(int32_t));
      for (int64_t j = 0; j < len; ++j) m[j] = 1;
      std::memset(m + len, 0, (max_len - len) * sizeof(int32_t));
    }
  });
}

}  // extern "C"
