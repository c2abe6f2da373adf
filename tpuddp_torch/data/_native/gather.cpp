// Host row gather of the port's data path: the port's own copy of the JAX
// package's multithreaded row gather (tpuddp/data/_native/gather.cpp).
//
// A batch is a row gather out of the in-memory dataset (images[idx]); this
// does it as parallel memcpy with an optional tail pad, called from the
// loader through ctypes (tpuddp_torch/data/_native/__init__.py builds it at
// first use and validates every argument before the call).
//
// Build: g++ -O3 -march=native -shared -fPIC gather.cpp -o libgather.so -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather n_idx rows of row_bytes each from src into dst, then pad dst with
// copies of its first gathered row up to pad_rows rows in all (the loader's
// static-shape final batch). n_threads <= 0 picks the hardware threads.
void tpuddp_torch_gather_rows(const uint8_t* src, int64_t row_bytes,
                              const int64_t* idx, int64_t n_idx, int64_t pad_rows,
                              uint8_t* dst, int n_threads) {
  if (n_idx <= 0) return;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 4;
  // a thread per MiB at most: starting one costs tens of microseconds, about
  // what a MiB of memcpy takes, so a 128-row CIFAR-10 batch (384 KiB) is
  // copied inline (the JAX package's copy starts a thread per 64 rows)
  const int64_t kMinBytesPerThread = int64_t(1) << 20;
  int threads = static_cast<int>(std::min<int64_t>(
      n_threads, std::max<int64_t>(1, n_idx * row_bytes / kMinBytesPerThread)));

  auto copy_range = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };

  if (threads <= 1) {
    copy_range(0, n_idx);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t chunk = (n_idx + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = std::min<int64_t>(n_idx, lo + chunk);
      if (lo >= hi) break;
      pool.emplace_back(copy_range, lo, hi);
    }
    for (auto& th : pool) th.join();
  }

  for (int64_t i = n_idx; i < pad_rows; ++i) {
    std::memcpy(dst + i * row_bytes, dst, static_cast<size_t>(row_bytes));
  }
}

int tpuddp_torch_gather_abi_version() { return 1; }

}  // extern "C"
