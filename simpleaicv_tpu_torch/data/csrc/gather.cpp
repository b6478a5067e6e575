// Record gather for the packed dataset cache (data/packed.py): copies n
// fixed-stride records from a base pointer (an mmap'd pack field) into a
// contiguous buffer. ctypes releases the GIL around the call, so the
// loader's prefetch thread gathers the next batch while the main thread
// drives the card; with several threads the page faults of a cold read
// overlap. Needs nothing beyond the C++ runtime.
//
// C ABI (ctypes; data/native_io.py):
//   nio_gather_records(base, record_bytes, indices, n, out, n_threads) -> n

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int nio_gather_records(const uint8_t* base, long record_bytes,
                       const long* indices, int n, uint8_t* out,
                       int n_threads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      std::memcpy(out + (size_t)i * record_bytes,
                  base + (size_t)indices[i] * record_bytes,
                  (size_t)record_bytes);
    }
  };
  const int t = std::max(1, std::min(n_threads, n));
  if (t == 1) {
    worker();
    return n;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return n;
}

}  // extern "C"
