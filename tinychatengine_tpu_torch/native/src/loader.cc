// Threaded checkpoint reader — C++ runtime IO (the port's copy of the JAX
// package's native/src/loader.cc).
//
// Replaces the reference's per-tensor fread loader
// (llm/src/utils.cc read_to_array + 32-byte-aligned allocate_aligned_memory,
// llm/src/utils.cc:205-221): one raw binary file per tensor, read eagerly at
// model construction. Here a small thread pool pread()s large files in
// parallel chunks directly into caller-provided (numpy) buffers, saturating
// NVMe/page-cache bandwidth during checkpoint load.
//
// C ABI only (ctypes).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Returns file size, or -1.
int64_t tce_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Read `nbytes` from `path` at `offset` into dst using up to n_threads
// parallel pread()s. Returns bytes read, or -1 on error.
int64_t tce_read_file(const char* path, void* dst, int64_t offset,
                      int64_t nbytes, int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  if (n_threads < 1) n_threads = 1;
  const int64_t kMinChunk = 8 << 20;  // 8 MB per thread minimum
  int64_t chunks = (nbytes + kMinChunk - 1) / kMinChunk;
  if (chunks < n_threads) n_threads = static_cast<int>(chunks > 0 ? chunks : 1);

  std::atomic<int64_t> total{0};
  std::atomic<bool> failed{false};
  int64_t per = (nbytes + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t begin = t * per;
      int64_t end = begin + per < nbytes ? begin + per : nbytes;
      char* p = static_cast<char*>(dst) + begin;
      int64_t pos = begin;
      while (pos < end) {
        ssize_t r = pread(fd, p, static_cast<size_t>(end - pos), offset + pos);
        if (r <= 0) {
          failed.store(true);
          return;
        }
        pos += r;
        p += r;
        total.fetch_add(r);
      }
    });
  }
  for (auto& th : ts) th.join();
  close(fd);
  return failed.load() ? -1 : total.load();
}

}  // extern "C"
