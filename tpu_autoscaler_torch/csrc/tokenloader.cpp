// Native token-shard loader for the in-tree trainer.
//
// The reference autoscaler has no data path at all (SURVEY §3: it is an
// infrastructure controller); this is runtime infrastructure for the
// in-tree workload: a memory-mapped reader over a binary file of uint32
// tokens that serves [batch, seq+1] next-token-prediction windows.
//
// Design for the TPU host:
// - mmap, not read(): the OS page cache backs every shard once per host
//   no matter how many loader instances exist, and first-touch faulting
//   overlaps with compute.
// - Stateless sampling: row r of step s starts at
//   splitmix64(seed, step, row) % (n_tokens - window + 1) — a pure
//   function of (seed, step), so checkpoint resume replays the exact
//   stream with no loader state to persist (crash-only, like the
//   controller), and a Python fallback can be bit-identical.
// - Double-buffered prefetch: a background thread fills the next step's
//   host buffer while JAX consumes the current one, hiding page-fault
//   and memcpy latency behind the device step.
//
// C ABI (ctypes-friendly): tl_open / tl_next / tl_prefetch / tl_n_tokens
// / tl_close.  All return codes: 0 ok, negative errno-style failures.

#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

inline uint64_t row_offset(uint64_t seed, uint64_t step, uint64_t row,
                           uint64_t span) {
  uint64_t h = splitmix64(seed ^ splitmix64(step ^ splitmix64(row)));
  return h % span;
}

struct Loader {
  const uint32_t* tokens = nullptr;
  size_t map_bytes = 0;
  int64_t n_tokens = 0;
  int64_t window = 0;  // seq + 1
  int64_t batch = 0;
  uint64_t seed = 0;

  // Prefetch state: one buffered step ahead.
  std::vector<uint32_t> buf;
  int64_t buf_step = -1;
  bool filling = false;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool stop = false;

  void fill(int64_t step, uint32_t* out) const {
    const uint64_t span =
        static_cast<uint64_t>(n_tokens - window + 1);
    for (int64_t r = 0; r < batch; ++r) {
      const uint64_t off = row_offset(seed, static_cast<uint64_t>(step),
                                      static_cast<uint64_t>(r), span);
      std::memcpy(out + r * window, tokens + off,
                  static_cast<size_t>(window) * sizeof(uint32_t));
    }
  }

  void worker_loop() {
    std::unique_lock<std::mutex> lock(mu);
    while (true) {
      cv.wait(lock, [&] { return stop || filling; });
      if (stop) return;
      const int64_t step = buf_step;
      lock.unlock();
      fill(step, buf.data());
      lock.lock();
      filling = false;
      cv.notify_all();
    }
  }
};

std::mutex g_mu;
std::map<int64_t, Loader*> g_loaders;
int64_t g_next_handle = 1;

Loader* get(int64_t handle) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_loaders.find(handle);
  return it == g_loaders.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

// Open a uint32 token shard.  Returns a positive handle, or a negative
// error: -1 open/stat failure, -2 too short for one window, -3 bad args.
int64_t tl_open(const char* path, int64_t window, int64_t batch,
                uint64_t seed) {
  if (window < 2 || batch < 1) return -3;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return -1; }
  const int64_t n = static_cast<int64_t>(st.st_size / sizeof(uint32_t));
  if (n < window) { ::close(fd); return -2; }
  void* map = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                   MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return -1;
  auto* l = new Loader();
  l->tokens = static_cast<const uint32_t*>(map);
  l->map_bytes = static_cast<size_t>(st.st_size);
  l->n_tokens = n;
  l->window = window;
  l->batch = batch;
  l->seed = seed;
  l->buf.resize(static_cast<size_t>(batch * window));
  l->worker = std::thread([l] { l->worker_loop(); });
  std::lock_guard<std::mutex> lock(g_mu);
  const int64_t handle = g_next_handle++;
  g_loaders[handle] = l;
  return handle;
}

int64_t tl_n_tokens(int64_t handle) {
  Loader* l = get(handle);
  return l ? l->n_tokens : -1;
}

// Fill out[batch * window] with step's batch.  Uses the prefetched
// buffer when it matches, else fills synchronously.  Kicks nothing off
// itself — call tl_prefetch(step + 1) after.
int tl_next(int64_t handle, int64_t step, uint32_t* out) {
  Loader* l = get(handle);
  if (!l) return -1;
  std::unique_lock<std::mutex> lock(l->mu);
  l->cv.wait(lock, [&] { return !l->filling; });
  if (l->buf_step == step) {
    std::memcpy(out, l->buf.data(), l->buf.size() * sizeof(uint32_t));
    return 0;
  }
  lock.unlock();
  l->fill(step, out);
  return 0;
}

// Start filling the internal buffer for `step` in the background.
int tl_prefetch(int64_t handle, int64_t step) {
  Loader* l = get(handle);
  if (!l) return -1;
  std::lock_guard<std::mutex> lock(l->mu);
  if (l->filling || l->buf_step == step) return 0;
  l->buf_step = step;
  l->filling = true;
  l->cv.notify_all();
  return 0;
}

int tl_close(int64_t handle) {
  Loader* l = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return -1;
    l = it->second;
    g_loaders.erase(it);
  }
  {
    std::lock_guard<std::mutex> lock(l->mu);
    l->stop = true;
    l->cv.notify_all();
  }
  l->worker.join();
  munmap(const_cast<uint32_t*>(l->tokens), l->map_bytes);
  delete l;
  return 0;
}

}  // extern "C"
