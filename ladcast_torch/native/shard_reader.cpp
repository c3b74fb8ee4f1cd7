// Multi-threaded random-access frame reader for latent and field shards
// (the port's copy of the JAX package's reader; built with g++ at first use
// by ladcast_torch/data/native_reader.py and loaded through ctypes).
//
// Frames lie at fixed strides in flat files: the data section of an .npy
// shard (stride = frame bytes), or the members of a tar archive of
// equal-size .npy members (stride = 512-byte header + payload padded to
// 512). Python hands the library (path, byte offset, frame count, stride)
// per file once, then asks for batches of global frame indices. Reads run
// on a worker pool with pread (thread-safe, no shared file offset), so a
// batch's gathers overlap across files and never hold the GIL.
//
// C ABI (ctypes):
//   sr_open(paths, n_shards, frames_per_shard, data_offsets, frame_bytes,
//           n_threads) -> handle                  (packed frames)
//   sr_open2(..., frame_strides, frame_bytes, n_threads) -> handle
//   sr_num_frames(handle) -> total frames
//   sr_read(handle, global_indices, n, out) -> 0 on success
//   sr_prefetch(handle, global_indices, n)     (page-cache readahead)
//   sr_close(handle)

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
  int fd = -1;
  int64_t data_offset = 0;
  int64_t num_frames = 0;
  int64_t stride = 0;  // byte distance between frame starts
};

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

struct Reader {
  std::vector<Shard> shards;
  std::vector<int64_t> cum_frames;  // exclusive prefix sum
  int64_t frame_bytes = 0;
  int64_t total_frames = 0;
  std::unique_ptr<ThreadPool> pool;

  // global index -> (shard, local index)
  bool locate(int64_t g, int* shard, int64_t* local) const {
    if (g < 0 || g >= total_frames) return false;
    // binary search over cum_frames
    int lo = 0, hi = static_cast<int>(shards.size()) - 1;
    while (lo < hi) {
      int mid = (lo + hi + 1) / 2;
      if (cum_frames[mid] <= g)
        lo = mid;
      else
        hi = mid - 1;
    }
    *shard = lo;
    *local = g - cum_frames[lo];
    return true;
  }
};

int read_frame(const Reader* r, int64_t g, char* dst) {
  int s;
  int64_t local;
  if (!r->locate(g, &s, &local)) return -1;
  const Shard& sh = r->shards[s];
  int64_t off = sh.data_offset + local * sh.stride;
  int64_t remaining = r->frame_bytes;
  while (remaining > 0) {
    ssize_t got = pread(sh.fd, dst, remaining, off);
    if (got <= 0) return -1;
    dst += got;
    off += got;
    remaining -= got;
  }
  return 0;
}

}  // namespace

extern "C" {

// frame_strides: byte distance between consecutive frame starts within
// each shard. Equal to frame_bytes for packed shards (.npy data
// sections); larger for containers with per-member headers/padding
// (tar archives of equal-size members -- 512-byte header + padding).
void* sr_open2(const char** paths, int n_shards,
               const int64_t* frames_per_shard, const int64_t* data_offsets,
               const int64_t* frame_strides, int64_t frame_bytes,
               int n_threads) {
  auto* r = new Reader();
  r->frame_bytes = frame_bytes;
  r->shards.resize(n_shards);
  r->cum_frames.resize(n_shards);
  int64_t cum = 0;
  for (int i = 0; i < n_shards; ++i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) {
      for (int j = 0; j < i; ++j) close(r->shards[j].fd);
      delete r;
      return nullptr;
    }
    r->shards[i] = {fd, data_offsets[i], frames_per_shard[i],
                    frame_strides[i]};
    r->cum_frames[i] = cum;
    cum += frames_per_shard[i];
  }
  r->total_frames = cum;
  if (n_threads < 1) n_threads = 1;
  r->pool = std::make_unique<ThreadPool>(n_threads);
  return r;
}

void* sr_open(const char** paths, int n_shards,
              const int64_t* frames_per_shard, const int64_t* data_offsets,
              int64_t frame_bytes, int n_threads) {
  std::vector<int64_t> strides(n_shards, frame_bytes);
  return sr_open2(paths, n_shards, frames_per_shard, data_offsets,
                  strides.data(), frame_bytes, n_threads);
}

int64_t sr_num_frames(void* handle) {
  return static_cast<Reader*>(handle)->total_frames;
}

int sr_read(void* handle, const int64_t* indices, int n, char* out) {
  auto* r = static_cast<Reader*>(handle);
  std::atomic<int> failed{0};
  int remaining = n;  // guarded by done_mu
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < n; ++i) {
    int64_t g = indices[i];
    char* dst = out + static_cast<int64_t>(i) * r->frame_bytes;
    r->pool->submit([r, g, dst, &failed, &remaining, &done_mu, &done_cv] {
      if (read_frame(r, g, dst) != 0) failed.fetch_add(1);
      // The count drops under the lock, so the caller cannot see 0 and
      // leave (destroying done_mu and done_cv) before this job is done
      // with them.
      std::lock_guard<std::mutex> lk(done_mu);
      if (--remaining == 0) done_cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&remaining] { return remaining == 0; });
  return failed.load() == 0 ? 0 : -1;
}

void sr_prefetch(void* handle, const int64_t* indices, int n) {
  auto* r = static_cast<Reader*>(handle);
  for (int i = 0; i < n; ++i) {
    int s;
    int64_t local;
    if (!r->locate(indices[i], &s, &local)) continue;
    const Shard& sh = r->shards[s];
#ifdef POSIX_FADV_WILLNEED
    posix_fadvise(sh.fd, sh.data_offset + local * sh.stride,
                  r->frame_bytes, POSIX_FADV_WILLNEED);
#endif
  }
}

void sr_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  r->pool.reset();
  for (auto& s : r->shards) close(s.fd);
  delete r;
}

}  // extern "C"
