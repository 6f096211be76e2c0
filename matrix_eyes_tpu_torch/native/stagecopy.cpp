// A host copy of one contiguous buffer into another, shared between the
// calling thread and a pool of helper threads: the photo's staging into
// pinned memory before its copy to the card (pipeline.stage).
//
// The buffer is cut into chunks that any participant claims with one atomic
// increment. The calling thread copies chunks too and then waits only for
// the chunks a helper has claimed and not yet finished, never for a helper
// to wake: a helper that is slow to be scheduled finds no chunk left and
// goes back to sleep. So the copy takes at worst about what the calling
// thread alone would take, plus a chunk, where a fork-join copy (OpenMP's)
// waits for its slowest thread, which on a host whose cores are shared can
// be many milliseconds late. Helpers sleep on a condition variable between
// copies and spin for nothing.
//
// When me_stage_copy returns, every byte has been copied and no helper
// reads the source again: a helper that takes a finished job only reads its
// counters, which it keeps alive through its own reference.
//
// The pool is made on the first copy with the helper count asked for, and
// is never destroyed (its threads end with the process). A child of fork
// inherits no helpers: its calling thread copies every chunk itself.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <system_error>
#include <thread>

namespace {

constexpr int64_t kChunk = 256 * 1024;

struct Job {
  const uint8_t* src;
  uint8_t* dst;
  int64_t n;       // bytes
  int64_t chunks;  // ceil(n / kChunk)
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> done{0};

  void run() {
    for (;;) {
      const int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= chunks) return;
      const int64_t off = i * kChunk;
      std::memcpy(dst + off, src + off, static_cast<size_t>(std::min(kChunk, n - off)));
      done.fetch_add(1, std::memory_order_release);
    }
  }
};

class Pool {
 public:
  explicit Pool(int helpers) {
    try {
      for (int i = 0; i < helpers; ++i) std::thread([this] { work(); }).detach();
    } catch (const std::system_error&) {
      // fewer helpers: the calling thread copies what they do not
    }
  }

  void copy(const uint8_t* src, uint8_t* dst, int64_t n) {
    auto job = std::make_shared<Job>();
    job->src = src;
    job->dst = dst;
    job->n = n;
    job->chunks = (n + kChunk - 1) / kChunk;
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = job;
      ++generation_;
    }
    cv_.notify_all();
    job->run();
    while (job->done.load(std::memory_order_acquire) < job->chunks) std::this_thread::yield();
    std::lock_guard<std::mutex> lk(mu_);
    if (job_ == job) job_.reset();
  }

 private:
  void work() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      cv_.wait(lk, [&] { return generation_ != seen; });
      seen = generation_;
      std::shared_ptr<Job> job = job_;
      lk.unlock();
      if (job) job->run();
      lk.lock();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::shared_ptr<Job> job_;
  uint64_t generation_ = 0;
};

std::once_flag pool_once;
Pool* pool = nullptr;  // never destroyed: its detached threads use it until exit

}  // namespace

extern "C" int me_stage_copy(const uint8_t* src, uint8_t* dst, int64_t n, int threads) {
  if (n < 0 || (n > 0 && (src == nullptr || dst == nullptr))) return 1;
  std::call_once(pool_once, [threads] { pool = new Pool(threads > 1 ? threads - 1 : 0); });
  if (n > 0) pool->copy(src, dst, n);
  return 0;
}
