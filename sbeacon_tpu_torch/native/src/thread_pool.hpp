// Minimal fixed-size thread pool.
//
// Native-component parity: the reference vendors a generic pool for its
// parallel S3 downloads (reference: lambda/duplicateVariantSearch/source/
// thread.hpp, 226 LoC of work-stealing queue) and hand-rolls 4 download
// threads in the BGZF reader (summariseSlice/source/vcf_chunk_reader.h:
// 69-105). Here one pool serves both roles: parallel block inflation and
// any future ranged-read prefetch.

#pragma once

#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace sbn {

class ThreadPool {
 public:
  explicit ThreadPool(std::size_t n) {
    if (n == 0) n = 1;
    for (std::size_t i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Run(); });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return done_ || !q_.empty(); });
        if (q_.empty()) {
          if (done_) return;
          continue;
        }
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }

  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool done_ = false;
};

}  // namespace sbn
