// The worker pool of the port's native host library: the JPEG decoder
// (jpeg_decode.cc) and the image ops (imaging.cc) are built into one
// library and run their batches on one pool, made by dfd_jpeg_pool_new.
// Each batch call submits one task an item and waits on a Latch.

#ifndef DFD_NATIVE_POOL_H_
#define DFD_NATIVE_POOL_H_

#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace dfd_native {

class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) workers_.emplace_back([this] { Run(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
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
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
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
  bool stop_ = false;
};

struct Latch {
  explicit Latch(int n) : count(n) {}
  void Done() {
    std::unique_lock<std::mutex> lk(mu);
    if (--count == 0) cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return count == 0; });
  }
  int count;
  std::mutex mu;
  std::condition_variable cv;
};

}  // namespace dfd_native

#endif  // DFD_NATIVE_POOL_H_
