// Native scan loader: KITTI velodyne .bin reader + threaded double-buffered
// prefetcher with fixed-capacity padding.
//
// The reference's input path is a ROS subscription feeding PCL conversions
// (scan_registration.cpp:828-862); here the host-side data path is a small
// C++ library so scan IO and padding never block the Python driver loop: the
// prefetch thread reads + pads scan k+1 while the device processes scan k.
//
// C ABI (consumed via ctypes from plo_tpu_torch/native/__init__.py):
//   plo_load_bin(path, out, capacity)            -> n points (or -1)
//   plo_prefetcher_create(paths, n, capacity)    -> handle
//   plo_prefetcher_next(h, out)                  -> n points (-2 = end)
//   plo_prefetcher_destroy(h)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Read one KITTI .bin (float32 x,y,z,reflectance) into out[capacity*4],
// zero-padding the tail. Returns the number of points (clamped to capacity).
int64_t load_bin(const char* path, float* out, int64_t capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t n = std::fread(out, sizeof(float) * 4, capacity, f);
  // Drain the remainder to report truncation honestly (points beyond
  // capacity are dropped, as in the Python fallback).
  std::fclose(f);
  if (n < capacity) {
    std::memset(out + n * 4, 0, sizeof(float) * 4 * (capacity - n));
  }
  return n;
}

struct Prefetcher {
  std::vector<std::string> paths;
  int64_t capacity = 0;
  size_t next_read = 0;   // next file the worker will read
  size_t next_serve = 0;  // next file the consumer will receive

  // Double buffer: worker fills `ready` slot, consumer copies out.
  std::vector<float> buf[2];
  int64_t buf_n[2] = {-3, -3};
  size_t buf_idx[2] = {SIZE_MAX, SIZE_MAX};

  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t my_file;
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          if (stop.load()) return true;
          if (next_read >= paths.size()) return false;
          // A slot is free if it's more than one file ahead of the consumer.
          return buf_idx[next_read % 2] == SIZE_MAX ||
                 buf_idx[next_read % 2] < next_serve;
        });
        if (stop.load() || next_read >= paths.size()) {
          if (next_read >= paths.size()) return;
          continue;
        }
        my_file = next_read++;
        slot = my_file % 2;
      }
      int64_t n = load_bin(paths[my_file].c_str(), buf[slot].data(), capacity);
      {
        std::lock_guard<std::mutex> lk(mu);
        buf_n[slot] = n;
        buf_idx[slot] = my_file;
      }
      cv.notify_all();
    }
  }

  int64_t next(float* out) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_serve >= paths.size()) return -2;
    size_t want = next_serve;
    int slot = want % 2;
    cv.wait(lk, [&] { return buf_idx[slot] == want || stop.load(); });
    if (buf_idx[slot] != want) return -2;
    int64_t n = buf_n[slot];
    std::memcpy(out, buf[slot].data(), sizeof(float) * 4 * capacity);
    next_serve++;
    cv.notify_all();
    return n;
  }
};

}  // namespace

extern "C" {

int64_t plo_load_bin(const char* path, float* out, int64_t capacity) {
  return load_bin(path, out, capacity);
}

void* plo_prefetcher_create(const char** paths, int64_t n_paths, int64_t capacity) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n_paths);
  p->capacity = capacity;
  p->buf[0].resize(capacity * 4);
  p->buf[1].resize(capacity * 4);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

int64_t plo_prefetcher_next(void* handle, float* out) {
  return static_cast<Prefetcher*>(handle)->next(out);
}

void plo_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    // Under the mutex: a worker between its predicate check and its wait
    // would otherwise miss this notify and sleep forever in join().
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
