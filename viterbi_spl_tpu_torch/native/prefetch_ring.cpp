// Native prefetch ring (the port's copy of
// viterbi_spl_tpu/native/prefetch_ring.cpp): a fixed ring of batch
// buffers filled by a worker
// thread pool executing plain memcpy descriptors, decoupling host batch
// assembly from device compute — the runtime role tf.data's
// .prefetch(10) plays in the reference training pipelines
// (dcnet/softmax_viterbi.py:587-656).
//
// Protocol (ctypes):
//   ring_create(slots, slot_bytes, n_threads) -> handle
//   ring_submit(h, descs, n)   — enqueue ONE batch fill; descs is an array
//                                of Desc {src, src_off, n_bytes, dst_off};
//                                blocks while all slots are in flight/held.
//   ring_pop(h) -> slot buffer pointer (blocks until the oldest submitted
//                                batch is filled; FIFO order)
//   ring_release(h, ptr)       — return the slot for reuse
//   ring_destroy(h)
//
// Descriptors reference caller-owned memory (the immutable precomputed
// track arrays); the caller must keep them alive while jobs are in flight.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Desc {
  const uint8_t* src;
  uint64_t src_off;
  uint64_t n_bytes;
  uint64_t dst_off;
};

struct Job {
  std::vector<Desc> descs;
  int slot;
};

struct Ring {
  std::vector<std::vector<uint8_t>> slots;
  std::vector<int> state;  // 0 free, 1 filling, 2 ready, 3 held
  std::deque<Job> pending;        // jobs not yet picked up by workers
  std::deque<int> ready_order;    // submit order of slots for FIFO pop
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_worker, cv_client;
  bool stop = false;

  Ring(int n_slots, uint64_t slot_bytes, int n_threads)
      : slots(n_slots), state(n_slots, 0) {
    for (auto& s : slots) s.resize(slot_bytes);
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker_loop(); });
  }

  ~Ring() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_worker.notify_all();
    for (auto& w : workers) w.join();
  }

  void worker_loop() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_worker.wait(lk, [this] { return stop || !pending.empty(); });
        if (stop) return;
        job = std::move(pending.front());
        pending.pop_front();
      }
      uint8_t* dst = slots[job.slot].data();
      for (const Desc& d : job.descs)
        std::memcpy(dst + d.dst_off, d.src + d.src_off, d.n_bytes);
      {
        std::lock_guard<std::mutex> lk(mu);
        state[job.slot] = 2;
      }
      cv_client.notify_all();
    }
  }

  int acquire_free_slot() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      for (size_t i = 0; i < state.size(); ++i)
        if (state[i] == 0) {
          state[i] = 1;
          return static_cast<int>(i);
        }
      cv_client.wait(lk);
    }
  }

  void submit(const Desc* descs, uint64_t n) {
    int slot = acquire_free_slot();
    Job job;
    job.descs.assign(descs, descs + n);
    job.slot = slot;
    {
      std::lock_guard<std::mutex> lk(mu);
      ready_order.push_back(slot);
      pending.push_back(std::move(job));
    }
    cv_worker.notify_one();
  }

  uint8_t* pop() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (!ready_order.empty()) {
        int slot = ready_order.front();
        if (state[slot] == 2) {
          ready_order.pop_front();
          state[slot] = 3;
          return slots[slot].data();
        }
      }
      cv_client.wait(lk);
    }
  }

  void release(uint8_t* ptr) {
    std::lock_guard<std::mutex> lk(mu);
    for (size_t i = 0; i < slots.size(); ++i)
      if (slots[i].data() == ptr) {
        state[i] = 0;
        cv_client.notify_all();
        return;
      }
  }
};

}  // namespace

extern "C" {

void* ring_create(int n_slots, uint64_t slot_bytes, int n_threads) {
  return new Ring(n_slots, slot_bytes, n_threads);
}

void ring_submit(void* h, const void* descs, uint64_t n) {
  static_cast<Ring*>(h)->submit(static_cast<const Desc*>(descs), n);
}

void* ring_pop(void* h) { return static_cast<Ring*>(h)->pop(); }

void ring_release(void* h, void* ptr) {
  static_cast<Ring*>(h)->release(static_cast<uint8_t*>(ptr));
}

void ring_destroy(void* h) { delete static_cast<Ring*>(h); }

}  // extern "C"
