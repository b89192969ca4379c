/* Shared-memory SPSC ring buffer for DataLoader worker→parent transport.
 *
 * Reference parity: the reference's C++ DataLoader workers ship numpy
 * batches to the trainer through shared memory
 * (paddle/fluid/operators/reader/ + python/paddle/io/dataloader/worker.py
 * _shared_memory path).  Here the native piece is deliberately tiny: one
 * lock-free single-producer single-consumer byte ring per worker, living
 * in a file under /dev/shm that the worker and the trainer both map
 * (the port's copy of paddle_tpu/io/native/ring.cc).  Messages are
 * length-framed byte blobs (the Python side pickles batches with
 * protocol 5); head/tail are std::atomics with acquire/release ordering,
 * and blocking waits back off with nanosleep so a stalled peer burns no
 * CPU.
 *
 * Built at first use by paddle_tpu_torch/io/native/__init__.py with
 *   g++ -O2 -shared -fPIC
 */
#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

namespace {

struct ring_hdr_t {
  std::atomic<uint64_t> head;    /* next write offset (monotonic)  */
  char pad1[56];                 /* keep producer/consumer lines apart */
  std::atomic<uint64_t> tail;    /* next read offset (monotonic)   */
  char pad2[56];
  uint64_t cap;                  /* data capacity in bytes         */
  std::atomic<int32_t> closed;   /* producer hung up               */
  char pad3[44];
};

inline char *ring_data(ring_hdr_t *h) {
  return reinterpret_cast<char *>(h) + sizeof(ring_hdr_t);
}

/* Exponential backoff: 50us doubling to a 5ms cap, so a briefly-blocked
 * peer stays responsive while a long-stalled one burns ~200 syscalls/sec
 * instead of 20k.  Returns the next sleep to use. */
long ring_backoff(long sleep_us) {
  struct timespec ts = {0, sleep_us * 1000};
  nanosleep(&ts, nullptr);
  long next = sleep_us * 2;
  return next > 5000 ? 5000 : next;
}

void copy_in(ring_hdr_t *h, uint64_t pos, const char *src, uint64_t len) {
  uint64_t off = pos % h->cap;
  uint64_t first = h->cap - off < len ? h->cap - off : len;
  memcpy(ring_data(h) + off, src, first);
  if (first < len) memcpy(ring_data(h), src + first, len - first);
}

void copy_out(ring_hdr_t *h, uint64_t pos, char *dst, uint64_t len) {
  uint64_t off = pos % h->cap;
  uint64_t first = h->cap - off < len ? h->cap - off : len;
  memcpy(dst, ring_data(h) + off, first);
  if (first < len) memcpy(dst + first, ring_data(h), len - first);
}

} // namespace

extern "C" {

uint64_t ring_hdr_size() { return sizeof(ring_hdr_t); }

int ring_init(void *mem, uint64_t total_size) {
  if (total_size <= sizeof(ring_hdr_t)) return -1;
  ring_hdr_t *h = static_cast<ring_hdr_t *>(mem);
  memset(static_cast<void *>(h), 0, sizeof(*h));
  h->cap = total_size - sizeof(ring_hdr_t);
  return 0;
}

void ring_close(void *mem) {
  static_cast<ring_hdr_t *>(mem)->closed.store(
      1, std::memory_order_release);
}

/* Write one length-framed message; blocks while the ring is full.
 * Returns 0 on success, -1 if the message can never fit, -2 on timeout. */
long ring_write(void *mem, const void *buf, uint64_t len, long timeout_ms) {
  ring_hdr_t *h = static_cast<ring_hdr_t *>(mem);
  uint64_t need = len + 8;
  if (need > h->cap) return -1;
  long waited_us = 0, sleep_us = 50;
  for (;;) {
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    if (h->cap - (head - tail) >= need) {
      uint64_t le = len; /* little-endian hosts (x86/arm) */
      copy_in(h, head, reinterpret_cast<const char *>(&le), 8);
      copy_in(h, head + 8, static_cast<const char *>(buf), len);
      h->head.store(head + need, std::memory_order_release);
      return 0;
    }
    if (timeout_ms >= 0 && waited_us > timeout_ms * 1000) return -2;
    waited_us += sleep_us;
    sleep_us = ring_backoff(sleep_us);
  }
}

/* Length of the next pending message.
 * >=0 message ready; -1 closed+drained; -2 timeout (try again). */
long ring_next_len(void *mem, long timeout_ms) {
  ring_hdr_t *h = static_cast<ring_hdr_t *>(mem);
  long waited_us = 0, sleep_us = 50;
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head - tail >= 8) {
      uint64_t le;
      copy_out(h, tail, reinterpret_cast<char *>(&le), 8);
      return static_cast<long>(le);
    }
    if (h->closed.load(std::memory_order_acquire) &&
        h->head.load(std::memory_order_acquire) ==
            h->tail.load(std::memory_order_relaxed))
      return -1;
    if (timeout_ms >= 0 && waited_us > timeout_ms * 1000) return -2;
    waited_us += sleep_us;
    sleep_us = ring_backoff(sleep_us);
  }
}

/* Pop the next message into out (must hold ring_next_len() bytes). */
long ring_read(void *mem, void *out, uint64_t maxlen) {
  ring_hdr_t *h = static_cast<ring_hdr_t *>(mem);
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t head = h->head.load(std::memory_order_acquire);
  if (head - tail < 8) return -2;
  uint64_t le;
  copy_out(h, tail, reinterpret_cast<char *>(&le), 8);
  if (le > maxlen) return -1;
  copy_out(h, tail + 8, static_cast<char *>(out), le);
  h->tail.store(tail + 8 + le, std::memory_order_release);
  return static_cast<long>(le);
}

} /* extern "C" */
