// Shared-memory ring buffer: the feed path between an executor's feeder
// task and the trainer it forked, on one host.
//
// The port's own copy of the JAX package's ring.  A single-producer /
// single-consumer byte ring in POSIX shared memory carries whole chunks
// (pickled row lists, or columnar frames whose columns are memcpy'd in
// with one scatter-gather push) with no syscall on the fast path and no
// trip through the executor's manager process.  The layout and the
// message framing below are the JAX package's byte for byte, so a ring
// written by either package reads back in the other.
//
// Layout: Header | data[capacity]
//   head: next write offset (producer-owned), tail: next read offset
//   (consumer-owned); both are free-running uint64 counters mod capacity.
//   Each message: uint32 len | payload | padding to 8 bytes.
//   closed: producer sets when done (consumer drains then sees EOF).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <string>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x54464f53514d5631ull;  // "TFOSQMV1"

struct Header {
  uint64_t magic;
  uint64_t capacity;
  std::atomic<uint64_t> head;
  std::atomic<uint64_t> tail;
  std::atomic<uint32_t> closed;
  uint32_t _pad;
};

struct Queue {
  Header* h;
  uint8_t* data;
  size_t map_len;
  std::string name;
  std::vector<uint8_t> scratch;
  bool owner;
};

inline uint64_t align8(uint64_t n) { return (n + 7) & ~7ull; }

void sleep_us(unsigned us) {
  struct timespec ts {0, (long)us * 1000};
  nanosleep(&ts, nullptr);
}

}  // namespace

extern "C" {

Queue* shq_create(const char* name, uint64_t capacity) {
  capacity = align8(capacity);
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(Header) + capacity;
  if (ftruncate(fd, (off_t)len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* h = new (mem) Header();
  h->capacity = capacity;
  h->head.store(0);
  h->tail.store(0);
  h->closed.store(0);
  h->magic = kMagic;  // published last
  auto* q = new Queue{h, (uint8_t*)mem + sizeof(Header), len, name, {}, true};
  return q;
}

Queue* shq_open(const char* name, int timeout_ms) {
  int fd = -1;
  for (int waited = 0;; waited += 10) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    if (waited >= timeout_ms) return nullptr;
    sleep_us(10000);
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = (Header*)mem;
  for (int waited = 0; h->magic != kMagic; waited += 1) {
    if (waited > 1000) {
      munmap(mem, (size_t)st.st_size);
      return nullptr;
    }
    sleep_us(1000);
  }
  auto* q = new Queue{h, (uint8_t*)mem + sizeof(Header), (size_t)st.st_size,
                      name, {}, false};
  return q;
}

// 0 ok; -1 timeout; -2 closed; -3 message larger than capacity
int shq_push(Queue* q, const uint8_t* buf, uint64_t len, int timeout_ms) {
  Header* h = q->h;
  uint64_t need = align8(4 + len);
  if (need + 8 > h->capacity) return -3;
  int waited_us = 0;
  for (;;) {
    if (h->closed.load(std::memory_order_acquire)) return -2;
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    if (head + need - tail <= h->capacity - 8) {
      uint64_t off = head % h->capacity;
      uint32_t len32 = (uint32_t)len;
      // header word never wraps (8-byte alignment); payload may wrap
      memcpy(q->data + off, &len32, 4);
      uint64_t poff = (off + 4) % h->capacity;
      uint64_t first = std::min(len, h->capacity - poff);
      memcpy(q->data + poff, buf, first);
      if (first < len) memcpy(q->data, buf + first, len - first);
      h->head.store(head + need, std::memory_order_release);
      return 0;
    }
    if (timeout_ms >= 0 && waited_us / 1000 >= timeout_ms) return -1;
    sleep_us(waited_us < 2000 ? 50 : 500);
    waited_us += waited_us < 2000 ? 50 : 500;
  }
}

// Scatter-gather push: one reservation, each segment memcpy'd straight
// from its source buffer (e.g. numpy column data) into the ring — no
// python-side assembly of a contiguous message.  Same returns as
// shq_push.
int shq_push_iov(Queue* q, const uint8_t** bufs, const uint64_t* lens,
                 int n, int timeout_ms) {
  Header* h = q->h;
  uint64_t len = 0;
  for (int i = 0; i < n; i++) len += lens[i];
  uint64_t need = align8(4 + len);
  if (need + 8 > h->capacity) return -3;
  int waited_us = 0;
  for (;;) {
    if (h->closed.load(std::memory_order_acquire)) return -2;
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    if (head + need - tail <= h->capacity - 8) {
      uint64_t off = head % h->capacity;
      uint32_t len32 = (uint32_t)len;
      memcpy(q->data + off, &len32, 4);
      uint64_t poff = (off + 4) % h->capacity;
      for (int i = 0; i < n; i++) {
        uint64_t first = std::min(lens[i], h->capacity - poff);
        memcpy(q->data + poff, bufs[i], first);
        if (first < lens[i]) memcpy(q->data, bufs[i] + first, lens[i] - first);
        poff = (poff + lens[i]) % h->capacity;
      }
      h->head.store(head + need, std::memory_order_release);
      return 0;
    }
    if (timeout_ms >= 0 && waited_us / 1000 >= timeout_ms) return -1;
    sleep_us(waited_us < 2000 ? 50 : 500);
    waited_us += waited_us < 2000 ? 50 : 500;
  }
}

// Wait for the next message and return its length WITHOUT consuming it
// (-1 timeout, -2 EOF).  Pair with shq_pop_into to copy the payload
// directly into a caller-owned buffer: one copy on the consumer side,
// vs pop-to-scratch + a python-level copy.
int64_t shq_peek_len(Queue* q, int timeout_ms) {
  Header* h = q->h;
  int waited_us = 0;
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head != tail) {
      uint32_t len32;
      memcpy(&len32, q->data + (tail % h->capacity), 4);
      return (int64_t)len32;
    }
    if (h->closed.load(std::memory_order_acquire)) return -2;
    if (timeout_ms >= 0 && waited_us / 1000 >= timeout_ms) return -1;
    sleep_us(waited_us < 2000 ? 50 : 500);
    waited_us += waited_us < 2000 ? 50 : 500;
  }
}

// Copy the pending message's payload into dst (size from shq_peek_len)
// and consume it.  Returns the length, or -1 if no message is pending
// (misuse: call only after a successful shq_peek_len).
int64_t shq_pop_into(Queue* q, uint8_t* dst) {
  Header* h = q->h;
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t head = h->head.load(std::memory_order_acquire);
  if (head == tail) return -1;
  uint64_t off = tail % h->capacity;
  uint32_t len32;
  memcpy(&len32, q->data + off, 4);
  uint64_t poff = (off + 4) % h->capacity;
  uint64_t first = std::min((uint64_t)len32, h->capacity - poff);
  memcpy(dst, q->data + poff, first);
  if (first < len32) memcpy(dst + first, q->data, len32 - first);
  h->tail.store(tail + align8(4 + len32), std::memory_order_release);
  return (int64_t)len32;
}

// >=0: message length (0 = legitimately empty payload) copied into
// internal scratch (get via shq_buffer); -1: timeout; -2: EOF (closed and
// drained).
int64_t shq_pop(Queue* q, int timeout_ms) {
  Header* h = q->h;
  int waited_us = 0;
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head != tail) {
      uint64_t off = tail % h->capacity;
      uint32_t len32;
      memcpy(&len32, q->data + off, 4);
      q->scratch.resize(len32);
      uint64_t poff = (off + 4) % h->capacity;
      uint64_t first = std::min((uint64_t)len32, h->capacity - poff);
      memcpy(q->scratch.data(), q->data + poff, first);
      if (first < len32)
        memcpy(q->scratch.data() + first, q->data, len32 - first);
      h->tail.store(tail + align8(4 + len32), std::memory_order_release);
      return (int64_t)len32;
    }
    if (h->closed.load(std::memory_order_acquire)) return -2;
    if (timeout_ms >= 0 && waited_us / 1000 >= timeout_ms) return -1;
    sleep_us(waited_us < 2000 ? 50 : 500);
    waited_us += waited_us < 2000 ? 50 : 500;
  }
}

const uint8_t* shq_buffer(Queue* q) { return q->scratch.data(); }

void shq_close_write(Queue* q) {
  q->h->closed.store(1, std::memory_order_release);
}

uint64_t shq_size(Queue* q) {
  return q->h->head.load() - q->h->tail.load();
}

void shq_free(Queue* q) {
  bool owner = q->owner;
  std::string name = q->name;
  munmap((void*)((uint8_t*)q->h), q->map_len);
  if (owner) shm_unlink(name.c_str());
  delete q;
}

}  // extern "C"
