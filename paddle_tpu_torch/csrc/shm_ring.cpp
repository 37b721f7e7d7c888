// Shared-memory SPSC ring buffer for DataLoader worker -> trainer batch
// transport.
//
// The port's copy of the repository's csrc/shm_ring.cpp. Equivalent of
// the reference's native DataLoader transport
// (reference: paddle/fluid/memory/allocation/mmap_allocator.cc — worker
// processes place LoDTensor payloads in shared memory and pass only
// handles through the queue; operators/reader/buffered_reader.cc does the
// staging). Python multiprocessing queues pickle the full batch through a
// pipe (two copies + syscall per chunk); this ring memcpys payload bytes
// into POSIX shared memory once, and only tiny metadata rides the queue.
//
// This copy also reserves a ring's pages when it is made
// (posix_fallocate).
//
// Design: one ring per worker, single producer (the worker) / single
// consumer (the trainer process) — head/tail are C++11 atomics, no locks.
// Layout: [header: capacity, head, tail][data bytes]. All functions are
// exported with C linkage for ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libshm_ring.so shm_ring.cpp -lrt
// (paddle_tpu_torch/core/shm_ring.py builds this on demand).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

struct RingHeader {
  int64_t capacity;                 // data bytes (power of two not required)
  std::atomic<int64_t> head;        // consumer position (monotonic)
  std::atomic<int64_t> tail;        // producer position (monotonic)
};

inline char* data_of(RingHeader* h) {
  return reinterpret_cast<char*>(h) + sizeof(RingHeader);
}

inline int64_t used(const RingHeader* h) {
  return h->tail.load(std::memory_order_acquire) -
         h->head.load(std::memory_order_acquire);
}

void copy_in(RingHeader* h, int64_t pos, const char* src, int64_t n) {
  const int64_t cap = h->capacity;
  const int64_t off = pos % cap;
  const int64_t first = (off + n <= cap) ? n : cap - off;
  std::memcpy(data_of(h) + off, src, first);
  if (n > first) std::memcpy(data_of(h), src + first, n - first);
}

void copy_out(RingHeader* h, int64_t pos, char* dst, int64_t n) {
  const int64_t cap = h->capacity;
  const int64_t off = pos % cap;
  const int64_t first = (off + n <= cap) ? n : cap - off;
  std::memcpy(dst, data_of(h) + off, first);
  if (n > first) std::memcpy(dst + first, data_of(h), n - first);
}

void nap() {
  timespec ts{0, 200 * 1000};  // 200us
  nanosleep(&ts, nullptr);
}

}  // namespace

extern "C" {

// Create (trainer side) or open (worker side) a named ring. Returns the
// mapped base pointer, or 0 on failure.
void* shm_ring_create(const char* name, int64_t capacity) {
  shm_unlink(name);  // stale ring from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  const int64_t total = sizeof(RingHeader) + capacity;
  // reserve the pages now, so a /dev/shm too small for the ring fails
  // here and not with SIGBUS in a producer's later write
  if (ftruncate(fd, total) != 0 || posix_fallocate(fd, 0, total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* h = new (base) RingHeader();
  h->capacity = capacity;
  h->head.store(0);
  h->tail.store(0);
  return base;
}

void* shm_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                    fd, 0);
  close(fd);
  return base == MAP_FAILED ? nullptr : base;
}

// Blocking push of exactly n bytes. Returns 0, or -1 after ~timeout_ms of
// the consumer not draining.
int shm_ring_push(void* base, const char* src, int64_t n, int64_t timeout_ms) {
  auto* h = static_cast<RingHeader*>(base);
  if (n > h->capacity) return -2;  // payload larger than the ring
  int64_t waited_us = 0;
  while (h->capacity - used(h) < n) {
    nap();
    waited_us += 200;
    if (timeout_ms >= 0 && waited_us > timeout_ms * 1000) return -1;
  }
  const int64_t pos = h->tail.load(std::memory_order_relaxed);
  copy_in(h, pos, src, n);
  h->tail.store(pos + n, std::memory_order_release);
  return 0;
}

// Blocking pop of exactly n bytes (the size arrives via the metadata
// queue). Returns 0, or -1 on timeout.
int shm_ring_pop(void* base, char* dst, int64_t n, int64_t timeout_ms) {
  auto* h = static_cast<RingHeader*>(base);
  if (n > h->capacity) return -2;
  int64_t waited_us = 0;
  while (used(h) < n) {
    nap();
    waited_us += 200;
    if (timeout_ms >= 0 && waited_us > timeout_ms * 1000) return -1;
  }
  const int64_t pos = h->head.load(std::memory_order_relaxed);
  copy_out(h, pos, dst, n);
  h->head.store(pos + n, std::memory_order_release);
  return 0;
}

int64_t shm_ring_capacity(void* base) {
  return static_cast<RingHeader*>(base)->capacity;
}

int64_t shm_ring_used(void* base) {
  return used(static_cast<RingHeader*>(base));
}

void shm_ring_close(void* base) {
  auto* h = static_cast<RingHeader*>(base);
  munmap(base, sizeof(RingHeader) + h->capacity);
}

void shm_ring_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
