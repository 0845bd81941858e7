// The port's copy of uda_tpu/native/reader.cc (same C ABI; UDA_TPU_READ_POOL=pool
// forces the worker pool on a host that grants io_uring).
// Native reader pool: async segment reads with batch completion.
//
// C++ equivalent of the reference's AIOHandler (libaio wrapper with a
// completion thread, reference src/CommUtils/AIOHandler.cc:80-235) and
// of the per-disk thread-pool reader in the orphaned AsyncIO/ directory
// (reference src/AsyncIO/AsyncReaderManager.cc:16-50, AsyncReaderThread.cc
// :36-86 — compiled but never wired; here the capability IS wired, into
// uda_tpu_torch.mofserver.data_engine).
//
// Two backends behind ONE submit/get_events ABI (PARITY C15):
//
//  - io_uring (backend 1): compiled in when the build host carries the
//    uapi header (<linux/io_uring.h>), selected at pool creation only
//    when the RUNNING kernel accepts io_uring_setup — a 4.4-class host
//    gets ENOSYS and silently takes the worker pool. One ring doorbell
//    submits a whole batch of reads (the RDMAbox batched-submission
//    lesson, arXiv:2104.12197); a reaper thread drains CQEs into the
//    same completion queue uda_pool_get_events serves.
//  - worker pool (backend 0): plain pread worker threads + a completion
//    queue (the io_getevents analogue, same min_nr/timeout shape as
//    AIOHandler.cc:152-235). uda_pool_submit_batch still amortizes the
//    lock round and wakes workers once per batch.

#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <errno.h>
#include <unistd.h>

#if defined(__linux__) && defined(__has_include)
#if __has_include(<linux/io_uring.h>)
#define UDA_HAVE_IOURING 1
#include <linux/io_uring.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_enter
#define __NR_io_uring_enter 426
#endif
#endif
#endif

namespace {

struct Job {
  int fd;
  int64_t offset;
  int64_t len;
  uint8_t* dst;
  uint64_t tag;
};

struct Event {
  uint64_t tag;
  int64_t result;  // bytes read, or -errno
};

#ifdef UDA_HAVE_IOURING

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
  return static_cast<int>(
      syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
              nullptr, 0));
}

// Minimal raw-syscall ring (no liburing dependency — the image bakes in
// no extra libraries). SQ/CQ mmaps + release/acquire on the shared
// head/tail indices, IORING_OP_READV SQEs (5.1+, the widest-supported
// read op) with one heap iovec per in-flight job.
struct Ring {
  int fd = -1;
  unsigned entries = 0;
  void* sq_ptr = nullptr;
  size_t sq_len = 0;
  void* cq_ptr = nullptr;
  size_t cq_len = 0;
  struct io_uring_sqe* sqes = nullptr;
  size_t sqes_len = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  struct io_uring_cqe* cqes = nullptr;

  bool init(unsigned want_entries) {
    struct io_uring_params p;
    std::memset(&p, 0, sizeof(p));
    fd = sys_io_uring_setup(want_entries, &p);
    if (fd < 0) return false;  // ENOSYS/EPERM: the worker pool serves
    entries = p.sq_entries;
    sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
    bool single_mmap = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
    if (single_mmap && cq_len > sq_len) sq_len = cq_len;
    sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) { sq_ptr = nullptr; return false; }
    if (single_mmap) {
      cq_ptr = sq_ptr;
      cq_len = 0;  // owned by the sq mapping
    } else {
      cq_ptr = mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
      if (cq_ptr == MAP_FAILED) { cq_ptr = nullptr; return false; }
    }
    sqes_len = p.sq_entries * sizeof(struct io_uring_sqe);
    sqes = static_cast<struct io_uring_sqe*>(
        mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES));
    if (sqes == MAP_FAILED) { sqes = nullptr; return false; }
    char* sq = static_cast<char*>(sq_ptr);
    sq_head = reinterpret_cast<unsigned*>(sq + p.sq_off.head);
    sq_tail = reinterpret_cast<unsigned*>(sq + p.sq_off.tail);
    sq_mask = reinterpret_cast<unsigned*>(sq + p.sq_off.ring_mask);
    sq_array = reinterpret_cast<unsigned*>(sq + p.sq_off.array);
    char* cq = static_cast<char*>(cq_ptr);
    cq_head = reinterpret_cast<unsigned*>(cq + p.cq_off.head);
    cq_tail = reinterpret_cast<unsigned*>(cq + p.cq_off.tail);
    cq_mask = reinterpret_cast<unsigned*>(cq + p.cq_off.ring_mask);
    cqes = reinterpret_cast<struct io_uring_cqe*>(cq + p.cq_off.cqes);
    return true;
  }

  void destroy() {
    if (sqes) munmap(sqes, sqes_len);
    if (cq_ptr && cq_ptr != sq_ptr && cq_len) munmap(cq_ptr, cq_len);
    if (sq_ptr) munmap(sq_ptr, sq_len);
    if (fd >= 0) close(fd);
    fd = -1;
  }

  // caller holds the pool mutex; returns false when the SQ is full
  bool push_sqe(uint8_t opcode, int job_fd, const void* addr,
                unsigned len, int64_t off, uint64_t user_data) {
    unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
    unsigned tail = *sq_tail;
    if (tail - head >= entries) return false;
    unsigned idx = tail & *sq_mask;
    struct io_uring_sqe* sqe = &sqes[idx];
    std::memset(sqe, 0, sizeof(*sqe));
    sqe->opcode = opcode;
    sqe->fd = job_fd;
    sqe->addr = reinterpret_cast<uint64_t>(addr);
    sqe->len = len;
    sqe->off = static_cast<uint64_t>(off);
    sqe->user_data = user_data;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    return true;
  }
};

#endif  // UDA_HAVE_IOURING

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> jobs;
  std::deque<Event> events;
  std::mutex mu;
  std::condition_variable job_cv;
  std::condition_variable event_cv;
  bool stopping = false;
  int backend = 0;  // 0 = worker pool, 1 = io_uring

#ifdef UDA_HAVE_IOURING
  Ring ring;
  std::thread reaper;
  // tag -> iovec kept alive until its CQE lands (READV semantics)
  std::unordered_map<uint64_t, struct iovec*> iovs;
  static constexpr uint64_t kStopTag = ~0ull;

  // caller holds mu; falls back to a synchronous pread when the SQ is
  // full (bounded by the server's batch cap, so effectively never).
  // Returns whether an SQE was actually pushed — the caller must ring
  // the doorbell for exactly the pushed count (io_uring_enter consumes
  // only real SQEs; over-asking would spin forever on r == 0).
  bool ring_submit_locked(const Job& job) {
    struct iovec* iov = new struct iovec;
    iov->iov_base = job.dst;
    iov->iov_len = static_cast<size_t>(job.len);
    if (!ring.push_sqe(IORING_OP_READV, job.fd, iov, 1, job.offset,
                       job.tag)) {
      delete iov;
      sync_read_locked(job);
      return false;
    }
    iovs[job.tag] = iov;
    return true;
  }

  void ring_doorbell(unsigned n) {
    // outside mu: the kernel copies SQEs on enter, the reaper owns CQs
    while (n > 0) {
      int r = sys_io_uring_enter(ring.fd, n, 0, 0);
      if (r < 0) {
        if (errno == EINTR) continue;
        // the ring died under us (should not happen post-init): fail
        // every in-flight tag so no waiter hangs
        std::lock_guard<std::mutex> lk(mu);
        for (auto& kv : iovs) {
          delete kv.second;
          events.push_back(Event{kv.first, -EIO});
        }
        iovs.clear();
        event_cv.notify_all();
        return;
      }
      n -= static_cast<unsigned>(r);
    }
  }

  void reap() {
    for (;;) {
      int r = sys_io_uring_enter(ring.fd, 0, 1, IORING_ENTER_GETEVENTS);
      if (r < 0 && errno != EINTR) return;
      bool saw_stop = false;
      {
        std::lock_guard<std::mutex> lk(mu);
        unsigned head = *ring.cq_head;
        unsigned tail = __atomic_load_n(ring.cq_tail, __ATOMIC_ACQUIRE);
        while (head != tail) {
          struct io_uring_cqe* cqe = &ring.cqes[head & *ring.cq_mask];
          if (cqe->user_data == kStopTag) {
            saw_stop = true;
          } else {
            auto it = iovs.find(cqe->user_data);
            if (it != iovs.end()) {
              delete it->second;
              iovs.erase(it);
              events.push_back(Event{cqe->user_data,
                                     static_cast<int64_t>(cqe->res)});
            }
            // unknown tag: already failed by the doorbell error path
            // (synthetic -EIO) — a late real CQE must not produce a
            // DUPLICATE event for a tag the consumer settled
          }
          ++head;
        }
        __atomic_store_n(ring.cq_head, head, __ATOMIC_RELEASE);
      }
      event_cv.notify_all();
      if (saw_stop) return;
    }
  }
#endif  // UDA_HAVE_IOURING

  // caller holds mu: a read executed inline (SQ overflow spill), its
  // completion pushed directly
  void sync_read_locked(const Job& job) {
    int64_t done = 0;
    int64_t result = 0;
    while (done < job.len) {
      ssize_t r = pread(job.fd, job.dst + done,
                        static_cast<size_t>(job.len - done),
                        static_cast<off_t>(job.offset + done));
      if (r < 0) {
        if (errno == EINTR) continue;
        result = -static_cast<int64_t>(errno);
        break;
      }
      if (r == 0) break;  // EOF
      done += r;
    }
    if (result == 0) result = done;
    events.push_back(Event{job.tag, result});
    event_cv.notify_all();
  }

  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        job_cv.wait(lk, [&] { return stopping || !jobs.empty(); });
        if (stopping && jobs.empty()) return;
        job = jobs.front();
        jobs.pop_front();
      }
      int64_t done = 0;
      int64_t result = 0;
      while (done < job.len) {
        ssize_t r = pread(job.fd, job.dst + done,
                          static_cast<size_t>(job.len - done),
                          static_cast<off_t>(job.offset + done));
        if (r < 0) {
          if (errno == EINTR) continue;
          result = -static_cast<int64_t>(errno);
          break;
        }
        if (r == 0) break;  // EOF
        done += r;
      }
      if (result == 0) result = done;
      {
        std::lock_guard<std::mutex> lk(mu);
        events.push_back(Event{job.tag, result});
      }
      event_cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* uda_pool_create(int threads) {
  if (threads < 1) threads = 1;
  Pool* p = new Pool();
#ifdef UDA_HAVE_IOURING
  // the io_uring rung: taken only when the RUNNING kernel accepts the
  // setup syscall (compiled-in != available; 4.4-class hosts land in
  // the worker pool below). UDA_TPU_READ_POOL=pool skips the ring, so
  // a host that grants it can still run (and test) the worker pool.
  const char* force = getenv("UDA_TPU_READ_POOL");
  bool ring_ok = !(force && strcmp(force, "pool") == 0);
  if (ring_ok && p->ring.init(1024)) {
    p->backend = 1;
    p->reaper = std::thread([p] { p->reap(); });
    return p;
  }
  p->ring.destroy();
#endif
  for (int i = 0; i < threads; ++i) {
    p->workers.emplace_back([p] { p->worker(); });
  }
  return p;
}

void uda_pool_destroy(void* pool) {
  Pool* p = static_cast<Pool*>(pool);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
#ifdef UDA_HAVE_IOURING
  if (p->backend == 1) {
    // wake the reaper blocked in GETEVENTS with a NOP completion; a
    // full SQ drains as in-flight reads complete, so retry-until-push
    // terminates
    for (;;) {
      {
        std::lock_guard<std::mutex> lk(p->mu);
        if (p->ring.push_sqe(IORING_OP_NOP, -1, nullptr, 0, 0,
                             Pool::kStopTag)) {
          break;
        }
      }
      usleep(1000);
    }
    p->ring_doorbell(1);
    if (p->reaper.joinable()) p->reaper.join();
    for (auto& kv : p->iovs) delete kv.second;
    p->iovs.clear();
    p->ring.destroy();
    delete p;
    return;
  }
#endif
  p->job_cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// 0 = pread worker pool, 1 = io_uring — which rung of the PARITY C15
// ladder this pool actually runs (the Python side records it as the
// io.backend metric label).
int uda_pool_backend(void* pool) {
  return static_cast<Pool*>(pool)->backend;
}

int uda_pool_submit(void* pool, int fd, int64_t offset, int64_t len,
                    uint8_t* dst, uint64_t tag) {
  Pool* p = static_cast<Pool*>(pool);
#ifdef UDA_HAVE_IOURING
  unsigned pushed = 0;
#endif
  {
    std::lock_guard<std::mutex> lk(p->mu);
    if (p->stopping) return -1;
#ifdef UDA_HAVE_IOURING
    if (p->backend == 1) {
      if (p->ring_submit_locked(Job{fd, offset, len, dst, tag})) {
        pushed = 1;
      }
    } else {
      p->jobs.push_back(Job{fd, offset, len, dst, tag});
    }
#else
    p->jobs.push_back(Job{fd, offset, len, dst, tag});
#endif
  }
#ifdef UDA_HAVE_IOURING
  if (p->backend == 1) {
    if (pushed) p->ring_doorbell(pushed);
    return 0;
  }
#endif
  p->job_cv.notify_one();
  return 0;
}

// Batched submission (the C15 submit_batch half): N reads enter under
// ONE lock round and ONE doorbell/notify — io_uring submits the whole
// SQE span with a single io_uring_enter, the worker pool enqueues all
// jobs then wakes every worker once. Per-job isolation is the event
// contract: each tag completes (or fails) independently.
int uda_pool_submit_batch(void* pool, int n, const int32_t* fds,
                          const int64_t* offsets, const int64_t* lens,
                          uint8_t* const* dsts, const uint64_t* tags) {
  Pool* p = static_cast<Pool*>(pool);
  if (n <= 0) return 0;
#ifdef UDA_HAVE_IOURING
  unsigned pushed = 0;
#endif
  {
    std::lock_guard<std::mutex> lk(p->mu);
    if (p->stopping) return -1;
    for (int i = 0; i < n; ++i) {
      Job job{fds[i], offsets[i], lens[i], dsts[i], tags[i]};
#ifdef UDA_HAVE_IOURING
      if (p->backend == 1) {
        if (p->ring_submit_locked(job)) ++pushed;
        continue;
      }
#endif
      p->jobs.push_back(job);
    }
  }
#ifdef UDA_HAVE_IOURING
  if (p->backend == 1) {
    // the doorbell rings for the SQEs actually pushed — spilled jobs
    // already completed synchronously under the lock
    if (pushed) p->ring_doorbell(pushed);
    return 0;
  }
#endif
  p->job_cv.notify_all();
  return 0;
}

// Drain completions: blocks until >= min_events are available or the
// timeout (seconds) elapses; returns the number written to out_*.
int uda_pool_get_events(void* pool, uint64_t* out_tags, int64_t* out_results,
                        int max_events, int min_events, double timeout_s) {
  Pool* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> lk(p->mu);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                      std::chrono::duration<double>(timeout_s));
  p->event_cv.wait_until(lk, deadline, [&] {
    return static_cast<int>(p->events.size()) >= min_events || p->stopping;
  });
  int n = 0;
  while (n < max_events && !p->events.empty()) {
    out_tags[n] = p->events.front().tag;
    out_results[n] = p->events.front().result;
    p->events.pop_front();
    ++n;
  }
  return n;
}

}  // extern "C"
