// POSIX shared-memory frame ring: the cross-process ingest transport.
//
// TPU-native equivalent of the reference's Win32 shared-memory protocol —
// named mutex + file mapping + ServerWriteOver/ClientReadOver events with a
// DatePacket header feeding BGR24 frames from one GetFromRtsp.exe producer per
// camera (reference stitching_sharemem.h:9-48, stitching_sharemem.cpp:22-123,
// producer spawn 64-bit driver stitching_detailed.cpp:785-793).
//
// Redesign rather than translation: a lock-free single-producer ring with a
// process-shared mutex/condvar only for consumer wakeup, N slots deep so a
// slow consumer never stalls the producer (the reference's INFINITE wait on a
// dead producer hangs its pipeline — SURVEY §5.3; here consume() takes a
// timeout and returns -1).
//
// C ABI via ctypes (native/build.py).
//
// The JAX package's stitchingvideo_tpu/native/sharemem.cpp with the same C
// ABI and ring layout (either package's processes share a ring), except the
// wait in shm_ring_consume: it polls `head` until its deadline and takes
// neither the mutex nor the condition variable. A producer killed while it
// held either (inside shm_ring_publish's broadcast) left a consumer that
// waited on them blocked for ever. The producer still broadcasts, for
// consumers that wait on the condition variable.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0x53544954434852ULL;  // "STITCHR"

struct RingHeader {
  uint64_t magic;
  int32_t width, height, channels, slots;
  int64_t frame_bytes;
  std::atomic<int64_t> head;     // sequence number of next slot to write
  pthread_mutex_t mu;
  pthread_cond_t cv;
  // per-slot sequence stamps follow (int64 x slots), then slot data
};

struct Handle {
  RingHeader* hdr = nullptr;
  size_t map_bytes = 0;
  char name[256] = {0};
  bool owner = false;

  int64_t* slot_seq() { return reinterpret_cast<int64_t*>(hdr + 1); }
  uint8_t* slot_data(int s) {
    return reinterpret_cast<uint8_t*>(slot_seq() + hdr->slots) +
           (size_t)s * hdr->frame_bytes;
  }
};

size_t total_bytes(int w, int h, int c, int slots) {
  return sizeof(RingHeader) + sizeof(int64_t) * slots +
         (size_t)w * h * c * slots;
}

}  // namespace

extern "C" {

// Create (producer side). Name like "/stitch_cam0".
void* shm_ring_create(const char* name, int width, int height, int channels,
                      int slots) {
  size_t bytes = total_bytes(width, height, channels, slots);
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)bytes) != 0) { close(fd); shm_unlink(name); return nullptr; }
  void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) { shm_unlink(name); return nullptr; }

  auto* h = new Handle();
  h->hdr = reinterpret_cast<RingHeader*>(p);
  h->map_bytes = bytes;
  h->owner = true;
  strncpy(h->name, name, sizeof(h->name) - 1);

  auto* hdr = h->hdr;
  hdr->width = width; hdr->height = height; hdr->channels = channels;
  hdr->slots = slots;
  hdr->frame_bytes = (int64_t)width * height * channels;
  hdr->head.store(0);
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutex_init(&hdr->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->cv, &ca);
  for (int s = 0; s < slots; ++s) h->slot_seq()[s] = -1;
  std::atomic_thread_fence(std::memory_order_release);
  hdr->magic = MAGIC;
  return h;
}

// Open (consumer side). Returns nullptr if missing/not yet initialized.
void* shm_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(RingHeader)) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                 MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  auto* hdr = reinterpret_cast<RingHeader*>(p);
  if (hdr->magic != MAGIC) { munmap(p, (size_t)st.st_size); return nullptr; }
  auto* h = new Handle();
  h->hdr = hdr;
  h->map_bytes = (size_t)st.st_size;
  strncpy(h->name, name, sizeof(h->name) - 1);
  return h;
}

// info_out: [width, height, channels, slots]
int shm_ring_info(void* vh, int* info_out) {
  auto* h = static_cast<Handle*>(vh);
  if (!h || !h->hdr) return -1;
  info_out[0] = h->hdr->width;
  info_out[1] = h->hdr->height;
  info_out[2] = h->hdr->channels;
  info_out[3] = h->hdr->slots;
  return 0;
}

// Producer: publish one frame (data must be frame_bytes long). seq is the
// caller's frame counter (monotonic); pass -1 to auto-increment.
int shm_ring_publish(void* vh, uint8_t* data, int64_t nbytes, int64_t seq) {
  auto* h = static_cast<Handle*>(vh);
  auto* hdr = h->hdr;
  if (nbytes != hdr->frame_bytes) return -1;
  int64_t next = (seq >= 0) ? seq : hdr->head.load(std::memory_order_relaxed);
  int slot = (int)(next % hdr->slots);
  h->slot_seq()[slot] = -1;  // mark in-flight
  std::atomic_thread_fence(std::memory_order_release);
  memcpy(h->slot_data(slot), data, (size_t)nbytes);
  std::atomic_thread_fence(std::memory_order_release);
  h->slot_seq()[slot] = next;
  hdr->head.store(next + 1, std::memory_order_release);
  pthread_mutex_lock(&hdr->mu);
  pthread_cond_broadcast(&hdr->cv);
  pthread_mutex_unlock(&hdr->mu);
  return 0;
}

// Consumer: copy the newest frame with seq > last_seq into buf.
// Returns the frame's seq, or -1 on timeout (dead/slow producer does not
// hang the pipeline). Between looks at the ring it sleeps POLL_NS; it never
// blocks on anything a producer holds.
int64_t shm_ring_consume(void* vh, uint8_t* buf, int64_t nbytes,
                         int64_t* last_seq, double timeout_s) {
  constexpr long POLL_NS = 200000;  // 0.2 ms: the most a new frame waits
  auto* h = static_cast<Handle*>(vh);
  auto* hdr = h->hdr;
  if (nbytes != hdr->frame_bytes) return -1;

  struct timespec deadline;
  clock_gettime(CLOCK_MONOTONIC, &deadline);
  deadline.tv_sec += (time_t)timeout_s;
  deadline.tv_nsec += (long)((timeout_s - (time_t)timeout_s) * 1e9);
  if (deadline.tv_nsec >= 1000000000L) { deadline.tv_sec++; deadline.tv_nsec -= 1000000000L; }

  while (true) {
    int64_t head = hdr->head.load(std::memory_order_acquire);
    int64_t newest = head - 1;
    if (newest > *last_seq) {
      int slot = (int)(newest % hdr->slots);
      // read, then verify the slot wasn't overwritten mid-copy
      for (int attempt = 0; attempt < 4; ++attempt) {
        int64_t s0 = h->slot_seq()[slot];
        if (s0 < 0) break;
        std::atomic_thread_fence(std::memory_order_acquire);
        memcpy(buf, h->slot_data(slot), (size_t)nbytes);
        std::atomic_thread_fence(std::memory_order_acquire);
        if (h->slot_seq()[slot] == s0) {
          *last_seq = s0;
          return s0;
        }
        newest = hdr->head.load(std::memory_order_acquire) - 1;
        slot = (int)(newest % hdr->slots);
      }
    }
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    if (now.tv_sec > deadline.tv_sec ||
        (now.tv_sec == deadline.tv_sec && now.tv_nsec >= deadline.tv_nsec))
      return -1;
    struct timespec pause = {0, POLL_NS};
    nanosleep(&pause, nullptr);
  }
}

void shm_ring_close(void* vh, int unlink_it) {
  auto* h = static_cast<Handle*>(vh);
  if (!h) return;
  if (h->hdr) munmap(h->hdr, h->map_bytes);
  if (unlink_it && h->name[0]) shm_unlink(h->name);
  delete h;
}

}  // extern "C"
