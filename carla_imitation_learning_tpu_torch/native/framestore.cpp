// framestore — packed frame-log store and window-batch prefetcher, the
// host-side IO layer of the PyTorch port's streaming tier.
//
// Frames are packed once into a single binary file; training maps it
// zero-copy with mmap, and a multi-threaded prefetcher gathers 4-frame
// window batches into host buffers that the training loop copies to the
// card. The file format is the JAX package's, byte for byte, so either
// package reads the other's files. Unlike that package's reader, this one
// hands batches out in batch-index order for any thread count: a worker
// that finishes batch b early parks it in slot b % max_queue until the
// consumer has taken every batch before it.
//
// Layout (little endian):
//   header:  int64 magic 'TPUILFS2', int64 n, int64 h, int64 w
//   frames:  n*h*w uint8 (grayscale luminance)
//   actions: n int32
//   traffic: n int32
//   sensors: n*3 float32
//   commands:n int32
//   starts:  n uint8 — 1 where a frame BEGINS an episode/stream (v2 only).
//            The reader samples ONLY windows that lie within one episode
//            (no start flag strictly inside (i, i+frame_skip]), matching
//            data/pipeline.DeviceDataset's boundary masking. 'TPUILFS1'
//            files (no starts section) remain readable: every window valid.
//
// C ABI only (used from Python via ctypes — no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kMagicV1 = 0x3153464C49555054;  // "TPUILFS1"
constexpr int64_t kMagicV2 = 0x3253464C49555054;  // "TPUILFS2"

struct Header {
  int64_t magic;
  int64_t n, h, w;
};

struct Store {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
  const uint8_t* frames = nullptr;
  const int32_t* actions = nullptr;
  const int32_t* traffic = nullptr;
  const float* sensors = nullptr;
  const int32_t* commands = nullptr;
  const uint8_t* starts = nullptr;  // null for v1 files
};

size_t payload_size(int64_t n, int64_t h, int64_t w, bool v2) {
  return sizeof(Header) + (size_t)n * h * w + n * 4 + n * 4 + n * 12 + n * 4 +
         (v2 ? (size_t)n : 0);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// write / open / close
// ---------------------------------------------------------------------------

// starts may be null: a zero bitmap (single uninterrupted stream) is written.
int fs_write(const char* path, const uint8_t* frames, const int32_t* actions,
             const int32_t* traffic, const float* sensors,
             const int32_t* commands, const uint8_t* starts,
             int64_t n, int64_t h, int64_t w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  Header hdr{kMagicV2, n, h, w};
  bool ok = fwrite(&hdr, sizeof(hdr), 1, f) == 1 &&
            fwrite(frames, 1, (size_t)n * h * w, f) == (size_t)n * h * w &&
            fwrite(actions, 4, n, f) == (size_t)n &&
            fwrite(traffic, 4, n, f) == (size_t)n &&
            fwrite(sensors, 4, n * 3, f) == (size_t)n * 3 &&
            fwrite(commands, 4, n, f) == (size_t)n;
  if (ok) {
    if (starts) {
      ok = fwrite(starts, 1, n, f) == (size_t)n;
    } else {
      std::vector<uint8_t> zeros(n, 0);
      ok = fwrite(zeros.data(), 1, n, f) == (size_t)n;
    }
  }
  fclose(f);
  return ok ? 0 : -2;
}

void* fs_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) { close(fd); return nullptr; }
  auto* s = new Store();
  s->fd = fd;
  s->map = map;
  s->map_size = st.st_size;
  std::memcpy(&s->hdr, map, sizeof(Header));
  bool v2 = s->hdr.magic == kMagicV2;
  if ((s->hdr.magic != kMagicV1 && !v2) ||
      payload_size(s->hdr.n, s->hdr.h, s->hdr.w, v2) != (size_t)st.st_size) {
    munmap(map, st.st_size);
    close(fd);
    delete s;
    return nullptr;
  }
  const uint8_t* base = (const uint8_t*)map + sizeof(Header);
  int64_t n = s->hdr.n, h = s->hdr.h, w = s->hdr.w;
  s->frames = base;
  s->actions = (const int32_t*)(base + (size_t)n * h * w);
  s->traffic = s->actions + n;
  s->sensors = (const float*)(s->traffic + n);
  s->commands = (const int32_t*)(s->sensors + n * 3);
  s->starts = v2 ? (const uint8_t*)(s->commands + n) : nullptr;
  return s;
}

void fs_info(void* handle, int64_t* n, int64_t* h, int64_t* w) {
  auto* s = (Store*)handle;
  *n = s->hdr.n; *h = s->hdr.h; *w = s->hdr.w;
}

const uint8_t* fs_frames(void* handle) { return ((Store*)handle)->frames; }
const int32_t* fs_actions(void* handle) { return ((Store*)handle)->actions; }
const int32_t* fs_traffic(void* handle) { return ((Store*)handle)->traffic; }
const float* fs_sensors(void* handle) { return ((Store*)handle)->sensors; }
const int32_t* fs_commands(void* handle) { return ((Store*)handle)->commands; }
// null for TPUILFS1 files (no starts section)
const uint8_t* fs_starts(void* handle) { return ((Store*)handle)->starts; }

void fs_close(void* handle) {
  auto* s = (Store*)handle;
  if (s->map) munmap(s->map, s->map_size);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

// ---------------------------------------------------------------------------
// threaded window-batch prefetcher
//
// Produces batches of (frames f32 [B, fs, H, W] normalized to [0,1],
// labels i32 [B]) with label index = start + fs (the sequential-window
// contract). Worker threads fill a bounded queue of ready batches; the JAX
// loop pops without blocking on IO.
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<uint8_t> frames;  // raw uint8 windows — normalize on device
  std::vector<int32_t> labels;
};

struct Slot {
  int64_t index = -1;  // batch index held, -1 when empty
  Batch batch;
};

struct Reader {
  Store* store;
  int batch, frame_skip;
  uint64_t seed;
  bool shuffle;
  int64_t n_samples;
  std::vector<int64_t> order;
  std::atomic<int64_t> cursor{0};
  // slot b % max_queue holds batch b once built; only batches in
  // [next, next + max_queue) may be parked, so slots never collide
  std::vector<Slot> slots;
  int64_t next = 0;  // the batch the consumer takes next (guarded by mu)
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t max_queue;
  std::vector<std::thread> workers;
  bool stop = false;  // guarded by mu
  int64_t n_batches;

  void worker() {
    int64_t h = store->hdr.h, w = store->hdr.w;
    size_t fsz = (size_t)frame_skip * h * w;
    for (;;) {
      int64_t b = cursor.fetch_add(1);
      if (b >= n_batches) break;
      Batch out;
      out.frames.resize((size_t)batch * fsz);
      out.labels.resize(batch);
      for (int i = 0; i < batch; ++i) {
        int64_t sample = order[(b * batch + i) % n_samples];
        const uint8_t* src = store->frames + (size_t)sample * h * w;
        // raw window copy (4x less host work + H2D than f32; device divides)
        std::memcpy(out.frames.data() + (size_t)i * fsz, src, fsz);
        out.labels[i] = store->actions[sample + frame_skip];
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_push.wait(lock, [&] { return b < next + (int64_t)max_queue || stop; });
      if (stop) break;
      Slot& slot = slots[b % max_queue];
      slot.index = b;
      slot.batch = std::move(out);
      cv_pop.notify_all();
    }
  }
};

void* fs_reader_create(void* handle, int batch, int frame_skip, int n_threads,
                       int shuffle, uint64_t seed, int max_queue) {
  auto* s = (Store*)handle;
  auto* r = new Reader();
  r->store = s;
  r->batch = batch;
  r->frame_skip = frame_skip;
  r->shuffle = shuffle != 0;
  r->seed = seed;
  r->max_queue = max_queue > 0 ? max_queue : 4;
  r->slots.resize(r->max_queue);
  int64_t n_starts = s->hdr.n - frame_skip;
  if (n_starts <= 0 || batch <= 0 || n_threads <= 0) { delete r; return nullptr; }
  // valid window starts only: no episode-start flag strictly inside
  // (i, i+frame_skip] — windows and their labels never cross a boundary
  r->order.reserve(n_starts);
  for (int64_t i = 0; i < n_starts; ++i) {
    bool crosses = false;
    if (s->starts) {
      for (int d = 1; d <= frame_skip; ++d) {
        if (s->starts[i + d]) { crosses = true; break; }
      }
    }
    if (!crosses) r->order.push_back(i);
  }
  r->n_samples = (int64_t)r->order.size();
  if (r->n_samples <= 0) { delete r; return nullptr; }
  if (r->shuffle) {
    std::mt19937_64 rng(seed);
    std::shuffle(r->order.begin(), r->order.end(), rng);
  }
  r->n_batches = r->n_samples / batch;
  if (r->n_batches == 0) r->n_batches = 1;
  for (int t = 0; t < n_threads; ++t)
    r->workers.emplace_back([r] { r->worker(); });
  return r;
}

int64_t fs_reader_n_batches(void* reader) { return ((Reader*)reader)->n_batches; }

// Copies the next batch, in batch-index order, into caller buffers (frames:
// uint8). Returns 0 on success, 1 when the epoch is exhausted.
int fs_reader_next(void* reader, uint8_t* frames_out, int32_t* labels_out) {
  auto* r = (Reader*)reader;
  std::unique_lock<std::mutex> lock(r->mu);
  if (r->next >= r->n_batches) return 1;
  Slot& slot = r->slots[r->next % r->max_queue];
  r->cv_pop.wait(lock, [&] { return slot.index == r->next || r->stop; });
  if (r->stop) return 1;
  Batch b = std::move(slot.batch);
  slot.index = -1;
  ++r->next;
  r->cv_push.notify_all();
  lock.unlock();
  std::memcpy(frames_out, b.frames.data(), b.frames.size());
  std::memcpy(labels_out, b.labels.data(), b.labels.size() * 4);
  return 0;
}

// Safe mid-epoch: workers parked for their turn wake on stop and exit.
void fs_reader_destroy(void* reader) {
  auto* r = (Reader*)reader;
  {
    std::lock_guard<std::mutex> lock(r->mu);
    r->stop = true;
  }
  r->cv_push.notify_all();
  r->cv_pop.notify_all();
  for (auto& t : r->workers) t.join();
  delete r;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Self-test entry (built only for the sanitizer harness):
//   g++ -fsanitize=thread -DFS_TEST_MAIN framestore.cpp -o fs_tsan_test
//   ./fs_tsan_test <scratch file path>
// Exercises the writer and the multi-threaded reader under contention:
// every thread count yields the 1-thread batch sequence, and readers
// destroyed mid-epoch join cleanly. ThreadSanitizer reports any data race.
// ---------------------------------------------------------------------------
#ifdef FS_TEST_MAIN
#include <cstdlib>

static int read_epoch(void* s, int threads, int shuffle, uint64_t seed,
                      int64_t stop_after, std::vector<int32_t>* labels) {
  void* r = fs_reader_create(s, /*batch=*/8, /*frame_skip=*/4, threads,
                             shuffle, seed, /*max_queue=*/2);
  if (!r) return 4;
  std::vector<uint8_t> fbuf(8 * 4 * 16 * 16);
  std::vector<int32_t> lbuf(8);
  int64_t got = 0;
  while ((stop_after < 0 || got < stop_after) &&
         fs_reader_next(r, fbuf.data(), lbuf.data()) == 0) {
    labels->insert(labels->end(), lbuf.begin(), lbuf.end());
    ++got;
  }
  int rc = (stop_after < 0 && got != fs_reader_n_batches(r)) ? 5 : 0;
  fs_reader_destroy(r);
  return rc;
}

int main(int argc, char** argv) {
  if (argc < 2) return 1;
  const int64_t n = 200, h = 16, w = 16;
  std::vector<uint8_t> frames(n * h * w);
  std::vector<int32_t> actions(n), traffic(n), commands(n);
  std::vector<float> sensors(n * 3);
  std::vector<uint8_t> starts(n, 0);
  for (int64_t i = 0; i < n; ++i) actions[i] = (int32_t)i;  // label = sample id
  for (int64_t i = 0; i < n; i += 50) starts[i] = 1;  // episode boundaries
  const char* path = argv[1];
  if (fs_write(path, frames.data(), actions.data(), traffic.data(),
               sensors.data(), commands.data(), starts.data(), n, h, w) != 0)
    return 2;
  void* s = fs_open(path);
  if (!s) return 3;
  for (int round = 0; round < 3; ++round) {
    std::vector<int32_t> want;
    int rc = read_epoch(s, 1, 1, round, -1, &want);
    if (rc) return rc;
    for (int threads = 2; threads <= 4; ++threads) {
      std::vector<int32_t> got;
      rc = read_epoch(s, threads, 1, round, -1, &got);
      if (rc) return rc;
      if (got != want) return 6;
    }
    std::vector<int32_t> part;
    rc = read_epoch(s, 4, 1, round, 2, &part);  // destroyed mid-epoch
    if (rc) return rc;
  }
  fs_close(s);
  std::remove(path);
  return 0;
}
#endif
