// framecache — native video-frame cache + prefetching batch sampler.
//
// The PyTorch port's own copy of recurrent_flows_tpu/native/framecache.cpp
// (same blob format, same sampling). It replaces the reference's CPU
// DataLoader workers (RFN/trainer.py:155-161 num_workers processes decoding
// PNGs per item): frames are converted once into a single mmap'd uint8 blob; steady-state
// batch sampling is pure C++ — random (video, window) selection, memcpy
// into a preallocated ring of pinned host buffers filled by a background
// prefetch thread, so Python only hands out ready batches.
//
// Blob layout (little endian):
//   u64 magic 0x46434231 ("FCB1")
//   u64 n_videos, u64 h, u64 w, u64 c
//   per video: u64 offset (bytes, from data start), u64 n_frames
//   data: uint8 frames, each h*w*c bytes, videos contiguous.
//
// C API (ctypes): fc_open / fc_close / fc_num_videos / fc_sample_batch /
// fc_prefetch_start / fc_next_batch / fc_prefetch_stop.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x46434231ULL;

struct VideoIndex {
  uint64_t offset;
  uint64_t n_frames;
};

struct RingBuffer {
  std::vector<uint8_t> data;
  bool ready = false;
};

struct Cache {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_videos = 0, h = 0, w = 0, c = 0;
  const VideoIndex* index = nullptr;
  const uint8_t* data = nullptr;

  // prefetch state
  std::thread worker;
  std::vector<RingBuffer> ring;
  size_t ring_read = 0, ring_write = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop{false};
  uint64_t pf_batch = 0, pf_seq = 0, pf_seed = 0;
};

size_t frame_bytes(const Cache* cc) { return cc->h * cc->w * cc->c; }

void sample_into(Cache* cc, uint64_t seed, uint64_t batch, uint64_t seq_len,
                 uint8_t* out) {
  const size_t fb = frame_bytes(cc);
  const size_t item_bytes = seq_len * fb;
  // parallel copy across items
  unsigned n_threads = std::min<unsigned>(std::thread::hardware_concurrency(),
                                          (unsigned)batch);
  if (n_threads == 0) n_threads = 1;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    threads.emplace_back([=]() {
      std::mt19937_64 rng(seed * 1000003ULL + t);
      for (uint64_t i = t; i < batch; i += n_threads) {
        const VideoIndex& vi = cc->index[rng() % cc->n_videos];
        uint64_t max_start =
            vi.n_frames >= seq_len ? vi.n_frames - seq_len : 0;
        uint64_t start = max_start ? rng() % (max_start + 1) : 0;
        const uint8_t* src = cc->data + vi.offset + start * fb;
        std::memcpy(out + i * item_bytes, src, item_bytes);
      }
    });
  }
  for (auto& th : threads) th.join();
}

void prefetch_loop(Cache* cc) {
  uint64_t counter = 0;
  while (!cc->stop.load()) {
    size_t slot;
    {
      std::unique_lock<std::mutex> lk(cc->mu);
      cc->cv_free.wait(lk, [&] {
        return cc->stop.load() || !cc->ring[cc->ring_write].ready;
      });
      if (cc->stop.load()) return;
      slot = cc->ring_write;
    }
    sample_into(cc, cc->pf_seed + (counter++), cc->pf_batch, cc->pf_seq,
                cc->ring[slot].data.data());
    {
      std::lock_guard<std::mutex> lk(cc->mu);
      cc->ring[slot].ready = true;
      cc->ring_write = (cc->ring_write + 1) % cc->ring.size();
    }
    cc->cv_ready.notify_one();
  }
}

}  // namespace

extern "C" {

void* fc_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* cc = new Cache();
  cc->fd = fd;
  cc->base = static_cast<const uint8_t*>(base);
  cc->size = st.st_size;
  const uint64_t* hdr = reinterpret_cast<const uint64_t*>(cc->base);
  if (hdr[0] != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    delete cc;
    return nullptr;
  }
  cc->n_videos = hdr[1];
  cc->h = hdr[2];
  cc->w = hdr[3];
  cc->c = hdr[4];
  cc->index = reinterpret_cast<const VideoIndex*>(cc->base + 5 * sizeof(uint64_t));
  cc->data = cc->base + 5 * sizeof(uint64_t) + cc->n_videos * sizeof(VideoIndex);
  return cc;
}

uint64_t fc_num_videos(void* h) { return static_cast<Cache*>(h)->n_videos; }
uint64_t fc_height(void* h) { return static_cast<Cache*>(h)->h; }
uint64_t fc_width(void* h) { return static_cast<Cache*>(h)->w; }
uint64_t fc_channels(void* h) { return static_cast<Cache*>(h)->c; }

// Synchronous batch: out must hold batch*seq_len*h*w*c bytes.
void fc_sample_batch(void* h, uint64_t seed, uint64_t batch, uint64_t seq_len,
                     uint8_t* out) {
  sample_into(static_cast<Cache*>(h), seed, batch, seq_len, out);
}

// Start the background prefetcher with n_buffers ring slots.
void fc_prefetch_start(void* h, uint64_t batch, uint64_t seq_len,
                       uint64_t n_buffers, uint64_t seed) {
  auto* cc = static_cast<Cache*>(h);
  cc->pf_batch = batch;
  cc->pf_seq = seq_len;
  cc->pf_seed = seed;
  cc->ring.resize(n_buffers);
  for (auto& rb : cc->ring)
    rb.data.resize(batch * seq_len * frame_bytes(cc));
  cc->stop.store(false);
  cc->worker = std::thread(prefetch_loop, cc);
}

// Blocking: copy the next ready batch into out and free the slot.
void fc_next_batch(void* h, uint8_t* out) {
  auto* cc = static_cast<Cache*>(h);
  size_t slot;
  {
    std::unique_lock<std::mutex> lk(cc->mu);
    cc->cv_ready.wait(lk, [&] { return cc->ring[cc->ring_read].ready; });
    slot = cc->ring_read;
  }
  std::memcpy(out, cc->ring[slot].data.data(), cc->ring[slot].data.size());
  {
    std::lock_guard<std::mutex> lk(cc->mu);
    cc->ring[slot].ready = false;
    cc->ring_read = (cc->ring_read + 1) % cc->ring.size();
  }
  cc->cv_free.notify_one();
}

void fc_prefetch_stop(void* h) {
  auto* cc = static_cast<Cache*>(h);
  if (cc->worker.joinable()) {
    cc->stop.store(true);
    cc->cv_free.notify_all();
    cc->worker.join();
  }
}

void fc_close(void* h) {
  auto* cc = static_cast<Cache*>(h);
  fc_prefetch_stop(cc);
  if (cc->base) munmap(const_cast<uint8_t*>(cc->base), cc->size);
  if (cc->fd >= 0) close(cc->fd);
  delete cc;
}

}  // extern "C"
