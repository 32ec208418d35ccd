// Native data-loader core: .cerec record file reader with mmap + prefetch.
//
// Counterpart of the reference's C++ data path: LMDB cursor
// (`src/caffe/util/db_lmdb.cpp`), background InternalThread prefetcher and
// BlockingQueue double buffering (`include/caffe/layers/base_data_layer.hpp:52-78`,
// `src/caffe/util/blocking_queue.cpp`). LMDB is replaced by a flat
// length-prefixed record format (data/datasets.py documents the layout);
// random shuffled access is O(1) because records are fixed-size.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). The Python side
// (caffe_escoin_tpu/data/native.py) wraps handles; batches are filled
// directly into caller-provided numpy buffers from worker threads, so the
// GIL is released for the entire decode+copy.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'C', 'E', 'R', 'C'};

struct CerecFile {
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap of whole file
  size_t file_len = 0;
  uint64_t sample_elems = 0;  // floats per sample
  uint64_t num = 0;           // number of records
  size_t data_offset = 0;
  size_t rec_bytes = 0;
};

struct Batch {
  std::vector<float> data;
  std::vector<int32_t> labels;
};

// Bounded queue mirroring the reference's BlockingQueue<Batch*>.
struct Prefetcher {
  CerecFile* file = nullptr;
  size_t batch = 0;
  bool shuffle = false;
  uint64_t seed = 0;

  std::deque<Batch> full;
  std::mutex mu;
  std::condition_variable cv_full, cv_free;
  size_t capacity = 4;  // reference PREFETCH_COUNT
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  std::atomic<uint64_t> cursor{0};
};

uint32_t ReadU32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

void FillBatch(Prefetcher* pf, Batch* out, std::mt19937_64* rng) {
  const CerecFile& f = *pf->file;
  out->data.resize(pf->batch * f.sample_elems);
  out->labels.resize(pf->batch);
  for (size_t b = 0; b < pf->batch; ++b) {
    uint64_t idx;
    if (pf->shuffle) {
      idx = (*rng)() % f.num;
    } else {
      idx = pf->cursor.fetch_add(1) % f.num;
    }
    const uint8_t* rec = f.base + f.data_offset + idx * f.rec_bytes;
    // layout: u32 payload_len | payload | i32 label
    std::memcpy(out->data.data() + b * f.sample_elems, rec + 4,
                f.sample_elems * sizeof(float));
    std::memcpy(&out->labels[b], rec + 4 + f.sample_elems * sizeof(float), 4);
  }
}

void WorkerLoop(Prefetcher* pf, uint64_t worker_seed) {
  std::mt19937_64 rng(worker_seed);
  while (!pf->stop.load()) {
    Batch batch;
    FillBatch(pf, &batch, &rng);
    std::unique_lock<std::mutex> lk(pf->mu);
    pf->cv_free.wait(lk, [pf] {
      return pf->stop.load() || pf->full.size() < pf->capacity;
    });
    if (pf->stop.load()) return;
    pf->full.push_back(std::move(batch));
    pf->cv_full.notify_one();
  }
}

}  // namespace

extern "C" {

// ---- file handling --------------------------------------------------------

void* cerec_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  if (base == MAP_FAILED || std::memcmp(base, kMagic, 4) != 0) {
    if (base != MAP_FAILED) munmap(const_cast<uint8_t*>(base), st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* f = new CerecFile;
  f->fd = fd;
  f->base = base;
  f->file_len = st.st_size;
  size_t off = 4;
  /* version */ ReadU32(base + off);
  off += 4;
  uint32_t ndim = ReadU32(base + off);
  off += 4;
  uint64_t elems = 1;
  for (uint32_t i = 0; i < ndim; ++i) {
    elems *= ReadU32(base + off);
    off += 4;
  }
  f->num = ReadU32(base + off);
  off += 4;
  f->sample_elems = elems;
  f->data_offset = off;
  f->rec_bytes = 4 + elems * sizeof(float) + 4;
  return f;
}

uint64_t cerec_num(void* h) { return static_cast<CerecFile*>(h)->num; }
uint64_t cerec_sample_elems(void* h) {
  return static_cast<CerecFile*>(h)->sample_elems;
}

void cerec_close(void* h) {
  auto* f = static_cast<CerecFile*>(h);
  if (f->base) munmap(const_cast<uint8_t*>(f->base), f->file_len);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

// ---- prefetcher -----------------------------------------------------------

void* cerec_prefetcher_start(void* file, uint64_t batch, int shuffle,
                             uint64_t seed, int num_workers, int capacity) {
  auto* pf = new Prefetcher;
  pf->file = static_cast<CerecFile*>(file);
  pf->batch = batch;
  pf->shuffle = shuffle != 0;
  pf->seed = seed;
  if (capacity > 0) pf->capacity = capacity;
  if (num_workers < 1) num_workers = 1;
  for (int i = 0; i < num_workers; ++i) {
    pf->workers.emplace_back(WorkerLoop, pf, seed + 0x9e3779b9ull * i);
  }
  return pf;
}

// Blocks until a batch is ready; copies into caller buffers.
// data_out: batch*sample_elems floats; label_out: batch int32.
int cerec_prefetcher_next(void* h, float* data_out, int32_t* label_out) {
  auto* pf = static_cast<Prefetcher*>(h);
  Batch batch;
  {
    std::unique_lock<std::mutex> lk(pf->mu);
    pf->cv_full.wait(lk, [pf] { return pf->stop.load() || !pf->full.empty(); });
    if (pf->full.empty()) return -1;
    batch = std::move(pf->full.front());
    pf->full.pop_front();
    pf->cv_free.notify_one();
  }
  std::memcpy(data_out, batch.data.data(), batch.data.size() * sizeof(float));
  std::memcpy(label_out, batch.labels.data(),
              batch.labels.size() * sizeof(int32_t));
  return 0;
}

void cerec_prefetcher_stop(void* h) {
  auto* pf = static_cast<Prefetcher*>(h);
  pf->stop.store(true);
  pf->cv_full.notify_all();
  pf->cv_free.notify_all();
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
