// Native reader for the packed .cfs feature store (format in
// cone_tpu_torch/data/store.py), the port's own copy of the JAX package's
// reader with the same C interface. A zero-copy mmap of one contiguous
// feature matrix + key index, with
//   * cfs_read        — single-entry copy into a caller buffer
//   * cfs_read_batch  — parallel padded batch fill (the fixed-shape window
//                       tensors the training loader consumes), multi-threaded
//   * cfs_prefetch    — MADV_WILLNEED + background page-touch so batch fills
//                       do not stall on disk
// cfs_open refuses a file whose header, index or payload would lie outside
// the mapping (a truncated or foreign file) instead of reading past it.
//
// A plain C interface for ctypes (cone_tpu_torch/data/native_store.py).
// Host code: built with g++ by cone_tpu_torch/kernels/build.py at first
// open, without -march=native, so a built library runs on any x86-64 host.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'C', 'F', 'S', 'T'};
constexpr size_t kHeaderSize = 4 + 4 + 4 + 1 + 8 + 8;

struct Entry {
  uint64_t row_start;
  uint64_t n_rows;
};

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;  // mmap of the whole file
  size_t file_size = 0;
  uint32_t dim = 0;
  uint8_t dtype = 0;  // 0=f32, 1=f16
  size_t itemsize = 4;
  const uint8_t* payload = nullptr;
  std::unordered_map<std::string, Entry> index;

  // prefetch machinery
  std::vector<std::thread> workers;
  std::deque<Entry> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  ~Store() {
    {
      // hold the mutex while setting stop: a worker between its predicate
      // check and cv.wait() blocking would otherwise miss the notify and
      // sleep forever, deadlocking join() (lost-wakeup race)
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
    if (base) munmap(const_cast<uint8_t*>(base), file_size);
    if (fd >= 0) close(fd);
  }

  size_t row_bytes() const { return size_t(dim) * itemsize; }

  const uint8_t* row_ptr(uint64_t row) const {
    return payload + row * row_bytes();
  }

  void touch(const Entry& e) const {
    const uint8_t* p = row_ptr(e.row_start);
    size_t bytes = e.n_rows * row_bytes();
    madvise(const_cast<uint8_t*>(p), bytes, MADV_WILLNEED);
    // touch one byte per page to force residency
    volatile uint8_t sink = 0;
    for (size_t off = 0; off < bytes; off += 4096) sink ^= p[off];
    (void)sink;
  }

  void worker() {
    for (;;) {
      Entry e;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return stop || !queue.empty(); });
        if (stop) return;
        e = queue.front();
        queue.pop_front();
      }
      touch(e);
    }
  }
};

template <typename T>
T read_le(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

}  // namespace

extern "C" {

void* cfs_open(const char* path, int n_prefetch_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(mem);
  s->file_size = st.st_size;

  const uint8_t* p = s->base;
  if (s->file_size < kHeaderSize || std::memcmp(p, kMagic, 4) != 0) {
    delete s;
    return nullptr;
  }
  p += 4;
  uint32_t version = read_le<uint32_t>(p);
  s->dim = read_le<uint32_t>(p);
  s->dtype = read_le<uint8_t>(p);
  uint64_t n_entries = read_le<uint64_t>(p);
  uint64_t index_offset = read_le<uint64_t>(p);
  if (version != 1 || s->dtype > 1 || s->dim == 0 || index_offset < kHeaderSize ||
      index_offset > s->file_size) {
    delete s;
    return nullptr;
  }
  s->itemsize = s->dtype == 0 ? 4 : 2;
  s->payload = s->base + kHeaderSize;
  const uint64_t payload_rows = (index_offset - kHeaderSize) / s->row_bytes();

  const uint8_t* ip = s->base + index_offset;
  const uint8_t* end = s->base + s->file_size;
  s->index.reserve(n_entries);
  for (uint64_t i = 0; i < n_entries; ++i) {
    if (end - ip < 2) {
      delete s;
      return nullptr;
    }
    uint16_t klen = read_le<uint16_t>(ip);
    if (uint64_t(end - ip) < uint64_t(klen) + 16) {
      delete s;
      return nullptr;
    }
    std::string key(reinterpret_cast<const char*>(ip), klen);
    ip += klen;
    Entry e;
    e.row_start = read_le<uint64_t>(ip);
    e.n_rows = read_le<uint64_t>(ip);
    if (e.row_start > payload_rows || e.n_rows > payload_rows - e.row_start) {
      delete s;
      return nullptr;
    }
    s->index.emplace(std::move(key), e);
  }

  for (int i = 0; i < n_prefetch_threads; ++i) {
    s->workers.emplace_back([s] { s->worker(); });
  }
  return s;
}

void cfs_close(void* h) { delete static_cast<Store*>(h); }

uint32_t cfs_dim(void* h) { return static_cast<Store*>(h)->dim; }
uint8_t cfs_dtype(void* h) { return static_cast<Store*>(h)->dtype; }
uint64_t cfs_num_entries(void* h) {
  return static_cast<Store*>(h)->index.size();
}

// -1 if missing, else number of rows
int64_t cfs_rows(void* h, const char* key) {
  auto* s = static_cast<Store*>(h);
  auto it = s->index.find(key);
  return it == s->index.end() ? -1 : int64_t(it->second.n_rows);
}

// Copy one entry into `out` (capacity rows_cap rows); returns rows copied
// or -1 if missing.
int64_t cfs_read(void* h, const char* key, void* out, int64_t rows_cap) {
  auto* s = static_cast<Store*>(h);
  auto it = s->index.find(key);
  if (it == s->index.end()) return -1;
  int64_t rows = std::min<int64_t>(it->second.n_rows, rows_cap);
  std::memcpy(out, s->row_ptr(it->second.row_start), rows * s->row_bytes());
  return rows;
}

// Fill a padded batch (n, max_rows, dim), zeroing the tail of each slot.
// keys: n NUL-terminated strings concatenated. lengths[i] receives the true
// row count (0 for missing keys). Parallel across entries.
void cfs_read_batch(void* h, const char* keys, int64_t n, int64_t max_rows,
                    void* out, int64_t* lengths) {
  auto* s = static_cast<Store*>(h);
  std::vector<const char*> ks(n);
  const char* p = keys;
  for (int64_t i = 0; i < n; ++i) {
    ks[i] = p;
    p += std::strlen(p) + 1;
  }
  size_t slot_bytes = size_t(max_rows) * s->row_bytes();
  auto fill = [&](int64_t i) {
    uint8_t* dst = static_cast<uint8_t*>(out) + i * slot_bytes;
    auto it = s->index.find(ks[i]);
    if (it == s->index.end()) {
      std::memset(dst, 0, slot_bytes);
      lengths[i] = 0;
      return;
    }
    int64_t rows = std::min<int64_t>(it->second.n_rows, max_rows);
    size_t bytes = rows * s->row_bytes();
    std::memcpy(dst, s->row_ptr(it->second.row_start), bytes);
    if (bytes < slot_bytes) std::memset(dst + bytes, 0, slot_bytes - bytes);
    lengths[i] = rows;
  };
  int64_t n_threads = std::min<int64_t>(n, 8);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fill(i);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<int64_t> next{0};
  for (int64_t t = 0; t < n_threads; ++t) {
    ts.emplace_back([&] {
      for (int64_t i = next++; i < n; i = next++) fill(i);
    });
  }
  for (auto& t : ts) t.join();
}

// Queue entries for background page-warming.
void cfs_prefetch(void* h, const char* keys, int64_t n) {
  auto* s = static_cast<Store*>(h);
  if (s->workers.empty()) return;
  const char* p = keys;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    for (int64_t i = 0; i < n; ++i) {
      auto it = s->index.find(p);
      if (it != s->index.end()) s->queue.push_back(it->second);
      p += std::strlen(p) + 1;
    }
  }
  s->cv.notify_all();
}

}  // extern "C"
