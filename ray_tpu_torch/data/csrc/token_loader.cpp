// Native token-batch data loader for LM training.
//
// The TPU-era equivalent of the reference's native data path (its C++ object
// plane feeds arrow blocks; here the training hot path is token batches):
// memory-maps a flat token file (int32 little-endian), and a pool of
// prefetch threads fills a bounded ring of [batch, seq_len+1] batches so
// the accelerator never waits on host IO. Sampling is either sequential
// (epoch order with a per-epoch seeded shuffle of window offsets) or
// uniform-random windows. Exposed through a C ABI consumed by
// ray_tpu/data/token_loader.py via ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libloader.so token_loader.cpp -lpthread

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

struct Batch {
  std::vector<int32_t> data;  // batch * (seq_len + 1)
};

struct Loader {
  const int32_t* tokens = nullptr;
  size_t n_tokens = 0;
  size_t map_len = 0;
  void* map_base = nullptr;
  int fd = -1;

  int batch = 0;
  int seq = 0;          // window length is seq + 1 (inputs+targets overlap)
  bool sequential = false;
  uint64_t seed = 0;

  std::deque<Batch> ready;
  size_t max_ready = 4;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits
  std::condition_variable cv_space;   // producers wait
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  // sequential mode: global monotonic cursor; the per-epoch permutation is
  // computed statelessly from (epoch, index) so threads never share mutable
  // shuffle state (no epoch-boundary races)
  std::atomic<uint64_t> cursor{0};

  size_t window() const { return static_cast<size_t>(seq) + 1; }
  size_t n_windows() const { return n_tokens / window(); }
};

uint64_t gcd_u64(uint64_t a, uint64_t b) { return b ? gcd_u64(b, a % b) : a; }

// Stateless per-epoch permutation of [0, n): two rounds of affine map
// idx -> (a * idx + b) mod n with epoch-seeded odd multipliers coprime to n.
// Weaker mixing than Fisher-Yates but race-free and O(1) per lookup.
uint64_t permute(uint64_t idx, uint64_t n, uint64_t seed, uint64_t epoch) {
  std::mt19937_64 rng(seed + 0x9E3779B97F4A7C15ULL * (epoch + 1));
  for (int round = 0; round < 2; round++) {
    uint64_t a = (rng() | 1) % n;
    while (a == 0 || gcd_u64(a, n) != 1) a = (a + 1) % n;
    uint64_t b = rng() % n;
    idx = (static_cast<__uint128_t>(a) * idx + b) % n;
  }
  return idx;
}

void fill_batch(Loader* L, Batch* out, std::mt19937_64* rng) {
  const size_t w = L->window();
  out->data.resize(static_cast<size_t>(L->batch) * w);
  for (int b = 0; b < L->batch; b++) {
    size_t start;
    if (L->sequential) {
      uint64_t pos = L->cursor.fetch_add(1);
      uint64_t n = L->n_windows();
      start = permute(pos % n, n, L->seed, pos / n) * w;
    } else {
      start = (*rng)() % (L->n_tokens - w + 1);
    }
    std::memcpy(out->data.data() + static_cast<size_t>(b) * w,
                L->tokens + start, w * sizeof(int32_t));
  }
}

void worker_loop(Loader* L, uint64_t worker_seed) {
  std::mt19937_64 rng(worker_seed);
  while (!L->stop.load()) {
    Batch batch;
    fill_batch(L, &batch, &rng);
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_space.wait(lk, [L] {
      return L->ready.size() < L->max_ready || L->stop.load();
    });
    if (L->stop.load()) return;
    L->ready.push_back(std::move(batch));
    L->cv_ready.notify_one();
  }
}

}  // namespace

extern "C" {

// mode: 0 = random windows, 1 = sequential shuffled epochs
void* loader_open(const char* path, int batch, int seq_len, int n_threads,
                  uint64_t seed, int mode) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (seq_len + 1) * 4) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_SEQUENTIAL);

  auto* L = new Loader();
  L->fd = fd;
  L->map_base = base;
  L->map_len = st.st_size;
  L->tokens = static_cast<const int32_t*>(base);
  L->n_tokens = st.st_size / 4;
  L->batch = batch;
  L->seq = seq_len;
  L->seed = seed;
  L->sequential = mode == 1;
  int n = n_threads > 0 ? n_threads : 1;
  for (int i = 0; i < n; i++) {
    L->workers.emplace_back(worker_loop, L, seed + 1000003ULL * (i + 1));
  }
  return L;
}

// Blocking: copies one [batch, seq_len+1] int32 batch into out.
int loader_next(void* handle, int32_t* out) {
  auto* L = static_cast<Loader*>(handle);
  Batch batch;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [L] { return !L->ready.empty() || L->stop.load(); });
    if (L->ready.empty()) return -1;
    batch = std::move(L->ready.front());
    L->ready.pop_front();
    L->cv_space.notify_one();
  }
  std::memcpy(out, batch.data.data(), batch.data.size() * sizeof(int32_t));
  return 0;
}

uint64_t loader_num_tokens(void* handle) {
  return static_cast<Loader*>(handle)->n_tokens;
}

uint64_t loader_batches_per_epoch(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  return L->n_windows() / L->batch;
}

void loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  munmap(L->map_base, L->map_len);
  ::close(L->fd);
  delete L;
}

}  // extern "C"
