// Shared-memory arena allocator for the node object store.
//
// The PyTorch port's copy of ray_tpu's arena, an equivalent of the
// reference's plasma arena
// (src/ray/object_manager/plasma/dlmalloc.cc + plasma_allocator.cc): one
// mmap'd tmpfs file per node holds many small objects, managed by a
// first-fit free list with coalescing that lives *inside* the shared
// mapping, guarded by a process-shared pthread mutex. Producer and consumer
// processes attach the same file; allocation returns byte offsets that are
// valid in every attached process, so reads are zero-copy memoryview
// slices.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (ray_tpu_torch/core/arena.py) — no pybind11 dependency. Its magic differs
// from ray_tpu's so neither runtime attaches the other's arena.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5254544F41524EULL;  // "RTTOARN"
constexpr uint64_t kAlign = 64;                    // cache-line alignment
constexpr uint64_t kNil = ~0ULL;

struct BlockHeader {
  uint64_t size;       // payload bytes (aligned)
  uint64_t prev_size;  // payload size of the previous block (for coalescing)
  uint32_t free;       // 1 = on free list
  uint32_t last;       // 1 = final block in arena
  uint64_t next_free;  // offset of next free block header (kNil = none)
  uint64_t prev_free;  // offset of prev free block header
};

struct ArenaHeader {
  uint64_t magic;
  uint64_t capacity;      // total payload area size
  uint64_t used;          // bytes currently allocated (incl. headers)
  uint64_t free_head;     // offset of first free block header
  pthread_mutex_t mutex;  // process-shared
};

struct Arena {
  ArenaHeader* header;
  uint8_t* base;   // start of block area (after header)
  uint64_t capacity;
  void* map;
  uint64_t map_size;
};

inline BlockHeader* block_at(Arena* a, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(a->base + off);
}

inline uint64_t align_up(uint64_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

void freelist_remove(Arena* a, uint64_t off) {
  BlockHeader* b = block_at(a, off);
  if (b->prev_free != kNil)
    block_at(a, b->prev_free)->next_free = b->next_free;
  else
    a->header->free_head = b->next_free;
  if (b->next_free != kNil)
    block_at(a, b->next_free)->prev_free = b->prev_free;
  b->next_free = b->prev_free = kNil;
}

void freelist_push(Arena* a, uint64_t off) {
  BlockHeader* b = block_at(a, off);
  b->free = 1;
  b->prev_free = kNil;
  b->next_free = a->header->free_head;
  if (b->next_free != kNil) block_at(a, b->next_free)->prev_free = off;
  a->header->free_head = off;
}

}  // namespace

extern "C" {

// Create (or truncate) an arena file of `capacity` payload bytes.
void* arena_create(const char* path, uint64_t capacity) {
  capacity = align_up(capacity);
  uint64_t map_size = sizeof(ArenaHeader) + capacity;
  int fd = open(path, O_RDWR | O_CREAT, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)map_size) != 0) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;

  Arena* a = new Arena();
  a->map = map;
  a->map_size = map_size;
  a->header = reinterpret_cast<ArenaHeader*>(map);
  a->base = reinterpret_cast<uint8_t*>(map) + sizeof(ArenaHeader);
  a->capacity = capacity;

  ArenaHeader* h = a->header;
  h->magic = kMagic;
  h->capacity = capacity;
  h->used = 0;
  h->free_head = 0;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);

  BlockHeader* first = block_at(a, 0);
  std::memset(first, 0, sizeof(BlockHeader));
  first->size = capacity - sizeof(BlockHeader);
  first->free = 1;
  first->last = 1;
  first->next_free = kNil;
  first->prev_free = kNil;
  return a;
}

// Attach to an existing arena file.
void* arena_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;
  ArenaHeader* h = reinterpret_cast<ArenaHeader*>(map);
  if (h->magic != kMagic) {
    munmap(map, st.st_size);
    return nullptr;
  }
  Arena* a = new Arena();
  a->map = map;
  a->map_size = st.st_size;
  a->header = h;
  a->base = reinterpret_cast<uint8_t*>(map) + sizeof(ArenaHeader);
  a->capacity = h->capacity;
  return a;
}

// Allocate `size` payload bytes; returns payload offset or UINT64_MAX.
uint64_t arena_alloc(void* handle, uint64_t size) {
  Arena* a = static_cast<Arena*>(handle);
  uint64_t need = align_up(size);
  ArenaHeader* h = a->header;
  if (pthread_mutex_lock(&h->mutex) == EOWNERDEAD)
    pthread_mutex_consistent(&h->mutex);

  uint64_t off = h->free_head;
  uint64_t result = kNil;
  while (off != kNil) {
    BlockHeader* b = block_at(a, off);
    if (b->size >= need) {
      freelist_remove(a, off);
      b->free = 0;
      // split if the remainder fits another block
      if (b->size >= need + sizeof(BlockHeader) + kAlign) {
        uint64_t rest_off = off + sizeof(BlockHeader) + need;
        BlockHeader* rest = block_at(a, rest_off);
        std::memset(rest, 0, sizeof(BlockHeader));
        rest->size = b->size - need - sizeof(BlockHeader);
        rest->prev_size = need;
        rest->last = b->last;
        b->last = 0;
        b->size = need;
        if (!rest->last) {
          uint64_t after = rest_off + sizeof(BlockHeader) + rest->size;
          block_at(a, after)->prev_size = rest->size;
        }
        freelist_push(a, rest_off);
      }
      h->used += sizeof(BlockHeader) + b->size;
      result = off + sizeof(BlockHeader);
      break;
    }
    off = b->next_free;
  }
  pthread_mutex_unlock(&h->mutex);
  return result;
}

// Free a payload offset returned by arena_alloc; coalesces neighbors.
int arena_free(void* handle, uint64_t payload_off) {
  Arena* a = static_cast<Arena*>(handle);
  ArenaHeader* h = a->header;
  uint64_t off = payload_off - sizeof(BlockHeader);
  if (pthread_mutex_lock(&h->mutex) == EOWNERDEAD)
    pthread_mutex_consistent(&h->mutex);
  BlockHeader* b = block_at(a, off);
  if (b->free) {
    pthread_mutex_unlock(&h->mutex);
    return -1;  // double free
  }
  h->used -= sizeof(BlockHeader) + b->size;

  // coalesce with next block
  if (!b->last) {
    uint64_t next_off = off + sizeof(BlockHeader) + b->size;
    BlockHeader* next = block_at(a, next_off);
    if (next->free) {
      freelist_remove(a, next_off);
      b->size += sizeof(BlockHeader) + next->size;
      b->last = next->last;
    }
  }
  // coalesce with previous block
  if (off != 0) {
    uint64_t prev_off = off - sizeof(BlockHeader) - b->prev_size;
    BlockHeader* prev = block_at(a, prev_off);
    if (prev->free) {
      freelist_remove(a, prev_off);
      prev->size += sizeof(BlockHeader) + b->size;
      prev->last = b->last;
      off = prev_off;
      b = prev;
    }
  }
  if (!b->last) {
    uint64_t after = off + sizeof(BlockHeader) + b->size;
    block_at(a, after)->prev_size = b->size;
  }
  b->free = 0;  // freelist_push sets it
  freelist_push(a, off);
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

uint64_t arena_used(void* handle) {
  return static_cast<Arena*>(handle)->header->used;
}

uint64_t arena_capacity(void* handle) {
  return static_cast<Arena*>(handle)->header->capacity;
}

// Base pointer of the payload area (for ctypes buffer construction).
void* arena_base(void* handle) { return static_cast<Arena*>(handle)->base; }

void arena_close(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  munmap(a->map, a->map_size);
  delete a;
}

}  // extern "C"
