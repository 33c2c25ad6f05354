// Shared-memory arena allocator: the native core of the node object store.
//
// The reference's plasma store runs dlmalloc over one big shm mapping inside
// a C++ store process (src/ray/object_manager/plasma/
// dlmalloc.cc, shared_memory.cc). This build keeps plasma's key property —
// one mapping, offset-addressed allocations, zero-copy readers — without a
// store *process*: the allocator state lives IN the shared memory itself,
// guarded by a process-shared robust mutex, so every worker on the node
// allocates/frees directly (no socket round-trip per object, no per-object
// file create/unlink).
//
// Layout:  [ArenaHeader | Block | payload | Block | payload | ...]
// Blocks form an address-ordered implicit list (size + free flag); free uses
// next-block coalescing; allocation is first-fit with split. Offsets returned
// to Python are payload offsets relative to the mapping base.
//
// Crash safety: the mutex is PTHREAD_MUTEX_ROBUST — if a worker dies while
// holding it, the next locker gets EOWNERDEAD, marks the state consistent,
// and continues (allocation metadata is only mutated under the lock, and each
// mutation is a couple of word writes; worst case a crash leaks one block,
// which the control plane's refcounting will free again).
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// Source-hash stamp (stale-binary guard): the build flow passes
// -DARENA_SRC_SHA256="<hex>" with the sha256 of this file; the marker string
// makes the hash greppable from the binary without loading it, and
// arena_source_hash() exposes it to the loader for self-heal rebuilds.
#ifndef ARENA_SRC_SHA256
#define ARENA_SRC_SHA256 "unknown"
#endif
__attribute__((used)) static const char arena_src_marker[] =
    "RAY_TPU_TORCH_ARENA_SRC_SHA256=" ARENA_SRC_SHA256;

namespace {

constexpr uint64_t kMagic = 0x52415954505541ULL;  // "RAYTPUA"
constexpr uint64_t kAlign = 64;                   // match python store alignment

struct ArenaHeader {
  uint64_t magic;
  uint64_t capacity;        // payload region size (bytes after header)
  uint64_t used;            // currently allocated payload bytes
  uint64_t high_water;      // max used ever
  pthread_mutex_t lock;     // process-shared, robust
};

struct Block {
  uint64_t size;            // payload size of this block
  uint64_t free;            // 1 = free
};

constexpr uint64_t kHeaderSize = (sizeof(ArenaHeader) + kAlign - 1) & ~(kAlign - 1);
constexpr uint64_t kBlockSize = (sizeof(Block) + kAlign - 1) & ~(kAlign - 1);

struct Handle {
  uint8_t* base;
  uint64_t map_size;
};

inline ArenaHeader* header(Handle* h) {
  return reinterpret_cast<ArenaHeader*>(h->base);
}

inline Block* first_block(Handle* h) {
  return reinterpret_cast<Block*>(h->base + kHeaderSize);
}

inline Block* next_block(Handle* h, Block* b) {
  uint8_t* p = reinterpret_cast<uint8_t*>(b) + kBlockSize + b->size;
  if (p >= h->base + h->map_size) return nullptr;
  return reinterpret_cast<Block*>(p);
}

int lock_arena(ArenaHeader* hd) {
  int rc = pthread_mutex_lock(&hd->lock);
  if (rc == EOWNERDEAD) {
    // Previous owner died mid-critical-section: adopt and repair.
    pthread_mutex_consistent(&hd->lock);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

// Create (or overwrite) an arena file of `capacity` payload bytes.
// Returns 0 on success.
int arena_create(const char* path, uint64_t capacity) {
  capacity = (capacity + kAlign - 1) & ~(kAlign - 1);
  uint64_t total = kHeaderSize + kBlockSize + capacity;
  int fd = open(path, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return -errno;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    int e = errno; close(fd); return -e;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -errno;

  auto* hd = reinterpret_cast<ArenaHeader*>(mem);
  hd->magic = kMagic;
  hd->capacity = capacity;
  hd->used = 0;
  hd->high_water = 0;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hd->lock, &attr);
  pthread_mutexattr_destroy(&attr);

  auto* b = reinterpret_cast<Block*>(reinterpret_cast<uint8_t*>(mem) + kHeaderSize);
  b->size = capacity;
  b->free = 1;

  munmap(mem, total);
  return 0;
}

// Attach to an existing arena; returns an opaque handle (NULL on failure).
void* arena_attach(const char* path) {
  int fd = open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  // A truncated/empty file cannot hold even the header + first block: mapping
  // it and dereferencing the header would read past EOF (SIGBUS on the last
  // partial page). Validate BEFORE touching the mapping.
  if (static_cast<uint64_t>(st.st_size) < kHeaderSize + kBlockSize) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hd = reinterpret_cast<ArenaHeader*>(mem);
  // Reject a header whose claimed capacity exceeds the real mapping: every
  // block-walk bound derives from map_size, but used/capacity accounting
  // trusts the header, and a corrupt capacity would let a split carve blocks
  // past EOF on a file that shrank underneath us. Compare by SUBTRACTION:
  // `kHeaderSize + kBlockSize + capacity` wraps for a hostile capacity near
  // 2^64 (unsigned wrap is defined behavior — UBSan stays silent) and would
  // step right around this check.
  if (hd->magic != kMagic ||
      hd->capacity > static_cast<uint64_t>(st.st_size) - kHeaderSize - kBlockSize) {
    munmap(mem, st.st_size);
    return nullptr;
  }
  auto* h = new Handle{reinterpret_cast<uint8_t*>(mem), static_cast<uint64_t>(st.st_size)};
  return h;
}

void arena_detach(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  if (!h) return;
  munmap(h->base, h->map_size);
  delete h;
}

// Allocate `size` payload bytes; returns the payload offset from the mapping
// base, or 0 on failure (offset 0 is inside the header, never a payload).
uint64_t arena_alloc(void* handle, uint64_t size) {
  auto* h = static_cast<Handle*>(handle);
  if (!h || size == 0) return 0;
  size = (size + kAlign - 1) & ~(kAlign - 1);
  ArenaHeader* hd = header(h);
  if (lock_arena(hd) != 0) return 0;

  uint64_t result = 0;
  for (Block* b = first_block(h); b != nullptr; b = next_block(h, b)) {
    if (b->free) {
      // Deferred coalescing: free-time merging only looks forward, so runs of
      // blocks freed in ascending address order stay split until this scan
      // stitches them back together.
      for (Block* n = next_block(h, b); n != nullptr && n->free; n = next_block(h, b)) {
        b->size += kBlockSize + n->size;
      }
    }
    if (!b->free || b->size < size) continue;
    uint64_t remainder = b->size - size;
    if (remainder > kBlockSize + kAlign) {
      // Split: carve the tail into a new free block. CRASH-CONSISTENT
      // ORDER (the robust mutex hands the table to a survivor if this
      // process dies mid-split): (1) write the tail header while it is
      // still invisible scribble inside b's payload, (2) shrink b — a walker
      // now sees two valid free blocks, (3) only then claim b below. Any
      // kill point leaves a walkable table; the old order (shrink first)
      // lost everything past the split until the tail header existed.
      auto* tail = reinterpret_cast<Block*>(
          reinterpret_cast<uint8_t*>(b) + kBlockSize + size);
      tail->size = remainder - kBlockSize;
      tail->free = 1;
      b->size = size;
    }
    b->free = 0;
    hd->used += b->size;
    if (hd->used > hd->high_water) hd->high_water = hd->used;
    result = static_cast<uint64_t>(
        reinterpret_cast<uint8_t*>(b) + kBlockSize - h->base);
    break;
  }
  pthread_mutex_unlock(&hd->lock);
  return result;
}

// Free the allocation whose payload starts at `offset`. Returns 0 on success.
int arena_free(void* handle, uint64_t offset) {
  auto* h = static_cast<Handle*>(handle);
  if (!h || offset < kHeaderSize + kBlockSize || offset >= h->map_size) return -EINVAL;
  auto* b = reinterpret_cast<Block*>(h->base + offset - kBlockSize);
  ArenaHeader* hd = header(h);
  if (lock_arena(hd) != 0) return -EAGAIN;
  if (b->free) { pthread_mutex_unlock(&hd->lock); return -EINVAL; }
  b->free = 1;
  hd->used -= b->size;
  // Coalesce with following free blocks (address-ordered walk from b).
  for (Block* n = next_block(h, b); n != nullptr && n->free; n = next_block(h, b)) {
    b->size += kBlockSize + n->size;
  }
  pthread_mutex_unlock(&hd->lock);
  return 0;
}

uint64_t arena_used(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h ? header(h)->used : 0;
}

uint64_t arena_capacity(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h ? header(h)->capacity : 0;
}

uint64_t arena_high_water(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h ? header(h)->high_water : 0;
}

// Base pointer for zero-copy views (ctypes turns this into a memoryview).
void* arena_base(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h ? h->base : nullptr;
}

uint64_t arena_map_size(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  return h ? h->map_size : 0;
}

// Hash of the source this binary was built from (stale-binary guard).
const char* arena_source_hash(void) { return ARENA_SRC_SHA256; }

}  // extern "C"
