// Thread-sanitizer stress harness for shm_arena.cpp: a sanitizer pass on
// the robust-mutex + coalescing allocator.
//
// N threads hammer one arena with alloc/write/verify/free cycles of random
// sizes. Each allocation is filled with a pattern derived from its offset
// and re-verified before free — catching overlapping allocations (allocator
// races) as data corruption, while TSAN catches any unsynchronized access
// to the header/block table.
//
// Build + run against the shm_arena.cpp beside it (tests/test_arena_stress.py
// does this):
//   g++ -O1 -g -fsanitize=thread -pthread shm_arena.cpp arena_stress.cpp -o arena_stress
//   TSAN_OPTIONS=halt_on_error=1 ./arena_stress /dev/shm/arena_tsan 200
//
// The harness exits 0 iff every verify passed and TSAN found no race.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <pthread.h>
#include <unistd.h>
#include <vector>

extern "C" {
int arena_create(const char* path, uint64_t capacity);
void* arena_attach(const char* path);
void arena_detach(void* handle);
uint64_t arena_alloc(void* handle, uint64_t size);
int arena_free(void* handle, uint64_t offset);
uint64_t arena_used(void* handle);
uint8_t* arena_base(void* handle);
}

static const uint64_t CAPACITY = 64ull << 20;  // 64MB arena
static int g_iters = 200;
static const char* g_path = nullptr;
static volatile int g_failed = 0;

static void fill(uint8_t* p, uint64_t n, uint64_t seed) {
  for (uint64_t i = 0; i < n; i++) p[i] = (uint8_t)((seed + i) * 2654435761u >> 24);
}

static int verify(const uint8_t* p, uint64_t n, uint64_t seed) {
  for (uint64_t i = 0; i < n; i++)
    if (p[i] != (uint8_t)((seed + i) * 2654435761u >> 24)) return 0;
  return 1;
}

static void* worker(void* arg) {
  long tid = (long)(intptr_t)arg;
  void* h = arena_attach(g_path);
  if (!h) { g_failed = 1; return nullptr; }
  uint8_t* base = arena_base(h);
  unsigned int rng = 0x9e3779b9u ^ (unsigned)tid;
  std::vector<std::pair<uint64_t, uint64_t>> held;  // (offset, size)
  for (int it = 0; it < g_iters && !g_failed; it++) {
    rng = rng * 1103515245u + 12345u;
    uint64_t size = 64 + (rng % (512 * 1024));
    uint64_t off = arena_alloc(h, size);
    if (off != 0) {
      fill(base + off, size, off ^ tid);
      held.emplace_back(off, size);
    }
    // Free roughly half the time (and always when the arena pushed back),
    // verifying the pattern survived neighboring allocations.
    if ((!held.empty() && (rng & 1)) || (off == 0 && !held.empty())) {
      rng = rng * 1103515245u + 12345u;
      size_t idx = rng % held.size();
      auto [o, s] = held[idx];
      if (!verify(base + o, s, o ^ tid)) {
        fprintf(stderr, "CORRUPTION tid=%ld off=%llu size=%llu\n", tid,
                (unsigned long long)o, (unsigned long long)s);
        g_failed = 1;
      }
      if (arena_free(h, o) != 0) {
        fprintf(stderr, "BAD FREE tid=%ld off=%llu\n", tid, (unsigned long long)o);
        g_failed = 1;
      }
      held.erase(held.begin() + idx);
    }
  }
  for (auto [o, s] : held) {
    if (!verify(base + o, s, o ^ tid)) g_failed = 1;
    arena_free(h, o);
  }
  arena_detach(h);
  return nullptr;
}

int main(int argc, char** argv) {
  if (argc < 2) { fprintf(stderr, "usage: %s <path> [iters]\n", argv[0]); return 2; }
  g_path = argv[1];
  if (argc > 2) g_iters = atoi(argv[2]);
  unlink(g_path);
  if (arena_create(g_path, CAPACITY) != 0) { fprintf(stderr, "create failed\n"); return 2; }
  const int NTHREADS = 8;
  pthread_t ts[NTHREADS];
  for (long i = 0; i < NTHREADS; i++)
    pthread_create(&ts[i], nullptr, worker, (void*)(intptr_t)i);
  for (int i = 0; i < NTHREADS; i++) pthread_join(ts[i], nullptr);
  // All held allocations were freed: the arena must be (near-)empty again.
  void* h = arena_attach(g_path);
  uint64_t used = arena_used(h);
  arena_detach(h);
  unlink(g_path);
  if (g_failed) { fprintf(stderr, "FAILED\n"); return 1; }
  printf("ok: %d threads x %d iters, residual used=%llu\n", NTHREADS, g_iters,
         (unsigned long long)used);
  return used == 0 ? 0 : 1;
}
