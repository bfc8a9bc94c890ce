/* fdtpu native runtime — see fdtpu.h for the design contract. */
#include "fdtpu.h"

#include <atomic>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#include <fcntl.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/vfs.h>
#include <unistd.h>

namespace {

constexpr uint64_t kAlign = 64;  /* cacheline */

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline uint8_t *at(void *base, uint64_t off) {
  return static_cast<uint8_t *>(base) + off;
}

/* Ring header: one cacheline of producer state, then depth slots. */
struct RingHdr {
  uint64_t magic;
  uint64_t depth;          /* power of two */
  std::atomic<uint64_t> seq;  /* next seq to publish (producer-owned) */
  uint64_t pad[5];
};
static_assert(sizeof(RingHdr) == 64, "ring header is one cacheline");

constexpr uint64_t kRingMagic = 0xfd79a9f07a960001ULL;

struct Slot {
  std::atomic<uint64_t> seq;
  uint64_t sig;
  uint32_t off;
  uint32_t sz;
  uint16_t ctl;
  uint16_t orig;
  uint32_t tspub;
};
static_assert(sizeof(Slot) == 32, "slot is 32 bytes");

inline RingHdr *ring_hdr(void *base, uint64_t off) {
  return reinterpret_cast<RingHdr *>(at(base, off));
}
inline Slot *ring_slots(void *base, uint64_t off) {
  return reinterpret_cast<Slot *>(at(base, off + sizeof(RingHdr)));
}

struct Fseq {
  std::atomic<uint64_t> seq;
  uint64_t pad[7];
};

struct Cnc {
  std::atomic<uint32_t> state;
  uint32_t pad0;
  std::atomic<uint64_t> heartbeat;
  uint64_t pad[6];
};

/* tcache: ring of most-recent tags + open-address presence map sized 2x
 * depth (power of two). Same dedup contract as the reference's tcache
 * (src/tango/fd_tcache.h:4-21) with a simpler eviction map. */
struct TcacheHdr {
  uint64_t depth;
  uint64_t map_cnt;        /* power of two, >= 2*depth */
  uint64_t next;           /* ring cursor */
  uint64_t pad[5];
  /* followed by: uint64_t ring[depth]; uint64_t map[map_cnt] */
};

inline uint64_t tmix(uint64_t x) {
  /* 64-bit finalizer-style mixer for map indexing */
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33; return x;
}

}  // namespace

extern "C" {

/* ---- workspace ------------------------------------------------------- */

static uint64_t wksp_map_len(uint64_t sz) {
  /* hugetlbfs requires hugepage-multiple lengths for ftruncate AND
   * munmap; statfs f_bsize on the mount reports its hugepage size.
   * Normal shm keeps the exact size. */
  const char *hugedir = getenv("FDTPU_HUGETLBFS");
  if (!hugedir || !hugedir[0]) return sz;
  struct statfs sf;
  if (statfs(hugedir, &sf) != 0 || sf.f_bsize <= 0) return sz;
  uint64_t ps = (uint64_t)sf.f_bsize;
  return (sz + ps - 1) / ps * ps;
}

static int wksp_open_fd(const char *name, int create) {
  /* Backing store selection (the reference's hugepage workspaces,
   * ref: src/util/shmem/fd_shmem.h — hugetlbfs-backed named regions):
   * when FDTPU_HUGETLBFS names a hugetlbfs mount, workspaces are
   * FILES there (real 2M/1G pages, kernel-enforced); otherwise
   * POSIX shm (/dev/shm) as before. Every process resolves the env
   * identically, so creators and joiners agree on the backing. */
  const char *hugedir = getenv("FDTPU_HUGETLBFS");
  char path[512];
  int fd;
  if (hugedir && hugedir[0]) {
    int n = snprintf(path, sizeof path, "%s/%s", hugedir, name);
    if (n < 0 || (size_t)n >= sizeof path) {
      errno = ENAMETOOLONG;        /* refuse truncated paths: a
                                    * truncated name could alias (and
                                    * replace-mode unlink) the WRONG
                                    * file */
      return -1;
    }
    if (create) {
      fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
      if (fd < 0 && errno == EEXIST && create == 2) {
        unlink(path);
        fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
      }
    } else {
      fd = open(path, O_RDWR);
    }
    return fd;
  }
  if (create) {
    fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
    if (fd < 0 && errno == EEXIST && create == 2) {
      shm_unlink(name);
      fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
    }
    return fd;
  }
  return shm_open(name, O_RDWR, 0600);
}

void *fdtpu_wksp_join(const char *name, uint64_t sz, int create) {
  /* create=0: join existing; create=1: exclusive create (fails on
   * EEXIST — safe under racing creators); create=2: replace — unlink any
   * stale segment from a crashed run and create fresh (zero-filled).
   * Replace mode is single-creator-discipline only: the caller asserts
   * no live process is using the name (the topology builder is the one
   * creator; every tile joins with create=0). */
  int fd = wksp_open_fd(name, create);
  if (fd < 0) return nullptr;
  uint64_t len = wksp_map_len(sz);
  if (create) {
    if (ftruncate(fd, (off_t)len) != 0) { close(fd); return nullptr; }
  } else {
    /* joining: segment must already be at least the requested size */
    struct stat st;
    if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < len) {
      close(fd);
      return nullptr;
    }
  }
  void *p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
#ifdef MADV_HUGEPAGE
  /* best-effort THP for shmem-backed regions (kernels with
   * shmem_enabled=advise honor this; harmless everywhere else) */
  madvise(p, sz, MADV_HUGEPAGE);
#endif
  return p;
}

int fdtpu_wksp_leave(void *base, uint64_t sz) {
  return munmap(base, wksp_map_len(sz));
}

int fdtpu_wksp_unlink(const char *name) {
  const char *hugedir = getenv("FDTPU_HUGETLBFS");
  if (hugedir && hugedir[0]) {
    char path[512];
    int n = snprintf(path, sizeof path, "%s/%s", hugedir, name);
    if (n < 0 || (size_t)n >= sizeof path) {
      errno = ENAMETOOLONG;
      return -1;
    }
    return unlink(path);
  }
  return shm_unlink(name);
}

/* ---- ring ------------------------------------------------------------- */

uint64_t fdtpu_ring_footprint(uint64_t depth) {
  return align_up(sizeof(RingHdr) + depth * sizeof(Slot));
}

int fdtpu_ring_init(void *base, uint64_t off, uint64_t depth) {
  if (!depth || (depth & (depth - 1))) return -1;
  RingHdr *h = ring_hdr(base, off);
  h->magic = kRingMagic;
  h->depth = depth;
  h->seq.store(0, std::memory_order_relaxed);
  Slot *s = ring_slots(base, off);
  for (uint64_t i = 0; i < depth; i++) {
    /* sentinel: "this slot last held seq i - depth", never a valid seq */
    s[i].seq.store(i - depth, std::memory_order_relaxed);
  }
  std::atomic_thread_fence(std::memory_order_release);
  return 0;
}

uint64_t fdtpu_ring_depth(void *base, uint64_t off) {
  return ring_hdr(base, off)->depth;
}

uint64_t fdtpu_ring_seq(void *base, uint64_t off) {
  return ring_hdr(base, off)->seq.load(std::memory_order_acquire);
}

/* bit 63 marks a slot as write-in-progress; real seqs stay below 2^63 */
constexpr uint64_t kWip = 1ULL << 63;

uint64_t fdtpu_ring_prepare(void *base, uint64_t ring_off) {
  RingHdr *h = ring_hdr(base, ring_off);
  uint64_t seq = h->seq.load(std::memory_order_relaxed);
  Slot *s = ring_slots(base, ring_off) + (seq & (h->depth - 1));
  /* Invalidate BEFORE the payload chunk is overwritten: a speculative
   * reader of the old frag re-checks the slot seq after its copy and now
   * sees the wip marker instead of the old seq -> rejects torn data. */
  s->seq.store(seq | kWip, std::memory_order_release);
  return seq;
}

uint64_t fdtpu_ring_publish(void *base, uint64_t ring_off, uint64_t sig,
                            uint64_t payload_off, uint32_t sz, uint16_t ctl,
                            uint16_t orig) {
  RingHdr *h = ring_hdr(base, ring_off);
  uint64_t seq = h->seq.load(std::memory_order_relaxed);
  Slot *s = ring_slots(base, ring_off) + (seq & (h->depth - 1));
  s->sig = sig;
  s->off = (uint32_t)(payload_off >> 6);  /* 64B chunk index */
  s->sz = sz;
  s->ctl = ctl;
  s->orig = orig;
  s->tspub = (uint32_t)fdtpu_ticks();
  s->seq.store(seq, std::memory_order_release);
  h->seq.store(seq + 1, std::memory_order_release);
  return seq;
}

uint64_t fdtpu_ring_publish_buf(void *base, uint64_t ring_off, uint64_t sig,
                                const uint8_t *data, uint32_t sz,
                                uint64_t arena_off, uint64_t mtu,
                                uint16_t ctl, uint16_t orig) {
  RingHdr *h = ring_hdr(base, ring_off);
  uint64_t seq = fdtpu_ring_prepare(base, ring_off);
  uint64_t chunk = arena_off + (seq & (h->depth - 1)) * mtu;
  std::memcpy(at(base, chunk), data, sz);
  return fdtpu_ring_publish(base, ring_off, sig, chunk, sz, ctl, orig);
}

int64_t fdtpu_ring_publish_batch(void *base, uint64_t ring_off,
                                 const uint8_t *buf, uint64_t stride,
                                 const uint32_t *sizes,
                                 const uint64_t *sigs,
                                 const uint8_t *mask, int64_t start,
                                 int64_t n, uint64_t arena_off,
                                 uint64_t mtu, const uint64_t *fseq_offs,
                                 int n_fseq, int64_t *published) {
  /* Publish masked rows [start, n) of a gathered buffer in one native
   * call, honoring reliable-consumer credits. Returns the row index it
   * stopped at (== n when done; < n when credits ran out — the caller
   * heartbeats and resumes). Credits are re-queried in blocks so the
   * fseq loads stay off the per-row path. */
  RingHdr *h = ring_hdr(base, ring_off);
  int64_t credits = n_fseq ? fdtpu_fctl_credits(base, ring_off, fseq_offs,
                                                n_fseq)
                           : (int64_t)h->depth;
  int64_t i = start;
  for (; i < n; i++) {
    if (!mask[i]) continue;
    if (n_fseq && credits <= 0) {
      credits = fdtpu_fctl_credits(base, ring_off, fseq_offs, n_fseq);
      if (credits <= 0) break;
    }
    uint64_t seq = fdtpu_ring_prepare(base, ring_off);
    uint64_t chunk = arena_off + (seq & (h->depth - 1)) * mtu;
    /* clamp to BOTH the slot capacity and the source row width — a
     * size past the stride would read the next row's payload */
    uint64_t cap = mtu < stride ? mtu : stride;
    uint32_t sz = sizes[i] <= cap ? sizes[i] : (uint32_t)cap;
    std::memcpy(at(base, chunk), buf + (uint64_t)i * stride, sz);
    fdtpu_ring_publish(base, ring_off, sigs ? sigs[i] : 0, chunk, sz,
                       /*ctl=*/3, /*orig=*/0);
    credits--;
    if (published) (*published)++;
  }
  return i;
}

int fdtpu_ring_consume(void *base, uint64_t ring_off, uint64_t seq,
                       fdtpu_frag_t *out) {
  RingHdr *h = ring_hdr(base, ring_off);
  Slot *s = ring_slots(base, ring_off) + (seq & (h->depth - 1));
  uint64_t found = s->seq.load(std::memory_order_acquire);
  if (found != seq) {
    /* signed distance: slot behind us -> unpublished; ahead -> overrun */
    return ((int64_t)(found - seq) < 0) ? 1 : -1;
  }
  out->sig = s->sig;
  out->off = (uint64_t)s->off << 6;  /* chunk index -> byte offset */
  out->sz = s->sz;
  out->ctl = s->ctl;
  out->orig = s->orig;
  out->tspub = s->tspub;
  std::atomic_thread_fence(std::memory_order_acquire);
  uint64_t check = s->seq.load(std::memory_order_relaxed);
  if (check != seq) return -1; /* torn: producer lapped mid-copy */
  out->seq = seq;
  return 0;
}

/* ---- fseq ------------------------------------------------------------- */

uint64_t fdtpu_fseq_footprint(void) { return sizeof(Fseq); }

int fdtpu_fseq_init(void *base, uint64_t off, uint64_t seq0) {
  reinterpret_cast<Fseq *>(at(base, off))
      ->seq.store(seq0, std::memory_order_release);
  return 0;
}

uint64_t fdtpu_fseq_query(void *base, uint64_t off) {
  return reinterpret_cast<Fseq *>(at(base, off))
      ->seq.load(std::memory_order_acquire);
}

void fdtpu_fseq_update(void *base, uint64_t off, uint64_t seq) {
  reinterpret_cast<Fseq *>(at(base, off))
      ->seq.store(seq, std::memory_order_release);
}

/* ---- fctl ------------------------------------------------------------- */

int64_t fdtpu_fctl_credits(void *base, uint64_t ring_off,
                           const uint64_t *fseq_offs, int n_fseq) {
  RingHdr *h = ring_hdr(base, ring_off);
  uint64_t seq = h->seq.load(std::memory_order_relaxed);
  int64_t credits = (int64_t)h->depth;
  for (int i = 0; i < n_fseq; i++) {
    uint64_t cseq = fdtpu_fseq_query(base, fseq_offs[i]);
    /* UINT64_MAX is the STALE sentinel: a dead/restarting consumer's
     * fseq (marked by the supervisor) is excluded from credit flow so
     * a crashed reliable consumer cannot wedge its producer; the
     * restarted tile re-includes itself by publishing a real seq. */
    if (cseq == UINT64_MAX) continue;
    int64_t c = (int64_t)h->depth - (int64_t)(seq - cseq);
    if (c < credits) credits = c;
  }
  return credits < 0 ? 0 : credits;
}

/* ---- cnc -------------------------------------------------------------- */

uint64_t fdtpu_cnc_footprint(void) { return sizeof(Cnc); }

int fdtpu_cnc_init(void *base, uint64_t off) {
  Cnc *c = reinterpret_cast<Cnc *>(at(base, off));
  c->state.store(FDTPU_CNC_BOOT, std::memory_order_relaxed);
  c->heartbeat.store(0, std::memory_order_release);
  return 0;
}

uint32_t fdtpu_cnc_state(void *base, uint64_t off) {
  return reinterpret_cast<Cnc *>(at(base, off))
      ->state.load(std::memory_order_acquire);
}

void fdtpu_cnc_set_state(void *base, uint64_t off, uint32_t st) {
  reinterpret_cast<Cnc *>(at(base, off))
      ->state.store(st, std::memory_order_release);
}

void fdtpu_cnc_heartbeat(void *base, uint64_t off, uint64_t now) {
  reinterpret_cast<Cnc *>(at(base, off))
      ->heartbeat.store(now, std::memory_order_release);
}

uint64_t fdtpu_cnc_last_heartbeat(void *base, uint64_t off) {
  return reinterpret_cast<Cnc *>(at(base, off))
      ->heartbeat.load(std::memory_order_acquire);
}

/* ---- tcache ----------------------------------------------------------- */

uint64_t fdtpu_tcache_footprint(uint64_t depth) {
  uint64_t map_cnt = 1;
  while (map_cnt < 4 * depth) map_cnt <<= 1;
  return align_up(sizeof(TcacheHdr) + (depth + map_cnt) * sizeof(uint64_t));
}

int fdtpu_tcache_init(void *base, uint64_t off, uint64_t depth) {
  if (!depth) return -1;
  TcacheHdr *h = reinterpret_cast<TcacheHdr *>(at(base, off));
  uint64_t map_cnt = 1;
  while (map_cnt < 4 * depth) map_cnt <<= 1;
  h->depth = depth;
  h->map_cnt = map_cnt;
  h->next = 0;
  uint64_t *ring = reinterpret_cast<uint64_t *>(h + 1);
  uint64_t *map = ring + depth;
  std::memset(ring, 0, depth * sizeof(uint64_t));
  std::memset(map, 0, map_cnt * sizeof(uint64_t));
  return 0;
}

int fdtpu_tcache_query(void *base, uint64_t off, uint64_t tag) {
  /* presence check only — no mutation. The verify path queries before
   * spending device lanes and inserts only tags that PASSED verification
   * (reference ordering: src/disco/verify/fd_verify_tile.h:84-101), so a
   * failed signature can never poison the dedup window. */
  if (!tag) tag = 1;
  TcacheHdr *h = reinterpret_cast<TcacheHdr *>(at(base, off));
  uint64_t *ring = reinterpret_cast<uint64_t *>(h + 1);
  uint64_t *map = ring + h->depth;
  uint64_t mask = h->map_cnt - 1;
  uint64_t idx = tmix(tag) & mask;
  while (map[idx]) {
    if (map[idx] == tag) return 1;
    idx = (idx + 1) & mask;
  }
  return 0;
}

int fdtpu_tcache_insert(void *base, uint64_t off, uint64_t tag) {
  /* tag 0 is reserved as the map's empty marker; remap (rare, and fine
   * for dedup purposes: 0 and 1 alias) */
  if (!tag) tag = 1;
  TcacheHdr *h = reinterpret_cast<TcacheHdr *>(at(base, off));
  uint64_t *ring = reinterpret_cast<uint64_t *>(h + 1);
  uint64_t *map = ring + h->depth;
  uint64_t mask = h->map_cnt - 1;

  uint64_t idx = tmix(tag) & mask;
  while (map[idx]) {
    if (map[idx] == tag) return 1; /* duplicate */
    idx = (idx + 1) & mask;
  }
  /* insert; evict oldest if ring full */
  uint64_t victim = ring[h->next % h->depth];
  ring[h->next % h->depth] = tag;
  h->next++;
  map[idx] = tag;
  if (victim && h->next > h->depth) {
    /* delete victim from map with backward-shift deletion */
    uint64_t vi = tmix(victim) & mask;
    while (map[vi] != victim) {
      if (!map[vi]) return 0; /* already gone (aliased remap) */
      vi = (vi + 1) & mask;
    }
    map[vi] = 0;
    uint64_t hole = vi, scan = (vi + 1) & mask;
    while (map[scan]) {
      uint64_t home = tmix(map[scan]) & mask;
      /* can map[scan] legally move into the hole? */
      bool movable = ((scan - home) & mask) >= ((scan - hole) & mask);
      if (movable) {
        map[hole] = map[scan];
        map[scan] = 0;
        hole = scan;
      }
      scan = (scan + 1) & mask;
    }
  }
  return 0;
}

/* ---- batch gather ------------------------------------------------------ */

int64_t fdtpu_ring_gather(void *base, uint64_t ring_off, uint64_t *seq_io,
                          int64_t max_n, uint8_t *out_buf,
                          uint64_t out_stride, uint32_t *out_sz,
                          uint64_t *out_sig, uint64_t *overrun_cnt,
                          uint64_t *out_seq) {
  int64_t n = 0;
  uint64_t seq = *seq_io;
  fdtpu_frag_t frag;
  while (n < max_n) {
    int rc = fdtpu_ring_consume(base, ring_off, seq, &frag);
    if (rc == 1) break; /* caught up */
    if (rc == -1) {
      /* lapped: resync to oldest plausibly-live seq */
      uint64_t prod = fdtpu_ring_seq(base, ring_off);
      uint64_t depth = fdtpu_ring_depth(base, ring_off);
      uint64_t resync = prod > depth ? prod - depth : 0;
      if (overrun_cnt) *overrun_cnt += resync - seq;
      seq = resync;
      continue;
    }
    uint8_t *dst = out_buf + (uint64_t)n * out_stride;
    uint32_t sz = frag.sz <= out_stride ? frag.sz : (uint32_t)out_stride;
    std::memcpy(dst, at(base, frag.off), sz);
    /* re-validate after payload copy: payload bytes are only stable while
     * the slot seq is unchanged (speculative read contract) */
    fdtpu_frag_t check;
    if (fdtpu_ring_consume(base, ring_off, seq, &check) != 0) {
      uint64_t prod = fdtpu_ring_seq(base, ring_off);
      uint64_t depth = fdtpu_ring_depth(base, ring_off);
      uint64_t resync = prod > depth ? prod - depth : 0;
      if (resync <= seq) resync = seq + 1;  /* always make progress */
      if (overrun_cnt) *overrun_cnt += resync - seq;
      seq = resync;
      continue;
    }
    if (sz < out_stride) std::memset(dst + sz, 0, out_stride - sz);
    if (out_sz) out_sz[n] = sz;
    if (out_sig) out_sig[n] = frag.sig;
    if (out_seq) out_seq[n] = seq;  /* per-frag seq: round-robin sharding
                                       key (ref: fd_verify_tile.c:49-53) */
    n++;
    seq++;
  }
  *seq_io = seq;
  return n;
}

uint64_t fdtpu_ticks(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

/* ---- batched txn parse + verify lane assembly --------------------------
 *
 * The verify tile's host hot path: at target ingest rates a per-txn
 * Python loop is the bottleneck (SURVEY language rule: no Python
 * stand-ins on the native hot path), so parsing, dedup-tag hashing and
 * device-lane assembly run here over the whole gathered batch.
 * Semantics mirror protocol/txn.py::parse_txn exactly (which itself
 * mirrors the reference zero-copy parser, ref:
 * src/ballet/txn/fd_txn.h:181-227, fd_txn_parse.c) — the Python parser
 * remains the spec; tests/test_txn.py fuzzes the two against each other.
 */

namespace {

constexpr int kMtu = 1232;
constexpr int kSigMax = 12;
constexpr int kAcctMax = 128;
constexpr int kInstrMax = 64;

/* compact-u16: 1-3 byte varint, minimal encoding enforced */
inline bool cu16(const uint8_t *p, int len, int *off, uint32_t *out) {
  uint32_t v = 0;
  for (int i = 0; i < 3; i++) {
    if (*off >= len) return false;
    uint8_t b = p[(*off)++];
    v |= (uint32_t)(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) {
      if (i == 2 && b > 0x03) return false;
      if (i > 0 && b == 0) return false;   /* non-minimal */
      *out = v;
      return true;
    }
  }
  return false;
}

/* SipHash-1-3 (public domain algorithm; short-input keyed hash).
 * Plays the role of the reference's seeded fd_hash dedup tag
 * (ref: src/disco/verify/fd_verify_tile.h:82). */
inline uint64_t rotl64(uint64_t x, int b) { return (x << b) | (x >> (64 - b)); }

uint64_t siphash13(uint64_t k0, uint64_t k1, const uint8_t *data, size_t len) {
  uint64_t v0 = 0x736f6d6570736575ull ^ k0;
  uint64_t v1 = 0x646f72616e646f6dull ^ k1;
  uint64_t v2 = 0x6c7967656e657261ull ^ k0;
  uint64_t v3 = 0x7465646279746573ull ^ k1;
  auto round = [&]() {
    v0 += v1; v1 = rotl64(v1, 13); v1 ^= v0; v0 = rotl64(v0, 32);
    v2 += v3; v3 = rotl64(v3, 16); v3 ^= v2;
    v0 += v3; v3 = rotl64(v3, 21); v3 ^= v0;
    v2 += v1; v1 = rotl64(v1, 17); v1 ^= v2; v2 = rotl64(v2, 32);
  };
  size_t n = len & ~7ull;
  for (size_t i = 0; i < n; i += 8) {
    uint64_t m;
    std::memcpy(&m, data + i, 8);
    v3 ^= m;
    round();
    v0 ^= m;
  }
  uint64_t b = (uint64_t)len << 56;
  for (size_t i = n; i < len; i++) b |= (uint64_t)data[i] << (8 * (i - n));
  v3 ^= b; round(); v0 ^= b;
  v2 ^= 0xff; round(); round(); round();
  return v0 ^ v1 ^ v2 ^ v3;
}

struct TxnMeta {
  int32_t ok;        /* 1 = parsed */
  int32_t sig_cnt;
  int32_t sig_off;
  int32_t msg_off;
  int32_t acct_off;
  int32_t acct_cnt;
  int32_t version;   /* -1 legacy, 0 = v0 */
  int32_t hdr;       /* n_signed | n_ro_signed<<8 | n_ro_unsigned<<16 */
};
static_assert(sizeof(TxnMeta) == 32, "meta ABI");

bool parse_one(const uint8_t *p, int len, TxnMeta *m) {
  if (len > kMtu) return false;
  int off = 0;
  uint32_t sig_cnt;
  if (!cu16(p, len, &off, &sig_cnt)) return false;
  if (sig_cnt < 1 || sig_cnt > kSigMax) return false;
  int sig_off = off;
  off += 64 * (int)sig_cnt;
  if (off > len) return false;
  int msg_off = off;
  if (off >= len) return false;
  int version = -1;
  if (p[off] & 0x80) {
    version = p[off] & 0x7F;
    if (version != 0) return false;
    off++;
  }
  if (off + 3 > len) return false;
  uint32_t n_signed = p[off], n_ro_signed = p[off + 1],
           n_ro_unsigned = p[off + 2];
  off += 3;
  if (n_signed != sig_cnt) return false;
  if (n_ro_signed >= n_signed) return false;
  uint32_t acct_cnt;
  if (!cu16(p, len, &off, &acct_cnt)) return false;
  if (acct_cnt < n_signed || acct_cnt > kAcctMax) return false;
  if (n_ro_unsigned > acct_cnt - n_signed) return false;
  int acct_off = off;
  off += 32 * (int)acct_cnt;
  if (off > len) return false;
  off += 32;                              /* blockhash */
  if (off > len) return false;
  uint32_t instr_cnt;
  if (!cu16(p, len, &off, &instr_cnt)) return false;
  if (instr_cnt > kInstrMax) return false;
  for (uint32_t i = 0; i < instr_cnt; i++) {
    if (off >= len) return false;
    uint8_t prog_idx = p[off++];
    if (prog_idx >= acct_cnt) return false;
    uint32_t n_acct;
    if (!cu16(p, len, &off, &n_acct)) return false;
    if (off + (int)n_acct > len) return false;
    for (uint32_t a = 0; a < n_acct; a++)
      if (p[off + (int)a] >= acct_cnt) return false;
    off += (int)n_acct;
    uint32_t n_data;
    if (!cu16(p, len, &off, &n_data)) return false;
    off += (int)n_data;
    if (off > len) return false;
  }
  if (version == 0) {
    uint32_t alut_cnt;
    if (!cu16(p, len, &off, &alut_cnt)) return false;
    for (uint32_t i = 0; i < alut_cnt; i++) {
      off += 32;
      if (off > len) return false;
      uint32_t n_w;
      if (!cu16(p, len, &off, &n_w)) return false;
      off += (int)n_w;
      uint32_t n_ro;
      if (!cu16(p, len, &off, &n_ro)) return false;
      off += (int)n_ro;
      if (off > len) return false;
    }
  }
  if (off != len) return false;           /* trailing bytes */
  m->ok = 1;
  m->sig_cnt = (int32_t)sig_cnt;
  m->sig_off = sig_off;
  m->msg_off = msg_off;
  m->acct_off = acct_off;
  m->acct_cnt = (int32_t)acct_cnt;
  m->version = version;
  m->hdr = (int32_t)(n_signed | (n_ro_signed << 8) | (n_ro_unsigned << 16));
  return true;
}

}  // namespace

/* Parse a gathered batch; fill meta (n x 8 int32) and dedup tags (n u64,
 * SipHash-1-3 of the full 64-byte first signature, per-boot seeded).
 * Returns count of successfully parsed txns. */
int64_t fdtpu_txn_parse_batch(const uint8_t *buf, const uint32_t *sizes,
                              int64_t n, uint64_t stride,
                              uint64_t seed0, uint64_t seed1,
                              int32_t *meta_out, uint64_t *tags_out) {
  int64_t ok_cnt = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t *p = buf + (uint64_t)i * stride;
    TxnMeta *m = reinterpret_cast<TxnMeta *>(meta_out + 8 * i);
    std::memset(m, 0, sizeof(*m));
    if (parse_one(p, (int)sizes[i], m)) {
      tags_out[i] = siphash13(seed0, seed1, p + m->sig_off, 64);
      ok_cnt++;
    } else {
      tags_out[i] = 0;
    }
  }
  return ok_cnt;
}

/* Fill device verify lanes from parsed batch. One lane per signature of
 * every parsed, non-skipped txn, starting at txn *cursor_io. Stops when
 * lanes are full or txns exhausted; advances *cursor_io past consumed
 * txns (a txn's sigs never split across chunks). Unused lanes are zeroed
 * (dead lanes, masked by the caller). Returns lanes filled.
 * lane_txn[j] = source txn index. */
int64_t fdtpu_verify_assemble(const uint8_t *buf, const uint32_t *sizes,
                              const int32_t *meta, const uint8_t *skip,
                              int64_t n, uint64_t stride,
                              int64_t *cursor_io, int64_t cap,
                              uint64_t max_len,
                              uint8_t *lane_sig, uint8_t *lane_pub,
                              uint8_t *lane_msg, int32_t *lane_len,
                              int32_t *lane_txn) {
  int64_t lanes = 0;
  int64_t i = *cursor_io;
  for (; i < n; i++) {
    const TxnMeta *m = reinterpret_cast<const TxnMeta *>(meta + 8 * i);
    if (!m->ok || (skip && skip[i])) continue;
    if (lanes + m->sig_cnt > cap) break;
    const uint8_t *p = buf + (uint64_t)i * stride;
    uint32_t msg_len = sizes[i] - (uint32_t)m->msg_off;
    if (msg_len > max_len) continue;      /* cannot fit: drop (over-MTU) */
    for (int s = 0; s < m->sig_cnt; s++) {
      std::memcpy(lane_sig + 64 * lanes, p + m->sig_off + 64 * s, 64);
      std::memcpy(lane_pub + 32 * lanes, p + m->acct_off + 32 * s, 32);
      std::memcpy(lane_msg + max_len * lanes, p + m->msg_off, msg_len);
      std::memset(lane_msg + max_len * lanes + msg_len, 0, max_len - msg_len);
      lane_len[lanes] = (int32_t)msg_len;
      lane_txn[lanes] = (int32_t)i;
      lanes++;
    }
  }
  /* zero dead lanes' lengths + map */
  for (int64_t j = lanes; j < cap; j++) {
    lane_len[j] = 0;
    lane_txn[j] = -1;
  }
  *cursor_io = i;
  return lanes;
}

int fdtpu_tcache_query_batch(void *base, uint64_t off, const uint64_t *tags,
                             const uint8_t *mask, int64_t n, uint8_t *hit) {
  for (int64_t i = 0; i < n; i++)
    hit[i] = (mask && !mask[i]) ? 0
             : (uint8_t)fdtpu_tcache_query(base, off, tags[i]);
  return 0;
}

int fdtpu_tcache_insert_batch(void *base, uint64_t off, const uint64_t *tags,
                              const uint8_t *mask, int64_t n, uint8_t *dup) {
  for (int64_t i = 0; i < n; i++)
    dup[i] = (mask && !mask[i]) ? 0
             : (uint8_t)fdtpu_tcache_insert(base, off, tags[i]);
  return 0;
}

}  /* extern "C" */
