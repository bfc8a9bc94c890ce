// The bank's wave scan: a block of system-program transfers, staged into
// conflict-free waves, executed wave after wave against one balance table.
//
// Replaces firedancer_tpu/svm/executor.py `_scan_packed` (:111), a jitted
// `lax.scan` over waves (not a Pallas kernel): each scan step gathers the
// wave's source and destination balances as (hi, lo) uint32 pairs,
// charges fee and amount where payable, and scatters the results back.
//
// What bounds it on the H100: neither bytes (28 B a lane, 8 B an account)
// nor operations (some 20 integer operations a lane), but latency: the
// chain of W dependent wave steps, which no two waves may overlap. One
// block on one SM is the design (more blocks would need a grid-wide
// barrier between waves), so the design shortens each step:
//  * the staged table comes into shared memory by bulk asynchronous
//    copies (cp.async.bulk, the TMA's 1-D form), one a chunk of 256 to
//    2048 lanes (some four waves), each completing on its own mbarrier.
//    One elected thread issues them at entry, with the balances' two
//    halves, so the loads are in flight before the first wave; a thread
//    waits on a chunk's barrier once, and only the first wait costs a
//    round trip to device memory. A step then touches shared memory
//    alone, and where a thread has one lane a wave it loads the next
//    wave's row while this wave's lane runs;
//  * a table larger than the block's 227 KB runs through a ring of chunk
//    slots: a producer warp refills a slot as soon as every scanning
//    warp has released it (a full and an empty mbarrier a slot, the
//    phase parity flipping on every reuse), so refills overlap the scan;
//  * the scanning threads are C rounded up to a warp. At C <= 32, the
//    bank's own waves (every transfer writes its signer, so a wave of
//    16 signers has at most 16 lanes), one warp scans and a __syncwarp()
//    separates two waves; wider waves meet at a named barrier that the
//    producer warp never joins;
//  * a lane's status goes to shared memory and reaches device memory
//    once: by one bulk store at the end of the scan (the balances too,
//    where they are in shared memory), or, on the ring, by the producer
//    warp's coalesced stores when it retires the chunk's slot;
//  * the balances sit in shared memory as two uint32 halves when they fit
//    beside the slots the scan needs (8 B an account of the 227 KB), as
//    they do at any shape up to 12,600 accounts; else they are 64-bit
//    words in a device-memory scratch.
// Lanes of one wave are account-disjoint by the conflict DAG's
// construction (a transfer writes src and dst), so a wave's reads and
// writes never race. Within a lane the order is the reference's: src is
// charged and written first, then dst is read, credited and written, so
// a self-transfer nets to the fee alone. An inactive lane (act = 0:
// padding) does nothing and reports STATUS_PAD; so does a lane whose src
// or dst is not below A, which the stage never builds (the plain version
// does the same). Lamports are u64 with mod-2^64 arithmetic, as the
// reference's carry and borrow chains on uint32 halves: fee + amount may
// wrap, and every compare is unsigned.
//
// Sizes that are not a multiple of 16 bytes (a last chunk of an odd lane
// count, an A that is not a multiple of 4) are taken: the bulk copy moves
// the 16-byte part and the elected thread copies the remaining words
// with ordinary loads before it arrives on the barrier. The wrapper
// checks that every pointer it passes is 16-byte aligned.
//
// The chunk, slot and parity arithmetic is in FD_HD helpers that the
// host build (__CUDACC__ unset) shares: `wave_scan_host` runs the scan
// through the same ring, sequentially, and checks each barrier's parity.
//
// Plain PyTorch version: firedancer_tpu_torch/ops/cuda_wave.py
// `wave_scan_plain`.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FD_DEV __device__ __forceinline__
#define FD_HD __host__ __device__ __forceinline__
#define FD_HDM __host__ __device__ __forceinline__
#else
#include <string.h>
#include <vector>
#define FD_DEV static inline
#define FD_HD static inline
#define FD_HDM inline
#endif

#define STATUS_PAD (-1)
#define STATUS_OK 0
#define STATUS_INSUFFICIENT 1
#define STATUS_FEE_FAIL 2
#define LANE_WORDS 7    // src, dst, amt_hi, amt_lo, fee_hi, fee_lo, act
#define LANE_BYTES 28
#define LG_CHUNK_LANES 8        // 256 lanes, 7,168 bytes of table a chunk
#define LG_MAX_CHUNK_LANES 11
#define SMEM_DEFAULT (48 * 1024)
#define SMEM_MAX (227 * 1024)

// ---- the ring's arithmetic (kernel, launcher and host build) ----------
// Lanes are numbered flat, g = w * C + c (fewer than 2^31); chunk k holds
// lanes [k L, (k + 1) L), L = 2^lg; it lives in slot k % slots, and its
// load completes phase k / slots of that slot's full barrier and its
// release phase k / slots of the slot's empty barrier.
FD_HD int chunk_of(int g, int lg) { return g >> lg; }
FD_HD int slot_of(int k, int slots) { return k % slots; }
FD_HD uint32_t ring_parity(int k, int slots) {
  return (uint32_t)((k / slots) & 1);
}
// lanes in chunk k of a table of `lanes` lanes
FD_HD int chunk_lanes(int k, int lanes, int lg) {
  const int rem = lanes - (k << lg);
  return rem < (1 << lg) ? rem : 1 << lg;
}
// A position in the ring, advanced one chunk at a time, so that neither
// the kernel nor the host build divides by `slots` on the scan's path:
// slot == slot_of(k, slots) and par == ring_parity(k, slots) throughout.
struct RingPos {
  int k;
  int slot;
  uint32_t par;
};
FD_HD void ring_next(RingPos &r, int slots) {
  r.k++;
  if (++r.slot == slots) {
    r.slot = 0;
    r.par ^= 1;
  }
}
FD_HD void ring_seek(RingPos &r, int k, int slots) {
  while (r.k < k) ring_next(r, slots);
}
// the part of `bytes` a bulk copy moves; the rest is whole words
FD_HD uint32_t bulk_part(uint32_t bytes) { return bytes & ~15u; }
FD_HD int64_t round16(int64_t x) { return (x + 15) & ~(int64_t)15; }

struct WavePlan {
  int lanes;          // W * C
  int chunks;         // ceil(lanes / L)
  int lg;             // L = 2^lg lanes a chunk
  int slots;          // chunk slots in shared memory (all chunks: resident)
  int ring;           // slots < chunks: a producer warp refills them
  int sbal;           // the balances in shared memory, else in the scratch
  int scan_threads;   // C rounded up to a warp, at most 1024 (992 on the ring)
  int threads;        // scan_threads, + 32 for the producer warp on the ring
  int bal_words;      // words of one balance half in shared memory,
                      // the spare slot A included
  int off_tab, off_st, off_bal, smem;   // shared-memory layout, bytes
};

// shared memory of `slots` slots: 2 slots + 1 mbarriers, the slots' table
// rows and statuses, then the balances
FD_HD int64_t plan_smem(int64_t slots, int lg, int64_t bal_bytes) {
  return round16(8 * (2 * slots + 1)) + (slots << lg) * (LANE_BYTES + 4)
      + bal_bytes;
}

// The launch's plan for W x C lanes over A accounts. A chunk holds some
// four waves, at least 2^LG_CHUNK_LANES lanes, where a wave has at most
// one lane a scanning thread, and 2^LG_MAX_CHUNK_LANES lanes for wider
// waves: each chunk costs every thread a wait and every warp a release.
// A resident table takes as many slots as chunks, else the ring as many
// as fit.
// A ring needs (scan threads - 1) / L + 2 slots at least: a warp waiting
// at the wave barrier holds the chunks of its last 32 lanes, and the
// wave's other warps may need every chunk up to the wave's end. The
// balances go to shared memory when they fit beside that many slots.
FD_HD WavePlan wave_plan(int W, int C, int A) {
  WavePlan p;
  p.lanes = W * C;
  p.lg = C <= 1024 - 32 ? LG_CHUNK_LANES : LG_MAX_CHUNK_LANES;
  while (p.lg < LG_MAX_CHUNK_LANES && (1 << p.lg) < 4 * C) p.lg++;
  p.chunks = (int)(((int64_t)p.lanes + (1 << p.lg) - 1) >> p.lg);
  int t = ((C + 31) / 32) * 32;
  t = t < 32 ? 32 : (t > 1024 ? 1024 : t);
  const int ring_t = t > 1024 - 32 ? 1024 - 32 : t;
  const int64_t need = ((ring_t - 1) >> p.lg) + 2;
  const int64_t fewest = p.chunks < need ? p.chunks : need;
  const int64_t bal = 2 * round16(((int64_t)A + 1) * 4);
  p.sbal = plan_smem(fewest, p.lg, bal) <= SMEM_MAX;
  const int64_t bal_in = p.sbal ? bal : 0;
  int64_t n = p.chunks;
  const int64_t fit =
      (SMEM_MAX - bal_in) / (((int64_t)(LANE_BYTES + 4) << p.lg) + 16) + 1;
  if (n > fit) n = fit;
  while (n > fewest && plan_smem(n, p.lg, bal_in) > SMEM_MAX) n--;
  if (n < fewest) n = fewest;
  p.slots = (int)n;
  p.ring = n < p.chunks;
  p.scan_threads = p.ring ? ring_t : t;
  p.threads = p.scan_threads + (p.ring ? 32 : 0);
  p.bal_words = (int)(round16(((int64_t)A + 1) * 4) / 4);
  p.off_tab = (int)round16(8 * (2 * n + 1));
  p.off_st = p.off_tab + (int)((n << p.lg) * LANE_BYTES);
  p.off_bal = p.off_st + (int)((n << p.lg) * 4);
  p.smem = p.off_bal + (int)bal_in;
  return p;
}

// The balance table as two uint32 halves (shared memory, or the host
// build's output) or as 64-bit words (the device-memory scratch).
struct Halves {
  uint32_t *hi, *lo;
  FD_HDM uint64_t get(uint32_t i) const {
    return ((uint64_t)hi[i] << 32) | lo[i];
  }
  FD_HDM void put(uint32_t i, uint64_t v) const {
    hi[i] = (uint32_t)(v >> 32);
    lo[i] = (uint32_t)v;
  }
};
struct Words {
  uint64_t *w;
  FD_HDM uint64_t get(uint32_t i) const { return w[i]; }
  FD_HDM void put(uint32_t i, uint64_t v) const { w[i] = v; }
};

// One lane of one wave against the balance table b of A accounts and a
// spare slot A. Without a branch, so that the lanes of a warp never
// diverge: a dead lane (not `on`, inactive, or src or dst not below A)
// runs the same loads and stores against the spare slot, whose value no
// live lane reads, and reports STATUS_PAD. The src and dst balances are
// read together, one round trip where the reference's order would take
// two.
template <class B>
FD_HD int32_t wave_lane(const B &b, const uint32_t *row, uint32_t A,
                        bool on) {
  const bool live = on && row[6] && row[0] < A && row[1] < A;
  const uint32_t s = live ? row[0] : A, d = live ? row[1] : A;
  const uint64_t amt = ((uint64_t)row[2] << 32) | row[3];
  const uint64_t fee = ((uint64_t)row[4] << 32) | row[5];
  const uint64_t need = amt + fee;                    // wraps mod 2^64
  const uint64_t sb = b.get(s), db = b.get(d);     // both reads at once:
  const bool fee_ok = sb >= fee, ok = sb >= need;  // dst is read after the
  const uint64_t sn = sb - (ok ? need : (fee_ok ? fee : 0));   // src write
  b.put(s, sn);                                   // only where they are
  b.put(d, (s == d ? sn : db) + (ok ? amt : 0));  // one account
  return !live ? STATUS_PAD
       : ok ? STATUS_OK : (fee_ok ? STATUS_INSUFFICIENT : STATUS_FEE_FAIL);
}

// The statuses of chunk k, kept in slot s, to device memory: lanes i0,
// i0 + step, ... of the chunk.
FD_HD void flush_chunk(int32_t *status, const int32_t *sst, int k, int s,
                       const WavePlan &p, int i0, int step) {
  const int n = chunk_lanes(k, p.lanes, p.lg);
  int32_t *out = status + ((int64_t)k << p.lg);
  const int32_t *in = sst + (s << p.lg);
  for (int i = i0; i < n; i += step) out[i] = in[i];
}

#ifdef __CUDACC__
FD_DEV uint32_t smem_addr(const void *p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
FD_DEV void mbar_init(uint64_t *b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(b)), "r"(count) : "memory");
}
FD_DEV void mbar_arrive(uint64_t *b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(b)) : "memory");
}
FD_DEV void mbar_arrive_tx(uint64_t *b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(b)), "r"(bytes) : "memory");
}
FD_DEV bool mbar_try_wait(uint64_t *b, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(smem_addr(b)), "r"(parity) : "memory");
  return done;
}
// Wait for the phase of parity `parity` to complete. A wait that never
// completes (a byte count that does not match its copies) traps after
// some 2^34 clocks, so the launch fails instead of holding the card.
FD_DEV void mbar_wait(uint64_t *b, uint32_t parity) {
  if (mbar_try_wait(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(b, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory to shared memory, completing on barrier b
FD_DEV void bulk_load(void *dst, const void *src, uint32_t bytes,
                      uint64_t *b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}
// `words` words to shared memory on barrier b (one arrival): the bulk
// part by the copy engine, the rest by this thread before it arrives
FD_DEV void stage_words(uint32_t *dst, const uint32_t *src, int words,
                        uint64_t *b) {
  const uint32_t bytes = (uint32_t)words * 4, part = bulk_part(bytes);
  for (uint32_t w = part / 4; w < bytes / 4; w++) dst[w] = src[w];
  mbar_arrive_tx(b, part);
  if (part) bulk_load(dst, src, part, b);
}
// both balance halves on one barrier
FD_DEV void stage_balances(uint32_t *bhi, uint32_t *blo,
                           const uint32_t *bal_hi, const uint32_t *bal_lo,
                           int A, uint64_t *b) {
  const uint32_t bytes = (uint32_t)A * 4, part = bulk_part(bytes);
  for (uint32_t w = part / 4; w < bytes / 4; w++) {
    bhi[w] = bal_hi[w];
    blo[w] = bal_lo[w];
  }
  mbar_arrive_tx(b, 2 * part);
  if (part) {
    bulk_load(bhi, bal_hi, part, b);
    bulk_load(blo, bal_lo, part, b);
  }
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared
// memory to device memory in the calling thread's bulk group
FD_DEV void bulk_store(void *dst, const void *src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}
// n words from shared memory to device memory: one bulk store where
// both ends are 16-byte aligned and n a multiple of 4 (by thread 0 of
// the step), else by threads t, t + step, ... one word each
FD_DEV void store_out(uint32_t *dst, const uint32_t *src, int n, int t,
                      int step) {
  if (!((((uintptr_t)dst | (uintptr_t)src) & 15) | (n & 3))) {
    if (t == 0 && n) bulk_store(dst, src, (uint32_t)n * 4);
  } else {
    for (int i = t; i < n; i += step) dst[i] = src[i];
  }
}
FD_DEV void scan_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}
// the chunk-k slot, given the ring position `at` at a chunk k' >= k
// with k' - k < slots
FD_DEV int slot_back(const RingPos &at, int k, int slots) {
  const int s = at.slot - (at.k - k);
  return s < 0 ? s + slots : s;
}

template <bool SBAL> struct BalOf { typedef Halves type; };
template <> struct BalOf<false> { typedef Words type; };

// RING: slots < chunks, a producer warp after the scanning warps.
// SBAL: balances in shared memory, else in gbal (A + 1 64-bit words).
// WARP1: one scanning warp (C <= 32), waves separated by __syncwarp().
//
// Waves of at most one lane a scanning thread (C <= scan threads, every
// wave of the bank) run the uniform loop: every thread waits on the
// chunks up to a wave's last lane, a thread past C shadows lane C - 1 as
// a dead lane, the row of wave w + 1 is loaded while wave w's lane runs
// (where the ring holds two waves' chunks), and on the ring thread 0
// releases a wave's chunks after the wave barrier (one arrival a slot).
// Wider waves run the general loop: each thread waits on its lanes'
// chunks and each warp releases the chunks below its lanes (one arrival
// a warp).
template <bool RING, bool SBAL, bool WARP1>
__global__ void __launch_bounds__(1024)
    wave_scan_kernel(const uint32_t *__restrict__ packed, int W, int C,
                     const uint32_t *__restrict__ bal_hi,
                     const uint32_t *__restrict__ bal_lo, int A,
                     uint32_t *__restrict__ out_hi,
                     uint32_t *__restrict__ out_lo,
                     int32_t *__restrict__ status, uint64_t *gbal,
                     const WavePlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t *full = (uint64_t *)smem, *empty = full + p.slots;
  uint64_t *bal_bar = full + 2 * p.slots;
  uint32_t *tab = (uint32_t *)(smem + p.off_tab);
  int32_t *sst = (int32_t *)(smem + p.off_st);
  uint32_t *bhi = (uint32_t *)(smem + p.off_bal), *blo = bhi + p.bal_words;
  const int nscan = WARP1 ? 32 : p.scan_threads, t = threadIdx.x;
  const int lg = p.lg;
  const bool narrow = WARP1 || C <= nscan;   // one lane a thread a wave
  const int first = p.chunks < p.slots ? p.chunks : p.slots;
  // the copies issued at entry: every chunk of a resident table; on the
  // ring the first two, so that the copy engine, which shares its rate
  // among the copies in flight, delivers them and the balances first
  const int early = RING && first > 2 ? 2 : first;
  if (t == (RING ? nscan : 0)) {   // the producer's lane 0, or thread 0
    for (int s = 0; s < p.slots; s++) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], narrow ? 1 : nscan / 32);
    }
    mbar_init(bal_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (SBAL) stage_balances(bhi, blo, bal_hi, bal_lo, A, bal_bar);
    for (int k = 0; k < early; k++)
      stage_words(tab + (k << lg) * LANE_WORDS,
                  packed + ((int64_t)k << lg) * LANE_WORDS,
                  chunk_lanes(k, p.lanes, lg) * LANE_WORDS, &full[k]);
  }
  if (!SBAL && t < nscan)
#pragma unroll 4
    for (int a = t; a < A; a += nscan)
      gbal[a] = ((uint64_t)bal_hi[a] << 32) | bal_lo[a];
  __syncthreads();                   // barriers initialised
  if (RING && t >= nscan) {          // the producer warp
    const int pl = t - nscan;
    if (pl == 0) {                   // the rest of the first fill
      mbar_wait(&full[0], 0);
      for (int k = early; k < first; k++)
        stage_words(tab + (k << lg) * LANE_WORDS,
                    packed + ((int64_t)k << lg) * LANE_WORDS,
                    chunk_lanes(k, p.lanes, lg) * LANE_WORDS, &full[k]);
    }
    RingPos r = {p.slots, 0, 1};     // refill chunk k into slot k % slots
    for (; r.k < p.chunks; ring_next(r, p.slots)) {
      mbar_wait(&empty[r.slot], r.par ^ 1);   // chunk k - slots released
      flush_chunk(status, sst, r.k - p.slots, r.slot, p, pl, 32);
      __syncwarp();                  // the flush read the statuses
      if (pl == 0)
        stage_words(tab + (r.slot << lg) * LANE_WORDS,
                    packed + ((int64_t)r.k << lg) * LANE_WORDS,
                    chunk_lanes(r.k, p.lanes, lg) * LANE_WORDS,
                    &full[r.slot]);
    }
    r.k -= p.slots;                  // the last chunks, never refilled
    r.par ^= 1;
    for (; r.k < p.chunks; ring_next(r, p.slots)) {
      mbar_wait(&empty[r.slot], r.par);
      flush_chunk(status, sst, r.k, r.slot, p, pl, 32);
    }
    return;
  }
  typename BalOf<SBAL>::type bal;
  if constexpr (SBAL) {
    bal = Halves{bhi, blo};
    mbar_wait(bal_bar, 0);
  } else {
    bal = Words{gbal};
  }
  if (narrow && p.lanes > 0) {
    const bool on = t < C;
    const int c = on ? t : C - 1;
    // ahead: the chunks of wave w + 1 are waited for during wave w, which
    // a ring allows when it holds two waves' chunks and one more
    const int span = (C - 1 + (1 << lg) - 1) / (1 << lg) + 1;
    const bool ahead = !RING || p.slots >= 2 * span + 1;
    RingPos have = {-1, -1, 0};      // the last chunk waited for
    RingPos rel = {0, 0, 0};         // the next chunk to release
    const auto wait_to = [&](int k) {
      for (; have.k < k; ) {
        ring_next(have, p.slots);
        mbar_wait(&full[have.slot], have.par);
      }
    };
    // lane g's place in the slots: g itself in a resident table
    const auto at = [&](int g) {
      return RING ? (slot_back(have, chunk_of(g, lg), p.slots) << lg)
                        + (g & ((1 << lg) - 1))
                  : g;
    };
    const auto load = [&](uint32_t *dst, int g) {
      const uint32_t *src = tab + at(g) * LANE_WORDS;
      for (int j = 0; j < LANE_WORDS; j++) dst[j] = src[j];
    };
    uint32_t row[LANE_WORDS], next[LANE_WORDS];
    if (ahead) {
      wait_to(chunk_of(C - 1, lg));
      load(row, c);
    }
#pragma unroll 1
    for (int w = 0, g = c; w < W; w++, g += C) {
      if (ahead) {
        if (w + 1 < W) {
          wait_to(chunk_of((w + 2) * C - 1, lg));
          load(next, g + C);
        }
      } else {
        wait_to(chunk_of((w + 1) * C - 1, lg));
        load(row, g);
      }
      const int32_t v = wave_lane(bal, row, A, on);
      if (on) sst[at(g)] = v;
      if (WARP1) __syncwarp();       // wave w's writes before wave w + 1
      else scan_barrier(nscan);
      if (RING)                      // chunks wholly below wave w + 1
        for (; rel.k < chunk_of((w + 1) * C, lg); ring_next(rel, p.slots))
          if (t == 0) mbar_arrive(&empty[rel.slot]);
      if (ahead)
        for (int j = 0; j < LANE_WORDS; j++) row[j] = next[j];
    }
    if (RING)                        // the producer flushes the rest
      for (; rel.k < p.chunks; ring_next(rel, p.slots))
        if (t == 0) mbar_arrive(&empty[rel.slot]);
  } else if (p.lanes > 0) {
    const int lane = t & 31, wbase = t & ~31;
    RingPos have = {-1, -1, 0};      // the chunk this thread waited for
    RingPos rel = {0, 0, 0};         // the next chunk the warp releases
    const uint32_t *rows = tab;
    int32_t *st = sst;
#pragma unroll 1
    for (int w = 0; w < W; w++) {
      const int g0 = w * C;
#pragma unroll 1
      for (int c0 = wbase; c0 < C; c0 += nscan) {
        if (RING) {                  // chunks below the warp's lanes
          const int lo_k = chunk_of(g0 + c0, lg);
          if (lo_k > rel.k) {
            __syncwarp();
            for (; rel.k < lo_k; ring_next(rel, p.slots))
              if (lane == 0) mbar_arrive(&empty[rel.slot]);
          }
        }
        const int c = c0 + lane;
        if (c < C) {
          const int g = g0 + c, k = chunk_of(g, lg);
          if (k != have.k) {
            ring_seek(have, k, p.slots);
            mbar_wait(&full[have.slot], have.par);
            rows = tab + (have.slot << lg) * LANE_WORDS;
            st = sst + (have.slot << lg);
          }
          const int i = g & ((1 << lg) - 1);
          st[i] = wave_lane(bal, rows + i * LANE_WORDS, A, true);
        }
      }
      if (WARP1) __syncwarp();       // wave w's writes before wave w + 1
      else scan_barrier(nscan);
    }
    if (RING) {                      // the producer flushes the rest
      __syncwarp();
      for (; rel.k < p.chunks; ring_next(rel, p.slots))
        if (lane == 0) mbar_arrive(&empty[rel.slot]);
    }
  }
  // the results: statuses (a resident table's; the producer flushes the
  // ring's) and balances from shared memory by bulk stores where aligned
  if (SBAL || !RING) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (WARP1) __syncwarp();         // every write before the bulk stores
    else scan_barrier(nscan);
  }
  if (!RING)
    store_out((uint32_t *)status, (const uint32_t *)sst, p.lanes, t, nscan);
  if (SBAL) {
    store_out(out_hi, bhi, A, t, nscan);
    store_out(out_lo, blo, A, t, nscan);
  } else {
#pragma unroll 4
    for (int a = t; a < A; a += nscan) {
      const uint64_t v = gbal[a];
      out_hi[a] = (uint32_t)(v >> 32);
      out_lo[a] = (uint32_t)v;
    }
  }
  if (t == 0) {                      // the bulk stores have read their
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");   // sources
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

typedef void (*WaveKernel)(const uint32_t *, int, int, const uint32_t *,
                           const uint32_t *, int, uint32_t *, uint32_t *,
                           int32_t *, uint64_t *, const WavePlan);
static const WaveKernel KERNELS[8] = {
    wave_scan_kernel<false, false, false>, wave_scan_kernel<false, false, true>,
    wave_scan_kernel<false, true, false>,  wave_scan_kernel<false, true, true>,
    wave_scan_kernel<true, false, false>,  wave_scan_kernel<true, false, true>,
    wave_scan_kernel<true, true, false>,   wave_scan_kernel<true, true, true>};

// packed (W, C, 7) uint32, bal_hi / bal_lo (A,) uint32 -> out_hi / out_lo
// (A,) uint32, status (W, C) int32; gbal: A + 1 uint64 of scratch (the
// spare slot A last), used (and then required) only when the plan keeps
// the balances out of shared memory, which it never does for A <=
// 12,600. Device pointers, packed, bal_hi and bal_lo
// 16-byte aligned, W x C below 2^31; launches on `stream` and returns
// cudaGetLastError().
extern "C" int fdtt_wave_scan(const void *packed, int W, int C,
                              const void *bal_hi, const void *bal_lo, int A,
                              void *out_hi, void *out_lo, void *status,
                              void *gbal, void *stream) {
  static bool opted[8];              // per instance, once per process
  if (W < 0 || C < 0 || A < 0 || (int64_t)W * C >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const WavePlan p = wave_plan(W, C, A);
  if (!p.sbal && !gbal) return (int)cudaErrorInvalidValue;
  const int inst = 4 * p.ring + 2 * p.sbal + (p.scan_threads == 32);
  const WaveKernel fn = KERNELS[inst];
  if (p.smem > SMEM_DEFAULT && !opted[inst]) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void *)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted[inst] = true;
  }
  fn<<<1, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const uint32_t *)packed, W, C, (const uint32_t *)bal_hi,
      (const uint32_t *)bal_lo, A, (uint32_t *)out_hi, (uint32_t *)out_lo,
      (int32_t *)status, (uint64_t *)gbal, p);
  return (int)cudaGetLastError();
}
#else
// Host build: the scan through the same ring, one lane after another (a
// wave's lanes are account-disjoint, so their order within the wave does
// not matter): a chunk is loaded into its slot when its first lane is
// reached, after the statuses of the slot's previous chunk are flushed;
// the producer's and the scanning side's ring positions advance as the
// kernel's do, and each barrier's completed phases are counted per slot.
// -> 0; 1 if a position or a parity disagrees with slot_of and
// ring_parity; 2 if the scanning side would read a slot that holds
// another chunk.
extern "C" int wave_scan_host(const uint32_t *packed, int W, int C,
                              const uint32_t *bal_hi, const uint32_t *bal_lo,
                              int A, uint32_t *out_hi, uint32_t *out_lo,
                              int32_t *status, int lg, int slots) {
  WavePlan p = wave_plan(W, C, A);
  p.lg = lg;
  p.chunks = (p.lanes + (1 << lg) - 1) >> lg;
  p.slots = slots;
  std::vector<uint32_t> tab(((size_t)slots << lg) * LANE_WORDS);
  std::vector<int32_t> sst((size_t)slots << lg);
  std::vector<int64_t> phases(2 * (size_t)slots, 0);   // full, empty
  std::vector<int> held((size_t)slots, -1);            // chunk in a slot
  std::vector<uint32_t> hi(bal_hi, bal_hi + A), lo(bal_lo, bal_lo + A);
  hi.push_back(0);                   // the spare slot A
  lo.push_back(0);
  const Halves bal = {hi.data(), lo.data()};
  RingPos load = {0, 0, 0};          // the producer: the next chunk to load
  RingPos have = {-1, -1, 0};        // the scanning side
  for (int g = 0; g < p.lanes; g++) {
    const int k = chunk_of(g, lg);
    for (; load.k <= k; ring_next(load, slots)) {
      const int s = load.slot;
      if (s != slot_of(load.k, slots) || load.par != ring_parity(load.k,
                                                                 slots))
        return 1;
      if (load.k >= slots) {         // wait on the release of k - slots
        if ((uint32_t)(phases[slots + s]++ & 1) != (load.par ^ 1)) return 1;
        flush_chunk(status, sst.data(), load.k - slots, s, p, 0, 1);
      }
      const uint32_t bytes = (uint32_t)chunk_lanes(load.k, p.lanes, lg)
                             * LANE_BYTES;
      uint32_t *dst = tab.data() + ((size_t)s << lg) * LANE_WORDS;
      const uint32_t *src = packed + ((int64_t)load.k << lg) * LANE_WORDS;
      memcpy(dst, src, bulk_part(bytes));
      for (uint32_t w = bulk_part(bytes) / 4; w < bytes / 4; w++)
        dst[w] = src[w];
      if ((uint32_t)(phases[s]++ & 1) != load.par) return 1;
      held[s] = load.k;
    }
    if (k != have.k) {
      ring_seek(have, k, slots);
      if (held[have.slot] != k) return 2;
    }
    const int at = (have.slot << lg) + (g & ((1 << lg) - 1));
    sst[at] = wave_lane(bal, tab.data() + (size_t)at * LANE_WORDS,
                        (uint32_t)A, true);
  }
  for (int k = p.chunks > slots ? p.chunks - slots : 0; k < p.chunks;
       k++) {                        // the last releases
    const int s = slot_of(k, slots);
    if ((uint32_t)(phases[slots + s]++ & 1) != ring_parity(k, slots))
      return 1;
    flush_chunk(status, sst.data(), k, s, p, 0, 1);
  }
  memcpy(out_hi, hi.data(), (size_t)A * 4);
  memcpy(out_lo, lo.data(), (size_t)A * 4);
  return 0;
}
#endif

// wave_plan for the wrapper and the tests: out = (ring, sbal, slots,
// chunks, chunk lanes, scan_threads, threads, smem bytes).
extern "C" void fdtt_wave_plan(int W, int C, int A, int64_t *out) {
  const WavePlan p = wave_plan(W, C, A);
  const int64_t v[8] = {p.ring, p.sbal, p.slots, p.chunks, (int64_t)1 << p.lg,
                        p.scan_threads, p.threads, p.smem};
  for (int i = 0; i < 8; i++) out[i] = v[i];
}
