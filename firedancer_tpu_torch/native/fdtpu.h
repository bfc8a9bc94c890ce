/* fdtpu — native host runtime for the TPU-native Firedancer rebuild.
 *
 * Re-expression (NOT a port) of the reference's intra-host messaging layer
 * semantics (reference: src/tango/ — mcache/dcache/fseq/fctl/cnc/tcache;
 * design contract in src/tango/fd_tango_base.h:24-112):
 *
 *   - single-producer descriptor rings with 64-bit monotone sequence
 *     numbers; consumers NEVER block the producer — an overrun consumer
 *     detects the seq gap and resynchronizes (lossy, "unreliable" mode);
 *   - reliable consumers exert credit-based backpressure by publishing
 *     their progress sequence (fseq) which the producer folds into its
 *     credit budget (fctl);
 *   - payloads live in a separate arena ("chunk" offsets valid in any
 *     address space, so multiple processes can map the workspace at
 *     different base addresses);
 *   - per-slot seqlock publish: payload + fields first, release-store of
 *     the slot's seq last; a speculative reader re-checks the slot seq
 *     after copying to detect tearing.
 *
 * Everything lives inside a named shared-memory "workspace" (reference:
 * src/util/wksp/fd_wksp.h:27-47) addressed by byte offsets.
 *
 * This layer is the bridge ABI between host tiles (C++ or Python) and the
 * TPU dispatch loop — exactly the role the tango ABI plays for the
 * reference's FPGA sigverify offload (src/wiredancer/README.md:12,106-121).
 */
#ifndef FDTPU_H
#define FDTPU_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---- frag descriptor ------------------------------------------------- */

/* Consumer-side copy of a ring slot (the in-ring slot itself is 32 bytes
 * and stores the payload offset as a 64-byte chunk index in 32 bits).
 * `seq` doubles as the seqlock version: slot valid iff slot.seq ==
 * expected ring seq for that slot. */
typedef struct {
  uint64_t seq;    /* published sequence number (release-stored last)   */
  uint64_t sig;    /* producer-defined signature for rx-side filtering  */
  uint64_t off;    /* payload BYTE offset within the workspace          */
  uint32_t sz;     /* payload size in bytes                             */
  uint16_t ctl;    /* bit0 SOM, bit1 EOM, bit2 ERR                      */
  uint16_t orig;   /* origin lane / tile id                             */
  uint32_t tspub;  /* publish timestamp (ticks, truncated)              */
} fdtpu_frag_t;

#define FDTPU_CTL_SOM 1u
#define FDTPU_CTL_EOM 2u
#define FDTPU_CTL_ERR 4u

/* ---- workspace ------------------------------------------------------- */

/* Create-or-join a named shared memory workspace of `sz` bytes.
 * Returns the local mapping address, or NULL on failure.
 * All intra-workspace references are byte offsets from this base. */
void   *fdtpu_wksp_join(const char *name, uint64_t sz, int create);
int     fdtpu_wksp_leave(void *base, uint64_t sz);
int     fdtpu_wksp_unlink(const char *name);

/* ---- ring (descriptor ring + optional payload arena) ------------------ */

/* Ring header lives in the workspace; depth must be a power of two.
 * Footprint = header + depth * sizeof(fdtpu_frag_t). */
uint64_t fdtpu_ring_footprint(uint64_t depth);
/* Initialize a ring at workspace offset `off`. Returns 0 on success. */
int      fdtpu_ring_init(void *base, uint64_t off, uint64_t depth);
uint64_t fdtpu_ring_depth(void *base, uint64_t off);
/* Producer-side cached sequence (next to publish). */
uint64_t fdtpu_ring_seq(void *base, uint64_t off);

/* Publish protocol (single producer):
 *   1. fdtpu_ring_prepare(): invalidates the next slot (release-stores a
 *      wip-marked seq so speculative readers of the OLD payload fail their
 *      re-check) and returns the seq about to be published.
 *   2. producer writes the payload bytes into the arena chunk.
 *   3. fdtpu_ring_publish(): fills descriptor fields, release-stores seq.
 * Payload offsets are stored as 64-byte chunk indices in 32 bits
 * (addressing up to 256 GiB of workspace); `payload_off` must be 64-byte
 * aligned. */
uint64_t fdtpu_ring_prepare(void *base, uint64_t ring_off);
uint64_t fdtpu_ring_publish(void *base, uint64_t ring_off,
                            uint64_t sig, uint64_t payload_off,
                            uint32_t sz, uint16_t ctl, uint16_t orig);
/* One-shot prepare+copy+publish for C-side producers. */
uint64_t fdtpu_ring_publish_buf(void *base, uint64_t ring_off, uint64_t sig,
                                const uint8_t *data, uint32_t sz,
                                uint64_t arena_off, uint64_t mtu,
                                uint16_t ctl, uint16_t orig);
/* Credit-gated batch publish of masked rows [start, n) of a gathered
 * (n, stride) buffer; returns the stop row (== n when complete, < n
 * when out of credits — heartbeat and resume). *published counts rows
 * actually sent. */
int64_t fdtpu_ring_publish_batch(void *base, uint64_t ring_off,
                                 const uint8_t *buf, uint64_t stride,
                                 const uint32_t *sizes,
                                 const uint64_t *sigs,
                                 const uint8_t *mask, int64_t start,
                                 int64_t n, uint64_t arena_off,
                                 uint64_t mtu, const uint64_t *fseq_offs,
                                 int n_fseq, int64_t *published);

/* Speculative consume at `seq`:
 *   returns  0: frag copied into *out (stable — seq re-check passed)
 *   returns  1: not yet published (caller spins / does housekeeping)
 *   returns -1: overrun — producer lapped the consumer; caller must
 *               resynchronize (e.g. jump to fdtpu_ring_seq - depth).   */
int fdtpu_ring_consume(void *base, uint64_t ring_off, uint64_t seq,
                       fdtpu_frag_t *out);

/* ---- fseq: published consumer progress -------------------------------- */

uint64_t fdtpu_fseq_footprint(void);
int      fdtpu_fseq_init(void *base, uint64_t off, uint64_t seq0);
uint64_t fdtpu_fseq_query(void *base, uint64_t off);
void     fdtpu_fseq_update(void *base, uint64_t off, uint64_t seq);

/* ---- fctl: producer credit computation --------------------------------
 * Credits = min over reliable consumers of
 *   depth - (producer_seq - consumer_fseq)
 * i.e. how many more frags can be published before overwriting a slot a
 * reliable consumer has not yet processed (reference semantics:
 * src/tango/fctl/fd_fctl.h:4-10 — "backpressure ... use sparingly"). */
int64_t fdtpu_fctl_credits(void *base, uint64_t ring_off,
                           const uint64_t *fseq_offs, int n_fseq);

/* ---- cnc: command & control + heartbeat ------------------------------- */

enum {
  FDTPU_CNC_BOOT = 0,
  FDTPU_CNC_RUN  = 1,
  FDTPU_CNC_HALT = 2,
  FDTPU_CNC_FAIL = 3,
};
uint64_t fdtpu_cnc_footprint(void);
int      fdtpu_cnc_init(void *base, uint64_t off);
uint32_t fdtpu_cnc_state(void *base, uint64_t off);
void     fdtpu_cnc_set_state(void *base, uint64_t off, uint32_t st);
void     fdtpu_cnc_heartbeat(void *base, uint64_t off, uint64_t now);
uint64_t fdtpu_cnc_last_heartbeat(void *base, uint64_t off);

/* ---- tcache: 64-bit tag dedup (ring + open-address map) --------------- */


uint64_t fdtpu_tcache_footprint(uint64_t depth);
int      fdtpu_tcache_init(void *base, uint64_t off, uint64_t depth);
/* Query-only presence check; returns 1 if tag present, 0 otherwise. */
int      fdtpu_tcache_query(void *base, uint64_t off, uint64_t tag);
/* Insert tag; returns 1 if tag was already present (duplicate), 0 if new.
 * Oldest tag is evicted once more than `depth` distinct tags inserted. */
int      fdtpu_tcache_insert(void *base, uint64_t off, uint64_t tag);

/* ---- batch gather: ring -> contiguous staging buffer ------------------ *
 * Drains up to max_n frags starting at *seq_io from the ring, copying
 * payloads into out_buf (stride out_stride, zero-padded) and metadata into
 * out_sz / out_sig. Stops early on an unpublished slot. On overrun,
 * resynchronizes to the producer's oldest still-valid seq and counts the
 * skip in *overrun_cnt. Returns number of frags gathered; *seq_io advances.
 * This is the microbatch assembly step of the TPU bridge tile
 * (the analog of the reference verify tile's during_frag copy,
 * src/disco/verify/fd_verify_tile.h:60-111, feeding a device batch). */
int64_t fdtpu_ring_gather(void *base, uint64_t ring_off, uint64_t *seq_io,
                          int64_t max_n, uint8_t *out_buf,
                          uint64_t out_stride, uint32_t *out_sz,
                          uint64_t *out_sig, uint64_t *overrun_cnt,
                          uint64_t *out_seq);

/* Tick counter (ns). */
uint64_t fdtpu_ticks(void);

/* Batched txn parse over a gathered buffer (full wire validation, same
 * contract as protocol/txn.py::parse_txn). meta_out: n x 8 int32 records
 * {ok, sig_cnt, sig_off, msg_off, acct_off, acct_cnt, version, hdr};
 * tags_out: n u64 seeded SipHash-1-3 dedup tags over the first 64-byte
 * signature. Returns number parsed ok. */
int64_t fdtpu_txn_parse_batch(const uint8_t *buf, const uint32_t *sizes,
                              int64_t n, uint64_t stride,
                              uint64_t seed0, uint64_t seed1,
                              int32_t *meta_out, uint64_t *tags_out);

/* Fill fixed-shape device verify lanes (one lane per signature) from the
 * parsed batch, skipping txns with skip[i] != 0. Chunk-able via
 * *cursor_io; a txn's sigs never split across chunks. Returns lanes
 * filled; dead lanes zeroed, lane_txn[j] = -1. */
int64_t fdtpu_verify_assemble(const uint8_t *buf, const uint32_t *sizes,
                              const int32_t *meta, const uint8_t *skip,
                              int64_t n, uint64_t stride,
                              int64_t *cursor_io, int64_t cap,
                              uint64_t max_len,
                              uint8_t *lane_sig, uint8_t *lane_pub,
                              uint8_t *lane_msg, int32_t *lane_len,
                              int32_t *lane_txn);

/* Batch tcache presence/insert (mask: optional per-txn enable). */
int fdtpu_tcache_query_batch(void *base, uint64_t off, const uint64_t *tags,
                             const uint8_t *mask, int64_t n, uint8_t *hit);
int fdtpu_tcache_insert_batch(void *base, uint64_t off, const uint64_t *tags,
                              const uint8_t *mask, int64_t n, uint8_t *dup);

/* ---- funk store: fork-aware shm record tree ---------------------------
 * Re-expression of funk's prepare/cancel/publish transaction tree over
 * the wksp offset ABI (ref: src/funk/fd_funk.h:28-90 — the reference
 * backs the same semantics with relocatable shared-memory maps). The
 * store is one carved region: a txn slot table, a fixed record-slot
 * array, an open-address (xid, key) -> record map with backward-shift
 * deletion (the tcache idiom), and a size-class heap for values. All
 * mutations and queries serialize on a pid-owned spinlock whose dead
 * holders are stolen (a killed exec tile must never wedge the store).
 *
 * xid 0 is the published root; keys are 32 bytes; error codes:
 *   -1 not found / bad xid      -2 unknown txn
 *   -3 fork depth limit         -4 slot table full
 *   -5 heap exhausted           -6 map full                            */

uint64_t fdtpu_store_footprint(uint64_t rec_max, uint64_t txn_max,
                               uint64_t heap_sz);
int      fdtpu_store_init(void *base, uint64_t off, uint64_t rec_max,
                          uint64_t txn_max, uint64_t heap_sz);
int      fdtpu_store_txn_prepare(void *base, uint64_t off,
                                 uint64_t parent_xid, uint64_t xid);
int      fdtpu_store_txn_cancel(void *base, uint64_t off, uint64_t xid);
int      fdtpu_store_txn_publish(void *base, uint64_t off, uint64_t xid);
int      fdtpu_store_txn_exists(void *base, uint64_t off, uint64_t xid);
/* parent xid (0 = child of root), or -2 when xid is not in preparation */
int64_t  fdtpu_store_txn_parent(void *base, uint64_t off, uint64_t xid);
int64_t  fdtpu_store_txn_children(void *base, uint64_t off, uint64_t xid,
                                  uint64_t *out, int64_t cap);
/* Write (or tombstone) a record in layer `xid`. xid 0 writes the root
 * directly; a root tombstone deletes the record (rec_remove(None)). */
int      fdtpu_store_put(void *base, uint64_t off, uint64_t xid,
                         const uint8_t *key, const uint8_t *val,
                         uint64_t sz, int tombstone);
/* Fork-visibility query: own layer, else nearest ancestor, else root.
 * Returns value size (copying min(sz, cap) bytes into out), -1 when
 * absent or tombstoned, -2 on unknown xid. */
int64_t  fdtpu_store_get(void *base, uint64_t off, uint64_t xid,
                         const uint8_t *key, uint8_t *out, uint64_t cap);
/* Enumerate ONE layer's own records (no ancestor fold). *cursor must be
 * 0 on the first call; returns value size per record (tombstones report
 * size 0 with *tomb_out = 1), -1 at end, -2 on unknown xid. */
int64_t  fdtpu_store_iter(void *base, uint64_t off, uint64_t xid,
                          uint64_t *cursor, uint8_t *key_out,
                          uint8_t *val_out, uint64_t cap,
                          int32_t *tomb_out);
/* Live record count (root + every in-preparation layer) — metrics. */
uint64_t fdtpu_store_rec_cnt(void *base, uint64_t off);

#ifdef __cplusplus
}
#endif
#endif /* FDTPU_H */
