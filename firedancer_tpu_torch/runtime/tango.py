"""ctypes bindings for the port's own native runtime (see native/fdtpu.h).

A copy of the JAX package's runtime/tango.py, trimmed to what the
topology's main path uses: workspaces, frag rings with their per-join
telemetry counters, fseqs, cncs, tcaches and the flight recorder's
TraceRing (pure numpy; without the reference's `snapshot_since`, which
serves the flight archive, ROADMAP.md queue A item 10). The library
is built from `firedancer_tpu_torch/native/` by `make` at first use.

Layout convention: a Workspace is a named shm segment; objects (rings,
fseqs, cncs, tcaches, payload arenas) are carved out of it at 64-byte
aligned offsets. Offsets, not pointers, are the inter-process currency
(ref: src/util/wksp/fd_wksp.h:27-47, src/tango/fd_tango_base.h:105-112).
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libfdtpu.so"))

CNC_BOOT, CNC_RUN, CNC_HALT, CNC_FAIL = 0, 1, 2, 3
FSEQ_STALE = (1 << 64) - 1    # sentinel: consumer excluded from fctl


def _build():
    # always invoke make: its dependency check is a no-op when fresh, and
    # this keeps a stale .so from shadowing edited C++ source
    subprocess.run(["make", "-s", "-C", os.path.abspath(_NATIVE_DIR)],
                   check=True)


def _load():
    _build()
    lib = ct.CDLL(_LIB_PATH)
    u64, i64, u32, u16, vp, cp = (ct.c_uint64, ct.c_int64, ct.c_uint32,
                                  ct.c_uint16, ct.c_void_p, ct.c_char_p)
    u8p, u32p, u64p = (ct.POINTER(ct.c_uint8), ct.POINTER(u32),
                       ct.POINTER(u64))
    i32p, i64p = ct.POINTER(ct.c_int32), ct.POINTER(i64)
    sigs = {
        "fdtpu_wksp_join": (vp, [cp, u64, ct.c_int]),
        "fdtpu_wksp_leave": (ct.c_int, [vp, u64]),
        "fdtpu_wksp_unlink": (ct.c_int, [cp]),
        "fdtpu_ring_footprint": (u64, [u64]),
        "fdtpu_ring_init": (ct.c_int, [vp, u64, u64]),
        "fdtpu_ring_seq": (u64, [vp, u64]),
        "fdtpu_ring_prepare": (u64, [vp, u64]),
        "fdtpu_ring_publish": (u64, [vp, u64, u64, u64, u32, u16, u16]),
        "fdtpu_ring_consume": (ct.c_int, [vp, u64, u64, vp]),
        "fdtpu_ring_publish_batch": (
            i64, [vp, u64, u8p, u64, u32p, u64p, u8p, i64, i64, u64, u64,
                  u64p, ct.c_int, i64p]),
        "fdtpu_fseq_footprint": (u64, []),
        "fdtpu_fseq_init": (ct.c_int, [vp, u64, u64]),
        "fdtpu_fseq_query": (u64, [vp, u64]),
        "fdtpu_fseq_update": (None, [vp, u64, u64]),
        "fdtpu_fctl_credits": (i64, [vp, u64, u64p, ct.c_int]),
        "fdtpu_cnc_footprint": (u64, []),
        "fdtpu_cnc_init": (ct.c_int, [vp, u64]),
        "fdtpu_cnc_state": (u32, [vp, u64]),
        "fdtpu_cnc_set_state": (None, [vp, u64, u32]),
        "fdtpu_cnc_heartbeat": (None, [vp, u64, u64]),
        "fdtpu_cnc_last_heartbeat": (u64, [vp, u64]),
        "fdtpu_tcache_footprint": (u64, [u64]),
        "fdtpu_tcache_init": (ct.c_int, [vp, u64, u64]),
        "fdtpu_tcache_query": (ct.c_int, [vp, u64, u64]),
        "fdtpu_tcache_insert": (ct.c_int, [vp, u64, u64]),
        "fdtpu_ring_gather": (i64, [vp, u64, u64p, i64, u8p, u64, u32p,
                                    u64p, u64p, u64p]),
        "fdtpu_ticks": (u64, []),
        "fdtpu_txn_parse_batch": (i64, [u8p, u32p, i64, u64, u64, u64,
                                        i32p, u64p]),
        "fdtpu_verify_assemble": (i64, [u8p, u32p, i32p, u8p, i64, u64,
                                        i64p, i64, u64, u8p, u8p, u8p,
                                        i32p, i32p]),
        "fdtpu_tcache_query_batch": (ct.c_int, [vp, u64, u64p, u8p, i64,
                                                u8p]),
        "fdtpu_tcache_insert_batch": (ct.c_int, [vp, u64, u64p, u8p, i64,
                                                 u8p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


lib = _load()


class Frag(ct.Structure):
    _fields_ = [("seq", ct.c_uint64), ("sig", ct.c_uint64),
                ("off", ct.c_uint64), ("sz", ct.c_uint32),
                ("ctl", ct.c_uint16), ("orig", ct.c_uint16),
                ("tspub", ct.c_uint32)]


class Workspace:
    """Named shared-memory workspace with a bump allocator for layout.

    The bump cursor is Python-side state used only at build time;
    joiners reconstruct offsets from the layout description, never from
    the cursor (offsets are the ABI)."""

    def __init__(self, name: str, size: int, create: bool = True,
                 replace: bool = True):
        """create=True makes a fresh segment; replace=True also unlinks a
        stale leftover of a crashed run (single-creator discipline)."""
        self.name, self.size = name, size
        mode = (2 if replace else 1) if create else 0
        self.base = lib.fdtpu_wksp_join(name.encode(), size, mode)
        if not self.base:
            raise OSError(f"wksp join failed: {name}")
        self._cursor = 64

    def alloc(self, footprint: int, align: int = 64) -> int:
        off = (self._cursor + align - 1) & ~(align - 1)
        if off + footprint > self.size:
            raise MemoryError("workspace exhausted")
        self._cursor = off + footprint
        return off

    def view(self, off: int, sz: int) -> np.ndarray:
        """uint8 numpy view of [off, off+sz): zero-copy payload access."""
        buf = (ct.c_uint8 * sz).from_address(self.base + off)
        return np.ctypeslib.as_array(buf)

    def close(self):
        if self.base:
            lib.fdtpu_wksp_leave(self.base, self.size)
            self.base = None

    def unlink(self):
        lib.fdtpu_wksp_unlink(self.name.encode())

    @staticmethod
    def unlink_name(name: str):
        lib.fdtpu_wksp_unlink(name.encode())


class Ring:
    """Single-producer frag ring + payload arena inside a workspace.

    Every join carries its own telemetry counters (m_pub, m_pub_bytes,
    m_backpressure on the publish side; m_consumed, m_bytes, m_overruns
    on the gather side), plain Python ints bumped by the methods below.
    Each tile process joins its own Ring per link, so they are that
    tile's per-link counters; the stem flushes them into the link's shm
    telemetry blocks (disco/metrics.py)."""

    def __init__(self, wksp: Workspace, off: int, depth: int,
                 arena_off: int = 0, mtu: int = 0, init: bool = False):
        self.wksp, self.off, self.depth = wksp, off, depth
        self.arena_off, self.mtu = arena_off, mtu
        self.m_pub = 0
        self.m_pub_bytes = 0
        self.m_backpressure = 0
        self.m_consumed = 0
        self.m_bytes = 0
        self.m_overruns = 0
        if init:
            rc = lib.fdtpu_ring_init(wksp.base, off, depth)
            if rc:
                raise ValueError("ring init failed (depth power of 2?)")

    @classmethod
    def create(cls, wksp: Workspace, depth: int, mtu: int = 0) -> "Ring":
        mtu = (mtu + 63) & ~63  # chunk-index addressing needs 64B alignment
        off = wksp.alloc(lib.fdtpu_ring_footprint(depth))
        arena_off = wksp.alloc(depth * mtu) if mtu else 0
        return cls(wksp, off, depth, arena_off, mtu, init=True)

    @property
    def seq(self) -> int:
        return lib.fdtpu_ring_seq(self.wksp.base, self.off)

    def publish(self, payload: bytes | np.ndarray, sig: int = 0,
                ctl: int = 3, orig: int = 0) -> int:
        """Prepare (invalidate slot), copy payload into the slot's arena
        chunk, publish. ctl=3 is SOM|EOM (single-frag message)."""
        assert self.mtu, "ring has no payload arena"
        seq = lib.fdtpu_ring_prepare(self.wksp.base, self.off)
        slot_off = self.arena_off + (seq % self.depth) * self.mtu
        data = np.frombuffer(payload, np.uint8) if isinstance(
            payload, (bytes, bytearray)) else payload
        assert data.nbytes <= self.mtu
        self.wksp.view(slot_off, data.nbytes)[:] = data
        self.m_pub += 1
        self.m_pub_bytes += data.nbytes
        return lib.fdtpu_ring_publish(self.wksp.base, self.off, sig,
                                      slot_off, data.nbytes, ctl, orig)

    def publish_batch(self, buf: np.ndarray, sizes: np.ndarray,
                      sigs: np.ndarray, mask: np.ndarray,
                      fseqs: list["Fseq"] | None = None,
                      start: int = 0) -> tuple[int, int]:
        """Credit-gated native publish of masked rows of a gathered
        (n, stride) buffer in ONE C call. Returns (stop_row, published):
        stop_row < len(buf) means credits ran out; resume from it."""
        assert self.mtu, "ring has no payload arena"
        n, stride = buf.shape
        buf = np.ascontiguousarray(buf, np.uint8)
        sizes = np.ascontiguousarray(sizes, np.uint32)
        assert not len(sizes) or int(sizes.max()) <= self.mtu, \
            "payload larger than ring mtu"
        sigs = np.ascontiguousarray(sigs, np.uint64)
        mask = np.ascontiguousarray(mask, np.uint8)
        offs = (ct.c_uint64 * len(fseqs))(*[f.off for f in fseqs]) \
            if fseqs else None
        pub = ct.c_int64(0)
        stop = lib.fdtpu_ring_publish_batch(
            self.wksp.base, self.off,
            buf.ctypes.data_as(ct.POINTER(ct.c_uint8)), stride,
            sizes.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            sigs.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            mask.ctypes.data_as(ct.POINTER(ct.c_uint8)),
            start, n, self.arena_off, self.mtu,
            offs, len(fseqs) if fseqs else 0, ct.byref(pub))
        stop, pub = int(stop), int(pub.value)
        if pub:
            self.m_pub += pub
            live = mask[start:stop] != 0
            self.m_pub_bytes += int(sizes[start:stop][live].sum())
        if stop < n:
            self.m_backpressure += 1     # credits ran out mid-batch
        return stop, pub

    def consume(self, seq: int):
        """-> (rc, Frag). rc 0=ok, 1=not yet, -1=overrun."""
        frag = Frag()
        rc = lib.fdtpu_ring_consume(self.wksp.base, self.off, seq,
                                    ct.byref(frag))
        if rc == 0:
            self.m_consumed += 1
            self.m_bytes += frag.sz
        elif rc == -1:
            self.m_overruns += 1
        return rc, frag

    def payload(self, frag: Frag) -> np.ndarray:
        return self.wksp.view(frag.off, frag.sz)

    def gather(self, seq: int, max_n: int, stride: int,
               want_seqs: bool = False):
        """Drain up to max_n frags into a fresh (max_n, stride) buffer.

        Returns (n, new_seq, buf, sizes, sigs, overruns), plus the
        per-frag seq array with want_seqs."""
        buf = np.zeros((max_n, stride), np.uint8)
        sizes = np.zeros(max_n, np.uint32)
        sigs = np.zeros(max_n, np.uint64)
        seqs = np.zeros(max_n, np.uint64) if want_seqs else None
        seq_io = ct.c_uint64(seq)
        ovr = ct.c_uint64(0)
        n = lib.fdtpu_ring_gather(
            self.wksp.base, self.off, ct.byref(seq_io), max_n,
            buf.ctypes.data_as(ct.POINTER(ct.c_uint8)), stride,
            sizes.ctypes.data_as(ct.POINTER(ct.c_uint32)),
            sigs.ctypes.data_as(ct.POINTER(ct.c_uint64)), ct.byref(ovr),
            seqs.ctypes.data_as(ct.POINTER(ct.c_uint64))
            if want_seqs else None)
        if n:
            self.m_consumed += int(n)
            self.m_bytes += int(sizes[:n].sum())
        self.m_overruns += int(ovr.value)
        if want_seqs:
            return n, seq_io.value, buf, sizes, sigs, ovr.value, seqs
        return n, seq_io.value, buf, sizes, sigs, ovr.value

    def credits(self, fseqs: list["Fseq"]) -> int:
        offs = (ct.c_uint64 * len(fseqs))(*[f.off for f in fseqs])
        c = lib.fdtpu_fctl_credits(self.wksp.base, self.off, offs,
                                   len(fseqs))
        if c <= 0:
            self.m_backpressure += 1     # a blocked publish attempt
        return c


def u64_snapshot(view_u64):
    """One-pass copy of a live shm u64 view (coherent field reads)."""
    return np.array(view_u64, copy=True)


class Fseq:
    def __init__(self, wksp: Workspace, off: int | None = None,
                 seq0: int = 0):
        self.wksp = wksp
        if off is None:
            off = wksp.alloc(lib.fdtpu_fseq_footprint())
            lib.fdtpu_fseq_init(wksp.base, off, seq0)
        self.off = off

    def query(self) -> int:
        return lib.fdtpu_fseq_query(self.wksp.base, self.off)

    def update(self, seq: int):
        lib.fdtpu_fseq_update(self.wksp.base, self.off, seq)

    def mark_stale(self):
        """Exclude this consumer from upstream credit flow (a dead or
        restarting tile: the native fctl skips the sentinel). Cleared by
        the next update()."""
        lib.fdtpu_fseq_update(self.wksp.base, self.off, FSEQ_STALE)


class Cnc:
    def __init__(self, wksp: Workspace, off: int | None = None):
        self.wksp = wksp
        if off is None:
            off = wksp.alloc(lib.fdtpu_cnc_footprint())
            lib.fdtpu_cnc_init(wksp.base, off)
        self.off = off

    @property
    def state(self) -> int:
        return lib.fdtpu_cnc_state(self.wksp.base, self.off)

    @state.setter
    def state(self, st: int):
        lib.fdtpu_cnc_set_state(self.wksp.base, self.off, st)

    def heartbeat(self):
        lib.fdtpu_cnc_heartbeat(self.wksp.base, self.off, lib.fdtpu_ticks())

    @property
    def last_heartbeat(self) -> int:
        return lib.fdtpu_cnc_last_heartbeat(self.wksp.base, self.off)


class Tcache:
    def __init__(self, wksp: Workspace, depth: int, off: int | None = None):
        self.wksp, self.depth = wksp, depth
        if off is None:
            off = wksp.alloc(lib.fdtpu_tcache_footprint(depth))
            lib.fdtpu_tcache_init(wksp.base, off, depth)
        self.off = off

    def query(self, tag: int) -> bool:
        """True iff tag is present (no mutation)."""
        return bool(lib.fdtpu_tcache_query(self.wksp.base, self.off, tag))

    def insert(self, tag: int) -> bool:
        """True iff tag was already present (duplicate)."""
        return bool(lib.fdtpu_tcache_insert(self.wksp.base, self.off, tag))

    def _batch(self, fn, tags, mask):
        tags = np.ascontiguousarray(tags, np.uint64)
        out = np.zeros(len(tags), np.uint8)
        mp = (mask.ctypes.data_as(ct.POINTER(ct.c_uint8))
              if mask is not None else None)
        fn(self.wksp.base, self.off,
           tags.ctypes.data_as(ct.POINTER(ct.c_uint64)), mp, len(tags),
           out.ctypes.data_as(ct.POINTER(ct.c_uint8)))
        return out

    def query_batch(self, tags, mask=None):
        """tags (n,) uint64 -> (n,) uint8 hit flags (native loop)."""
        return self._batch(lib.fdtpu_tcache_query_batch, tags, mask)

    def insert_batch(self, tags, mask=None):
        """tags (n,) uint64 -> (n,) uint8 was-duplicate flags; only rows
        with mask[i] != 0 are inserted."""
        return self._batch(lib.fdtpu_tcache_insert_batch, tags, mask)


TRACE_REC_U64 = 4             # ts_ns | sig | arg | meta(etype/link/count)
TRACE_REC_SZ = TRACE_REC_U64 * 8
TRACE_HDR_U64 = 8             # [0] cursor, [1] depth, rest reserved
TRACE_LINK_NONE = 0xFFFF


class TraceRing:
    """Per-tile flight-recorder event ring in the workspace — the same
    design as the frag mcache (fixed depth, overwrite-oldest, cursor is
    the total-records-written count) but for 32-byte trace records, and
    pure Python/numpy: a single writer (the owning tile) appends, any
    process attached to the workspace snapshots. The region survives
    the tile's death — the supervisor reads a dead tile's last events
    out of shm for the black-box dump (trace/export.py).

    Record layout (4 little-endian u64 words):

        [0] ts_ns   end timestamp (utils/tempo.monotonic_ns — the cnc
                    heartbeat clock, so traces and watchdog decisions
                    share one timeline)
        [1] sig     frag lineage key (the frag's sig / dedup tag; 0 if
                    the event is not frag-scoped)
        [2] arg     span duration in ns (0 for instant events)
        [3] meta    etype | link_id << 16 | count << 32
                    (etype: trace/events.py; link_id indexes the
                    plan's sorted link names, TRACE_LINK_NONE if none)
    """

    def __init__(self, wksp: Workspace, off: int, depth: int,
                 init: bool = False):
        if depth <= 0 or depth & (depth - 1):
            raise ValueError(f"trace depth {depth} not a power of two")
        self.wksp, self.off, self.depth = wksp, off, depth
        self._v = wksp.view(off, self.footprint(depth)).view(np.uint64)
        if init:
            self._v[:] = 0
            self._v[1] = depth

    @staticmethod
    def footprint(depth: int) -> int:
        return (TRACE_HDR_U64 + depth * TRACE_REC_U64) * 8

    @classmethod
    def create(cls, wksp: Workspace, depth: int) -> "TraceRing":
        off = wksp.alloc(cls.footprint(depth))
        return cls(wksp, off, depth, init=True)

    @property
    def cursor(self) -> int:
        return int(self._v[0])

    def append(self, ts_ns: int, etype: int, sig: int = 0, arg: int = 0,
               link: int = TRACE_LINK_NONE, count: int = 0):
        """Lock-free single-writer append (overwrites the oldest record
        once full; the cursor keeps counting so readers know how much
        history was lost). Record words land before the cursor bump, so
        a racing reader never sees a half-written CURRENT record — it
        can still see a torn overwritten slot, the documented snapshot
        caveat."""
        v = self._v
        cur = int(v[0])
        base = TRACE_HDR_U64 + (cur & (self.depth - 1)) * TRACE_REC_U64
        m64 = (1 << 64) - 1
        v[base] = ts_ns & m64
        v[base + 1] = int(sig) & m64
        v[base + 2] = int(arg) & m64
        v[base + 3] = (etype & 0xFFFF) | ((link & 0xFFFF) << 16) \
            | ((int(count) & 0xFFFFFFFF) << 32)
        v[0] = cur + 1

    def append_batch(self, ts_ns: int, etype: int, sigs,
                     arg: int = 0, link: int = TRACE_LINK_NONE,
                     count: int = 0):
        """Vectorized single-writer append of one record per sig: the
        whole batch lands with ONE cursor bump (numpy scatter into the
        ring view — no per-record Python). All records share the batch
        timestamp/arg/link/meta; `sig` is the per-record lineage key.
        When the batch exceeds the ring depth only the newest `depth`
        records are materialized, but the cursor still counts every
        one, so readers see the correct history-loss accounting."""
        sigs = np.asarray(sigs, np.uint64)
        n = len(sigs)
        if not n:
            return
        v = self._v
        cur = int(v[0])
        keep = sigs[-self.depth:] if n > self.depth else sigs
        m = len(keep)
        slot = (cur + (n - m) + np.arange(m, dtype=np.int64)) \
            & (self.depth - 1)
        base = TRACE_HDR_U64 + slot * TRACE_REC_U64
        m64 = (1 << 64) - 1
        v[base] = ts_ns & m64
        v[base + 1] = keep
        v[base + 2] = int(arg) & m64
        v[base + 3] = (etype & 0xFFFF) | ((link & 0xFFFF) << 16) \
            | ((int(count) & 0xFFFFFFFF) << 32)
        v[0] = cur + n

    def snapshot(self) -> tuple[int, np.ndarray]:
        """-> (cursor, records (n, 4) u64 oldest-first, n <= depth).
        A copy — safe to decode while the writer keeps appending; a
        record being overwritten concurrently may read torn (one
        record out of `depth`, oldest-first, and only on a LIVE tile —
        post-mortem reads are exact)."""
        raw = np.array(self._v, copy=True)
        cur = int(raw[0])
        recs = raw[TRACE_HDR_U64:TRACE_HDR_U64
                   + self.depth * TRACE_REC_U64].reshape(
                       self.depth, TRACE_REC_U64)
        n = min(cur, self.depth)
        if not n:
            return cur, recs[:0]
        idx = [(cur - n + i) & (self.depth - 1) for i in range(n)]
        return cur, recs[idx]
