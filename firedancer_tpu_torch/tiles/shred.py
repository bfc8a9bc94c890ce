"""Shred tile cores: the leader half, PoH entries -> entry batches ->
signed merkle FEC sets -> turbine first-hop UDP egress, and the
follower half, raw shred wires -> FEC resolution -> store -> ordered
slices, with turbine retransmit (copy of the JAX package's
tiles/shred.py: `ShredLeaderCore`, `ShredRecoverCore` and the frame
helpers `pack_slice`, `parse_slice` and `parse_entry_batch`).

The reference's shred tile serves both directions of turbine
(ref: src/disco/shred/fd_shred_tile.c:6-60). Its `drop_slot_every`
fault seam withholds every Nth slot's shreds from turbine, so that a
non-leader's repair tile must recover the slot (tiles/repair.py).
Signing rides the keyguard LEADER role (32-byte merkle roots only,
src/disco/keyguard/fd_keyguard_authorize.c is_shred_ping).

Entry-batch wire format (this framework's own; a replay parses it back
out of reassembled slices):

  entry := u32 num_hashes | 32B hash | u32 txn_cnt
           | txn_cnt x (u16 len | payload)

A batch is a concatenation of entries; PoH re-verifies from it alone
(mixin = sha256 over the entries' first signatures, has_mixin =
txn_cnt > 0 — the fd_poh mixin discipline).

Slice frame (the recover core's out link):
  u64 slot | u32 first_fec_idx | u8 slot_complete | payload
"""
from __future__ import annotations

import struct

from ..shred.fec_resolver import FecResolver
from ..shred.shred_dest import ShredDest
from ..shred.shredder import Shredder
from ..shred.store import FecStore, Reassembler
from ..shred import format as fmt

# poh entry frame offsets (disco/tiles.py PohAdapter wire)
_ENTRY_FIXED = 113          # <QIIB + prev32 + hash32 + mixin32
ENTRY_FLAG_SLOT_COMPLETE = 1


def pack_slice(slot: int, first_fec_idx: int, slot_complete: bool,
               payload: bytes) -> bytes:
    return struct.pack("<QIB", slot, first_fec_idx,
                       1 if slot_complete else 0) + payload


def parse_slice(frame: bytes):
    slot, first, done = struct.unpack_from("<QIB", frame, 0)
    return slot, first, bool(done), frame[13:]


def parse_entry_batch(batch: bytes):
    """Entry-batch bytes -> [(num_hashes, hash, [txn payloads])]."""
    out = []
    off = 0
    while off < len(batch):
        num_hashes, = struct.unpack_from("<I", batch, off)
        h = batch[off + 4:off + 36]
        txn_cnt, = struct.unpack_from("<I", batch, off + 36)
        off += 40
        txns = []
        for _ in range(txn_cnt):
            ln, = struct.unpack_from("<H", batch, off)
            txns.append(batch[off + 2:off + 2 + ln])
            off += 2 + ln
        out.append((num_hashes, h, txns))
    return out


class ShredLeaderCore:
    """PoH entries -> entry batches -> signed FEC sets -> turbine
    first-hop UDP egress (+ every wire on the out ring for the local
    store / archiver seam)."""

    def __init__(self, sign_fn, identity: bytes, cluster, sock,
                 out_ring=None, out_fseqs=None,
                 shred_version: int = 0, fanout: int = 200,
                 flush_bytes: int = 31840, batch_out=None,
                 batch_fseqs=None, drop_slot_every: int = 0,
                 cnc=None):
        """cluster: [ClusterNode]; sock: bound UDP socket for egress.
        batch_out: optional ring that mirrors every flushed entry batch
        (u64 slot | u8 block_complete | bytes) — the byte-identity
        witness the two-topology test compares against.
        drop_slot_every: fault-injection seam (test-only): every Nth
        slot's shreds are withheld from turbine (still mirrored on
        out_ring), simulating total network loss of a block so the
        repair path must recover it."""
        self.shredder = Shredder(sign_fn, shred_version=shred_version)
        self.identity = identity
        self.dest = ShredDest(cluster, identity, fanout=fanout)
        self.sock = sock
        self.out_ring = out_ring
        self.out_fseqs = out_fseqs
        self.batch_out = batch_out
        self.batch_fseqs = batch_fseqs
        self.flush_bytes = flush_bytes
        self.drop_slot_every = drop_slot_every
        self.cur_slot = None
        self.cur_tick = 0
        self.buf = bytearray()
        # mirror-link egress staging (r13): _tx buffers wires here and
        # flush_egress ships them as ONE credit-gated publish_batch —
        # a slot's worth of shreds must not cost one Python publish
        # each on the out ring (UDP egress stays per wire: a sendto is
        # a syscall per datagram by nature). cnc lets the batched
        # publish abort instead of spinning if the tile is halted
        # while backpressured.
        self._egress: list[tuple[bytes, int]] = []
        self._cnc = cnc
        self.metrics = {"entries": 0, "batches": 0, "fec_sets": 0,
                        "data_shreds": 0, "parity_shreds": 0,
                        "sent": 0, "no_dest": 0, "sign_fail": 0,
                        "slots": 0, "dropped": 0}

    def on_entry(self, frame: bytes) -> int:
        """One poh entry frame; returns shreds transmitted."""
        slot, tick, num_hashes, _has_mix = struct.unpack_from(
            "<QIIB", frame, 0)
        h = frame[49:81]
        flags, txn_cnt = 0, 0
        blob = b""
        if len(frame) > _ENTRY_FIXED:
            flags = frame[_ENTRY_FIXED]
            txn_cnt, = struct.unpack_from("<H", frame, _ENTRY_FIXED + 1)
            blob = frame[_ENTRY_FIXED + 3:]
        if self.cur_slot is not None and slot != self.cur_slot:
            # missed the slot_complete flag (overrun): close what we had
            sent = self._flush(block_complete=True)
        else:
            sent = 0
        self.cur_slot = slot
        self.cur_tick = tick
        self.buf += struct.pack("<I", num_hashes) + h \
            + struct.pack("<I", txn_cnt) + blob
        self.metrics["entries"] += 1
        if flags & ENTRY_FLAG_SLOT_COMPLETE:
            sent += self._flush(block_complete=True)
            self.cur_slot = None
        elif len(self.buf) >= self.flush_bytes:
            sent += self._flush(block_complete=False)
        return sent

    def _flush(self, block_complete: bool) -> int:
        if not self.buf or self.cur_slot is None:
            self.buf = bytearray()
            return 0
        slot = self.cur_slot
        batch = bytes(self.buf)
        self.buf = bytearray()
        parent_off = 1 if slot > 0 else 0
        sets = self.shredder.shred_batch(
            batch, slot, parent_off, self.cur_tick & fmt.REF_TICK_MASK,
            block_complete)
        self.metrics["batches"] += 1
        if block_complete:
            self.metrics["slots"] += 1
        if self.batch_out is not None:
            self._publish(self.batch_out, self.batch_fseqs,
                          struct.pack("<QB", slot,
                                      1 if block_complete else 0) + batch,
                          sig=slot)
        sent = 0
        for fs in sets:
            self.metrics["fec_sets"] += 1
            self.metrics["data_shreds"] += len(fs.data_shreds)
            self.metrics["parity_shreds"] += len(fs.parity_shreds)
            for wire in fs.data_shreds + fs.parity_shreds:
                sent += self._tx(wire, slot)
        return sent

    def _tx(self, wire: bytes, slot: int) -> int:
        variant = wire[fmt.VARIANT_OFF]
        is_data = fmt.is_data(variant)
        idx, = struct.unpack_from("<I", wire, 0x49)
        node = self.dest.first_hop(slot, idx, 1 if is_data else 0,
                                   self.identity)
        n = 0
        dropped = self.drop_slot_every \
            and slot % self.drop_slot_every == self.drop_slot_every - 1
        if dropped:
            self.metrics["dropped"] += 1
        elif node is not None and node.addr[1]:
            self.sock.sendto(wire, node.addr)
            self.metrics["sent"] += 1
            n = 1
        else:
            self.metrics["no_dest"] += 1
        if self.out_ring is not None:
            self._egress.append((wire, idx))
        return n

    def flush_egress(self) -> int:
        """Publish every buffered mirror wire as one credit-gated
        batch (stop-row resume on a mid-batch stall, halt-aware via
        the shared publish_wave helper). The adapter calls this once
        per poll and on halt; in-process tests that drive on_entry
        directly call it to observe the mirror ring."""
        if not self._egress:
            return 0
        wires, self._egress = self._egress, []
        from ..disco.tiles import publish_wave
        return publish_wave(self.out_ring, self.out_fseqs,
                            [(idx, w) for w, idx in wires],
                            cnc=self._cnc)

    @staticmethod
    def _publish(ring, fseqs, frame: bytes, sig: int):
        import time
        while fseqs and ring.credits(fseqs) <= 0:
            time.sleep(20e-6)
        ring.publish(frame, sig=sig)


class ShredRecoverCore:
    """Raw shred wires -> FEC resolution -> store -> ordered slices,
    plus TURBINE RETRANSMIT: every structurally valid shred forwards
    to this node's children in the stake-weighted tree (the
    non-leader half of fd_shred_tile — receive, retransmit, resolve).

    verify_sig is host-side here (one root per FEC set, ~32 sigs/s/slot
    — not the hot path; the hot ed25519 path is the verify tile's
    batched device kernel)."""

    def __init__(self, leader_pubkey: bytes, out_ring, out_fseqs,
                 max_pending: int = 1024, store_sets: int = 4096,
                 dest: "ShredDest | None" = None,
                 identity: bytes | None = None, sock=None):
        from ..utils.ed25519_ref import verify

        def verify_sig(sig, root, slot):
            return verify(sig, leader_pubkey, root)

        self.resolver = FecResolver(verify_sig, max_pending=max_pending)
        self.store = FecStore(max_sets=store_sets)
        self.reasm = Reassembler()
        self.leader_pubkey = leader_pubkey
        self.dest = dest
        self.identity = identity
        self.sock = sock
        self.out_ring = out_ring
        self.out_fseqs = out_fseqs
        self.metrics = {"shreds": 0, "fecs": 0, "slices": 0,
                        "slots_done": 0, "parse_fail": 0,
                        "retransmitted": 0}
        # per-shred retransmit dedup: first sight of (slot, type, idx)
        # forwards, replays don't (bounded FIFO — a replayed shred must
        # not amplify fanout-fold)
        from collections import OrderedDict
        self._rt_seen: OrderedDict = OrderedDict()
        self._rt_seen_max = 1 << 16

    def _retransmit(self, wire: bytes):
        if self.dest is None or self.sock is None:
            return
        try:
            slot, = struct.unpack_from("<Q", wire, 0x41)
            idx, = struct.unpack_from("<I", wire, 0x49)
            is_data = fmt.is_data(wire[fmt.VARIANT_OFF])
        except Exception:
            return
        for node in self.dest.children(slot, idx, 1 if is_data else 0,
                                       self.leader_pubkey):
            if node.addr[1]:
                self.sock.sendto(wire, node.addr)
                self.metrics["retransmitted"] += 1

    def on_shred(self, wire: bytes, retransmit: bool = True) -> int:
        """retransmit=False for repair responses — turbine must never
        forward repaired shreds (the reference's repair/turbine
        separation)."""
        self.metrics["shreds"] += 1
        rm = self.resolver.metrics
        before = (rm["bad_sig"], rm["bad_proof"], rm["eqvoc"],
                  rm["root_mismatch"])
        try:
            fec, _eqvoc = self.resolver.add_shred(wire)
        except Exception:
            self.metrics["parse_fail"] += 1
            return 0
        valid = before == (rm["bad_sig"], rm["bad_proof"], rm["eqvoc"],
                           rm["root_mismatch"])
        if retransmit and valid:
            # forward each DISTINCT valid shred once (shreds of
            # already-completed sets still forward — they are the
            # retransmission chain for peers behind us — but replays
            # of the same shred never amplify)
            try:
                slot, = struct.unpack_from("<Q", wire, 0x41)
                idx, = struct.unpack_from("<I", wire, 0x49)
                key = (slot, fmt.is_data(wire[fmt.VARIANT_OFF]), idx)
            except Exception:
                key = None
            if key is not None and key not in self._rt_seen:
                while len(self._rt_seen) >= self._rt_seen_max:
                    self._rt_seen.popitem(last=False)
                self._rt_seen[key] = True
                self._retransmit(wire)
        if fec is None:
            return 0
        self.metrics["fecs"] += 1
        self.store.insert(fec.merkle_root, fec.slot, fec.fec_set_idx,
                          b"".join(fec.data_payloads))
        slices = self.reasm.add_fec(fec)
        for sl in slices:
            ShredLeaderCore._publish(
                self.out_ring, self.out_fseqs,
                pack_slice(sl.slot, sl.first_fec_idx, sl.slot_complete,
                           sl.payload),
                sig=sl.slot)
            self.metrics["slices"] += 1
            if sl.slot_complete:
                self.metrics["slots_done"] += 1
        return len(slices)
