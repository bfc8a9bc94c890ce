"""Repair policy: which requests to send, to whom, with time-window
dedup (copy of the JAX package's repair/policy.py; ref: src/discof/repair/fd_policy.h:1-45 — round-robin over
peers, DFS/BFS over the forest, LRU dedup of identical requests within
a configurable window).

Request wire (signed under the keyguard's REPAIR role, which requires
the u32 discriminant in [8, 11] followed by OUR pubkey and a body of
at least 80 bytes — src/disco/keyguard/fd_keyguard_authorize.c:94-113;
the real protocol's header carries sender, recipient, timestamp and
nonce the same way):

  u32 disc | sender 32 | recipient 32 | u64 ts_ms | u64 nonce |
  u64 slot | u32 shred_idx
"""
from __future__ import annotations

import struct

DISC_WINDOW_INDEX = 8          # request one shred by (slot, idx)
DISC_HIGHEST_WINDOW = 9        # request the highest shred of a slot
DISC_ORPHAN = 10               # request ancestry of an orphan slot
DISC_ANCESTOR_HASHES = 11

REQ_LEN = 4 + 32 + 32 + 8 + 8 + 8 + 4     # 96 >= keyguard's 80-byte floor


def pack_request(disc: int, sender: bytes, recipient: bytes, ts_ms: int,
                 nonce: int, slot: int, shred_idx: int = 0) -> bytes:
    return (struct.pack("<I", disc) + sender + recipient
            + struct.pack("<QQQI", ts_ms, nonce, slot, shred_idx))


def parse_request(b: bytes):
    disc, = struct.unpack_from("<I", b, 0)
    sender = b[4:36]
    recipient = b[36:68]
    ts_ms, nonce, slot, idx = struct.unpack_from("<QQQI", b, 68)
    return disc, sender, recipient, ts_ms, nonce, slot, idx


class RepairPolicy:
    def __init__(self, identity: bytes, dedup_window_ns: int = 100_000_000,
                 max_inflight: int = 512):
        self.identity = identity
        self.window_ns = dedup_window_ns
        self.max_inflight = max_inflight
        self.peers: list[bytes] = []
        self._rr = 0
        self._nonce = 0
        # (kind, slot, idx) -> last sent ns (LRU-ish, pruned on use)
        self._sent: dict[tuple, int] = {}

    def set_peers(self, peers: list[bytes]):
        self.peers = list(peers)

    def _dedup(self, key: tuple, now_ns: int) -> bool:
        """True = suppressed (sent within the window)."""
        last = self._sent.get(key)
        if last is not None and now_ns - last < self.window_ns:
            return True
        self._sent[key] = now_ns
        if len(self._sent) > 4 * self.max_inflight:
            cutoff = now_ns - self.window_ns
            self._sent = {k: t for k, t in self._sent.items()
                          if t >= cutoff}
        return False

    def next_peer(self) -> bytes | None:
        if not self.peers:
            return None
        p = self.peers[self._rr % len(self.peers)]
        self._rr += 1
        return p

    def plan(self, forest, now_ns: int,
             max_requests: int = 64) -> list[tuple[bytes, bytes]]:
        """-> [(peer, request_payload_to_sign)] for the current forest
        state: window-index requests for known holes, highest-window
        probes for open-ended blocks, orphan requests for parentless
        slots (ref fd_policy round-robin DFS)."""
        out = []
        for slot, idx in forest.requests():
            if len(out) >= max_requests:
                break
            blk = forest.blks[slot]
            if blk.parent_slot is None and not blk.idxs:
                disc, key = DISC_ORPHAN, ("orphan", slot, 0)
            elif blk.complete_idx is None and idx > blk.buffered_idx:
                disc, key = DISC_HIGHEST_WINDOW, ("high", slot, 0)
            else:
                disc, key = DISC_WINDOW_INDEX, ("idx", slot, idx)
            if self._dedup(key, now_ns):
                continue
            peer = self.next_peer()
            if peer is None:
                break
            self._nonce += 1
            out.append((peer, pack_request(
                disc, self.identity, peer, now_ns // 1_000_000,
                self._nonce, slot, idx)))
        return out
