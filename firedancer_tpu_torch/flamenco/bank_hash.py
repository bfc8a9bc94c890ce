"""Bank hash: the per-slot state commitment (copy of the JAX package's
flamenco/bank_hash.py).

The reference assembles each slot's bank hash from the parent bank
hash, the accounts delta (now the homomorphic lattice hash), the
signature count, and the last blockhash (ref: fd_runtime bank-hash
assembly; lthash accumulator per src/ballet/lthash/fd_lthash.h — the
accounts_lt_hash feature). Every modified account's lattice element is
one lane of ONE batched lthash call (ops/blake3.lthash_batch: the BLAKE3
kernel's `lthash` entry on the card, `lthash_plain` on the CPU), summed
mod 2^16 on the device, and the accumulator update is a pair of wrapping
u16 vector sums.

  account_lt(pubkey, account) = lthash_2048(serialized account)
  acc' = acc - Σ account_lt(old_i) + Σ account_lt(new_i)
  bank_hash = sha256(parent || checksum(acc') || sig_cnt_le || blockhash)

Zero-lamport (deleted) accounts contribute nothing — removing an
account subtracts its old element only, mirroring the reference's
delete discipline.

Where the copy differs from the reference: the `device` argument takes
the place of its switch on JAX's backend (`_lthash_on_host`, :43-49),
and the lanes are not padded to a power of two (that padding, :76-83,
saved XLA a compile per batch shape; a padded lane is sliced off before
the sum, so the lattice value is the same); a launch is as wide as its
longest serialized account. A wide fold (a restore's whole store)
launches at most `LT_CHUNK` lanes at a time and adds the partial sums
mod 2^16: lattice sums are homomorphic, so the value is the one launch
would give, and the card holds one chunk's (N, 1024) lanes, not the
whole store's.
"""
from __future__ import annotations

import hashlib
import struct

import numpy as np

from ..ops.blake3 import lthash_add, lthash_batch, lthash_reduce

LT_MSG_MAX = 2048           # lthash_batch input cap per lane
LT_CHUNK = 1 << 16          # lanes a launch: 256 MiB of int32 lanes


def serialize_account(pubkey: bytes, acct) -> bytes:
    """Canonical per-account hash input: lamports | rent_epoch |
    data | executable | owner | pubkey (the reference's account-hash
    field order, truncated to the lattice input cap; longer data folds
    through sha256 first so every account hashes in one lane)."""
    data = acct.data
    head = struct.pack("<QQ", acct.lamports, acct.rent_epoch)
    tail = bytes([1 if acct.executable else 0]) + acct.owner + pubkey
    if len(head) + len(data) + len(tail) > LT_MSG_MAX:
        data = hashlib.sha256(data).digest()
    return head + data + tail


def lane_msgs(raws: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Messages -> their zero-padded (N, longest) uint8 rows and (N,)
    int32 lengths, gathered from one joined buffer."""
    lens = np.fromiter(map(len, raws), np.int32, len(raws))
    flat = np.frombuffer(b"".join(raws), np.uint8)
    col = np.arange(int(lens.max()))
    idx = (np.cumsum(lens) - lens)[:, None] + col
    inside = col < lens[:, None]
    msgs = np.zeros(idx.shape, np.uint8)
    msgs[inside] = flat[idx[inside]]
    return msgs, lens


def accounts_lthash(items, device="cuda", chunk: int = LT_CHUNK) \
        -> np.ndarray:
    """[(pubkey, Account)] -> summed lattice element (1024 u16): the
    lanes in lthash launches of at most `chunk` accounts on `device`
    (one launch for any slot's delta), each summed there, the partial
    sums added mod 2^16. Zero-lamport accounts skip; an empty delta is
    zeros and launches nothing."""
    raws = [serialize_account(pk, a) for pk, a in items
            if a is not None and a.lamports != 0]
    if not raws:
        return np.zeros(1024, np.uint16)
    acc = None
    for i in range(0, len(raws), chunk):
        lanes = lthash_batch(*lane_msgs(raws[i:i + chunk]), device=device)
        part = lthash_reduce(lanes)
        acc = part if acc is None else lthash_add(acc, part)
    return acc.cpu().numpy().astype(np.uint16)


class BankHasher:
    """Running accounts lattice + the per-slot hash chain; its lthash
    work runs on `device`."""

    def __init__(self, acc: np.ndarray | None = None, device="cuda"):
        self.acc = (np.zeros(1024, np.uint16) if acc is None
                    else acc.astype(np.uint16))
        self.device = device

    def apply_txn_delta(self, funk, xid):
        """Fold one in-preparation funk txn's account changes into the
        lattice (old = parent-visible values). THE shared delta scan —
        the replay tile and the backtest recorder both use it, so two
        consumers hashing identical ledgers cannot drift."""
        from ..svm.accdb import Account
        recs = funk.txn_recs(xid)
        old_items = [(key, v) for key in recs
                     if isinstance(v := funk.rec_query(None, key),
                                   Account)]
        new_items = [(key, v) for key, v in recs.items()
                     if isinstance(v, Account)]
        self.apply_delta(old_items, new_items)

    def apply_delta(self, old_items, new_items):
        """old/new: [(pubkey, Account|None)] for every record the slot
        modified (old = parent-visible value). u16 lanes wrap mod
        2^16."""
        self.acc = (self.acc
                    - accounts_lthash(old_items, self.device)
                    + accounts_lthash(new_items, self.device))

    def checksum(self) -> bytes:
        """32-byte lattice checksum (blake3 of the 2048-byte element in
        the reference; sha256 here — internal commitment, documented):
        the element as 1,024 little-endian u16."""
        return hashlib.sha256(self.acc.astype("<u2").tobytes()).digest()

    def bank_hash(self, parent: bytes, sig_cnt: int,
                  last_blockhash: bytes) -> bytes:
        return hashlib.sha256(
            parent + self.checksum()
            + struct.pack("<Q", sig_cnt) + last_blockhash).digest()


def lthash_of_root(funk, device="cuda") -> np.ndarray:
    """Full recompute over the published root (the snapshot-verify
    fan-out; the delta path must always agree with this oracle)."""
    from ..svm.accdb import Account
    items = [(k, v) for k, v in funk.root_items().items()
             if isinstance(v, Account)]
    return accounts_lthash(items, device)
