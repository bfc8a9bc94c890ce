"""Backtest: deterministic ledger replay asserting BANK HASHES (copy of
the JAX package's app/backtest.py: pack_block, unpack_block, record,
replay and the CLI; ref: src/discof/backtest/fd_backtest_tile.c:317 —
replay recorded ledger segments through the runtime and assert each
slot's bank hash).

Ledger file = checkpoint frame stream (utils/checkpt.py):
  frame 0   genesis funk checkpoint (nested, bytes)
  frame i   one block: u64 slot | u32 txn_cnt | (u32 len | payload)*
            | u8 has_hash | bank_hash 32 — the recorder's per-slot
            state commitment (flamenco/bank_hash.py lattice chain),
            asserted slot by slot on replay
  last      expected final state fingerprint (8 bytes)

Replay executes every block through the host TxnExecutor in a funk
fork published per block (the bank discipline), recomputes each
slot's bank hash (its accounts delta on the BLAKE3 kernel's `lthash`
entry on `device`) AND the final fingerprint, and reports sec/slot.
A ledger either package records replays through the other's.

Where the copy differs from the reference: `record`, `replay` and the
CLI take a `device` (default "cuda") for the bank hash's lthash work.

CLI:  python -m firedancer_tpu_torch.app.backtest replay <ledger>
          [--device cpu]
"""
from __future__ import annotations

import hashlib
import io
import struct
import sys
import time

from ..flamenco.bank_hash import BankHasher, lthash_of_root
from ..funk.funk import Funk
from ..svm.accdb import AccDb
from ..svm.programs import TxnExecutor
from ..svm.programs import OK
from ..tiles.snapshot import state_fingerprint
from ..utils.checkpt import (
    CheckptReader, CheckptWriter, funk_checkpt, funk_restore,
)


def pack_block(slot: int, payloads: list[bytes],
               bank_hash: bytes = b"") -> bytes:
    """u64 slot | u32 cnt | (u32 len | payload)* | u8 has_hash |
    [bank_hash 32] — the marker is EXPLICIT so a corrupted length
    field fails parsing loudly instead of silently disabling the
    per-slot gate."""
    out = struct.pack("<QI", slot, len(payloads))
    for p in payloads:
        out += struct.pack("<I", len(p)) + p
    if bank_hash:
        assert len(bank_hash) == 32
        return bytes(out) + b"\x01" + bank_hash
    return bytes(out) + b"\x00"


def unpack_block(b: bytes):
    """-> (slot, payloads, bank_hash|b"") — the trailing 32 bytes, if
    present, are the recorded per-slot commitment."""
    slot, cnt = struct.unpack_from("<QI", b, 0)
    off = 12
    payloads = []
    for _ in range(cnt):
        (ln,) = struct.unpack_from("<I", b, off)
        off += 4
        payloads.append(b[off:off + ln])
        off += ln
    if off >= len(b) or b[off] not in (0, 1):
        raise ValueError("corrupt block frame (bad hash marker)")
    has = b[off]
    bank_hash = b[off + 1:off + 33] if has else b""
    if has and len(bank_hash) != 32:
        raise ValueError("corrupt block frame (short bank hash)")
    return slot, payloads, bank_hash


def record(genesis: Funk, blocks: list[tuple[int, list[bytes]]],
           fp, device="cuda") -> int:
    """Execute blocks from genesis, writing the ledger + final
    fingerprint (bank hashes on `device`). Returns the fingerprint."""
    gbuf = io.BytesIO()
    funk_checkpt(genesis, gbuf)
    w = CheckptWriter(fp)
    w.frame(gbuf.getvalue())
    funk = funk_restore(Funk, io.BytesIO(gbuf.getvalue()))
    ex = TxnExecutor(AccDb(funk))
    hasher = BankHasher(lthash_of_root(funk, device), device)
    parent = hashlib.sha256(b"genesis" + hasher.checksum()).digest()
    for slot, payloads in blocks:
        raw = pack_block(slot, payloads)     # serialized ONCE
        _, parent = _exec_block(funk, ex, slot, payloads, hasher,
                                parent, raw_block=raw)
        w.frame(raw[:-1] + b"\x01" + parent)
    fingerprint = state_fingerprint(funk)
    w.frame(fingerprint.to_bytes(8, "little"))
    w.fini()
    return fingerprint


def _exec_block(funk: Funk, ex: TxnExecutor, slot: int,
                payloads: list[bytes], hasher: BankHasher,
                parent: bytes,
                raw_block: bytes | None = None) -> tuple[int, bytes]:
    """Execute + publish one block; -> (ok_count, bank_hash). The
    DELTA scan is shared with the replay tile
    (BankHasher.apply_txn_delta); the chain INPUTS (parent seed,
    sig-count heuristic, blockhash = frame sha256) are backtest-local,
    so backtest hashes gate ledger determinism, not cross-component
    equality."""
    xid = ("block", slot)
    funk.txn_prepare(None, xid)
    ok = 0
    sigs = 0
    for p in payloads:
        ok += ex.execute(xid, p).status == OK
        sigs += max(1, p[0] if p else 1)      # compact-u16 first byte
    hasher.apply_txn_delta(funk, xid)
    funk.txn_publish(xid)
    # blockhash over the block's serialized bytes; replay passes the
    # frame it already holds instead of re-packing
    blockhash = hashlib.sha256(
        raw_block if raw_block is not None
        else pack_block(slot, payloads)).digest()
    return ok, hasher.bank_hash(parent, sigs, blockhash)


def replay(fp, verbose: bool = False, device="cuda") -> dict:
    """Replay a ledger, its bank hashes on `device`; raises on bank
    hash or fingerprint divergence."""
    r = CheckptReader(fp)
    frames = r.frames()
    genesis_blob = next(frames)
    funk = funk_restore(Funk, io.BytesIO(genesis_blob))
    ex = TxnExecutor(AccDb(funk))
    hasher = BankHasher(lthash_of_root(funk, device), device)
    parent = hashlib.sha256(b"genesis" + hasher.checksum()).digest()
    blocks = txns = executed = 0
    t0 = time.perf_counter()
    last = None
    for frame in frames:
        if last is not None:
            slot, payloads, want_hash = unpack_block(last)
            raw = (last[:-33] if want_hash else last[:-1]) + b"\x00"
            ok, got_hash = _exec_block(funk, ex, slot, payloads,
                                       hasher, parent, raw_block=raw)
            executed += ok
            parent = got_hash
            if want_hash and got_hash != want_hash:
                raise AssertionError(
                    f"bank hash diverged at slot {slot}: "
                    f"{got_hash.hex()[:16]} != {want_hash.hex()[:16]}")
            blocks += 1
            txns += len(payloads)
        last = frame
    dt = time.perf_counter() - t0
    want = int.from_bytes(last, "little") if last and len(last) == 8 \
        else None
    got = state_fingerprint(funk)
    if want is None or got != want:
        raise AssertionError(
            f"state diverged: fingerprint {got:#x} != expected "
            f"{want:#x}" if want is not None else "ledger missing "
            "fingerprint trailer")
    out = {"blocks": blocks, "txns": txns, "executed_ok": executed,
           "sec_per_slot": round(dt / max(blocks, 1), 6),
           "fingerprint": got}
    if verbose:
        print(out)
    return out


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if len(argv) == 4 and argv[2] == "--device":
        device = argv.pop(3)
        argv.pop(2)
    if len(argv) != 2 or argv[0] != "replay":
        print(__doc__)
        return 1
    with open(argv[1], "rb") as f:
        replay(f, verbose=True, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
