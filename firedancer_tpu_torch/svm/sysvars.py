"""Sysvar ACCOUNTS — the on-chain view of runtime state (copy of the JAX
package's svm/sysvars.py).

The reference maintains a sysvar cache and materializes each sysvar as
a real account under its well-known address at every slot boundary
(ref: src/flamenco/runtime/sysvar/fd_sysvar.c, fd_sysvar_clock.c,
fd_sysvar_slot_hashes.c; the cache in fd_sysvar_cache.h). Programs
read them two ways — as instruction accounts (stake/vote pass Clock
and Rent explicitly) and via sol_get_*_sysvar syscalls — and both
views must agree byte-for-byte.

This module owns the account layouts (Agave bincode encodings, pinned
by tests) and `update_sysvars`, which the replay stage calls at each
slot start: their bytes are bank-hash lattice inputs. The VM's syscall
cache (`read_sysvar_cache`, which svm/programs.py `_exec_bpf` calls)
reads the same encodings from accdb when the accounts exist, so the two
views cannot drift.
"""
from __future__ import annotations

import struct

from ..funk.funk import key32
from ..utils.base58 import b58_decode_32
from .accdb import Account

SYSVAR_OWNER = b58_decode_32("Sysvar1111111111111111111111111111111111111")
CLOCK_ID = b58_decode_32("SysvarC1ock11111111111111111111111111111111")
RENT_ID = b58_decode_32("SysvarRent111111111111111111111111111111111")
EPOCH_SCHEDULE_ID = b58_decode_32(
    "SysvarEpochSchedu1e111111111111111111111111")
SLOT_HASHES_ID = b58_decode_32(
    "SysvarS1otHashes111111111111111111111111111")
RECENT_BLOCKHASHES_ID = b58_decode_32(
    "SysvarRecentB1ockHashes11111111111111111111")
STAKE_HISTORY_ID = b58_decode_32(
    "SysvarStakeHistory1111111111111111111111111")

SLOT_HASHES_MAX = 512
RECENT_MAX = 150

# rent parameters (Solana mainnet defaults)
LAMPORTS_PER_BYTE_YEAR = 3480
EXEMPTION_THRESHOLD = 2.0
BURN_PERCENT = 50


def enc_clock(slot: int, epoch: int, epoch_start_ts: int = 0,
              leader_schedule_epoch: int | None = None,
              unix_ts: int = 0) -> bytes:
    """40-byte Clock (ref: fd_sysvar_clock.h layout)."""
    lse = epoch + 1 if leader_schedule_epoch is None \
        else leader_schedule_epoch
    return struct.pack("<QqQQq", slot, epoch_start_ts, epoch, lse,
                       unix_ts)


def dec_clock(b: bytes) -> dict:
    slot, ets, epoch, lse, ts = struct.unpack("<QqQQq", b[:40])
    return {"slot": slot, "epoch_start_timestamp": ets, "epoch": epoch,
            "leader_schedule_epoch": lse, "unix_timestamp": ts}


def enc_rent(lamports_per_byte_year: int = LAMPORTS_PER_BYTE_YEAR,
             exemption_threshold: float = EXEMPTION_THRESHOLD,
             burn_percent: int = BURN_PERCENT) -> bytes:
    """17-byte Rent."""
    return struct.pack("<Qd B", lamports_per_byte_year,
                       exemption_threshold, burn_percent)


def rent_exempt_minimum(data_len: int,
                        lamports_per_byte_year: int =
                        LAMPORTS_PER_BYTE_YEAR,
                        exemption_threshold: float =
                        EXEMPTION_THRESHOLD) -> int:
    """Minimum balance for rent exemption (Agave Rent::minimum_balance:
    (ACCOUNT_STORAGE_OVERHEAD=128 + data_len) * lpby * threshold)."""
    return int((128 + data_len) * lamports_per_byte_year
               * exemption_threshold)


def enc_epoch_schedule(slots_per_epoch: int,
                       leader_schedule_slot_offset: int | None = None,
                       warmup: bool = False,
                       first_normal_epoch: int = 0,
                       first_normal_slot: int = 0) -> bytes:
    """33-byte EpochSchedule."""
    off = slots_per_epoch if leader_schedule_slot_offset is None \
        else leader_schedule_slot_offset
    return struct.pack("<QQBQQ", slots_per_epoch, off,
                       1 if warmup else 0, first_normal_epoch,
                       first_normal_slot)


def enc_stake_history(entries: list[tuple[int, tuple]]) -> bytes:
    """StakeHistory: Vec<(Epoch, {effective, activating, deactivating}
    u64 x3)>, newest first, capped at 512 entries (Agave layout; ref
    src/flamenco/runtime/sysvar/fd_sysvar_stake_history.c)."""
    entries = entries[:512]
    out = struct.pack("<Q", len(entries))
    for epoch, (eff, act, deact) in entries:
        out += struct.pack("<QQQQ", epoch, eff, act, deact)
    return out


def dec_stake_history(b: bytes) -> dict[int, tuple]:
    (n,) = struct.unpack_from("<Q", b, 0)
    out = {}
    off = 8
    for _ in range(n):
        epoch, eff, act, deact = struct.unpack_from("<QQQQ", b, off)
        out[epoch] = (eff, act, deact)
        off += 32
    return out


def stake_history_from_account(acct) -> dict | None:
    """Decode the StakeHistory sysvar account (or None when absent /
    malformed) — the ONE read-and-decode policy shared by the stake
    program's withdraw gate and the epoch-stakes aggregation."""
    if acct is None or len(getattr(acct, "data", b"")) < 8:
        return None
    try:
        return dec_stake_history(bytes(acct.data))
    except Exception:
        return None


def enc_slot_hashes(entries: list[tuple[int, bytes]]) -> bytes:
    """bincode Vec<(Slot, Hash)>, newest first, capped at 512."""
    entries = entries[:SLOT_HASHES_MAX]
    out = struct.pack("<Q", len(entries))
    for slot, h in entries:
        out += struct.pack("<Q", slot) + h
    return out


def dec_slot_hashes(b: bytes) -> list[tuple[int, bytes]]:
    n, = struct.unpack_from("<Q", b, 0)
    out = []
    off = 8
    for _ in range(n):
        slot, = struct.unpack_from("<Q", b, off)
        out.append((slot, b[off + 8:off + 40]))
        off += 40
    return out


def enc_recent_blockhashes(entries: list[tuple[bytes, int]]) -> bytes:
    """bincode Vec<Entry{blockhash, fee_calculator{u64}}>, newest
    first, capped at 150."""
    entries = entries[:RECENT_MAX]
    out = struct.pack("<Q", len(entries))
    for h, lps in entries:
        out += h + struct.pack("<Q", lps)
    return out


def _write(db, xid, key: bytes, data: bytes):
    """Materialize a sysvar account; accepts an AccDb or a bare Funk
    (the one shape for every sysvar writer)."""
    funk = db.funk if hasattr(db, "funk") else db
    funk.rec_write(xid, key32(key), Account(
        lamports=rent_exempt_minimum(len(data)), data=bytearray(data),
        owner=SYSVAR_OWNER, executable=False))


def update_sysvars(db, xid, slot: int, epoch: int,
                   slots_per_epoch: int = 432_000,
                   blockhash: bytes | None = None,
                   lamports_per_sig: int = 5000,
                   unix_ts: int = 0):
    """Materialize/refresh the sysvar accounts for `slot` — the slot-
    boundary duty of the bank (ref: fd_runtime block prepare calling
    the fd_sysvar_*_update family). `blockhash` (the PARENT bank hash)
    prepends to SlotHashes and RecentBlockhashes."""
    _write(db, xid, CLOCK_ID,
           enc_clock(slot, epoch,
                     epoch_start_ts=unix_ts, unix_ts=unix_ts))
    _write(db, xid, RENT_ID, enc_rent())
    _write(db, xid, EPOCH_SCHEDULE_ID,
           enc_epoch_schedule(slots_per_epoch))
    if blockhash is not None:
        prev = db.peek(xid, SLOT_HASHES_ID)
        hashes = dec_slot_hashes(bytes(prev.data)) if prev else []
        if slot > 0:
            hashes = [(slot - 1, blockhash)] + hashes
        _write(db, xid, SLOT_HASHES_ID, enc_slot_hashes(hashes))
        prevr = db.peek(xid, RECENT_BLOCKHASHES_ID)
        rb = []
        if prevr:
            raw = bytes(prevr.data)
            n, = struct.unpack_from("<Q", raw, 0)
            off = 8
            for _ in range(n):
                rb.append((raw[off:off + 32],
                           struct.unpack_from("<Q", raw, off + 32)[0]))
                off += 40
        rb = [(blockhash, lamports_per_sig)] + rb
        _write(db, xid, RECENT_BLOCKHASHES_ID,
               enc_recent_blockhashes(rb))


def read_sysvar_cache(db, xid, fallback_slot: int,
                      fallback_epoch: int) -> dict[str, bytes]:
    """The VM syscall view: account bytes when materialized, else
    synthesized from the executor's slot/epoch (keeps pre-sysvar
    topologies working)."""
    cache = {}
    clock = db.peek(xid, CLOCK_ID)
    cache["clock"] = bytes(clock.data[:40]) if clock \
        and len(clock.data) >= 40 else enc_clock(fallback_slot,
                                                 fallback_epoch)
    rent = db.peek(xid, RENT_ID)
    cache["rent"] = bytes(rent.data[:17]) if rent \
        and len(rent.data) >= 17 else enc_rent()
    es = db.peek(xid, EPOCH_SCHEDULE_ID)
    if es and len(es.data) >= 33:
        cache["epoch_schedule"] = bytes(es.data[:33])
    return cache
