"""Solana transaction wire parser (the port's own copy of the JAX
package's protocol/txn.py, without the keyguard's message-shape probe).

Equivalent of the reference's zero-copy txn parser
(ref: src/ballet/txn/fd_txn.h:181-227 — `fd_txn_t` descriptor table;
fd_txn_parse.c), re-shaped for the TPU pipeline: instead of an in-place
descriptor struct, `parse_txn` returns the offsets/views the verify and
pack tiles need — signatures, signer pubkeys, the signed message region,
account metadata and instruction table.

Wire layout (legacy and v0):
  compact-u16 signature count | sigs (64B each) | message
  message: [0x80|version byte if v0] header(3B: n_signed, n_ro_signed,
  n_ro_unsigned) | compact-u16 account count | accounts (32B each) |
  recent blockhash (32B) | compact-u16 instr count | instrs
  {prog_idx u8, compact-u16 n_acct + idxs, compact-u16 n_data + bytes}
  v0 only: compact-u16 ALUT count | {key 32B, w_idxs, ro_idxs}

Limits mirror the reference: MTU 1232 bytes
(src/ballet/txn/fd_txn.h:102-104), <= 12 actual signatures
(FD_TXN_ACTUAL_SIG_MAX, src/ballet/txn/fd_txn.h:68).
"""
from __future__ import annotations

from dataclasses import dataclass, field

MTU = 1232
SIG_MAX = 12
ACCT_MAX = 128
INSTR_MAX = 64


class TxnParseError(ValueError):
    pass


def _cu16(data: bytes, off: int) -> tuple[int, int]:
    """Decode compact-u16 (1-3 byte LEB-style varint, max 0xffff)."""
    v = 0
    for i in range(3):
        if off >= len(data):
            raise TxnParseError("truncated compact-u16")
        b = data[off]
        off += 1
        v |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            if i == 2 and b > 0x03:
                raise TxnParseError("compact-u16 overflow")
            # non-minimal encodings rejected (consensus rule)
            if i > 0 and b == 0:
                raise TxnParseError("non-minimal compact-u16")
            return v, off
    raise TxnParseError("compact-u16 too long")


@dataclass
class Instr:
    prog_idx: int
    acct_idxs: bytes
    data_off: int
    data_sz: int


@dataclass
class ParsedTxn:
    """Offsets are into the original payload (zero-copy discipline)."""
    sig_cnt: int
    sig_off: int              # signatures start (64B each)
    msg_off: int              # signed region: [msg_off, len(payload))
    version: int              # -1 legacy, 0 = v0
    n_signed: int
    n_ro_signed: int
    n_ro_unsigned: int
    acct_cnt: int
    acct_off: int             # account keys start (32B each)
    blockhash_off: int
    instrs: list[Instr] = field(default_factory=list)
    alut_cnt: int = 0
    # v0: [(table_key, writable_idxs bytes, readonly_idxs bytes)]
    aluts: tuple = ()
    size: int = 0             # consumed wire bytes (== len for strict)

    def signatures(self, payload: bytes) -> list[bytes]:
        return [payload[self.sig_off + 64 * i: self.sig_off + 64 * (i + 1)]
                for i in range(self.sig_cnt)]

    def signer_pubkeys(self, payload: bytes) -> list[bytes]:
        return [payload[self.acct_off + 32 * i: self.acct_off + 32 * (i + 1)]
                for i in range(self.sig_cnt)]

    def message(self, payload: bytes) -> bytes:
        end = self.size if self.size else len(payload)
        return payload[self.msg_off:end]

    def account_keys(self, payload: bytes) -> list[bytes]:
        return [payload[self.acct_off + 32 * i: self.acct_off + 32 * (i + 1)]
                for i in range(self.acct_cnt)]

    def is_writable(self, idx: int) -> bool:
        """Static account write permission (legacy/v0 static keys).
        Mirrors the reference's account classification
        (src/ballet/txn/fd_txn.h message header semantics)."""
        if idx < self.n_signed:
            return idx < self.n_signed - self.n_ro_signed
        unsigned_idx = idx - self.n_signed
        n_unsigned = self.acct_cnt - self.n_signed
        return unsigned_idx < n_unsigned - self.n_ro_unsigned


def parse_txn(payload: bytes, allow_trailing: bool = False) -> ParsedTxn:
    """allow_trailing=True parses a txn at a PREFIX of payload and
    reports the consumed size (the fd_txn_parse_core return-size
    contract the gossip vote parser relies on,
    ref src/flamenco/gossip/fd_gossip_msg_parse.c:114)."""
    if len(payload) > MTU and not allow_trailing:
        raise TxnParseError(f"payload {len(payload)} > MTU {MTU}")
    sig_cnt, off = _cu16(payload, 0)
    if not 1 <= sig_cnt <= SIG_MAX:
        raise TxnParseError(f"bad signature count {sig_cnt}")
    sig_off = off
    off += 64 * sig_cnt
    if off > len(payload):
        raise TxnParseError("truncated signatures")
    msg_off = off

    if off >= len(payload):
        raise TxnParseError("empty message")
    version = -1
    if payload[off] & 0x80:
        version = payload[off] & 0x7F
        if version != 0:
            raise TxnParseError(f"unsupported txn version {version}")
        off += 1
    if off + 3 > len(payload):
        raise TxnParseError("truncated header")
    n_signed, n_ro_signed, n_ro_unsigned = payload[off:off + 3]
    off += 3
    if n_signed != sig_cnt:
        raise TxnParseError("header signer count != signature count")
    if n_ro_signed >= n_signed:
        # the fee payer (signer 0) must be writable
        raise TxnParseError("readonly signed count out of range")

    acct_cnt, off = _cu16(payload, off)
    if not n_signed <= acct_cnt <= ACCT_MAX:
        raise TxnParseError(f"bad account count {acct_cnt}")
    if n_ro_unsigned > acct_cnt - n_signed:
        raise TxnParseError("readonly unsigned count out of range")
    acct_off = off
    off += 32 * acct_cnt
    if off > len(payload):
        raise TxnParseError("truncated account keys")
    blockhash_off = off
    off += 32
    if off > len(payload):
        raise TxnParseError("truncated blockhash")

    instr_cnt, off = _cu16(payload, off)
    if instr_cnt > INSTR_MAX:
        raise TxnParseError(f"too many instructions {instr_cnt}")
    instrs = []
    for _ in range(instr_cnt):
        if off >= len(payload):
            raise TxnParseError("truncated instruction")
        prog_idx = payload[off]
        off += 1
        if prog_idx >= acct_cnt:
            raise TxnParseError("instr program index out of range")
        n_acct, off = _cu16(payload, off)
        acct_idxs = payload[off:off + n_acct]
        off += n_acct
        if off > len(payload):
            raise TxnParseError("truncated instr accounts")
        if version != 0 and any(ix >= acct_cnt for ix in acct_idxs):
            # v0 indexes may address table-loaded accounts; bounded
            # below once the alut section is parsed
            raise TxnParseError("instr account index out of range")
        n_data, off = _cu16(payload, off)
        data_off = off
        off += n_data
        if off > len(payload):
            raise TxnParseError("truncated instr data")
        instrs.append(Instr(prog_idx, acct_idxs, data_off, n_data))

    alut_cnt = 0
    aluts = []
    if version == 0:
        alut_cnt, off = _cu16(payload, off)
        for _ in range(alut_cnt):
            tkey = payload[off:off + 32]
            off += 32
            n_w, off = _cu16(payload, off)
            w_idxs = payload[off:off + n_w]
            off += n_w
            n_ro, off = _cu16(payload, off)
            ro_idxs = payload[off:off + n_ro]
            off += n_ro
            if off > len(payload):
                raise TxnParseError("truncated address lookup table")
            aluts.append((tkey, w_idxs, ro_idxs))
        # now the loaded-account count is known: bound every instr
        # index against static + loaded (consumers like the pack cost
        # model index keys BEFORE resolution and must never IndexError)
        n_loaded = sum(len(w) + len(r) for _, w, r in aluts)
        for ins in instrs:
            if ins.prog_idx >= acct_cnt + n_loaded or any(
                    ix >= acct_cnt + n_loaded for ix in ins.acct_idxs):
                raise TxnParseError("instr account index out of range")

    if off != len(payload) and not allow_trailing:
        raise TxnParseError(f"trailing bytes: {len(payload) - off}")

    return ParsedTxn(sig_cnt, sig_off, msg_off, version, n_signed,
                     n_ro_signed, n_ro_unsigned, acct_cnt, acct_off,
                     blockhash_off, instrs, alut_cnt, tuple(aluts),
                     size=off)


# ---------------------------------------------------------------------------
# construction (tests / synthetic load gen — the benchg analog,
# ref: src/app/shared_dev/commands/bench/fd_benchg_tile.c)
# ---------------------------------------------------------------------------

def _cu16_enc(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def build_message(signer_pubkeys: list[bytes], extra_accounts: list[bytes],
                  blockhash: bytes, instrs: list[tuple[int, bytes, bytes]],
                  n_ro_signed: int = 0, n_ro_unsigned: int = 0,
                  version: int = -1, aluts=()) -> bytes:
    """instrs: (prog_idx, acct_idxs, data).
    aluts (v0): [(table_key, writable_idxs, readonly_idxs)] — loaded
    addresses extend the key list past the static accounts, writables
    first (the reference's v0 address-table section,
    src/ballet/txn/fd_txn.h address table lookups)."""
    accounts = list(signer_pubkeys) + list(extra_accounts)
    out = bytearray()
    if version == 0:
        out.append(0x80)
    out += bytes([len(signer_pubkeys), n_ro_signed, n_ro_unsigned])
    out += _cu16_enc(len(accounts))
    for a in accounts:
        assert len(a) == 32
        out += a
    assert len(blockhash) == 32
    out += blockhash
    out += _cu16_enc(len(instrs))
    for prog_idx, acct_idxs, data in instrs:
        out.append(prog_idx)
        out += _cu16_enc(len(acct_idxs)) + bytes(acct_idxs)
        out += _cu16_enc(len(data)) + bytes(data)
    if version == 0:
        out += _cu16_enc(len(aluts))
        for tkey, w_idxs, ro_idxs in aluts:
            assert len(tkey) == 32
            out += tkey
            out += _cu16_enc(len(w_idxs)) + bytes(w_idxs)
            out += _cu16_enc(len(ro_idxs)) + bytes(ro_idxs)
    return bytes(out)


def build_txn(signatures: list[bytes], message: bytes) -> bytes:
    out = bytearray(_cu16_enc(len(signatures)))
    for s in signatures:
        assert len(s) == 64
        out += s
    out += message
    return bytes(out)
