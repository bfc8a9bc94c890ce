"""Host-side transaction executor + the native system program (copy of
the JAX package's svm/programs.py: `TxnExecutor` (:967-1074) with v0
transactions through their lookup tables, `TxnContext`, `InstrCtx`,
`LogCollector`, `TxnResult`, `_exec_system` (:284) with its nonce and
seed accounts, `create_with_seed`, the PDA derivation
`create_program_address` / `find_program_address` that svm/alut.py's
`derive_table_address` uses, and `dispatch_instr` (:919-950) to the
vote, stake, lookup-table and precompile programs of svm/vote.py,
svm/stake.py, svm/alut.py and svm/precompiles.py).

The reference's per-txn execution (load accounts, charge fees, dispatch
instructions sequentially through native program handlers, commit or
roll back atomically) lives in fd_executor/fd_system_program
(ref: src/flamenco/runtime/fd_executor.c, fd_runtime.h:254-266,
program/fd_system_program.c:59-330). The wave executor (executor.py)
covers the batched pure-transfer fast path on the device; THIS module
is the host path the follower's replay runs.

Where the copy differs from the reference: `dispatch_instr` has no
`depth` or `budget` (CPI's), and the upgradeable loader and a deployed
sBPF program (an executable account owned by a BPF loader) raise
`disco.unported.refuse(..., "15b")` where the reference runs them. A
program id that no program answers to fails the transaction with
`unknown_program`, as in the reference. Without CPI an instruction's
privileges are always the transaction message's, and `TxnResult` and
`TxnContext` carry none of the sBPF path's compute meter, heap size or
return data.

Semantics mirrored from the reference per instruction:
  Transfer        from must SIGN, be writable, system-owned, no data;
                  insufficient lamports aborts the txn
                  (fd_system_program.c:59-137)
  CreateAccount   to must SIGN, be empty (0 lamports, no data, system
                  owner); allocate+assign+fund (:254-330)
  Assign          account must SIGN, be writable, system-owned (:202-230)
  Allocate        account must SIGN, be writable, system-owned, data
                  empty; space <= MAX_PERMITTED_DATA_LENGTH (:143-200)

A failing instruction rolls the whole transaction back; the fee is
charged to the payer regardless (the reference commits fees before
execution). Every touched account goes through accdb rw handles, so
rollback is just dropping them (accdb.close_rw(discard=True)).
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

from ..disco.unported import refuse
from ..funk.funk import key32
from ..pack.cost import BPF_UPGRADEABLE_LOADER_ID, COMPUTE_BUDGET_PROGRAM_ID
from ..protocol.txn import ParsedTxn, parse_txn
from .accdb import AccDb, Account, SYSTEM_PROGRAM_ID

BPF_LOADER_ID = b"BPFLoader" + bytes(23)
MAX_PERMITTED_DATA_LENGTH = 10 * 1024 * 1024

# system instruction discriminants (u32 LE bincode, the Agave enum)
SYS_CREATE_ACCOUNT = 0
SYS_ASSIGN = 1
SYS_TRANSFER = 2
SYS_CREATE_WITH_SEED = 3
SYS_ADVANCE_NONCE = 4
SYS_WITHDRAW_NONCE = 5
SYS_INIT_NONCE = 6
SYS_AUTHORIZE_NONCE = 7
SYS_ALLOCATE = 8
SYS_ALLOCATE_WITH_SEED = 9
SYS_ASSIGN_WITH_SEED = 10
SYS_TRANSFER_WITH_SEED = 11

NONCE_STATE_SZ = 80           # u32 version | u32 state | authority 32
                              # | durable nonce 32 | fee/sig u64


def create_with_seed(base: bytes, seed: bytes, owner: bytes) -> bytes:
    """Pubkey::create_with_seed — sha256(base || seed || owner); seed-
    derived addresses are NOT PDAs (no off-curve requirement),
    ref fd_system_program.c:389."""
    return hashlib.sha256(base + seed + owner).digest()


MAX_SEEDS = 16                     # PDA seed count limit (Solana)
MAX_SEED_LEN = 32
PDA_MARKER = b"ProgramDerivedAddress"


def create_program_address(seeds: list[bytes],
                           program_id: bytes) -> bytes | None:
    """sha256(seeds .. program_id .. marker); None if the result lies
    ON the ed25519 curve (a PDA must have no private key)."""
    from ..utils.ed25519_ref import pt_decompress
    if len(seeds) > MAX_SEEDS or any(len(s) > MAX_SEED_LEN
                                     for s in seeds):
        return None
    h = hashlib.sha256()
    for s in seeds:
        h.update(s)
    h.update(program_id)
    h.update(PDA_MARKER)
    addr = h.digest()
    if pt_decompress(addr) is not None:
        return None                   # on-curve: invalid PDA
    return addr


def find_program_address(seeds: list[bytes],
                         program_id: bytes) -> tuple[bytes, int]:
    for bump in range(255, -1, -1):
        addr = create_program_address(seeds + [bytes([bump])],
                                      program_id)
        if addr is not None:
            return addr, bump
    raise ValueError("no viable bump seed")


def _read_seed_str(data: bytes, off: int):
    """bincode String: u64 length + utf8 bytes; -> (seed, next_off)."""
    if off + 8 > len(data):
        raise ValueError("truncated seed")
    n, = struct.unpack_from("<Q", data, off)
    if n > 32 or off + 8 + n > len(data):     # MAX_SEED_LEN
        raise ValueError("seed too long")
    return data[off + 8:off + 8 + n], off + 8 + n


def _nonce_state(authority: bytes, durable: bytes,
                 fee_per_sig: int = 5000) -> bytes:
    return struct.pack("<II", 1, 1) + authority + durable \
        + struct.pack("<Q", fee_per_sig)


def _parse_nonce(data: bytes):
    if len(data) < NONCE_STATE_SZ:
        raise ValueError("short nonce state")
    ver, state = struct.unpack_from("<II", data, 0)
    if ver != 1 or state != 1:
        raise ValueError("nonce not initialized")
    return data[8:40], data[40:72]            # authority, durable


# status codes (fd_executor error flavor)
OK = "ok"
ERR_FEE = "fee_payer_insufficient"
ERR_PARSE = "parse_failed"
ERR_MISSING_SIG = "missing_required_signature"
ERR_NOT_WRITABLE = "account_not_writable"
ERR_INSUFFICIENT = "insufficient_funds"
ERR_ALREADY_IN_USE = "account_already_in_use"
ERR_INVALID_OWNER = "invalid_account_owner"
ERR_HAS_DATA = "account_has_data"
ERR_SPACE = "invalid_space"
ERR_UNKNOWN_IX = "unknown_instruction"
ERR_UNKNOWN_PROGRAM = "unknown_program"
ERR_BAD_IX_DATA = "bad_instruction_data"
ERR_VM = "program_failed"
ERR_RENT = "insufficient_funds_for_rent"
ERR_ALUT = "alut_resolution_failed"


class LogCollector(list):
    """Bounded program-log buffer (the reference's fd_log_collector:
    10KB budget, a single truncation marker once exceeded)."""

    MAX_BYTES = 10_000

    def __init__(self):
        super().__init__()
        self._bytes = 0
        self._truncated = False

    def append(self, line):
        if self._truncated:
            return
        n = len(line.encode()) if isinstance(line, str) else len(line)
        if self._bytes + n > self.MAX_BYTES:
            self._truncated = True
            super().append("Log truncated")
            return
        self._bytes += n
        super().append(line)

    def extend(self, lines):
        for ln in lines:
            self.append(ln)


@dataclass
class TxnResult:
    status: str
    fee: int
    logs: list


class TxnContext:
    """Per-txn view: copy-on-write accounts over one accdb fork."""

    def __init__(self, db: AccDb, xid, txn: ParsedTxn, payload: bytes,
                 epoch: int = 0, slot: int = 0, loaded_keys=(),
                 loaded_writable=()):
        self.db = db
        self.xid = xid
        self.txn = txn
        self.payload = payload
        self.epoch = epoch            # Clock-sysvar stand-in
        self.slot = slot
        # v0: table-loaded addresses extend the static list (writables
        # first — the resolv contract, svm/alut.py)
        self.keys = txn.account_keys(payload) + list(loaded_keys)
        self._loaded_writable = list(loaded_writable)
        self._work: dict[bytes, Account] = {}
        self._pre: dict[bytes, tuple] = {}   # (lamports, data_len) at load
        self.logs = LogCollector()

    def is_signer(self, idx: int) -> bool:
        return idx < self.txn.sig_cnt

    def is_writable(self, idx: int) -> bool:
        if idx >= self.txn.acct_cnt:
            return self._loaded_writable[idx - self.txn.acct_cnt]
        return self.txn.is_writable(idx)

    def account(self, idx: int) -> Account:
        k = self.keys[idx]
        if k not in self._work:
            a = self.db.peek(self.xid, k)
            self._work[k] = Account() if a is None else \
                Account(a.lamports, a.data, a.owner, a.executable,
                        a.rent_epoch)
            self._pre[k] = (0, 0) if a is None else \
                (a.lamports, len(a.data))
        return self._work[k]

    def rent_violation(self) -> bytes | None:
        """Post-execution rent-state check (modern consensus: rent is
        never collected, but every touched account must LEAVE the txn
        rent-exempt — ref src/flamenco/runtime/sysvar/fd_sysvar_rent.c
        minimum-balance discipline + Agave check_rent_state):
        an account passes when it is empty (0 lamports), meets the
        rent-exempt minimum for its data size, or was ALREADY
        rent-paying and did not grow (Agave's RentPaying->RentPaying
        transition: same data size, lamports non-increasing; an
        exempt account may never become rent-paying). Returns the
        first offending key, else None."""
        from .sysvars import rent_exempt_minimum
        for k, a in self._work.items():
            if a.lamports == 0:
                continue
            need = rent_exempt_minimum(len(a.data))
            if a.lamports >= need:
                continue
            pre_l, pre_len = self._pre.get(k, (0, 0))
            pre_paying = 0 < pre_l < rent_exempt_minimum(pre_len)
            if pre_paying and a.lamports <= pre_l \
                    and len(a.data) == pre_len:
                continue               # rent-paying shrank/held: legal
            return k
        return None

    def commit(self):
        for k, a in self._work.items():
            self.db.funk.rec_write(self.xid, key32(k), a)


class InstrCtx:
    """One instruction invocation: local account indices, with the
    transaction message's signer/writable bits (no CPI frames here)."""

    def __init__(self, ctx: TxnContext, program_id: bytes,
                 acct_idxs, data: bytes):
        self.ctx = ctx
        self.program_id = program_id
        self.acct_idxs = list(acct_idxs)
        self.data = data

    @property
    def n(self) -> int:
        return len(self.acct_idxs)

    def key(self, i: int) -> bytes:
        return self.ctx.keys[self.acct_idxs[i]]

    def account(self, i: int) -> Account:
        return self.ctx.account(self.acct_idxs[i])

    def is_signer(self, i: int) -> bool:
        return self.ctx.is_signer(self.acct_idxs[i])

    def is_writable(self, i: int) -> bool:
        return self.ctx.is_writable(self.acct_idxs[i])

    def signer_keys(self) -> set:
        return {self.ctx.keys[i] for i in range(self.ctx.txn.sig_cnt)}

    @property
    def logs(self):
        return self.ctx.logs


def _u64(data: bytes, off: int) -> int:
    return struct.unpack_from("<Q", data, off)[0]


def _exec_system(ic: InstrCtx) -> str:
    data = ic.data
    if len(data) < 4:
        return ERR_BAD_IX_DATA
    disc = struct.unpack_from("<I", data, 0)[0]

    if disc == SYS_TRANSFER:
        if len(data) < 12 or ic.n < 2:
            return ERR_BAD_IX_DATA
        amount = _u64(data, 4)
        if not ic.is_signer(0):
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(1):
            return ERR_NOT_WRITABLE
        src = ic.account(0)
        if src.owner != SYSTEM_PROGRAM_ID:
            # the system program may only debit accounts it owns — a
            # signer must not drain an account previously Assigned to
            # another program (ref fd_system_program_transfer_verified,
            # Agave ExternalAccountLamportSpend)
            return ERR_INVALID_OWNER
        if src.data:
            return ERR_HAS_DATA          # transfer-from must hold no data
        if amount > src.lamports:
            ic.logs.append(
                f"Transfer: insufficient lamports {src.lamports}, "
                f"need {amount}")
            return ERR_INSUFFICIENT
        src.lamports -= amount
        ic.account(1).lamports += amount
        return OK

    if disc == SYS_CREATE_ACCOUNT:
        if len(data) < 4 + 8 + 8 + 32 or ic.n < 2:
            return ERR_BAD_IX_DATA
        lamports = _u64(data, 4)
        space = _u64(data, 12)
        owner = data[20:52]
        if not ic.is_signer(0) or not ic.is_signer(1):
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(1):
            return ERR_NOT_WRITABLE
        to = ic.account(1)
        if to.lamports or to.data or to.owner != SYSTEM_PROGRAM_ID:
            ic.logs.append("Create Account: account already in use")
            return ERR_ALREADY_IN_USE
        if space > MAX_PERMITTED_DATA_LENGTH:
            return ERR_SPACE
        src = ic.account(0)
        if lamports > src.lamports:
            return ERR_INSUFFICIENT
        to.data = bytes(space)
        to.owner = owner
        src.lamports -= lamports
        to.lamports += lamports
        return OK

    if disc == SYS_ASSIGN:
        if len(data) < 36 or ic.n < 1:
            return ERR_BAD_IX_DATA
        if not ic.is_signer(0):
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        acct = ic.account(0)
        if acct.owner != SYSTEM_PROGRAM_ID:
            return ERR_INVALID_OWNER
        acct.owner = data[4:36]
        return OK

    if disc == SYS_CREATE_WITH_SEED:
        # disc | base 32 | seed str | lamports u64 | space u64 | owner
        try:
            base = data[4:36]
            seed, off = _read_seed_str(data, 36)
            lamports, space = struct.unpack_from("<QQ", data, off)
            owner = data[off + 16:off + 48]
        except (ValueError, struct.error):
            return ERR_BAD_IX_DATA
        if ic.n < 2 or len(owner) != 32:
            return ERR_BAD_IX_DATA
        if ic.key(1) != create_with_seed(base, seed, owner):
            return ERR_INVALID_OWNER          # address mismatch
        # base must sign (it authorizes the derived address)
        if not ic.is_signer(0) or base not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(1):
            return ERR_NOT_WRITABLE
        to = ic.account(1)
        if to.lamports or to.data or to.owner != SYSTEM_PROGRAM_ID:
            return ERR_ALREADY_IN_USE
        if space > MAX_PERMITTED_DATA_LENGTH:
            return ERR_SPACE
        src = ic.account(0)
        if src.owner != SYSTEM_PROGRAM_ID or src.data:
            return ERR_INVALID_OWNER
        if lamports > src.lamports:
            return ERR_INSUFFICIENT
        to.data = bytes(space)
        to.owner = owner
        src.lamports -= lamports
        to.lamports += lamports
        return OK

    if disc in (SYS_ALLOCATE_WITH_SEED, SYS_ASSIGN_WITH_SEED):
        try:
            base = data[4:36]
            seed, off = _read_seed_str(data, 36)
            if disc == SYS_ALLOCATE_WITH_SEED:
                space, = struct.unpack_from("<Q", data, off)
                owner = data[off + 8:off + 40]
            else:
                space = None
                owner = data[off:off + 32]
        except (ValueError, struct.error):
            return ERR_BAD_IX_DATA
        if ic.n < 1 or len(owner) != 32:
            return ERR_BAD_IX_DATA
        if ic.key(0) != create_with_seed(base, seed, owner):
            return ERR_INVALID_OWNER
        if base not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        acct = ic.account(0)
        if acct.owner != SYSTEM_PROGRAM_ID:
            return ERR_INVALID_OWNER
        if disc == SYS_ALLOCATE_WITH_SEED:
            if acct.data:
                return ERR_HAS_DATA
            if space > MAX_PERMITTED_DATA_LENGTH:
                return ERR_SPACE
            acct.data = bytes(space)
        acct.owner = owner
        return OK

    if disc == SYS_TRANSFER_WITH_SEED:
        # disc | lamports u64 | from_seed str | from_owner 32;
        # accounts [from(derived), base(signer), to]
        try:
            amount, = struct.unpack_from("<Q", data, 4)
            seed, off = _read_seed_str(data, 12)
            from_owner = data[off:off + 32]
        except (ValueError, struct.error):
            return ERR_BAD_IX_DATA
        if ic.n < 3 or len(from_owner) != 32:
            return ERR_BAD_IX_DATA
        if ic.key(0) != create_with_seed(ic.key(1), seed, from_owner):
            return ERR_INVALID_OWNER
        if not ic.is_signer(1):
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(2):
            return ERR_NOT_WRITABLE
        src = ic.account(0)
        if src.owner != SYSTEM_PROGRAM_ID or src.data:
            return ERR_INVALID_OWNER
        if amount > src.lamports:
            return ERR_INSUFFICIENT
        src.lamports -= amount
        ic.account(2).lamports += amount
        return OK

    if disc == SYS_INIT_NONCE:
        if len(data) < 36 or ic.n < 1:
            return ERR_BAD_IX_DATA
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        acct = ic.account(0)
        # the account must be PRE-ALLOCATED to exactly the nonce size
        # (Agave's guard: allocation required the account's signature
        # at CreateAccount time — without it, init+withdraw would
        # drain any writable wallet that never signed)
        if acct.owner != SYSTEM_PROGRAM_ID \
                or len(acct.data) != NONCE_STATE_SZ \
                or any(acct.data[:8]):
            return ERR_INVALID_OWNER
        durable = hashlib.sha256(
            b"DURABLE_NONCE" + ic.key(0)
            + ic.ctx.slot.to_bytes(8, "little")).digest()
        acct.data = _nonce_state(data[4:36], durable)
        return OK

    if disc in (SYS_ADVANCE_NONCE, SYS_AUTHORIZE_NONCE):
        if ic.n < 1:
            return ERR_BAD_IX_DATA
        acct = ic.account(0)
        if acct.owner != SYSTEM_PROGRAM_ID:
            return ERR_INVALID_OWNER
        try:
            authority, durable = _parse_nonce(acct.data)
        except ValueError:
            return ERR_INVALID_OWNER
        if authority not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        if disc == SYS_ADVANCE_NONCE:
            # derived from (key, slot) — the SAME formula as init, so
            # advancing twice in one slot yields an unchanged value
            # and FAILS (Agave: advance on an unmoved blockhash fails)
            new = hashlib.sha256(
                b"DURABLE_NONCE" + ic.key(0)
                + ic.ctx.slot.to_bytes(8, "little")).digest()
            if new == durable:
                return ERR_BAD_IX_DATA        # nonce must move
            acct.data = _nonce_state(authority, new)
        else:
            if len(data) < 36:
                return ERR_BAD_IX_DATA
            acct.data = _nonce_state(data[4:36], durable)
        return OK

    if disc == SYS_WITHDRAW_NONCE:
        if len(data) < 12 or ic.n < 2:
            return ERR_BAD_IX_DATA
        lamports = _u64(data, 4)
        acct = ic.account(0)
        if acct.owner != SYSTEM_PROGRAM_ID:
            return ERR_INVALID_OWNER
        try:
            authority, _durable = _parse_nonce(acct.data)
        except ValueError:
            # UNINITIALIZED nonce-sized account: recoverable by the
            # account's own signature (Agave's uninitialized-withdraw
            # path — otherwise allocated-but-never-initialized funds
            # would be stuck: Transfer refuses data-bearing sources)
            if len(acct.data) == NONCE_STATE_SZ \
                    and not any(acct.data) \
                    and ic.key(0) in ic.signer_keys():
                authority = ic.key(0)
            else:
                return ERR_INVALID_OWNER
        if authority not in ic.signer_keys():
            return ERR_MISSING_SIG
        if not ic.is_writable(0) or not ic.is_writable(1):
            return ERR_NOT_WRITABLE
        if lamports > acct.lamports:
            return ERR_INSUFFICIENT
        if lamports != acct.lamports:
            # partial withdraw must leave the rent-exempt reserve
            # (Agave nonce withdraw: lamports + min_balance must fit;
            # a FULL withdraw closes the account instead)
            from .sysvars import rent_exempt_minimum
            if lamports + rent_exempt_minimum(NONCE_STATE_SZ) \
                    > acct.lamports:
                return ERR_INSUFFICIENT
        acct.lamports -= lamports
        ic.account(1).lamports += lamports
        if acct.lamports == 0:
            acct.data = b""               # full withdraw closes
        return OK

    if disc == SYS_ALLOCATE:
        if len(data) < 12 or ic.n < 1:
            return ERR_BAD_IX_DATA
        space = _u64(data, 4)
        if not ic.is_signer(0):
            return ERR_MISSING_SIG
        if not ic.is_writable(0):
            return ERR_NOT_WRITABLE
        acct = ic.account(0)
        if acct.owner != SYSTEM_PROGRAM_ID:
            return ERR_INVALID_OWNER
        if acct.data:
            return ERR_HAS_DATA
        if space > MAX_PERMITTED_DATA_LENGTH:
            return ERR_SPACE
        acct.data = bytes(space)
        return OK

    return ERR_UNKNOWN_IX


def dispatch_instr(ctx: TxnContext, ic: InstrCtx) -> str:
    """Route one instruction to its program (the fd_executor
    native-program dispatch switch); the upgradeable loader and deployed
    sBPF programs are refused (item 15b)."""
    from .alut import ALUT_PROGRAM_ID, exec_alut
    from .precompiles import (
        ED25519_PROGRAM_ID, SECP256K1_PROGRAM_ID, SECP256R1_PROGRAM_ID,
        exec_ed25519_precompile, exec_secp256k1_precompile,
        exec_secp256r1_precompile,
    )
    from .stake import STAKE_PROGRAM_ID, exec_stake
    from .vote import VOTE_PROGRAM_ID, exec_vote
    pid = ic.program_id
    if pid == SYSTEM_PROGRAM_ID:
        return _exec_system(ic)
    if pid == VOTE_PROGRAM_ID:
        return exec_vote(ic)
    if pid == STAKE_PROGRAM_ID:
        return exec_stake(ic)
    if pid == ALUT_PROGRAM_ID:
        return exec_alut(ic)
    if pid == ED25519_PROGRAM_ID:
        return exec_ed25519_precompile(ic)
    if pid == SECP256K1_PROGRAM_ID:
        return exec_secp256k1_precompile(ic)
    if pid == SECP256R1_PROGRAM_ID:
        return exec_secp256r1_precompile(ic)
    if pid == BPF_UPGRADEABLE_LOADER_ID:
        refuse("the upgradeable BPF loader", "15b")
    if pid == COMPUTE_BUDGET_PROGRAM_ID:
        return OK                    # requests pre-scanned by execute()
    pa = ctx.db.peek(ctx.xid, pid)
    if pa is not None and pa.executable \
            and pa.owner in (BPF_LOADER_ID, BPF_UPGRADEABLE_LOADER_ID):
        refuse("a deployed sBPF program", "15b")
    return ERR_UNKNOWN_PROGRAM


class TxnExecutor:
    """fd_runtime_prepare_and_execute_txn analog for the host path."""

    def __init__(self, db: AccDb, fee_per_signature: int = 5000,
                 enforce_rent: bool = True):
        self.db = db
        self.fee_per_signature = fee_per_signature
        self.enforce_rent = enforce_rent
        self.epoch = 0               # advanced by the bank at boundaries
        self.slot = 0

    def begin_slot(self, xid, slot: int, epoch: int | None = None,
                   slots_per_epoch: int = 432_000,
                   blockhash: bytes | None = None):
        """Slot-boundary duty (ref: fd_runtime block-prepare calling
        the fd_sysvar_*_update family): advance the executor's clock
        view and materialize the sysvar ACCOUNTS in this fork so
        programs reading them as instruction accounts and via syscalls
        see identical bytes."""
        from .sysvars import update_sysvars
        self.slot = slot
        self.epoch = slot // slots_per_epoch if epoch is None else epoch
        update_sysvars(self.db, xid, slot, self.epoch,
                       slots_per_epoch=slots_per_epoch,
                       blockhash=blockhash,
                       lamports_per_sig=self.fee_per_signature)

    def execute(self, xid, payload: bytes) -> TxnResult:
        try:
            txn = parse_txn(payload)
        except Exception:
            return TxnResult(ERR_PARSE, 0, [])
        keys = txn.account_keys(payload)
        fee = self.fee_per_signature * txn.sig_cnt

        # fee payer: signer 0, charged even when execution fails
        # (the reference commits fees before dispatch)
        payer = self.db.open_rw(xid, keys[0], do_create=True)
        if payer.account.lamports < fee:
            self.db.close_rw(payer, discard=True)
            return TxnResult(ERR_FEE, 0, [])
        # rent-state baseline is the PRE-FEE payer; the fee itself may
        # not push an exempt payer into rent-paying (Agave
        # validate_fee_payer rejects at LOAD: no fee charged, no state
        # committed)
        payer_pre = (payer.account.lamports, len(payer.account.data))
        if self.enforce_rent:
            from .sysvars import rent_exempt_minimum
            post = payer_pre[0] - fee
            need = rent_exempt_minimum(payer_pre[1])
            pre_paying = payer_pre[0] < need
            if post != 0 and post < need and not pre_paying:
                self.db.close_rw(payer, discard=True)
                return TxnResult(ERR_RENT, 0, [])
        payer.account.lamports -= fee
        self.db.close_rw(payer)

        loaded_keys, loaded_writable = (), ()
        if txn.version == 0 and txn.aluts:
            from .alut import AlutResolveError, resolve_loaded_keys
            try:
                loaded_keys, loaded_writable = resolve_loaded_keys(
                    self.db, xid, txn, slot=self.slot)
            except AlutResolveError:
                return TxnResult(ERR_ALUT, fee, [])
        ctx = TxnContext(self.db, xid, txn, payload, epoch=self.epoch,
                         slot=self.slot, loaded_keys=loaded_keys,
                         loaded_writable=loaded_writable)
        if self.enforce_rent:
            # force the payer into the working set under its pre-fee
            # baseline so the rent-state check always covers it
            ctx.account(0)
            ctx._pre[keys[0]] = payer_pre
        keys = ctx.keys                # static + table-loaded
        total = len(keys)
        # pre-scan ComputeBudget requests (the reference resolves the
        # whole budget before dispatch, fd_compute_budget_program.h): a
        # malformed one fails the txn. The limits it sets meter sBPF
        # execution only (item 15b), so nothing here reads them.
        from ..pack.cost import ComputeBudgetState, CostError
        cb = ComputeBudgetState()
        for instr in txn.instrs:
            if instr.prog_idx < len(keys) \
                    and keys[instr.prog_idx] == COMPUTE_BUDGET_PROGRAM_ID:
                data = payload[instr.data_off:
                               instr.data_off + instr.data_sz]
                try:
                    cb.parse_instr(data)
                except CostError:
                    return TxnResult(ERR_BAD_IX_DATA, fee, [])
        for instr in txn.instrs:
            # v0 defers the index bound to post-resolution
            if instr.prog_idx >= total or \
                    any(i >= total for i in instr.acct_idxs):
                return TxnResult(ERR_PARSE, fee, ctx.logs)
            data = payload[instr.data_off:instr.data_off + instr.data_sz]
            ic = InstrCtx(ctx, keys[instr.prog_idx],
                          list(instr.acct_idxs), data)
            st = dispatch_instr(ctx, ic)
            if st != OK:
                # atomic rollback: drop the working set (fee stays)
                return TxnResult(st, fee, ctx.logs)
        if self.enforce_rent and ctx.rent_violation() is not None:
            return TxnResult(ERR_RENT, fee, ctx.logs)
        ctx.commit()
        return TxnResult(OK, fee, ctx.logs)
