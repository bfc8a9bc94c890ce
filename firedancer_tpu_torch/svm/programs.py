"""Host-side transaction executor + native system program + CPI (copy of
the JAX package's svm/programs.py).

The reference's per-txn execution (load accounts, charge fees, dispatch
instructions sequentially through native program handlers, commit or
roll back atomically) lives in fd_executor/fd_system_program
(ref: src/flamenco/runtime/fd_executor.c, fd_runtime.h:254-266,
program/fd_system_program.c:59-330). The wave executor (executor.py)
covers the batched pure-transfer fast path on device; THIS module is
the general host path the exec tiles run for everything else — the
split SURVEY §7 hard-part 6 prescribes (sBPF and general dispatch stay
on host cores).

Instructions execute through an InstrCtx: a local-index account view
carrying THIS invocation's privileges. The top-level view derives
signer/writable from the transaction message; a CPI view derives them
from the caller-validated account metas (ref: the instruction context
stack of fd_executor.c / fd_exec_instr_ctx.h — privileges never
escalate down the stack except through verified PDA seed signing,
fd_vm_syscall_cpi.c).

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

from ..funk.funk import key32
from ..protocol.txn import ParsedTxn, parse_txn
from .accdb import AccDb, Account, SYSTEM_PROGRAM_ID

# the REAL base58 program id (shared with the pack cost model)
from ..pack.cost import COMPUTE_BUDGET_PROGRAM_ID  # noqa: E402
BPF_LOADER_ID = b"BPFLoader" + bytes(23)
MAX_PERMITTED_DATA_LENGTH = 10 * 1024 * 1024
MAX_CPI_DEPTH = 4                  # instruction stack height limit
MAX_SEEDS = 16                     # PDA seed count limit (Solana)
MAX_SEED_LEN = 32

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
ERR_BALANCE_VIOLATION = "sum_of_lamports_changed"
ERR_RENT = "insufficient_funds_for_rent"
ERR_CPI = "cpi_violation"
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
    return_data: bytes = b""


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
        self.last_exec_cu = 0        # CU used by the last BPF frame
        self.cu_limit = 200_000      # SetComputeUnitLimit applies here
        self.cu_used = 0             # shared meter across instructions
        self.heap_sz = 32 * 1024     # RequestHeapFrame applies here
        self.return_data = b""       # sol_set_return_data (txn-wide)
        self.return_data_program = bytes(32)

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
    """One instruction invocation: local account indices + privileges.

    privileges=None -> top-level (txn-message signer/writable bits);
    privileges=[(signer, writable)] -> a CPI frame with the flags the
    caller requested AND the runtime validated."""

    def __init__(self, ctx: TxnContext, program_id: bytes,
                 acct_idxs, data: bytes, privileges=None):
        self.ctx = ctx
        self.program_id = program_id
        self.acct_idxs = list(acct_idxs)
        self.data = data
        self.priv = privileges

    @property
    def n(self) -> int:
        return len(self.acct_idxs)

    def key(self, i: int) -> bytes:
        return self.ctx.keys[self.acct_idxs[i]]

    def account(self, i: int) -> Account:
        return self.ctx.account(self.acct_idxs[i])

    def is_signer(self, i: int) -> bool:
        if self.priv is not None:
            return self.priv[i][0]
        return self.ctx.is_signer(self.acct_idxs[i])

    def is_writable(self, i: int) -> bool:
        if self.priv is not None:
            return self.priv[i][1]
        return self.ctx.is_writable(self.acct_idxs[i])

    def signer_keys(self) -> set:
        if self.priv is not None:
            return {self.key(i) for i in range(self.n)
                    if self.priv[i][0]}
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


# ---------------------------------------------------------------------------
# program-derived addresses (ref: fd_vm_syscall_pda.c / Agave
# Pubkey::create_program_address)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# sBPF execution + CPI
# ---------------------------------------------------------------------------

def _build_input(ic: InstrCtx) -> tuple[bytes, list[int]]:
    """Compact input layout (raw-text fixture programs): u16 n_accounts
    | n x (pubkey 32 | lamports u64 | is_signer u8 | is_writable u8) |
    u16 data_len | instruction data (the input-region discipline of
    src/flamenco/vm/fd_vm.h, compact layout documented in
    vm/interp.py). Returns (blob, per-account lamports offsets)."""
    blob = struct.pack("<H", ic.n)
    offs = []
    for i in range(ic.n):
        offs.append(len(blob) + 32)
        blob += (ic.key(i)
                 + struct.pack("<Q", ic.account(i).lamports)
                 + bytes([1 if ic.is_signer(i) else 0,
                          1 if ic.is_writable(i) else 0]))
    blob += struct.pack("<H", len(ic.data)) + ic.data
    return blob, offs


MAX_PERMITTED_DATA_INCREASE = 10 * 1024


def _build_input_solana(ic: InstrCtx) -> tuple[bytes, list[int]]:
    """The real Solana aligned input serialization, for ELF programs
    built with the SDK entrypoint (ref: the reference's account
    serialization into the VM input region, src/flamenco/runtime/
    fd_runtime serialize + Agave serialize_parameters_aligned):

      u64 n | per account: u8 dup(0xff) | u8 signer | u8 writable |
      u8 executable | 4B pad | pubkey 32 | owner 32 | u64 lamports |
      u64 data_len | data | 10KiB spare | pad to 8 | u64 rent_epoch
      | u64 instr data len | instr data | program_id 32

    Duplicate account entries serialize as u8 index + 7B pad."""
    blob = bytearray(struct.pack("<Q", ic.n))
    offs: list[int] = []
    seen: dict[bytes, int] = {}
    for i in range(ic.n):
        key = ic.key(i)
        if key in seen:
            offs.append(offs[seen[key]])
            blob += bytes([seen[key]]) + bytes(7)
            continue
        seen[key] = i
        a = ic.account(i)
        blob += bytes([0xFF, 1 if ic.is_signer(i) else 0,
                       1 if ic.is_writable(i) else 0,
                       1 if a.executable else 0]) + bytes(4)
        blob += key + a.owner
        offs.append(len(blob))
        blob += struct.pack("<QQ", a.lamports, len(a.data))
        blob += a.data
        blob += bytes(MAX_PERMITTED_DATA_INCREASE)
        pad = (-len(blob)) % 8
        blob += bytes(pad)
        blob += struct.pack("<Q", a.rent_epoch)
    blob += struct.pack("<Q", len(ic.data)) + ic.data
    blob += ic.program_id
    return bytes(blob), offs


def _refresh_input_lamports(vm, ic: InstrCtx):
    """Rewrite the VM input region's lamport slots from the current
    account state (after a CPI mutated them). NOTE a documented
    divergence from the reference: direct lamport stores made by the
    caller BEFORE a CPI are overwritten by this refresh — combine
    direct writes with CPI by re-applying them after the call."""
    for i, off in enumerate(vm._lam_offsets):
        vm.mem_write(0x4_0000_0000 + off,
                     struct.pack("<Q", ic.account(i).lamports))


def _parse_cpi_instruction(vm, vaddr):
    """Our compact CPI ABI (documented; the reference marshals the
    Rust/C AccountInfo layouts, fd_vm_syscall_cpi.c — same contract,
    different wire): program_id 32 | u16 n | n x (pubkey 32 |
    u8 signer | u8 writable) | u16 dlen | data."""
    program_id = vm.mem_read(vaddr, 32)
    n, = struct.unpack("<H", vm.mem_read(vaddr + 32, 2))
    if n > 64:
        raise ValueError("too many CPI accounts")
    metas = []
    off = vaddr + 34
    for _ in range(n):
        pk = vm.mem_read(off, 32)
        flags = vm.mem_read(off + 32, 2)
        metas.append((pk, bool(flags[0]), bool(flags[1])))
        off += 34
    dlen, = struct.unpack("<H", vm.mem_read(off, 2))
    data = vm.mem_read(off + 2, dlen)
    return program_id, metas, data


def _parse_signer_seeds(vm, vaddr):
    """u8 n_signers | per signer: u8 n_seeds | n x (u8 len | bytes)."""
    if not vaddr:
        return []
    n_signers = vm.mem_read(vaddr, 1)[0]
    if n_signers > MAX_SEEDS:
        raise ValueError("too many CPI signers")
    out = []
    off = vaddr + 1
    for _ in range(n_signers):
        n_seeds = vm.mem_read(off, 1)[0]
        off += 1
        if n_seeds > MAX_SEEDS:
            raise ValueError("too many seeds")
        seeds = []
        for _ in range(n_seeds):
            ln = vm.mem_read(off, 1)[0]
            seeds.append(vm.mem_read(off + 1, ln))
            off += 1 + ln
        out.append(seeds)
    return out


def _make_cpi_syscalls(ctx: TxnContext, ic: InstrCtx, depth: int):
    """Bind invoke_signed + PDA syscalls to this instruction frame
    (ref: src/flamenco/vm/syscall/fd_vm_syscall_cpi.c:1-40,
    fd_vm_syscall_pda.c)."""
    from ..vm.interp import ERR_ABORT, VmFault
    from ..vm.syscalls import CU_SYSCALL_BASE

    def sys_invoke_signed(vm, r1, r2, r3, r4, r5):
        vm.charge(CU_SYSCALL_BASE * 10)
        if depth + 1 >= MAX_CPI_DEPTH:
            raise VmFault(ERR_ABORT, "max CPI depth")
        # the invocation stack shares ONE budget: the child runs on the
        # caller's remaining CU and its usage is charged back (the
        # reference's shared compute meter)
        remaining = vm.compute_budget - vm._cu
        try:
            program_id, metas, data = _parse_cpi_instruction(vm, r1)
            signer_seeds = _parse_signer_seeds(vm, r2)
        except Exception as e:
            raise VmFault(ERR_ABORT, f"bad CPI instruction: {e}")
        pda_signers = set()
        for seeds in signer_seeds:
            addr = create_program_address(list(seeds), ic.program_id)
            if addr is None:
                raise VmFault(ERR_ABORT, "invalid PDA seeds")
            pda_signers.add(addr)
        # accounts must already be in the txn, and privileges must not
        # escalate beyond the caller's view (PDA seeds excepted)
        outer = {ic.key(i): i for i in range(ic.n)}
        idxs, privs = [], []
        for pk, want_sign, want_write in metas:
            oi = outer.get(pk)
            if oi is None:
                raise VmFault(ERR_ABORT,
                              "CPI account not in caller accounts")
            if want_sign and not ic.is_signer(oi) \
                    and pk not in pda_signers:
                raise VmFault(ERR_ABORT, "CPI signer escalation")
            if want_write and not ic.is_writable(oi):
                raise VmFault(ERR_ABORT, "CPI writable escalation")
            idxs.append(ic.acct_idxs[oi])
            privs.append((want_sign, want_write))
        child = InstrCtx(ctx, bytes(program_id), idxs, bytes(data),
                         privileges=privs)
        ctx.last_exec_cu = 0
        st = dispatch_instr(ctx, child, depth + 1, budget=remaining)
        if st != OK:
            raise VmFault(ERR_ABORT, f"CPI failed: {st}")
        vm.charge(ctx.last_exec_cu)
        # the callee's return data becomes visible to the caller's
        # sol_get_return_data (the CPI-result ABI)
        vm.return_data = ctx.return_data
        vm.return_data_program = ctx.return_data_program
        _refresh_input_lamports(vm, ic)
        return 0

    def sys_create_pda(vm, r1, r2, r3, r4, r5):
        vm.charge(CU_SYSCALL_BASE * 15)
        if r2 > MAX_SEEDS:
            return 1                  # MaxSeedLengthExceeded, not trunc
        seeds = [vm.mem_read(vm.read_u(r1 + 16 * i, 8),
                             vm.read_u(r1 + 16 * i + 8, 8))
                 for i in range(r2)]
        program_id = vm.mem_read(r3, 32)
        addr = create_program_address(seeds, program_id)
        if addr is None:
            return 1
        vm.mem_write(r4, addr)
        return 0

    def sys_find_pda(vm, r1, r2, r3, r4, r5):
        vm.charge(CU_SYSCALL_BASE * 15)
        if r2 > MAX_SEEDS:
            return 1
        seeds = [vm.mem_read(vm.read_u(r1 + 16 * i, 8),
                             vm.read_u(r1 + 16 * i + 8, 8))
                 for i in range(r2)]
        program_id = vm.mem_read(r3, 32)
        try:
            addr, bump = find_program_address(seeds, program_id)
        except ValueError:
            return 1
        vm.mem_write(r4, addr)
        vm.mem_write(r5, bytes([bump]))
        return 0

    from ..vm.syscalls import syscall_id
    return {
        syscall_id(b"sol_invoke_signed_c"): sys_invoke_signed,
        syscall_id(b"sol_invoke_signed_rust"): sys_invoke_signed,
        syscall_id(b"sol_create_program_address"): sys_create_pda,
        syscall_id(b"sol_try_find_program_address"): sys_find_pda,
    }


_PROG_CACHE: dict[bytes, "object"] = {}     # sha256(elf) -> SbpfProgram
_PROG_CACHE_MAX = 64


def _load_elf_cached(data: bytes):
    """Loaded-program cache (the reference's progcache role): keyed by
    content hash so redeployments miss cleanly; bounded FIFO."""
    from ..vm import elf
    key = hashlib.sha256(data).digest()
    prog = _PROG_CACHE.get(key)
    if prog is None:
        prog = elf.load(data)
        while len(_PROG_CACHE) >= _PROG_CACHE_MAX:
            _PROG_CACHE.pop(next(iter(_PROG_CACHE)))
        _PROG_CACHE[key] = prog
    return prog


def _exec_bpf(ctx: TxnContext, ic: InstrCtx, program: Account,
              depth: int = 0, budget: int | None = None) -> str:
    """Run a deployed sBPF program (executable account owned by the
    loader) in the VM. ELF-packaged programs (magic 0x7f 'ELF') go
    through the loader (vm/elf.py — parse, relocate, call registry,
    ref src/ballet/sbpf/fd_sbpf_loader.h:1-12); raw text sections
    execute directly (the pre-ELF deployment path, kept for fixtures).

    After a successful run, lamports of WRITABLE accounts are read back
    under two runtime rules: sum-of-lamports conservation (never mint
    or burn), and the OWNERSHIP rule — only the executing program may
    DEBIT an account, and only if that account is owned by it
    (credits are unrestricted), mirroring the reference runtime's
    account-modification checks."""
    from ..vm import DEFAULT_SYSCALLS, ERR_NONE as VM_OK, Vm
    syscalls = dict(DEFAULT_SYSCALLS)
    syscalls.update(_make_cpi_syscalls(ctx, ic, depth))
    if budget is None:
        # top-level frame: the txn's shared meter (requested limit
        # minus CU already burned by earlier instructions)
        budget = max(0, ctx.cu_limit - ctx.cu_used)
    kw = {"compute_budget": budget, "heap_sz": ctx.heap_sz}
    # sysvars the VM exposes via get_*_sysvar syscalls (the reference's
    # fd_sysvar_cache): account bytes when the bank materialized them
    # (svm/sysvars.py), synthesized from slot/epoch otherwise — the
    # account view and the syscall view must agree byte-for-byte
    from .sysvars import read_sysvar_cache
    sysvars = read_sysvar_cache(ctx.db, ctx.xid, ctx.slot, ctx.epoch)
    if program.data[:4] == b"\x7fELF":
        from ..vm import elf
        try:
            prog = _load_elf_cached(program.data)
        except elf.ElfError as e:
            ctx.logs.append(f"ELF load failed: {e}")
            return ERR_VM
        # SDK-built programs deserialize the REAL Solana input ABI
        blob, lam_offs = _build_input_solana(ic)
        vm = Vm(prog.text, input_data=blob, syscalls=syscalls,
                image=prog.image, text_off=prog.text_off,
                calls=prog.calls, **kw)
        vm._lam_offsets = lam_offs
        vm.sysvars = sysvars
        vm.program_id = ic.program_id
        vm.return_data = ctx.return_data
        vm.return_data_program = ctx.return_data_program
        res = vm.run(entry_pc=prog.entry_pc)
    else:
        blob, lam_offs = _build_input(ic)
        vm = Vm(program.data, input_data=blob, syscalls=syscalls, **kw)
        vm._lam_offsets = lam_offs
        vm.sysvars = sysvars
        vm.program_id = ic.program_id
        vm.return_data = ctx.return_data
        vm.return_data_program = ctx.return_data_program
        res = vm.run()
    ctx.logs.extend(res.log)
    ctx.last_exec_cu = res.compute_used
    if depth == 0:
        ctx.cu_used += res.compute_used
    ctx.return_data = getattr(vm, "return_data", b"")
    ctx.return_data_program = getattr(vm, "return_data_program",
                                      bytes(32))
    if res.error != VM_OK or res.r0 != 0:
        return ERR_VM
    # lamports write-back with conservation over UNIQUE accounts: an
    # instruction may list the same account at several indices (the
    # runtime maps them to ONE account), so both the before-sum and the
    # applied value dedup by key with last-slot-wins — otherwise a
    # duplicated index could double-count `before` and mint the
    # difference
    final: dict[bytes, tuple[int, int]] = {}     # key -> (local_i, lam)
    for i, off in enumerate(vm._lam_offsets):
        lam = int.from_bytes(vm.mem_read(
            0x4_0000_0000 + off, 8), "little")
        final[ic.key(i)] = (i, lam)
    uniq = {ic.key(i): ic.account(i) for i in range(ic.n)}
    before = sum(a.lamports for a in uniq.values())
    if sum(lam for _, lam in final.values()) != before:
        return ERR_BALANCE_VIOLATION
    for key, (i, lam) in final.items():
        a = uniq[key]
        if lam != a.lamports:
            if not ic.is_writable(i):
                return ERR_NOT_WRITABLE
            if lam < a.lamports and a.owner != ic.program_id:
                # a program may only DEBIT accounts it owns — txn-level
                # writability alone must not let an arbitrary deployed
                # program drain a victim's account
                return ERR_INVALID_OWNER
            a.lamports = lam
    return OK


def dispatch_instr(ctx: TxnContext, ic: InstrCtx, depth: int = 0,
                   budget: int | None = None) -> str:
    """Route one instruction frame to its program (the fd_executor
    native-program dispatch switch + BPF fallback)."""
    from ..pack.cost import BPF_UPGRADEABLE_LOADER_ID
    from .alut import ALUT_PROGRAM_ID, exec_alut
    from .loader import exec_upgradeable_loader, resolve_program_elf
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
        return exec_upgradeable_loader(ic)
    if pid == COMPUTE_BUDGET_PROGRAM_ID:
        return OK                    # requests pre-scanned by execute()
    pa = ctx.db.peek(ctx.xid, pid)
    if pa is not None and pa.executable:
        if pa.owner == BPF_LOADER_ID:
            return _exec_bpf(ctx, ic, pa, depth, budget=budget)
        if pa.owner == BPF_UPGRADEABLE_LOADER_ID:
            # loader-v3 indirection: program -> programdata -> ELF
            elf_bytes = resolve_program_elf(ctx.db, ctx.xid, pa)
            if elf_bytes is None:
                return ERR_UNKNOWN_PROGRAM
            shim = Account(pa.lamports, bytes(elf_bytes), pa.owner,
                           True, pa.rent_epoch)
            return _exec_bpf(ctx, ic, shim, depth, budget=budget)
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
        # whole budget before dispatch, fd_compute_budget_program.h)
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
        if cb.set_cu:
            ctx.cu_limit = cb.compute_units
        if cb.set_heap:
            ctx.heap_sz = cb.heap_size
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
        return TxnResult(OK, fee, ctx.logs, ctx.return_data)
