"""Transaction cost model + compute-budget instruction parsing (copy of
the JAX package's pack/cost.py).

The consensus cost model the leader schedules against
(ref: src/disco/pack/fd_pack_cost.h:10-28): total cost =

    per-signature cost  (720/txn sig; precompile instrs add 2400 per
                         ed25519 sig, 6690 per secp256k1, 4800 per
                         secp256r1 — counted from the instr's first
                         data byte)
  + per-write-lock cost (300 per writable account)
  + instr data cost     (total instruction data bytes / 4)
  + execution cost      (compute-budget requested CU limit, else
                         200k per non-builtin + 3k per builtin instr,
                         clamped to 1.4M)
  + loaded-accounts-data cost (8 CU per 32 KiB page of the requested
                         — default 64 MiB — loaded data size)

Simple votes short-circuit to a fixed 3428 CU
(FD_PACK_SIMPLE_VOTE_COST) regardless of contents.

The compute-budget program parser is the reference's state machine
(src/disco/pack/fd_compute_budget_program.h:91-146): four instruction
kinds keyed by the first data byte, each settable at most once, any
malformed/duplicate instruction fails the whole transaction. The
priority fee is ceil(cu_limit * micro_lamports_per_cu / 1e6) lamports
(python ints: no saturation ladder needed — the reference's careful
split arithmetic exists only to dodge u64 overflow).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..protocol.txn import ParsedTxn
from ..utils.base58 import b58_decode_32

# consensus-critical constants (fd_pack_cost.h:92-99)
COST_PER_SIGNATURE = 720
COST_PER_ED25519_SIGNATURE = 2400
COST_PER_SECP256K1_SIGNATURE = 6690
COST_PER_SECP256R1_SIGNATURE = 4800
COST_PER_WRITABLE_ACCT = 300
INV_COST_PER_INSTR_DATA_BYTE = 4
MAX_TXN_COST = 1_573_166                     # fd_pack_cost.h:148
MIN_TXN_COST = COST_PER_SIGNATURE + COST_PER_WRITABLE_ACCT

# compute budget program (fd_compute_budget_program.h:40-52)
MAX_BUILTIN_CU_LIMIT = 3_000
DEFAULT_INSTR_CU_LIMIT = 200_000
MAX_CU_LIMIT = 1_400_000
HEAP_FRAME_GRANULARITY = 1024
MICRO_LAMPORTS_PER_LAMPORT = 1_000_000
HEAP_COST = 8
ACCOUNT_DATA_COST_PAGE_SIZE = 32 * 1024
MAX_LOADED_DATA_SZ = 64 * 1024 * 1024

# vote (fd_pack_cost.h:196-207)
VOTE_DEFAULT_COMPUTE_UNITS = 2_100
SIMPLE_VOTE_COST = (COST_PER_SIGNATURE + 2 * COST_PER_WRITABLE_ACCT
                    + VOTE_DEFAULT_COMPUTE_UNITS + 8)

# well-known program ids (public Solana constants; the reference keys a
# perfect hash table on the same set, fd_pack_cost.h:68-79)
VOTE_PROGRAM_ID = b58_decode_32(
    "Vote111111111111111111111111111111111111111")
SYSTEM_PROGRAM_ID = b58_decode_32("11111111111111111111111111111111")
COMPUTE_BUDGET_PROGRAM_ID = b58_decode_32(
    "ComputeBudget111111111111111111111111111111")
BPF_UPGRADEABLE_LOADER_ID = b58_decode_32(
    "BPFLoaderUpgradeab1e11111111111111111111111")
BPF_LOADER_1_ID = b58_decode_32(
    "BPFLoader1111111111111111111111111111111111")
BPF_LOADER_2_ID = b58_decode_32(
    "BPFLoader2111111111111111111111111111111111")
LOADER_V4_ID = b58_decode_32(
    "LoaderV411111111111111111111111111111111111")
KECCAK_SECP_PROGRAM_ID = b58_decode_32(
    "KeccakSecp256k11111111111111111111111111111")
ED25519_SV_PROGRAM_ID = b58_decode_32(
    "Ed25519SigVerify111111111111111111111111111")
SECP256R1_PROGRAM_ID = b58_decode_32(
    "Secp256r1SigVerify1111111111111111111111111")

BUILTIN_PROGRAMS = frozenset({
    VOTE_PROGRAM_ID, SYSTEM_PROGRAM_ID, COMPUTE_BUDGET_PROGRAM_ID,
    BPF_UPGRADEABLE_LOADER_ID, BPF_LOADER_1_ID, BPF_LOADER_2_ID,
    LOADER_V4_ID, KECCAK_SECP_PROGRAM_ID, ED25519_SV_PROGRAM_ID,
    SECP256R1_PROGRAM_ID})

_PRECOMPILE_SIG_COST = {
    ED25519_SV_PROGRAM_ID: COST_PER_ED25519_SIGNATURE,
    KECCAK_SECP_PROGRAM_ID: COST_PER_SECP256K1_SIGNATURE,
    SECP256R1_PROGRAM_ID: COST_PER_SECP256R1_SIGNATURE,
}


class CostError(ValueError):
    """Transaction fails the cost model (malformed compute budget)."""


@dataclass
class ComputeBudgetState:
    """Accumulated compute-budget requests
    (fd_compute_budget_program.h:57-80)."""
    set_cu: bool = False
    set_fee: bool = False
    set_heap: bool = False
    set_loaded: bool = False
    compute_units: int = 0
    micro_lamports_per_cu: int = 0
    heap_size: int = 0
    loaded_acct_data_sz: int = 0

    def parse_instr(self, data: bytes):
        """One ComputeBudgetProgram instruction; raises CostError on any
        malformed or duplicate request (the whole txn then fails)."""
        if len(data) < 5:
            raise CostError("compute budget instr too short")
        kind = data[0]
        if kind == 1:                                # RequestHeapFrame
            if self.set_heap:
                raise CostError("duplicate RequestHeapFrame")
            self.heap_size = int.from_bytes(data[1:5], "little")
            if self.heap_size % HEAP_FRAME_GRANULARITY:
                raise CostError("heap size granularity")
            self.set_heap = True
        elif kind == 2:                              # SetComputeUnitLimit
            if self.set_cu:
                raise CostError("duplicate SetComputeUnitLimit")
            self.compute_units = min(int.from_bytes(data[1:5], "little"),
                                     MAX_CU_LIMIT)
            self.set_cu = True
        elif kind == 3:                              # SetComputeUnitPrice
            if len(data) < 9:
                raise CostError("SetComputeUnitPrice too short")
            if self.set_fee:
                raise CostError("duplicate SetComputeUnitPrice")
            self.micro_lamports_per_cu = int.from_bytes(data[1:9], "little")
            self.set_fee = True
        elif kind == 4:                              # SetLoadedAcctDataSz
            if self.set_loaded:
                raise CostError("duplicate SetLoadedAccountsDataSize")
            sz = int.from_bytes(data[1:5], "little")
            if sz == 0:
                raise CostError("zero loaded data size")
            self.loaded_acct_data_sz = min(sz, MAX_LOADED_DATA_SZ)
            self.set_loaded = True
        else:                                        # 0 deprecated, 5+ bad
            raise CostError(f"bad compute budget discriminant {kind}")

    def finalize(self, instr_cnt: int, builtin_instr_cnt: int):
        """-> (cu_limit, priority_fee_lamports, loaded_data_cost)
        (fd_compute_budget_program.h finalize)."""
        if self.set_cu:
            cu_limit = self.compute_units
        else:
            cu_limit = ((instr_cnt - builtin_instr_cnt)
                        * DEFAULT_INSTR_CU_LIMIT
                        + builtin_instr_cnt * MAX_BUILTIN_CU_LIMIT)
        cu_limit = min(cu_limit, MAX_CU_LIMIT)
        loaded_sz = (self.loaded_acct_data_sz if self.set_loaded
                     else MAX_LOADED_DATA_SZ)
        loaded_cost = HEAP_COST * (
            (loaded_sz + ACCOUNT_DATA_COST_PAGE_SIZE - 1)
            // ACCOUNT_DATA_COST_PAGE_SIZE)
        fee = -(-(cu_limit * self.micro_lamports_per_cu)
                // MICRO_LAMPORTS_PER_LAMPORT)
        return cu_limit, fee, loaded_cost


def is_simple_vote(t: ParsedTxn, payload: bytes) -> bool:
    """fd_txn_is_simple_vote_transaction (fd_txn.h:457-471): legacy,
    one instruction, <= 2 signatures, vote program."""
    if len(t.instrs) != 1 or t.version != -1 or t.sig_cnt > 2:
        return False
    keys = t.account_keys(payload)
    return keys[t.instrs[0].prog_idx] == VOTE_PROGRAM_ID


@dataclass(frozen=True)
class TxnCost:
    total: int                 # cost units charged against block limits
    execution: int             # CU limit handed to the VM
    priority_fee: int          # lamports beyond the per-signature fee
    precompile_sig_cnt: int
    loaded_data_cost: int
    is_simple_vote: bool


def compute_cost(t: ParsedTxn, payload: bytes) -> TxnCost:
    """fd_pack_compute_cost (fd_pack_cost.h:230-320). Raises CostError
    where the reference returns 0 (txn must be dropped)."""
    if is_simple_vote(t, payload):
        return TxnCost(SIMPLE_VOTE_COST, VOTE_DEFAULT_COMPUTE_UNITS, 0,
                       0, 0, True)

    keys = t.account_keys(payload)
    sig_cost = COST_PER_SIGNATURE * t.sig_cnt
    writable_cnt = sum(t.is_writable(i) for i in range(t.acct_cnt))
    writable_cost = COST_PER_WRITABLE_ACCT * writable_cnt

    cbp = ComputeBudgetState()
    instr_data_sz = 0
    non_builtin_cnt = 0
    precompile_sig_cnt = 0
    for ins in t.instrs:
        instr_data_sz += ins.data_sz
        prog = keys[ins.prog_idx]
        data = payload[ins.data_off:ins.data_off + ins.data_sz]
        if prog not in BUILTIN_PROGRAMS:
            non_builtin_cnt += 1
        elif prog == COMPUTE_BUDGET_PROGRAM_ID:
            cbp.parse_instr(data)
        elif prog in _PRECOMPILE_SIG_COST:
            n = data[0] if ins.data_sz > 0 else 0
            precompile_sig_cnt += n
            sig_cost += n * _PRECOMPILE_SIG_COST[prog]

    instr_data_cost = instr_data_sz // INV_COST_PER_INSTR_DATA_BYTE
    cu_limit, fee, loaded_cost = cbp.finalize(
        len(t.instrs), len(t.instrs) - non_builtin_cnt)
    total = (sig_cost + writable_cost + cu_limit + instr_data_cost
             + loaded_cost)
    return TxnCost(total, cu_limit, fee, precompile_sig_cnt, loaded_cost,
                   False)
