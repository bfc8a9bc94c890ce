"""The sBPF family of tools/general_exec.py's workload: deployed programs
through the door, the bank and the follower, with an oracle of its own
arithmetic. Its counts are chosen for coverage, as the rest of the mix's
are: no rate is read from them.

Programs (ELF images written by tools/sbpf_elf.py, each walking the
aligned Solana input ABI to its accounts and instruction data):

  vault   loader v3. Mode 0 moves lamports out of a PDA it signs for
          (seeds "vault", index, bump) by CPI into the system program
          and logs both balances as the input region shows them after
          the call; mode 1 moves lamports directly between two accounts
          (legal from an escrow the program owns); mode 2 only credits
  hash    loader v3. sol_sha256 of its instruction data, set as the
          return data; reads the Clock sysvar; logs a .rodata line and
          sol_log_64 (slot, digest's first word, length, version)
  spin    loader v3. A loop of a count from its data (the compute meter)
  curve   BPF_LOADER_ID (the ELF in the program account). Validates an
          edwards point and adds two (sol_curve_validate_point,
          sol_curve_group_op), the sum as the return data

Genesis holds those four, with their programdata padded to PD_LEN, and
the upgrade's source buffer (hash v2). Traffic, each txn signed by a
user (or the deployer) and asking pack for a compute-unit limit:

  slot 0    InitializeBuffer of the deploy buffer and of a second one
  slot 1    the Writes: the hash program v1 in chunks that keep each
            signed txn within 1,232 bytes, and to the second buffer the
            same ELF with a bad e_machine
  slot 2    Deploy of "hash2" from the first buffer (a later slot than
            its Writes, so pack's order of them cannot matter), Deploy of
            the second: bad_instruction_data
  slot 3    Upgrade of hash2 to v2 from the genesis buffer; SetAuthority
            and Close, which the JAX package's loader v3 does not
            implement: unknown_instruction in both packages
  slots 4-7 hash2's invocations (v2)
  any slot  384 invocations of vault, hash, spin and
            curve, and the designed failures: a CU limit below the
            spin's need (program_failed), a direct debit of an account
            the program does not own (invalid_account_owner), a lamport
            mint (sum_of_lamports_changed)

A door run drains after slots 0-3 (`BARRIERS`), so the sequence's order
holds there as in the follower's slots.
"""
from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

from ..pack.cost import BPF_UPGRADEABLE_LOADER_ID, COMPUTE_BUDGET_PROGRAM_ID
from ..protocol.txn import MTU
from ..svm import loader
from ..svm.accdb import Account
from ..svm.programs import (BPF_LOADER_ID, ERR_BAD_IX_DATA,
                            ERR_BALANCE_VIOLATION, ERR_INVALID_OWNER,
                            ERR_UNKNOWN_IX, ERR_VM, OK,
                            find_program_address)
from ..utils.ed25519_ref import BASEPOINT, pt_compress, pt_mul
from . import sbpf_elf

LOADER = BPF_UPGRADEABLE_LOADER_ID
PD_LEN = 8192                 # programdata's ELF room (Deploy's max)
VAULTS, ESCROWS, RECIPIENTS = 8, 4, 16
N_VAULT_CPI, N_VAULT_MOVE, N_HASH, N_HASH2, N_SPIN, N_CURVE = \
    128, 32, 96, 32, 64, 32
BARRIERS = (0, 1, 2, 3)
SLOTS = 8
PDA_LAMPORTS, ESCROW_LAMPORTS, RECIPIENT_LAMPORTS = 10**12, 10**11, 10**9
HEAP = 0x3_0000_0000

# the input walk every program calls first: r1 = the input region ->
# r0 = the instruction data's length field; heap[8 i] = account i's
# record (a duplicate's: its original's). Record: +8 key, +40 owner,
# +72 lamports, +80 data length, +88 data, 10 KiB of room, pad to 8,
# rent epoch (svm/programs.py `_build_input_solana`)
WALK = f"""
walk:
    ldxdw r2, [r1+0]
    mov64 r3, r1
    add64 r3, 8
    mov64 r4, 0
    lddw r5, {HEAP}
walk_loop:
    jge r4, r2, walk_done
    ldxb r6, [r3+0]
    jne r6, 0xff, walk_dup
    stxdw [r5+0], r3
    ldxdw r6, [r3+80]
    add64 r3, r6
    add64 r3, 10335
    and64 r3, -8
    add64 r3, 8
    ja walk_next
walk_dup:
    lsh64 r6, 3
    lddw r7, {HEAP}
    add64 r7, r6
    ldxdw r7, [r7+0]
    stxdw [r5+0], r7
    add64 r3, 8
walk_next:
    add64 r5, 8
    add64 r4, 1
    ja walk_loop
walk_done:
    mov64 r0, r3
    exit
"""

VAULT = f"""
entrypoint:
    call walk
    mov64 r9, r0
    lddw r6, {HEAP}
    ldxdw r7, [r6+0]
    ldxdw r8, [r6+8]
    ldxb r2, [r9+8]
    ldxdw r3, [r9+16]
    jeq r2, 0, cpi
    jeq r2, 1, move
    jeq r2, 2, credit
    mov64 r0, 1
    exit
move:
    ldxdw r4, [r7+72]
    sub64 r4, r3
    stxdw [r7+72], r4
credit:
    ldxdw r4, [r8+72]
    add64 r4, r3
    stxdw [r8+72], r4
    mov64 r0, 0
    exit
cpi:
    lddw r6, {HEAP + 0x100}
    stb [r6+32], 2
    mov64 r1, r6
    add64 r1, 34
    mov64 r2, r7
    add64 r2, 8
    mov64 r3, 32
    call sol_memcpy_
    stb [r6+66], 1
    stb [r6+67], 1
    mov64 r1, r6
    add64 r1, 68
    mov64 r2, r8
    add64 r2, 8
    mov64 r3, 32
    call sol_memcpy_
    stb [r6+101], 1
    stb [r6+102], 12
    stb [r6+104], 2
    ldxdw r3, [r9+16]
    stxdw [r6+108], r3
    lddw r6, {HEAP + 0x200}
    stb [r6+0], 1
    stb [r6+1], 3
    stb [r6+2], 5
    mov64 r1, r6
    add64 r1, 3
    lddw r2, @0
    mov64 r3, 5
    call sol_memcpy_
    stb [r6+8], 1
    ldxb r2, [r9+9]
    stxb [r6+9], r2
    stb [r6+10], 1
    ldxb r2, [r9+10]
    stxb [r6+11], r2
    lddw r1, {HEAP + 0x100}
    lddw r2, {HEAP + 0x200}
    call sol_invoke_signed_c
    ldxdw r1, [r9+16]
    ldxdw r2, [r7+72]
    ldxdw r3, [r8+72]
    mov64 r4, 0
    mov64 r5, 0
    call sol_log_64_
    mov64 r0, 0
    exit
""" + WALK


def _hash_src(version: int, line: bytes) -> str:
    return f"""
entrypoint:
    call walk
    mov64 r9, r0
    lddw r6, {HEAP + 0x100}
    mov64 r2, r9
    add64 r2, 8
    stxdw [r6+0], r2
    ldxdw r2, [r9+0]
    stxdw [r6+8], r2
    mov64 r1, r6
    mov64 r2, 1
    lddw r3, {HEAP + 0x200}
    call sol_sha256
    lddw r1, {HEAP + 0x200}
    mov64 r2, 32
    call sol_set_return_data
    lddw r1, {HEAP + 0x300}
    call sol_get_clock_sysvar
    lddw r1, @0
    mov64 r2, {len(line)}
    call sol_log_
    lddw r6, {HEAP + 0x300}
    ldxdw r1, [r6+0]
    lddw r6, {HEAP + 0x200}
    ldxdw r2, [r6+0]
    ldxdw r3, [r9+0]
    mov64 r4, {version}
    mov64 r5, 0
    call sol_log_64_
    mov64 r0, 0
    exit
""" + WALK


SPIN = """
entrypoint:
    call walk
    ldxdw r2, [r0+8]
    mov64 r6, r2
    mov64 r3, 0
spin:
    jeq r2, 0, spun
    add64 r3, r2
    xor64 r3, 0x5a
    sub64 r2, 1
    ja spin
spun:
    mov64 r1, r6
    mov64 r2, r3
    mov64 r3, 0
    mov64 r4, 0
    mov64 r5, 0
    call sol_log_64_
    mov64 r0, 0
    exit
""" + WALK

CURVE = f"""
entrypoint:
    call walk
    mov64 r9, r0
    add64 r9, 8
    mov64 r1, 0
    mov64 r2, r9
    call sol_curve_validate_point
    mov64 r6, r0
    mov64 r1, 0
    mov64 r2, 0
    mov64 r3, r9
    mov64 r4, r9
    add64 r4, 32
    lddw r5, {HEAP + 0x100}
    call sol_curve_group_op
    mov64 r7, r0
    lddw r1, {HEAP + 0x100}
    mov64 r2, 32
    call sol_set_return_data
    mov64 r1, r6
    mov64 r2, r7
    mov64 r3, 0
    mov64 r4, 0
    mov64 r5, 0
    call sol_log_64_
    mov64 r0, r7
    exit
""" + WALK

HASH_LINES = {1: b"hash v1", 2: b"hash v2"}


def elfs() -> dict:
    """name -> the program's ELF image."""
    return {
        "vault": sbpf_elf.build(VAULT, b"vault"),
        "hash": sbpf_elf.build(_hash_src(1, HASH_LINES[1]), HASH_LINES[1]),
        "hash_v2": sbpf_elf.build(_hash_src(2, HASH_LINES[2]),
                                  HASH_LINES[2]),
        "spin": sbpf_elf.build(SPIN),
        "curve": sbpf_elf.build(CURVE),
    }


def spin_result(count: int) -> int:
    """What the spin program computes for `count` (its log's 2nd word)."""
    acc = 0
    for c in range(count, 0, -1):
        acc = ((acc + c) ^ 0x5A) & ((1 << 64) - 1)
    return acc


def log64(*words) -> str:
    """sol_log_64_'s line for five words."""
    return " ".join(f"{w & ((1 << 64) - 1):#x}" for w in words)


def cu_limit_ix(units: int) -> bytes:
    """ComputeBudget SetComputeUnitLimit."""
    return bytes([2]) + struct.pack("<I", units)


def vault_data(mode: int, idx: int, bump: int, amount: int) -> bytes:
    return bytes([mode, idx, bump]) + bytes(5) + struct.pack("<Q", amount)


@dataclass
class SbpfOracle:
    """The family's own arithmetic: what the store must hold after it and
    what each of its txns must return."""
    programs: dict                # name -> program id
    programdata: dict             # name -> programdata key
    buffers: dict                 # name -> buffer key
    elfs: dict                    # name -> ELF image
    lamports: dict                # key -> expected lamports
    # payload -> {"status", optional "return_data", "log", "program"}
    expect: dict = field(default_factory=dict)

    def check(self, state: dict, results: dict | None = None) -> dict:
        """Hold a store's root state ({key: (lamports, data, owner,
        executable, rent_epoch)}) and, when given, the executor's
        results ({payload: (status, return_data, logs, cu)}) to the
        arithmetic. Raises AssertionError. -> a summary."""
        bad = {k.hex()[:16]: (state.get(k, (0,))[0], want)
               for k, want in self.lamports.items()
               if state.get(k, (0,))[0] != want}
        assert not bad, f"sBPF lamports differ from the arithmetic: {bad}"
        pd_len = loader.PROGRAMDATA_META_SZ + PD_LEN

        def pd_ok(name, elf):
            _, data, owner, _, _ = state[self.programdata[name]]
            assert owner == LOADER and len(data) == pd_len, name
            st, info = loader.parse_state(data)
            assert st == loader.ST_PROGRAMDATA and \
                info["authority"] == self.programs["deployer"], name
            assert data[loader.PROGRAMDATA_META_SZ:] == \
                elf + bytes(PD_LEN - len(elf)), f"{name}'s programdata"
            return info["slot"]
        for name in ("vault", "hash", "spin"):
            pd_ok(name, self.elfs[name])
        deployed_slot = pd_ok("hash2", self.elfs["hash_v2"])
        _, data, owner, exe, _ = state[self.programs["hash2"]]
        assert exe and owner == LOADER and data == loader.program_state(
            self.programdata["hash2"]), "hash2's program account"
        for name in ("deploy", "upgrade"):
            assert state[self.buffers[name]][1] == \
                struct.pack("<I", loader.ST_UNINIT), f"{name} buffer"
        _, data, _, exe, _ = state[self.buffers["bad"]]
        assert data == loader.buffer_state(self.programs["deployer"]) \
            + self.elfs["bad"], "the bad deploy's buffer"
        bad_prog = state.get(self.programs["bad"])
        assert bad_prog is None or not (bad_prog[3] or bad_prog[1]), \
            "the bad deploy made a program"
        out = {"lamports_checked": len(self.lamports),
               "hash2_slot": deployed_slot}
        if results is None:
            return out
        statuses: dict = {}
        for p, want in self.expect.items():
            assert p in results, f"{want['program']} txn never executed"
            status, rdata, logs, _ = results[p]
            assert status == want["status"], \
                f"{want['program']}: {status}, expected {want['status']}"
            if "return_data" in want:
                assert rdata == want["return_data"], want["program"]
            if "log" in want:
                assert want["log"] in logs, (want["program"], logs)
            key = f"{want['program']}:{status}"
            statuses[key] = statuses.get(key, 0) + 1
        out["statuses"] = dict(sorted(statuses.items()))
        return out

    def designed_failures(self) -> int:
        return sum(w["status"] != OK for w in self.expect.values())

    def host_costs(self, results: dict, timing_ns: dict) -> dict:
        """{program: {txns, cu, us_per_txn, us_per_cu}} over the
        invocations (failures included), from an executor's results and
        host ns a payload."""
        acc: dict = {}
        for p, want in self.expect.items():
            prog = want["program"]
            if prog == "loader" or p not in results:
                continue
            n, cu, ns = acc.get(prog, (0, 0, 0))
            acc[prog] = (n + 1, cu + results[p][3], ns + timing_ns[p])
        return {prog: {"txns": n, "cu": cu, "us_per_txn": ns / n / 1e3,
                       "us_per_cu": ns / cu / 1e3 if cu else None}
                for prog, (n, cu, ns) in sorted(acc.items())}


def build(keys, users: int, bh, scale: float = 1.0) \
        -> tuple[dict, list, SbpfOracle]:
    """The family over `keys` (general_exec._Keys), `users` funded users
    (fee payers) and `bh(i)` blockhashes; `scale` multiplies the
    invocations' counts (the deploy sequence and the designed failures
    stay whole). -> (genesis accounts, traffic [(slot index, payload,
    family)], oracle)."""
    def scaled(c):
        return max(1, int(round(c * scale)))

    def key(tag, i=0):
        return hashlib.sha256(b"gx-sbpf/%s/%d" % (tag.encode(), i)).digest()
    images = elfs()
    bad_elf = bytearray(images["hash"])
    struct.pack_into("<H", bad_elf, 18, 62)          # EM_X86_64
    images["bad"] = bytes(bad_elf)
    deployer = keys.pub("deployer", 0)
    progs = {n: key("program/" + n) for n in
             ("vault", "hash", "spin", "curve", "hash2", "bad")}
    progs["deployer"] = deployer
    pdata = {n: key("programdata/" + n) for n in
             ("vault", "hash", "spin", "hash2", "bad")}
    bufs = {n: key("buffer/" + n) for n in ("deploy", "upgrade", "bad")}
    gen: dict[bytes, Account] = {deployer: Account(lamports=10**11)}
    for n in ("vault", "hash", "spin"):
        gen[progs[n]] = Account(10**9, loader.program_state(pdata[n]),
                                LOADER, True)
        gen[pdata[n]] = Account(10**10, loader.programdata_state(
            0, deployer) + images[n] + bytes(PD_LEN - len(images[n])),
            LOADER)
    gen[progs["curve"]] = Account(10**10, images["curve"], BPF_LOADER_ID,
                                  True)
    for n in ("hash2", "bad"):
        gen[progs[n]] = Account(10**9, b"", LOADER)
        gen[pdata[n]] = Account(10**10, b"", LOADER)
    for n in ("deploy", "bad"):
        gen[bufs[n]] = Account(10**10, b"", LOADER)
    gen[bufs["upgrade"]] = Account(10**10, loader.buffer_state(deployer)
                                   + images["hash_v2"], LOADER)
    vaults = [find_program_address([b"vault", bytes([i])], progs["vault"])
              for i in range(VAULTS)]
    escrows = [key("escrow", i) for i in range(ESCROWS)]
    rcpt = [key("recipient", i) for i in range(RECIPIENTS)]
    victim = key("victim")
    for v, _ in vaults:
        gen[v] = Account(PDA_LAMPORTS)
    for e in escrows:
        gen[e] = Account(ESCROW_LAMPORTS, b"", progs["vault"])
    for r in rcpt + [victim]:
        gen[r] = Account(RECIPIENT_LAMPORTS)
    lam = {k: a.lamports for k, a in gen.items()
           if k in set(escrows) | set(rcpt) | {victim}
           | {v for v, _ in vaults}}
    oracle = SbpfOracle(progs, pdata, bufs, images, lam)
    traffic: list = []
    n_txn = [0]

    def add(slot, payload, family, program, status=OK, **want):
        assert len(payload) <= MTU, (program, len(payload))
        traffic.append((slot, payload, family))
        oracle.expect[payload] = dict(status=status, program=program,
                                      **want)

    def invoke(slot, prog, writable, readonly, ix_accts, data, cu,
               family, program, status=OK, **want):
        """One user's txn: a compute-unit limit, then `prog` over
        `writable` + `readonly` accounts (ix_accts index those)."""
        i = n_txn[0]
        n_txn[0] += 1
        extra = list(writable) + list(readonly) + [prog,
                                                   COMPUTE_BUDGET_PROGRAM_ID]
        base = 1                  # the fee payer is account 0
        p = keys.txn([("user", i % users)], extra,
                     [(base + len(extra) - 1, [], cu_limit_ix(cu)),
                      (base + len(extra) - 2,
                       [base + j for j in ix_accts], data)],
                     bh(50_000 + i),
                     n_ro_unsigned=len(readonly) + 2)
        add(slot, p, family, program, status, **want)

    def loader_txn(slot, accts, data, ix_accts, n_ro=0, status=OK):
        """The deployer's loader v3 txn; accts after the deployer, the
        last n_ro read-only; ix_accts index [deployer] + accts."""
        i = n_txn[0]
        n_txn[0] += 1
        p = keys.txn([("deployer", 0)], list(accts) + [LOADER],
                     [(len(accts) + 1, ix_accts, data)], bh(60_000 + i),
                     n_ro_unsigned=n_ro + 1)
        add(slot, p, "loader", "loader", status)

    # the deploy sequence and the loader's other instructions
    loader_txn(0, [bufs["deploy"]], loader.ix_init_buffer(), [1, 0])
    loader_txn(0, [bufs["bad"]], loader.ix_init_buffer(), [1, 0])
    probe = keys.txn([("deployer", 0)], [bufs["deploy"], LOADER],
                     [(2, [1, 0], loader.ix_write(0, b""))], bh(0),
                     n_ro_unsigned=1)
    chunk = MTU - len(probe) - 1        # the length field grows a byte
    for buf, elf in ((bufs["deploy"], images["hash"]),
                     (bufs["bad"], images["bad"])):
        for off in range(0, len(elf), chunk):
            loader_txn(1, [buf], loader.ix_write(off, elf[off:off + chunk]),
                       [1, 0])
    loader_txn(2, [progs["hash2"], pdata["hash2"], bufs["deploy"]],
               loader.ix_deploy(PD_LEN), [1, 2, 3, 0])
    loader_txn(2, [progs["bad"], pdata["bad"], bufs["bad"]],
               loader.ix_deploy(PD_LEN), [1, 2, 3, 0],
               status=ERR_BAD_IX_DATA)
    loader_txn(3, [pdata["hash2"], progs["hash2"], bufs["upgrade"]],
               loader.ix_upgrade(), [1, 2, 3, 0])
    loader_txn(3, [pdata["hash2"], key("new_authority")],
               struct.pack("<I", loader.IX_SET_AUTHORITY), [1, 0, 2],
               n_ro=1, status=ERR_UNKNOWN_IX)
    loader_txn(3, [bufs["deploy"], rcpt[0]],
               struct.pack("<I", loader.IX_CLOSE), [1, 2, 0],
               status=ERR_UNKNOWN_IX)

    def spread(i, n):
        return i * SLOTS // n
    # invocations
    for i in range(scaled(N_VAULT_CPI)):
        (v, bump), r = vaults[i % VAULTS], rcpt[i % RECIPIENTS]
        amount = 1_000_000 + i
        lam[v] -= amount
        lam[r] += amount
        invoke(spread(i, scaled(N_VAULT_CPI)), progs["vault"], [v, r], [],
               [0, 1], vault_data(0, i % VAULTS, bump, amount), 20_000,
               "sbpf_vault", "vault")
    for i in range(scaled(N_VAULT_MOVE)):
        e, r = escrows[i % ESCROWS], rcpt[(5 * i) % RECIPIENTS]
        amount = 2_000_000 + i
        lam[e] -= amount
        lam[r] += amount
        invoke(spread(i, scaled(N_VAULT_MOVE)), progs["vault"], [e, r], [],
               [0, 1], vault_data(1, 0, 0, amount), 5_000, "sbpf_vault",
               "vault")
    for i in range(scaled(N_HASH)):
        msg = b"gx-sbpf-hash/%d/" % i + bytes(range(i % 64))
        invoke(spread(i, scaled(N_HASH)), progs["hash"], [], [], [], msg,
               10_000, "sbpf_hash", "hash",
               return_data=hashlib.sha256(msg).digest(),
               log=HASH_LINES[1].decode())
    for i in range(scaled(N_HASH2)):
        msg = b"gx-sbpf-hash2/%d" % i
        invoke(4 + i * 4 // scaled(N_HASH2), progs["hash2"], [], [],
               [], msg, 10_000, "sbpf_hash", "hash",
               return_data=hashlib.sha256(msg).digest(),
               log=HASH_LINES[2].decode())
    for i in range(scaled(N_SPIN)):
        count = 50 + (i * 37) % 351
        invoke(spread(i, scaled(N_SPIN)), progs["spin"], [], [], [],
               struct.pack("<Q", count), 5 * count + 400, "sbpf_spin",
               "spin", log=log64(count, spin_result(count), 0, 0, 0))
    for i in range(scaled(N_CURVE)):
        a, b = 3 + i, 1000 + 7 * i
        pa, pb = (pt_compress(pt_mul(x, BASEPOINT)) for x in (a, b))
        invoke(spread(i, scaled(N_CURVE)), progs["curve"], [], [], [], pa + pb,
               5_000, "sbpf_curve", "curve",
               return_data=pt_compress(pt_mul(a + b, BASEPOINT)),
               log=log64(0, 0, 0, 0, 0))
    # designed failures
    invoke(5, progs["spin"], [], [], [], struct.pack("<Q", 400), 300,
           "sbpf_spin", "spin", status=ERR_VM)
    invoke(6, progs["vault"], [victim, rcpt[1]], [], [0, 1],
           vault_data(1, 0, 0, 5_000_000), 5_000, "sbpf_vault", "vault",
           status=ERR_INVALID_OWNER)
    invoke(7, progs["vault"], [escrows[0], rcpt[2]], [], [0, 1],
           vault_data(2, 0, 0, 7_000_000), 5_000, "sbpf_vault", "vault",
           status=ERR_BALANCE_VIOLATION)
    return gen, traffic, oracle
