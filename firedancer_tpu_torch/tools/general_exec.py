"""The general bank's workload for cfg/general.toml (bank0 with
exec="general") and the in-process follower: a coverage mix that runs
every ported program and each designed failure path, most of it votes.
Its per-program counts are chosen for coverage, not taken from a
published block, so its rate and its host time by program family are
not a mainnet block's.

    python -m firedancer_tpu_torch.tools.general_exec [--out PATH]

writes the genesis checkpoint (utils/checkpt.funk_checkpt, uncompressed)
that cfg/general.toml's `genesis_ckpt` names,
firedancer_tpu_torch/build/general/genesis.ckpt by default, and prints
the workload's counts. `build()` returns the whole workload:

  genesis   512 validators, each a funded identity (fee payer, node and
            authorized voter) with an initialized vote account
            (commission 10; a full tower of 31 votes, so every new vote
            roots a slot and earns a credit; 16 credits in epoch 0, so
            the first epoch boundary pays rewards), two delegated stake
            accounts (active since genesis); 16 active lookup tables of
            32 addresses (the v0 transfers' destinations) and SPARE
            tables the ALUT traffic deactivates; 256 funded users
  traffic   over SLOTS slots: one vote a validator a slot (Vote and
            TowerSync in turn), 256 system transfers, 64 stake txns
            (deactivate, withdraw, a fresh create + initialize +
            delegate), 32 ALUT txns (create + extend, extend,
            deactivate), 48 ed25519, 16 secp256k1 and 16 secp256r1
            precompile txns, and the designed failures: 8 precompile
            txns with a bad signature (program_failed) and 8 votes
            signed by a user who is not the authorized voter
            (missing_required_signature)
  sBPF      tools/sbpf_family.py: four deployed programs in genesis, a
            loader v3 deploy sequence, an Upgrade, a SetAuthority and a
            Close, 384 invocations (vault by CPI and directly, hash,
            spin, curve) and four designed failures, each txn asking
            for a compute-unit limit; a door run drains after each of
            the sequence's slots (`Workload.barriers`)
  v0        256 v0 transfers whose destinations load through the tables
            (in-process runs only: pack refuses unresolved v0)

Every transaction is signed (tools/paced_sender.comb_signer for ed25519,
the host curve code for secp256k1, `p256_sign` for secp256r1), so the
verify tile passes them all. Also here: the precompile instruction
encoders, `workload_slices` (the follower's slices on a real PoH chain)
and `PlainBank` (bank0's exec="general" path in process on the
CPU, the oracle of a topology run).
"""
from __future__ import annotations

import argparse
import hashlib
import hmac
import os
import struct
import time
from dataclasses import dataclass, field

from ..protocol.txn import build_message, build_txn
from ..svm import alut, stake, vote
from ..svm.accdb import Account
from ..svm.precompiles import (ED25519_PROGRAM_ID, SECP256K1_PROGRAM_ID,
                               SECP256R1_PROGRAM_ID, THIS_IX, THIS_IX_U8)
from ..svm.sysvars import rent_exempt_minimum
from . import sbpf_family
from .paced_sender import comb_signer
from .slices import slot_slices

SYS = bytes(32)
VALIDATORS = 512
USERS = 256
TABLES = 16
TABLE_ADDRS = 32
SPARE_TABLES = 10        # the ALUT traffic's deactivation targets
SLOTS = 8
TRANSFERS = 256
STAKE_TXNS = 64
ALUT_TXNS = 32
ED_TXNS, K1_TXNS, R1_TXNS = 48, 16, 16
BAD_PRECOMPILES = 8
BAD_VOTES = 8
V0_TXNS = 256
ENTRY_TXNS = 32          # txns an entry in the follower's slices
VOTE_BASE = 1000         # the genesis towers' first voted slot
COMMISSION = 10
GENESIS_CREDITS = 16
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "general", "genesis.ckpt")


# -- precompile instructions -------------------------------------------------

def ed25519_ix(items) -> bytes:
    """ed25519 precompile data over [(sig, pub, msg)], every offset into
    this instruction (u16 indexes, 0xFFFF)."""
    hdr = 2 + 14 * len(items)
    head, body = bytearray([len(items), 0]), bytearray()
    for sig, pub, msg in items:
        off = hdr + len(body)
        head += struct.pack("<HHHHHHH", off, THIS_IX, off + 64, THIS_IX,
                            off + 96, len(msg), THIS_IX)
        body += sig + pub + msg
    return bytes(head + body)


def secp256k1_ix(sig65: bytes, addr: bytes, msg: bytes) -> bytes:
    hdr = 1 + 11
    return bytes([1]) + struct.pack(
        "<HBHBHHB", hdr, THIS_IX_U8, hdr + 65, THIS_IX_U8, hdr + 85,
        len(msg), THIS_IX_U8) + sig65 + addr + msg


def secp256r1_ix(sig: bytes, pub33: bytes, msg: bytes) -> bytes:
    hdr = 2 + 14
    return bytes([1, 0]) + struct.pack(
        "<HHHHHHH", hdr, THIS_IX, hdr + 64, THIS_IX, hdr + 97, len(msg),
        THIS_IX) + sig + pub33 + msg


def secp256k1_sign(priv: int, msg: bytes) -> tuple[bytes, bytes]:
    """-> (r || s || recovery id, the signer's 20-byte eth address)."""
    from ..utils import secp256k1 as k1
    from ..utils.keccak import keccak256
    r, s, rec = k1.sign(priv, keccak256(msg))
    q = k1._mul(priv, (k1.GX, k1.GY))
    return (r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([rec]),
            k1.eth_address(q))


def p256_sign(priv: int, msg: bytes) -> tuple[bytes, bytes]:
    """ECDSA-SHA256 on P-256 with a deterministic nonce (HMAC-SHA256 of
    the key and digest) and low s, as the secp256r1 precompile takes it.
    -> (33-byte compressed pubkey, r || s)."""
    from ..utils import secp256r1 as r1
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % r1.N
    k = int.from_bytes(hmac.new(priv.to_bytes(32, "big"),
                                hashlib.sha256(msg).digest(),
                                hashlib.sha256).digest(), "big") % r1.N or 1
    while True:
        rx = r1._affine(r1._jmul(k, (r1.GX, r1.GY)))[0] % r1.N
        s = pow(k, r1.N - 2, r1.N) * (z + rx * priv) % r1.N
        if rx and s:
            break
        k = k % (r1.N - 1) + 1
    s = min(s, r1.N - s)
    qx, qy = r1._affine(r1._jmul(priv, (r1.GX, r1.GY)))
    pub33 = bytes([2 | (qy & 1)]) + qx.to_bytes(32, "big")
    return pub33, rx.to_bytes(32, "big") + s.to_bytes(32, "big")


# -- the workload --------------------------------------------------------------

@dataclass
class Workload:
    genesis: dict                 # key -> Account (the store's root)
    traffic: list                 # (slot index, payload, family)
    v0: list                      # (slot index, payload)
    designed_fail: int
    counts: dict = field(default_factory=dict)
    seconds: float = 0.0
    # slot indexes after which a door run drains before sending more
    # (the sBPF deploy sequence's order); empty: one stream
    barriers: tuple = ()
    sbpf: "SbpfOracle | None" = None

    def family(self) -> dict:
        """payload -> program family."""
        fam = {p: f for _, p, f in self.traffic}
        fam.update((p, "v0") for _, p in self.v0)
        return fam


class _Keys:
    def __init__(self, seed: int):
        self.signer = comb_signer()
        self.tag = b"gx%d/" % seed
        self._pubs: dict = {}

    def seed(self, role: str, i: int) -> bytes:
        return hashlib.sha256(self.tag + b"%s/%d" % (role.encode(), i)
                              ).digest()

    def pub_of(self, seed: bytes) -> bytes:
        if seed not in self._pubs:
            self._pubs[seed] = self.signer(seed, b"")[0]
        return self._pubs[seed]

    def pub(self, role: str, i: int) -> bytes:
        return self.pub_of(self.seed(role, i))

    def txn(self, signers, extra, instrs, blockhash, n_ro_unsigned=0,
            version=-1, aluts=()) -> bytes:
        """signers: [(role, i)] -> a signed txn payload."""
        seeds = [self.seed(r, i) for r, i in signers]
        pubs = [self.pub_of(s) for s in seeds]
        msg = build_message(pubs, extra, blockhash,
                            [(p, bytes(a), d) for p, a, d in instrs],
                            n_ro_unsigned=n_ro_unsigned, version=version,
                            aluts=aluts)
        return build_txn([self.signer(s, msg)[1] for s in seeds], msg)


def _vote_state(node: bytes) -> bytes:
    st = vote.VoteState(node, node, node, commission=COMMISSION)
    st.apply_vote(list(range(VOTE_BASE, VOTE_BASE + 31)))
    st.credits = GENESIS_CREDITS
    st.epoch_credits = [(0, GENESIS_CREDITS, 0)]
    return st.to_bytes()


def build(validators: int = VALIDATORS, users: int = USERS,
          tables: int = TABLES, table_addrs: int = TABLE_ADDRS,
          scale: float = 1.0) -> Workload:
    """The workload at `validators`, `users` and `tables` of
    `table_addrs`; `scale` multiplies the counts of the non-vote traffic
    (tests run it small). Keys and messages derive from fixed seeds."""
    t0 = time.perf_counter()
    keys = _Keys(18)

    def n(c):
        return max(1, int(round(c * scale)))
    ident = [keys.pub("id", v) for v in range(validators)]
    votes = [keys.pub("vote", v) for v in range(validators)]
    st_a = [keys.pub("stake_a", v) for v in range(validators)]
    st_b = [keys.pub("stake_b", v) for v in range(validators)]
    user = [keys.pub("user", u) for u in range(users)]
    reserve = rent_exempt_minimum(stake.STATE_SZ)
    gen: dict[bytes, Account] = {}
    for v in range(validators):
        gen[ident[v]] = Account(lamports=10**11)
        gen[votes[v]] = Account(10**10, bytearray(_vote_state(ident[v])),
                                vote.VOTE_PROGRAM_ID)
        for i, sk in enumerate((st_a[v], st_b[v])):
            amount = 10**12 * (1 + (v + i) % 7)
            st = stake.StakeState(
                stake.ST_DELEGATED, ident[v], ident[v], reserve, votes[v],
                amount, stake.EPOCH_NONE, stake.EPOCH_NONE)
            gen[sk] = Account(reserve + amount + 10**8,
                              bytearray(st.to_bytes()),
                              stake.STAKE_PROGRAM_ID)
    for u in range(users):
        gen[user[u]] = Account(lamports=10**11)
    # lookup tables: `tables` active ones hold the v0 destinations, the
    # spare ones are the ALUT traffic's deactivation targets
    table_keys, dests = [], []
    for j in range(tables + SPARE_TABLES):
        auth = user[j % users]
        tkey, _ = alut.derive_table_address(auth, 100 + j)
        addrs = [hashlib.sha256(b"gx-dest/%d/%d" % (j, i)).digest()
                 for i in range(table_addrs)]
        gen[tkey] = Account(10**9, bytearray(alut.AlutState(
            auth, addresses=addrs).to_bytes()), alut.ALUT_PROGRAM_ID)
        table_keys.append((tkey, j % users))
        if j < tables:
            dests.append(addrs)

    def bh(s):
        return hashlib.sha256(b"gx-blockhash/%d" % s).digest()
    traffic = []
    # votes: one a validator a slot, Vote and TowerSync in turn
    for s in range(SLOTS):
        for v in range(validators):
            vs = VOTE_BASE + 31 + s
            data = vote.ix_vote([vs], bh(s), 1_700_000_000 + s) \
                if (v + s) % 2 == 0 else vote.ix_tower_sync(
                    [(vs, 1)], None, bh(s), bh(s + 1000),
                    1_700_000_000 + s)
            traffic.append((s, keys.txn([("id", v)],
                                        [votes[v], vote.VOTE_PROGRAM_ID],
                                        [(2, [1], data)], bh(s),
                                        n_ro_unsigned=1), "vote"))
    other = []
    for i in range(n(TRANSFERS)):
        u = i % users
        other.append((keys.txn([("user", u)], [user[(u + 1) % users], SYS],
                               [(2, [0, 1], struct.pack("<IQ", 2,
                                                        1000 + i))],
                               bh(i), n_ro_unsigned=1), "transfer"))
    for i in range(n(STAKE_TXNS)):
        v = i % validators
        kind = i % 3
        if kind == 0:
            p = keys.txn([("id", v)], [st_a[v], stake.STAKE_PROGRAM_ID],
                         [(2, [1], stake.ix_deactivate())], bh(i),
                         n_ro_unsigned=1)
        elif kind == 1:
            p = keys.txn([("id", v)], [st_b[v], stake.STAKE_PROGRAM_ID],
                         [(2, [1, 0], stake.ix_withdraw(10**6 + i))],
                         bh(i), n_ro_unsigned=1)
        else:
            create = struct.pack("<IQQ", 0, reserve + 10**9,
                                 stake.STATE_SZ) + stake.STAKE_PROGRAM_ID
            p = keys.txn([("id", v), ("stake_new", i)],
                         [votes[v], SYS, stake.STAKE_PROGRAM_ID],
                         [(3, [0, 1], create),
                          (4, [1], stake.ix_initialize(ident[v],
                                                       ident[v])),
                          (4, [1, 2], stake.ix_delegate())], bh(i),
                         n_ro_unsigned=3)
        other.append((p, "stake"))
    n_alut = n(ALUT_TXNS)
    for i in range(n_alut):
        kind = i % 3
        if kind == 0:           # create + extend a fresh table
            u = i % users
            tkey, bump = alut.derive_table_address(user[u], 5000 + i)
            addrs = [hashlib.sha256(b"gx-new/%d/%d" % (i, a)).digest()
                     for a in range(4)]
            p = keys.txn([("user", u)], [tkey, alut.ALUT_PROGRAM_ID],
                         [(2, [1, 0], alut.ix_create(5000 + i, bump)),
                          (2, [1, 0], alut.ix_extend(addrs))], bh(i),
                         n_ro_unsigned=1)
        else:
            # extend an active table (appends past the v0 indexes) or
            # deactivate a spare one
            j = (i // 3) % tables if kind == 1 \
                else tables + (i // 3) % SPARE_TABLES
            tkey, u = table_keys[j]
            data = alut.ix_extend([hashlib.sha256(
                b"gx-ext/%d" % i).digest()]) if kind == 1 \
                else alut.ix_deactivate()
            p = keys.txn([("user", u)], [tkey, alut.ALUT_PROGRAM_ID],
                         [(2, [1, 0], data)], bh(i), n_ro_unsigned=1)
        other.append((p, "alut"))

    def precompile(u, pid, data, tag):
        return (keys.txn([("user", u % users)], [pid], [(1, [], data)],
                         bh(u), n_ro_unsigned=1), tag)
    for i in range(n(ED_TXNS)):
        msg = b"gx-ed25519/%d" % i
        pub, sig = keys.signer(keys.seed("ed", i), msg)
        other.append(precompile(i, ED25519_PROGRAM_ID,
                                ed25519_ix([(sig, pub, msg)]), "ed25519"))
    for i in range(n(K1_TXNS)):
        msg = b"gx-secp256k1/%d" % i
        sig65, addr = secp256k1_sign(0xC0FFEE + i, msg)
        other.append(precompile(i, SECP256K1_PROGRAM_ID,
                                secp256k1_ix(sig65, addr, msg),
                                "secp256k1"))
    for i in range(n(R1_TXNS)):
        msg = b"gx-secp256r1/%d" % i
        pub33, sig = p256_sign(0xBEEF + i, msg)
        other.append(precompile(i, SECP256R1_PROGRAM_ID,
                                secp256r1_ix(sig, pub33, msg), "secp256r1"))
    # designed failures: precompiles with a bad signature, votes signed
    # by a user who is not the authorized voter
    for i in range(BAD_PRECOMPILES):
        msg = b"gx-bad/%d" % i
        if i % 3 == 0:
            pub, sig = keys.signer(keys.seed("ed", 10_000 + i), msg)
            pid, data, tag = ED25519_PROGRAM_ID, ed25519_ix(
                [(sig[:8] + bytes([sig[8] ^ 1]) + sig[9:], pub, msg)]), \
                "ed25519"
        elif i % 3 == 1:
            sig65, addr = secp256k1_sign(0xBAD + i, msg)
            pid, data, tag = SECP256K1_PROGRAM_ID, secp256k1_ix(
                sig65, bytes(20), msg), "secp256k1"
        else:
            pub33, sig = p256_sign(0xBAD + i, msg)
            pid, data, tag = SECP256R1_PROGRAM_ID, secp256r1_ix(
                sig[:40] + bytes([sig[40] ^ 1]) + sig[41:], pub33, msg), \
                "secp256r1"
        other.append(precompile(1000 + i, pid, data, tag))
    for i in range(BAD_VOTES):
        v = (7 * i) % validators
        other.append((keys.txn(
            [("user", i % users)], [votes[v], vote.VOTE_PROGRAM_ID],
            [(2, [1], vote.ix_vote([VOTE_BASE + 100 + i], bh(i)))],
            bh(i), n_ro_unsigned=1), "vote"))
    for i, (p, fam) in enumerate(other):
        traffic.append((i * SLOTS // len(other), p, fam))
    traffic.sort(key=lambda t: t[0])
    v0 = []
    n_v0 = n(V0_TXNS)
    for i in range(n_v0):
        j, a = i % tables, (i // tables) % table_addrs
        v0.append((i * SLOTS // n_v0, keys.txn(
            [("user", (i * 5) % users)], [SYS],
            [(1, [0, 2], struct.pack("<IQ", 2, 1_000_000 + i))], bh(i),
            n_ro_unsigned=1, version=0,
            aluts=[(table_keys[j][0], bytes([a]), b"")])))
    sb_gen, sb_traffic, oracle = sbpf_family.build(keys, users, bh, scale)
    gen.update(sb_gen)
    traffic = sorted(traffic + sb_traffic, key=lambda t: t[0])
    counts = {}
    for _, _, fam in traffic:
        counts[fam] = counts.get(fam, 0) + 1
    counts["v0"] = len(v0)
    return Workload(gen, traffic, v0, BAD_PRECOMPILES + BAD_VOTES
                    + oracle.designed_failures(), counts,
                    time.perf_counter() - t0, sbpf_family.BARRIERS, oracle)


def write_genesis(wl: Workload, path: str = DEFAULT_OUT) -> str:
    """The genesis checkpoint (uncompressed: the card's machine has no
    zstandard), written to a temporary name and renamed."""
    from ..funk.funk import Funk, key32
    from ..utils.checkpt import funk_checkpt
    funk = Funk()
    for key, a in wl.genesis.items():
        funk.rec_write(None, key32(key), a)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        funk_checkpt(funk, f, compress=False)
    os.replace(tmp, path)
    return path


# -- the follower's blocks -----------------------------------------------------

def workload_slices(wl: Workload, first_slot: int, hashes_per_tick: int,
                    v0: bool = True) -> dict:
    """The workload's slots from `first_slot` as complete slices on a
    real PoH chain (tools/slices.slot_slices), v0 transfers included
    unless `v0` is false."""
    by_slot: dict = {}
    for s, p, _ in wl.traffic:
        by_slot.setdefault(first_slot + s, []).append(p)
    if v0:
        for s, p in wl.v0:
            by_slot.setdefault(first_slot + s, []).append(p)
    return slot_slices(by_slot, hashes_per_tick=hashes_per_tick,
                       entry_txns=ENTRY_TXNS)


def replay_workload(slices: dict, genesis_path: str, device: str,
                    hashes_per_tick: int, slots_per_epoch: int) -> dict:
    """ReplayCore on `device` over a funk restored from the genesis
    checkpoint, fed every slice in one release (its PoH checks one
    batch). -> {"bank_hashes": {slot: hash}, "state": root_state,
    "metrics", "seconds"}."""
    from ..funk.funk import Funk
    from ..tiles.replay import ReplayCore
    from ..utils.checkpt import funk_restore
    with open(genesis_path, "rb") as f:
        funk = funk_restore(Funk, f)
    t0 = time.perf_counter()
    core = ReplayCore(funk=funk, hashes_per_tick=hashes_per_tick,
                      slots_per_epoch=slots_per_epoch, device=device)
    core.on_slices([slices[s] for s in sorted(slices)])
    secs = time.perf_counter() - t0
    assert core.metrics["slots_replayed"] == len(slices), core.metrics
    return {"bank_hashes": {s: core.bank_hash_of[s] for s in slices},
            "state": root_state(funk), "metrics": dict(core.metrics),
            "seconds": secs}


# -- the oracle of a topology run ----------------------------------------------

class PlainBank:
    """bank0's exec="general" path in process on the CPU: a BankAdapter
    over no rings (its flush is dropped), fed the microblock frames bank0
    took (pack -> bank), in order, each at its slot. It runs the same
    `_wave_general` and `TxnExecutor` as bank0, so it is no independent
    oracle of what the programs compute (the CPU parity tests hold that
    to the JAX package, and the sBPF family's own arithmetic,
    `SbpfOracle.check`, holds its results). `ns` and `results` hold each
    payload's host ns and (status, return data, logs, sBPF compute
    units)."""

    def __init__(self, genesis_ckpt: str, slots_per_epoch: int,
                 family: dict | None = None):
        from types import SimpleNamespace

        from ..disco.tiles import BankAdapter
        ctx = SimpleNamespace(
            tile_name="plain_bank", in_seq0={},
            plan={"links": {"mb": {"mtu": 1 << 16}, "done": {"mtu": 64}}},
            in_rings={"mb": None}, out_rings={"done": None},
            out_fseqs={"done": []})
        self.bank = BankAdapter(ctx, {
            "exec": "general", "device": "cpu", "wave": 1,
            "genesis_ckpt": genesis_ckpt,
            "slots_per_epoch": slots_per_epoch})
        self.bank._flush_wave = lambda *a: None
        self.family = family or {}
        self.ns: dict = {}
        self.results: dict = {}
        self._ctx = None
        ex = self.bank.executor
        run = ex.execute

        def timed(xid, payload):
            self._ctx = None
            t0 = time.perf_counter_ns()
            r = run(xid, payload)
            self.ns[payload] = time.perf_counter_ns() - t0
            self.results[payload] = (
                r.status, r.return_data, tuple(r.logs),
                0 if self._ctx is None else self._ctx.cu_used)
            return r
        ex.execute = timed

    def feed(self, frames):
        """The frames through bank0's path; each transaction's context
        is kept for its compute units (the executor's TxnContext, seen
        through a subclass for the feed's length: TxnResult carries no
        compute units, in the JAX package neither)."""
        from ..svm import programs
        base = programs.TxnContext
        bank = self

        class Seen(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                bank._ctx = self
        programs.TxnContext = Seen
        try:
            for frame in frames:
                _b, cnt, mb, slot = struct.unpack_from("<HHQQ", frame, 0)
                self.bank.slot = max(self.bank.slot, slot)
                self.bank.m["txns"] += cnt
                self.bank.m["microblocks"] += 1
                self.bank._wave_general([(frame, cnt, mb)])
        finally:
            programs.TxnContext = base
        return self.bank.m

    def us_per_txn(self) -> dict:
        """The host's mean us a transaction by program family."""
        acc: dict = {}
        for p, ns in self.ns.items():
            fam = self.family.get(p, "other")
            tot, cnt = acc.get(fam, (0, 0))
            acc[fam] = (tot + ns, cnt + 1)
        return {f: tot / cnt / 1e3 for f, (tot, cnt) in sorted(acc.items())}


def root_state(funk) -> dict:
    """The store's published root as {key: (lamports, data, owner,
    executable, rent_epoch)}."""
    return {bytes(k): (v.lamports, bytes(v.data), v.owner, v.executable,
                       v.rent_epoch)
            for k, v in funk.root_items().items() if isinstance(v, Account)}


def chain_settings(cfg: dict) -> tuple[int, int]:
    """A loaded config's (bank0's slots_per_epoch, poh's
    hashes_per_tick): what a replay of its blocks must take."""
    args = {t["name"]: t for t in cfg["tile"]}
    return args["bank0"]["slots_per_epoch"], args["poh"]["hashes_per_tick"]


def run_general(cfg_path: str, wl: Workload, genesis_path: str,
                device: str, name: str, final_ckpt: str,
                timeout_s: float = 300.0, window: int = 256) -> dict:
    """Boot cfg/general.toml (verify and bank0 on `device`, bank0 over
    `genesis_path`, writing its store's root to `final_ckpt` at its
    halt), send the workload's traffic to the sock door with a
    WindowSender (at most `window` datagrams between what it sent and
    what the door read, so the door reads every one), in the groups of
    `_groups` (the loop drains after each: the sBPF deploy sequence's
    order; the last goes once poh is in a later epoch, so the votes
    before it earn rewards, a wait left out of the wall), wait until
    every transaction is executed, failed or dropped at a named hop, and
    poh has mixed in every microblock, and halt. Then PlainBank over the microblocks bank0
    took (a LinkTap on pack -> bank0), in order. Its store check holds
    bank0 to its own code run in process: it shows that the run is
    deterministic and that the rings, the halt and the checkpoint lose
    nothing, not that the programs are right; tests/test_torch_*.py hold
    what they compute to the JAX package on the CPU, and the sBPF
    family's own arithmetic (`SbpfOracle.check`) holds bank0's store and
    each of its txns' results. Raises AssertionError on any check of
    chip_smoke.py 23a. -> the record."""
    from ..app.config import build_topology, load_config
    from ..disco.launch import TopologyRunner
    from ..funk.funk import Funk
    from ..utils.checkpt import funk_restore
    from . import leader_drain
    from .paced_sender import WindowSender
    cfg = load_config(cfg_path, overrides={"tile": [
        {"name": "verify", "device": device},
        {"name": "bank0", "device": device, "genesis_ckpt": genesis_path}]})
    spe, _ = chain_settings(cfg)
    frames = [p for _, p, _ in wl.traffic]
    topo = build_topology(cfg, name=name)
    # the drill's seam: not a config key (the reference has none)
    topo.tiles["bank0"].args["final_ckpt"] = final_ckpt
    runner = TopologyRunner(topo.build())
    tap = None
    try:
        t_boot = time.perf_counter()
        runner.start()
        runner.wait_running(timeout_s=timeout_s)
        boot_s = time.perf_counter() - t_boot
        tap = leader_drain.LinkTap(runner, "pack_bank0")
        port = int(runner.metrics("sock")["port"])
        t0 = time.perf_counter()
        sent, idle = 0, 0.0
        groups = _groups(wl)
        for k, group in enumerate(groups):
            if k and k + 1 == len(groups):
                # the last group executes in a later epoch than the
                # groups before it, so the votes they landed earn
                # rewards at its first microblock's epoch boundary
                # (a quick run can otherwise fit in one epoch)
                idle += _next_epoch(runner, spe, timeout_s)
            base = sent
            sender = WindowSender(
                group, port, lambda: runner.metrics("sock")["rx"] - base,
                window).start()
            deadline = time.monotonic() + timeout_s
            while not sender.dry or \
                    runner.metrics("sock")["rx"] < base + len(group):
                runner.check_failures()
                assert time.monotonic() < deadline, \
                    f"the door read {runner.metrics('sock')['rx']} of " \
                    f"{base + len(group)} (sent {base + sender.sent})"
                time.sleep(0.01)
            sent += sender.stop()
            dropped = leader_drain.wait_drained(runner, sent,
                                                timeout_s=timeout_s)
        wall = time.perf_counter() - t0 - idle
        leader_drain.wait_mixed(runner, timeout_s)
        # the shred leg is not drained: its pure-Python Reed-Solomon
        # lags the bank, and a poh backpressured at its halt drops the
        # entries it staged (the shreds are not what this run checks)
        t1 = time.perf_counter()
        runner.halt()
        halt_s = time.perf_counter() - t1
        m = {tn: runner.metrics(tn) for tn in runner.plan["tiles"]}
        micro = tap.stop()
        assert tap.overruns == 0, "the pack -> bank0 tap was overrun"
        for tn, proc in runner.procs.items():
            assert proc.exitcode == 0, f"tile {tn} exit code {proc.exitcode}"
    finally:
        if tap is not None:
            tap.close()
        runner.halt()
        runner.close()
    b, sock = m["bank0"], m["sock"]
    verify = {tn: m[tn] for tn in leader_drain.verify_shards(runner)}
    t2 = time.perf_counter()
    oracle = PlainBank(genesis_path, spe, wl.family())
    om = oracle.feed(micro)
    oracle_s = time.perf_counter() - t2
    with open(final_ckpt, "rb") as f:
        got = root_state(funk_restore(Funk, f))
    want = root_state(oracle.bank.funk)
    diff = [k.hex() for k in set(got) | set(want)
            if got.get(k) != want.get(k)]
    for key, have, need in (
            ("sock.rx", sock["rx"], sent), ("sent", sent, len(frames)),
            ("bank0.txns + drops", b["txns"] + dropped, len(frames)),
            ("bank0 ok + fail + skip", b["transfers"] + b["exec_fail"]
             + b["exec_skip"], b["txns"]),
            ("bank0.exec_fail", b["exec_fail"], om["exec_fail"]),
            ("oracle.exec_fail", om["exec_fail"], wl.designed_fail),
            ("bank0.rewards_paid", b["rewards_paid"], om["rewards_paid"]),
            ("microblocks", len(micro), b["microblocks"]),
            ("poh.mixins", m["poh"]["mixins"], b["microblocks"]),
            ("accounts differing from the oracle", len(diff), 0)):
        assert have == need, f"{key} = {have}, expected {need}"
    assert b["rewards_paid"] > 0, "no epoch rewards were paid"
    for tn, v in verify.items():
        assert v["cpu_fallback"] == 0 and v["device_errors"] == 0, \
            f"{tn}: {v}"
    # the sBPF family against its own arithmetic: bank0's store, and
    # each txn's status, return data and log as bank0's path gave them
    sbpf = wl.sbpf.check(got, oracle.results)
    return {"sent": sent, "door_rx": sock["rx"], "dropped": dropped,
            "bank_txns": b["txns"], "executed": b["transfers"],
            "exec_fail": b["exec_fail"], "oracle_exec_fail":
            om["exec_fail"], "rewards_paid": b["rewards_paid"],
            "microblocks": b["microblocks"], "accounts": len(got),
            "boot_s": boot_s, "wall_s": wall, "e2e_general_tps":
            b["txns"] / wall, "halt_s": halt_s,
            "shred_fec_sets": m["shred"]["fec_sets"],
            "oracle_s": oracle_s, "verify_batches":
            {tn: v["batches"] for tn, v in verify.items()},
            "slots": m["poh"]["slots"], "epochs":
            oracle.bank._rewards_epoch,
            "host_us_per_txn": oracle.us_per_txn(), "sbpf": sbpf,
            "sbpf_host": wl.sbpf.host_costs(oracle.results, oracle.ns)}


def _next_epoch(runner, spe: int, timeout_s: float) -> float:
    """Wait until poh is two slots into the epoch after its current one
    (pack's slot follows poh's a frame behind). -> seconds waited."""
    t0 = time.perf_counter()
    target = (runner.metrics("poh")["slots"] // spe + 1) * spe + 2
    deadline = time.monotonic() + timeout_s
    while runner.metrics("poh")["slots"] < target:
        runner.check_failures()
        assert time.monotonic() < deadline, f"poh never reached {target}"
        time.sleep(0.01)
    return time.perf_counter() - t0


def _groups(wl: Workload) -> list:
    """The traffic's payloads in the groups a door run sends, draining
    after each: cut after each slot index of `wl.barriers`."""
    groups, cur = [], []
    for i, (slot, p, _) in enumerate(wl.traffic):
        cur.append(p)
        last = i + 1 == len(wl.traffic)
        if last or (slot in wl.barriers
                    and wl.traffic[i + 1][0] != slot):
            groups.append(cur)
            cur = []
    return groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    wl = build()
    path = write_genesis(wl, a.out)
    print(f"genesis: {len(wl.genesis)} accounts -> {path}; traffic "
          f"{len(wl.traffic)} txns {wl.counts}; built in "
          f"{wl.seconds:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
