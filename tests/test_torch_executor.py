"""The port's execution leg against the JAX package's: the wave scan
(ops/cuda_wave.py's plain version against the reference's jitted
`_scan_packed`, svm/executor.py:111), the staged tables, the pipelined
WaveExecutor, the conflict DAG's waves and the funk fork tree. Inputs are
numpy-made; every comparison is exact (balances are u64 integers)."""
import random

import jax
import numpy as np
import pytest
import torch

from firedancer_tpu.funk import Funk as JFunk
from firedancer_tpu.replay.rdisp import ConflictDag as JDag
from firedancer_tpu.svm import executor as jexec
from firedancer_tpu_torch.funk import Funk, FunkTxnError
from firedancer_tpu_torch.ops import cuda_wave
from firedancer_tpu_torch.replay import ConflictDag
from firedancer_tpu_torch.svm import executor as texec
from firedancer_tpu_torch.svm.accdb import Account
from torch_wave_cases import U64, keys_of, rand_block, wave_cases

_ref_scan = jax.jit(jexec._scan_packed)


CASES = wave_cases()


def _funk_pair(bal):
    fj, ft = JFunk(), Funk()
    for k, v in bal.items():
        fj.rec_write(None, k, v)
        ft.rec_write(None, k, v)
    return fj, ft


def _tables(bal, txns):
    """The reference's staged table and balance halves for `txns`, and
    the port's. -> (ref packed, port packed, bal_hi, bal_lo, key_idx)."""
    staged = jexec.WaveExecutor().stage(txns)
    key_idx = staged.key_idx
    packed, _, _ = texec.pack_table(txns, key_idx)
    n = texec._bucket(len(key_idx) + 1)
    hi, lo = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    for k, i in key_idx.items():
        hi[i], lo[i] = bal.get(k, 0) >> 32, bal.get(k, 0) & 0xFFFFFFFF
    return np.asarray(staged.packed_dev), packed, hi, lo, key_idx


@pytest.mark.parametrize("case", [c for c in CASES if c != "empty"])
def test_plain_scan_matches_reference_scan(case):
    """The same staged table (the two packages stage identically)
    through the reference's jitted scan and the port's plain scan:
    equal balances and statuses, and both equal the serial oracle."""
    bal, txns = CASES[case]
    ref_packed, packed, hi, lo, key_idx = _tables(bal, txns)
    np.testing.assert_array_equal(packed, ref_packed)
    rh, rl, rst = (np.asarray(x) for x in _ref_scan(ref_packed, hi, lo))
    th, tl, tst = cuda_wave.wave_scan(torch.from_numpy(packed),
                                      torch.from_numpy(hi),
                                      torch.from_numpy(lo))
    np.testing.assert_array_equal(th.numpy(), rh)
    np.testing.assert_array_equal(tl.numpy(), rl)
    np.testing.assert_array_equal(tst.numpy(), rst)
    oracle = dict(bal)
    want = jexec.execute_block_serial(oracle, txns)
    _, tix, act = texec.pack_table(txns, key_idx)
    got = [None] * len(txns)
    for wi, li in zip(*np.nonzero(act)):
        got[tix[wi, li]] = int(tst[wi, li])
    if case != "u64_edges":        # the oracle's ints do not wrap
        assert got == want
        for k, i in key_idx.items():
            assert (int(th[i]) << 32 | int(tl[i])) == oracle.get(k, 0)


def test_u64_edge_case_exercises_every_edge():
    """The u64 case really holds what it is named for: a wrapped need
    that passes, a hi-word borrow, and each status."""
    bal, txns = CASES["u64_edges"]
    _, packed, hi, lo, key_idx = _tables(bal, txns)
    _, _, st = cuda_wave.wave_scan(*(torch.from_numpy(x)
                                     for x in (packed, hi, lo)))
    st = st.numpy()
    assert {0, 1, 2} <= set(st[st >= 0].tolist())
    assert any((t.amount + t.fee) >> 64 for t in txns)
    assert max(bal.values()) == U64


def test_plain_scan_skips_lanes_past_the_table():
    """A lane whose src or dst is not an account slot does nothing (the
    kernel's guard), and an inactive lane neither."""
    packed = np.zeros((1, 4, 7), np.uint32)
    packed[0, 0] = (0, 1, 0, 5, 0, 1, 1)
    packed[0, 1] = (9, 1, 0, 5, 0, 1, 1)          # src past A
    packed[0, 2] = (2, 2, 0, 5, 0, 1, 0)          # inactive
    packed[0, 3] = (2, 3, 0, 5, 0, 1, 1)
    hi = np.zeros(4, np.uint32)
    lo = np.array([10, 0, 10, 0], np.uint32)
    h, lo2, st = cuda_wave.wave_scan(*(torch.from_numpy(x)
                                       for x in (packed, hi, lo)))
    assert st.tolist() == [[0, -1, -1, 0]]
    assert lo2.tolist() == [4, 5, 4, 5] and not h.any()


def test_wave_scan_refuses_bad_inputs():
    p = torch.zeros((1, 2, 7), dtype=torch.uint32)
    b = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(ValueError, match="packed"):
        cuda_wave.wave_scan(p[..., :6], b, b)
    with pytest.raises(ValueError, match="bal_lo"):
        cuda_wave.wave_scan(p, b, b.long())
    with pytest.raises(ValueError, match="packed"):
        cuda_wave.wave_scan(p.int(), b, b)


def test_wave_scan_refuses_misaligned_or_strided_views():
    """The kernel stages packed and both balance halves by 16-byte bulk
    copies, so the wrapper refuses, on either device and before any
    launch, a view that starts off a 16-byte boundary or is not
    contiguous; a view at a multiple of 16 bytes (WaveExecutor's bal[1]
    of a bucketed A) is taken, and its results equal a fresh copy's."""
    p = torch.zeros((2, 4, 7), dtype=torch.uint32)
    bal = torch.arange(2 * 9, dtype=torch.int64).to(torch.uint32)
    with pytest.raises(ValueError, match="bal_lo must be 16-byte aligned"):
        cuda_wave.wave_scan(p, bal[:8], bal[1:9])
    with pytest.raises(ValueError, match="bal_hi must be 16-byte aligned"):
        cuda_wave.wave_scan_slab(p, bal[2:10], bal[8:16])
    flat = torch.zeros(2 * 4 * 7 + 1, dtype=torch.uint32)
    with pytest.raises(ValueError, match="packed must be 16-byte aligned"):
        cuda_wave.wave_scan(flat[1:].view(2, 4, 7), bal[:8], bal[8:16])
    with pytest.raises(ValueError, match="bal_hi must be a contiguous"):
        cuda_wave.wave_scan(p, bal[::2], bal[8:16])
    with pytest.raises(ValueError, match="packed must be a contiguous"):
        cuda_wave.wave_scan(torch.zeros((4, 2, 7), dtype=torch.uint32
                                        ).transpose(0, 1), bal[:8], bal[8:16])
    packed = torch.zeros((1, 4, 7), dtype=torch.uint32)
    packed[0, 0] = torch.tensor((0, 1, 0, 5, 0, 1, 1))
    two = torch.tensor([[0, 0, 0, 0], [10, 0, 3, 4]], dtype=torch.uint32)
    got = cuda_wave.wave_scan(packed, two[0], two[1])
    want = cuda_wave.wave_scan(packed, two[0].clone(), two[1].clone())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].tolist() == [4, 5, 3, 4]


@pytest.mark.parametrize("case", ["random1", "u64_edges", "block17"])
def test_wave_executor_slab_matches_serial_oracle(case):
    """WaveExecutor on the CPU through the result slab: dispatch takes one
    int32 slab [bal_hi | bal_lo | status] from wave_scan_slab and keeps
    views of it, which equal wave_scan's three results; finalize's
    statuses and committed balances equal the serial oracle's (the u64
    case against the reference's WaveExecutor, whose ints wrap)."""
    bal, txns = CASES[case]
    funk = _funk_pair(bal)[1]
    wx = texec.WaveExecutor("cpu")
    staged = wx.stage(txns)
    disp = wx.dispatch(funk, None, "blk", staged)
    bh, bl, st = disp.out
    assert bh.untyped_storage().data_ptr() == \
        st.untyped_storage().data_ptr() == bl.untyped_storage().data_ptr()
    a = bh.shape[0]
    bal_in = torch.zeros((2, a), dtype=torch.uint32)
    for k, i in staged.key_idx.items():
        bal_in[0, i], bal_in[1, i] = bal.get(k, 0) >> 32, \
            bal.get(k, 0) & 0xFFFFFFFF
    for g, w in zip(disp.out, cuda_wave.wave_scan(staged.packed_dev,
                                                  bal_in[0], bal_in[1])):
        assert torch.equal(g, w)
    got = wx.finalize(funk, disp)
    keys = set(bal) | {k for t in txns for k in (t.src, t.dst)}
    if case == "u64_edges":
        fj = _funk_pair(bal)[0]
        assert got == jexec.execute_block(fj, None, "blk", txns)
        for k in keys:
            assert funk.rec_query("blk", k) == fj.rec_query("blk", k)
    else:
        oracle = dict(bal)
        assert got == texec.execute_block_serial(oracle, txns)
        for k in keys:
            assert funk.rec_query("blk", k) == oracle.get(k, 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_execute_block_matches_reference_and_oracle(case):
    """execute_block on the port (plain scan) and on the reference: equal
    statuses and equal funk balances in the fork; the serial oracle too
    (tests/test_leader_batch.py:408, tests/test_replay.py:90)."""
    bal, txns = CASES[case]
    fj, ft = _funk_pair(bal)
    want = jexec.execute_block(fj, None, "blk", txns)
    got = texec.execute_block(ft, None, "blk", txns, device="cpu")
    assert got == want
    keys = set(bal) | {k for t in txns for k in (t.src, t.dst)}
    for k in keys:
        assert ft.rec_query("blk", k) == fj.rec_query("blk", k)
    if case != "u64_edges":
        oracle = dict(bal)
        assert got == texec.execute_block_serial(oracle, txns)


def test_pipelined_wave_executor_matches_serial_and_reference():
    """The bank tile's order, stage k+1 before finalize k, on both
    packages' WaveExecutors over the same microblock waves, against the
    serial oracle; every funk balance compared after every wave
    (tests/test_leader_batch.py:348)."""
    rng = random.Random(11)
    keys = keys_of(12)
    bal0 = {k: rng.randint(0, 50_000) for k in keys}
    txns = [texec.SystemTxn(rng.choice(keys), rng.choice(keys),
                            rng.randint(0, 20_000),
                            rng.choice((0, 10, 5_000)))
            for _ in range(56)]
    waves = [txns[i:i + 14] for i in range(0, len(txns), 14)]
    oracle = dict(bal0)
    want_st = texec.execute_block_serial(oracle, txns)
    runs = []
    for wx, funk in ((jexec.WaveExecutor(), _funk_pair(bal0)[0]),
                     (texec.WaveExecutor("cpu"), _funk_pair(bal0)[1])):
        pending, st, after = None, [], []
        for wi, wave in enumerate(waves):
            staged = wx.stage(wave)
            if pending is not None:
                st.extend(wx.finalize(funk, pending))
                funk.txn_publish(pending.xid)
                after.append({k: funk.rec_query(None, k) for k in keys})
            pending = wx.dispatch(funk, None, f"w{wi}", staged)
        st.extend(wx.finalize(funk, pending))
        funk.txn_publish(pending.xid)
        after.append({k: funk.rec_query(None, k) for k in keys})
        runs.append((st, after))
    (jst, jafter), (tst, tafter) = runs
    assert tst == jst == want_st
    assert tafter == jafter
    assert tafter[-1] == {k: oracle.get(k, 0) for k in keys}


def test_wave_executor_across_forks_and_typed_accounts():
    """Two competing forks from one parent, then a block on the published
    fork; and the typed-account write-back (tests/test_replay.py:118)."""
    rng = np.random.default_rng(8)
    keys, txns_a = rand_block(rng, 40, 10)
    _, txns_b = rand_block(rng, 40, 10)
    results = []
    for funk_cls, run in (
            (JFunk, lambda f, p, x, t: jexec.execute_block(f, p, x, t)),
            (Funk, lambda f, p, x, t: texec.execute_block(f, p, x, t,
                                                          device="cpu"))):
        funk = funk_cls()
        funk.txn_prepare(None, "root")
        for i, k in enumerate(keys):
            funk.rec_write("root", k, 25_000 if i % 2 else
                           _acct(funk_cls, 25_000))
        funk.txn_publish("root")
        st_a = run(funk, None, "fork_a", txns_a)
        st_b = run(funk, None, "fork_b", txns_b)
        view = [_lamports(funk.rec_query(x, k)) for x in ("fork_a",
                                                           "fork_b")
                for k in keys]
        funk.txn_publish("fork_a")
        st2 = run(funk, None, "blk2", txns_b)
        view += [_lamports(funk.rec_query("blk2", k)) for k in keys]
        typed = [type(funk.rec_query("blk2", k)).__name__ for k in keys]
        results.append((st_a, st_b, st2, view, typed))
    assert results[0] == results[1]
    assert set(results[1][4]) == {"Account"}


def _acct(funk_cls, lamports):
    if funk_cls is JFunk:
        from firedancer_tpu.svm.accdb import Account as JAccount
        return JAccount(lamports=lamports)
    return Account(lamports=lamports)


def _lamports(v):
    return v if isinstance(v, int) or v is None else v.lamports


# -- ConflictDag ----------------------------------------------------------

def _dag_cases():
    rng = np.random.default_rng(6)
    out = {}
    for name, (n_txn, n_acct) in (("wide", (80, 12)), ("chains", (60, 4)),
                                  ("bench", (248, 40))):
        _, txns = rand_block(rng, n_txn, n_acct)
        out[name] = [((t.src, t.dst), ()) for t in txns]
    a, b = b"a" * 32, b"b" * 32
    out["read_write"] = [((a,), ()), ((), (a,)), ((), (a,)), ((a,), ()),
                         ((b,), (a,)), ((), (b, a))]
    return out


DAG_CASES = _dag_cases()


@pytest.mark.parametrize("case", sorted(DAG_CASES))
def test_conflict_dag_matches_reference(case):
    """waves() and the dispatcher's ready order equal the reference's
    (tests/test_replay.py:34-90), and each wave is conflict-free."""
    txns = DAG_CASES[case]
    dags = (JDag(), ConflictDag())
    for w, r in txns:
        assert dags[0].add_txn(w, r) == dags[1].add_txn(w, r)
    assert dags[1].waves() == dags[0].waves()
    for wave in dags[1].waves():
        seen_w, seen_r = set(), set()
        for i in wave:
            w, r = set(txns[i][0]), set(txns[i][1]) - set(txns[i][0])
            assert not (w & (seen_w | seen_r)) and not (r & seen_w)
            seen_w |= w
            seen_r |= r
    orders = []
    for dag in dags:
        order = []
        while not dag.done:
            i = dag.next_ready()
            assert i is not None
            order.append(i)
            dag.complete(i)
        orders.append(order)
    assert orders[0] == orders[1]


# -- Funk ------------------------------------------------------------------

def _run_ops(funk, ops):
    """Apply ops to a funk; -> the list of each op's result (or the
    exception's class name)."""
    out = []
    for op, *a in ops:
        try:
            fn = {"prepare": funk.txn_prepare, "write": funk.rec_write,
                  "remove": funk.rec_remove, "query": funk.rec_query,
                  "cancel": funk.txn_cancel, "publish": funk.txn_publish,
                  "prepared": funk.txn_is_prepared,
                  "children": funk.txn_children,
                  "root": funk.root_items, "items_at": funk.items_at,
                  "recs": funk.txn_recs}[op]
            r = fn(*a)
            out.append(sorted(r) if op == "children" else r)
        except Exception as e:             # both must raise alike
            out.append(type(e).__name__)
        out.append(funk.last_publish)
    return out


def _funk_cases():
    out = {
        "shadowing": [
            ("write", None, b"a", 1), ("prepare", None, "t1"),
            ("query", "t1", b"a"), ("write", "t1", b"a", 2),
            ("query", "t1", b"a"), ("query", None, b"a"),
            ("prepare", "t1", "t2"), ("query", "t2", b"a"),
            ("remove", "t2", b"a"), ("query", "t2", b"a"),
            ("query", "t1", b"a"), ("items_at", "t2"), ("recs", "t2")],
        "competing": [
            ("write", None, b"k", 0), ("prepare", None, "a"),
            ("prepare", None, "b"), ("write", "a", b"k", 1),
            ("write", "b", b"k", 2), ("query", "a", b"k"),
            ("query", "b", b"k"), ("query", None, b"k"),
            ("children", None)],
        "publish": [
            ("write", None, b"x", 0), ("prepare", None, "p"),
            ("write", "p", b"x", 1), ("write", "p", b"y", 10),
            ("prepare", "p", "c"), ("write", "c", b"x", 2),
            ("prepare", "p", "rival"), ("write", "rival", b"x", 99),
            ("prepare", "c", "child"), ("write", "child", b"z", 5),
            ("publish", "c"), ("query", None, b"x"), ("query", None, b"y"),
            ("prepared", "p"), ("prepared", "c"), ("prepared", "rival"),
            ("prepared", "child"), ("query", "child", b"z"),
            ("query", "child", b"x"), ("root",), ("children", None)],
        "cancel": [
            ("prepare", None, "a"), ("prepare", "a", "b"),
            ("prepare", "b", "c"), ("prepare", "a", "d"), ("cancel", "b"),
            ("prepared", "a"), ("prepared", "b"), ("prepared", "c"),
            ("prepared", "d"), ("children", "a")],
        "errors": [
            ("prepare", None, "a"), ("prepare", None, "a"),
            ("prepare", "zz", "b"), ("write", "zz", b"k", 1),
            ("query", "zz", b"k"), ("cancel", "zz"), ("publish", "zz"),
            ("recs", "zz"), ("prepare", None, None)],
    }
    rng = random.Random(7)
    ops, live, nxt = [], [], 0
    keys = [bytes([k]) for k in range(8)]
    shadow = Funk()            # tracks which xids are live
    for _ in range(1500):
        if ops:
            _run_ops(shadow, ops[-1:])
            live = [x for x in live if shadow.txn_is_prepared(x)]
        r = rng.random()
        if r < 0.28 or not live:
            parent = rng.choice([None] + live)
            ops.append(("prepare", parent, f"t{nxt}"))
            live.append(f"t{nxt}")
            nxt += 1
        elif r < 0.55:
            ops.append(("write", rng.choice([None] + live),
                        rng.choice(keys), rng.randrange(1000)))
        elif r < 0.65:
            ops.append(("remove", rng.choice([None] + live),
                        rng.choice(keys)))
        elif r < 0.8:
            ops.append(("query", rng.choice([None] + live),
                        rng.choice(keys)))
        elif r < 0.9:
            ops.append(("cancel", rng.choice(live)))
        else:
            ops.append(("publish", rng.choice(live)))
    ops += [("root",)] + [("items_at", x) for x in live[-20:]]
    out["randomized"] = ops
    return out


FUNK_CASES = _funk_cases()


@pytest.mark.parametrize("case", sorted(FUNK_CASES))
def test_funk_matches_reference(case):
    """The same operations on both packages' Funk give the same results,
    errors and published roots (tests/test_funk.py:10-170)."""
    ops = FUNK_CASES[case]
    assert _run_ops(Funk(), ops) == _run_ops(JFunk(), ops)


def test_key32_refuses_short_keys():
    from firedancer_tpu_torch.funk import key32
    assert key32(b"k" * 32) == b"k" * 32
    with pytest.raises(ValueError, match="exactly 32"):
        key32(b"k" * 31)
    assert issubclass(FunkTxnError, RuntimeError)
