"""The port's shm account store (firedancer_tpu_torch/native/fdtpu.cc's
funk store, runtime/tango.py::Store, funk/shmfunk.py) against the JAX
package's: the reference's naive-model random fork trees
(tests/test_funk.py) driven through both packages' ShmFunk side by side,
with identical answers and identical errors at every step; one workspace
written by either library's Store and read by the other's; the header,
txn and rec sizes; the pid-owned lock stolen from a child process that
exited while holding it; normalize_funk's errors and the value codec
equal to the reference's. Exact: every answer is bytes or an int."""
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest

from firedancer_tpu.funk import shmfunk as jshm
from firedancer_tpu.runtime import Store as JStore
from firedancer_tpu.runtime import Workspace as JWorkspace
from firedancer_tpu.svm.accdb import Account as JAccount
from firedancer_tpu_torch.funk import shmfunk as tshm
from firedancer_tpu_torch.runtime import Store as TStore
from firedancer_tpu_torch.runtime import Workspace as TWorkspace
from firedancer_tpu_torch.svm.accdb import Account as TAccount
from test_funk import NaiveForkModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = 0xfd79a9f07a960005
HDR_SZ, TXN_SZ, REC_SZ = 320, 64, 64
LOCK_WORD = 9                  # StoreHdr u64 index of the lock


@pytest.fixture
def wksp_name():
    name = f"/fdtt_st{os.getpid()}"
    yield name
    TWorkspace.unlink_name(name)


# -- layout -------------------------------------------------------------

@pytest.mark.parametrize("rec_max,txn_max,heap_sz", [
    (16, 16, 1 << 12), (4096, 256, 1 << 24), (1000, 17, 12345)])
def test_footprint_and_header_match_reference(wksp_name, rec_max, txn_max,
                                              heap_sz):
    """The same footprint from both libraries, and a header whose offsets
    give a 320-byte header, 64-byte txn slots and 64-byte rec slots."""
    fp = TStore.footprint(rec_max, txn_max, heap_sz)
    assert fp == JStore.footprint(rec_max, txn_max, heap_sz)
    w = TWorkspace(wksp_name, fp + 4096)
    try:
        st = TStore(w, rec_max=rec_max, txn_max=txn_max, heap_sz=heap_sz)
        h = w.view(st.off, HDR_SZ).view(np.uint64)
        magic, rmax, tmax, map_cnt, hsz, txn_off, rec_off, map_off, \
            heap_off, lock = (int(x) for x in h[:10])
        assert (magic, rmax, tmax, hsz, lock) == (MAGIC, rec_max, txn_max,
                                                 heap_sz, 0)
        assert txn_off == HDR_SZ
        assert rec_off - txn_off >= TXN_SZ * txn_max
        assert rec_off - txn_off < TXN_SZ * txn_max + 64
        assert rec_off - txn_off == -(-TXN_SZ * txn_max // 64) * 64
        assert map_off - rec_off == -(-REC_SZ * rec_max // 64) * 64
        assert map_cnt >= 4 * rec_max and map_cnt & (map_cnt - 1) == 0
        assert heap_off - map_off == -(-4 * map_cnt // 64) * 64
        assert heap_off + -(-heap_sz // 64) * 64 == fp
    finally:
        w.close()


# -- random fork trees --------------------------------------------------

def _call(f, op, *a):
    """-> ("ok", result) or ("err", exception type name, message)."""
    try:
        return ("ok", getattr(f, op)(*a))
    except Exception as e:    # noqa: BLE001 — compared, not swallowed
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_random_fork_trees_match_reference_and_naive_model(seed):
    """tests/test_funk.py's randomized walk over prepare / write / remove
    / query / cancel / publish, through the reference's ShmFunk and the
    port's at once: each op's answer or error is the same in both, the
    naive model agrees where the op succeeded, and the final sweep,
    root, per-layer records, children and live record count agree."""
    rng = random.Random(seed)
    ref = jshm.ShmFunk(rec_max=2048, txn_max=64, heap_sz=1 << 20)
    port = tshm.ShmFunk(rec_max=2048, txn_max=64, heap_sz=1 << 20)
    try:
        m = NaiveForkModel()
        next_xid = 0
        keys = [bytes([k]) * 32 for k in range(8)]
        errs = 0
        for step in range(2500):
            op = rng.random()
            live = m.live()
            if op < 0.28 or not live:
                parent = rng.choice([None] + live)
                xid = f"t{next_xid}"
                next_xid += 1
                call = ("txn_prepare", parent, xid)
                upd = (m.prepare, parent, xid)
            elif op < 0.55:
                tx, k = rng.choice([None] + live), rng.choice(keys)
                v = rng.choice([rng.randrange(1000), TAccount(
                    lamports=rng.randrange(1 << 40), data=bytes(
                        rng.randrange(256) for _ in range(rng.randrange(
                            80))))])
                call = ("rec_write", tx, k, v)
                upd = (m.write, tx, k, v)
            elif op < 0.65:
                tx, k = rng.choice([None] + live), rng.choice(keys)
                call = ("rec_remove", tx, k)
                upd = (m.remove, tx, k)
            elif op < 0.8:
                tx, k = rng.choice([None] + live), rng.choice(keys)
                got = _call(port, "rec_query", tx, k)
                want = _call(ref, "rec_query", tx, k)
                assert _same(got, want), f"step {step}: {got} != {want}"
                assert got == ("ok", m.query(tx, k)), f"step {step}"
                continue
            elif op < 0.9:
                tx = rng.choice(live)
                call = ("txn_cancel", tx)
                upd = (m.cancel, tx)
            else:
                tx = rng.choice(live)
                call = ("txn_publish", tx)
                upd = (m.publish, tx)
            want = _call(ref, *_to_ref(call))
            got = _call(port, *call)
            assert _same(got, want), f"step {step} {call[0]}: {got} != {want}"
            if got[0] == "ok":
                upd[0](*upd[1:])
            else:
                errs += 1            # a full txn table: both alike
            assert all(port.txn_is_prepared(x) for x in m.live())
        for tx in [None] + m.live():
            for k in keys:
                assert port.rec_query(tx, k) == m.query(tx, k)
                assert _same(("ok", port.rec_query(tx, k)),
                             ("ok", ref.rec_query(tx, k)))
            assert _plain(port.items_at(tx)) == _plain(ref.items_at(tx))
            assert sorted(port.txn_children(tx)) == \
                sorted(ref.txn_children(tx))
            if tx is not None:
                assert _plain(port.txn_recs(tx)) == _plain(ref.txn_recs(tx))
        assert port.root_items() == m.root
        assert port.raw.rec_cnt() == ref.raw.rec_cnt()
        assert next_xid > 400 and errs < next_xid // 2
    finally:
        ref.close(unlink=True)
        port.close(unlink=True)


def _to_ref(call):
    """The call with a port Account turned into the reference's, so each
    store gets its own package's record (tag 1, not a pickle)."""
    if call[0] == "rec_write" and isinstance(call[3], TAccount):
        a = call[3]
        return call[:3] + (JAccount(lamports=a.lamports, data=a.data),)
    return call


def _plain(v):
    """Either package's Account as a tuple, so records compare across
    packages; dicts and None pass through."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (TAccount, JAccount)):
        return ("acct", v.lamports, bytes(v.data), bytes(v.owner),
                bool(v.executable), v.rent_epoch)
    return v


def _same(a, b) -> bool:
    if a[0] != b[0]:
        return False
    if a[0] == "ok":
        return _plain(a[1]) == _plain(b[1])
    return a[1:] == b[1:]


# -- one workspace, two libraries ---------------------------------------

def _fill(st, acct_cls, codec):
    """Root records, two fork layers with writes and tombstones."""
    k = [bytes([i]) * 32 for i in range(6)]
    st.put(0, k[0], codec.encode_value(5))
    st.put(0, k[1], codec.encode_value(acct_cls(lamports=7, data=b"xy")))
    st.put(0, k[2], b"\x02" + bytes(5000))         # a large heap class
    assert st.txn_prepare(0, 11) == 0
    assert st.txn_prepare(11, 12) == 0
    st.put(11, k[0], codec.encode_value(6))
    st.put(11, k[3], codec.encode_value(9))
    st.put(12, k[1], None)                          # tombstone
    st.put(12, k[4], codec.encode_value(1 << 63))
    return k


def _read(st, k):
    def call(fn, *a):
        try:
            return fn(*a)
        except KeyError as e:             # unknown txn: both alike
            return ("KeyError", str(e))
    return {
        "get": [(x, i, call(st.get, x, i)) for x in (0, 11, 12) for i in k],
        "layers": [call(lambda x: sorted(st.iter_layer(x)), x)
                   for x in (0, 11, 12)],
        "parent": [st.txn_parent(x) for x in (11, 12)],
        "children": [call(st.txn_children, x) for x in (0, 11)],
        "exists": [st.txn_exists(x) for x in (0, 11, 12, 13)],
        "rec_cnt": st.rec_cnt(),
    }


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_one_workspace_reads_the_same_through_both_libraries(wksp_name,
                                                             writer):
    """A store written by one library reads the same through the other:
    every visibility query, layer, parent, child and count, and a
    publish by the reader then reads the same through the writer."""
    fp = TStore.footprint(512, 16, 1 << 18)
    if writer == "reference":
        ww = JWorkspace(wksp_name, fp + 4096)
        rw = TWorkspace(wksp_name, fp + 4096, create=False)
        wst = JStore(ww, rec_max=512, txn_max=16, heap_sz=1 << 18)
        rst = TStore(rw, off=wst.off, rec_max=512, txn_max=16,
                     heap_sz=1 << 18)
        k = _fill(wst, JAccount, jshm)
    else:
        ww = TWorkspace(wksp_name, fp + 4096)
        rw = JWorkspace(wksp_name, fp + 4096, create=False)
        wst = TStore(ww, rec_max=512, txn_max=16, heap_sz=1 << 18)
        rst = JStore(rw, off=wst.off, rec_max=512, txn_max=16,
                     heap_sz=1 << 18)
        k = _fill(wst, TAccount, tshm)
    try:
        before = _read(wst, k)
        assert _read(rst, k) == before
        assert before["get"][1][2] == before["get"][7][2] \
            and before["get"][13][2] is None      # the tombstone shadows
        assert rst.txn_publish(12) == 0           # the reader publishes
        after = _read(wst, k)
        assert _read(rst, k) == after
        assert after["exists"] == [False, False, False, False]
        assert tshm.decode_value(wst.get(0, k[4])) == 1 << 63
        assert wst.get(0, k[1]) is None
        # the reader's heap reuse is the writer's: rewrite, then remove
        rst.put(0, k[5], b"\x00" + bytes(8))
        wst.put(0, k[5], None)
        assert rst.get(0, k[5]) is None and wst.rec_cnt() == rst.rec_cnt()
    finally:
        rw.close()
        ww.close()


# -- the lock -----------------------------------------------------------

_HOLD = """
import sys
sys.path.insert(0, {root!r})
from firedancer_tpu_torch.runtime import Workspace
import numpy as np, os
w = Workspace({name!r}, {size}, create=False)
h = w.view({off}, 320).view(np.uint64)
h[{word}] = os.getpid()        # dies holding the lock
print(os.getpid())
"""


def test_lock_of_a_dead_holder_is_stolen(wksp_name):
    """A child process takes the store's lock and exits holding it; the
    next op here steals it (kill(pid, 0) == ESRCH) instead of spinning
    forever, and the store reads and writes on. Same through the
    reference's library."""
    fp = TStore.footprint(64, 16, 1 << 16)
    w = TWorkspace(wksp_name, fp + 4096)
    jw = JWorkspace(wksp_name, fp + 4096, create=False)
    try:
        st = TStore(w, rec_max=64, txn_max=16, heap_sz=1 << 16)
        jst = JStore(jw, off=st.off, rec_max=64, txn_max=16,
                     heap_sz=1 << 16)
        st.put(0, bytes(32), b"\x00" + bytes(8))
        h = w.view(st.off, HDR_SZ).view(np.uint64)
        for store in (st, jst):
            out = subprocess.run(
                [sys.executable, "-c", _HOLD.format(
                    root=ROOT, name=wksp_name, size=fp + 4096, off=st.off,
                    word=LOCK_WORD)],
                check=True, capture_output=True, text=True, timeout=60)
            dead = int(out.stdout.split()[-1])
            assert int(h[LOCK_WORD]) == dead
            res = {}

            def op(store=store, res=res):
                store.put(0, b"\x07" * 32, b"\x00" + bytes(8))
                res["get"] = store.get(0, bytes(32))
            t = threading.Thread(target=op, daemon=True)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive(), "the dead holder's lock was not stolen"
            assert res["get"] == b"\x00" + bytes(8)
            assert int(h[LOCK_WORD]) == 0
        assert st.rec_cnt() == 2
    finally:
        jw.close()
        w.close()


# -- config and codec ---------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, {}, {"backend": "shm", "heap_mb": 4}, {"rec_max": "64"},
    {"bakend": "shm"}, {"backend": "sm"}, {"backend": "disk"},
    {"rec_max": 8}, {"txn_max": 15}, {"heap_mb": 0}, "shm", ["shm"],
    {"rec_max": "x"}])
def test_normalize_funk_matches_reference(spec):
    got, want = _call(tshm, "normalize_funk", spec), \
        _call(jshm, "normalize_funk", spec)
    assert got == want
    assert tshm.FUNK_DEFAULTS == jshm.FUNK_DEFAULTS


@pytest.mark.parametrize("val", [
    0, 5, (1 << 64) - 1, 1 << 64, -1, True, ("slot", 3),
    "acct", "acct_data", "acct_exec"])
def test_value_codec_matches_reference(val):
    """encode_value gives the reference's bytes and decode_value the
    reference's value, for bare lamports, Accounts and pickled values."""
    accts = {"acct": dict(lamports=9),
             "acct_data": dict(lamports=1 << 50, data=bytes(range(90)),
                               owner=b"\x05" * 32, rent_epoch=7),
             "acct_exec": dict(lamports=2, executable=True)}
    if val in accts:
        tv, jv = TAccount(**accts[val]), JAccount(**accts[val])
    else:
        tv = jv = val
    enc = tshm.encode_value(tv)
    assert enc == jshm.encode_value(jv)
    assert _plain(tshm.decode_value(enc)) == _plain(jshm.decode_value(enc))
