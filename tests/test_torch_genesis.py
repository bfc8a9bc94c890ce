"""The port's genesis (firedancer_tpu_torch/app/genesis.py)
against the JAX package's on the same arguments: the checkpoint is byte
for byte the reference's, both packages derive the same stakes and
leader schedule from it, it restores and executes a transfer alike, an
oversized user pool is refused by both, and the CLI prints what the
reference's prints. These are tests/test_genesis.py's four tests as
cases of a two-package comparison. Exact."""
import io
import struct

import pytest

from firedancer_tpu.app import genesis as jgenesis
from firedancer_tpu_torch.app import genesis as tgenesis

CASES = [(1, 16, 1_000_000), (2, 4, 99), (3, 16, 500)]


def _ckpt(mod_checkpt, funk) -> bytes:
    buf = io.BytesIO()
    mod_checkpt(funk, buf)
    return buf.getvalue()


@pytest.mark.parametrize("validators,users,stake", CASES)
def test_genesis_checkpoint_is_the_references(validators, users, stake):
    """The same accounts in the same checkpoint bytes; the same
    validators (identity, vote key, stake key)."""
    from firedancer_tpu.utils.checkpt import funk_checkpt as jckpt
    from firedancer_tpu_torch.utils.checkpt import funk_checkpt as tckpt
    tf, tv = tgenesis.build_genesis(validators, users, stake)
    jf, jv = jgenesis.build_genesis(validators, users, stake)
    assert tv == jv
    assert _ckpt(tckpt, tf) == _ckpt(jckpt, jf)
    assert len(tf.root_items()) == 3 * validators + users
    assert tgenesis.validator_seed(validators) == \
        jgenesis.validator_seed(validators)


@pytest.mark.parametrize("validators,users,stake", CASES)
def test_genesis_drives_the_same_stakes_and_leader_schedule(
        validators, users, stake):
    """node_stakes and total_stake at epochs 0 and 1 agree between the
    packages (delegations activate after epoch 0), and so does the
    epoch-1 leader schedule over 64 slots."""
    from firedancer_tpu.flamenco.leaders import EpochLeaders as JLeaders
    from firedancer_tpu.flamenco.stakes import node_stakes as jns
    from firedancer_tpu.flamenco.stakes import total_stake as jts
    from firedancer_tpu_torch.flamenco.leaders import EpochLeaders
    from firedancer_tpu_torch.flamenco.stakes import node_stakes, total_stake
    tf, tv = tgenesis.build_genesis(validators, users, stake)
    jf, _ = jgenesis.build_genesis(validators, users, stake)
    for epoch in (0, 1):
        assert node_stakes(tf, None, epoch) == jns(jf, None, epoch)
        assert total_stake(tf, None, epoch) == jts(jf, None, epoch)
    assert total_stake(tf, None, 0) == 0
    assert total_stake(tf, None, 1) == validators * stake
    ns = node_stakes(tf, None, 1)
    assert set(ns) == {ident for ident, _, _ in tv}
    ours = EpochLeaders(1, b"\x01" * 32, ns, 64)
    theirs = JLeaders(1, b"\x01" * 32, ns, 64)
    for n in ns:
        assert ours.leader_slots(n) == theirs.leader_slots(n)
    assert sum(len(ours.leader_slots(n)) for n in ns) == 64


def test_genesis_restores_and_executes_as_the_reference():
    """The checkpoint restores through both packages' funk_restore to the
    same keys, and a validator identity pays for a transfer that both
    executors run alike."""
    from firedancer_tpu.funk.funk import Funk as JFunk
    from firedancer_tpu.protocol.txn import build_message, build_txn
    from firedancer_tpu.svm import AccDb as JAccDb
    from firedancer_tpu.svm import TxnExecutor as JExecutor
    from firedancer_tpu.svm.accdb import SYSTEM_PROGRAM_ID
    from firedancer_tpu.utils.checkpt import funk_restore as jrestore
    from firedancer_tpu_torch.funk.funk import Funk
    from firedancer_tpu_torch.svm import AccDb, TxnExecutor
    from firedancer_tpu_torch.utils.checkpt import funk_checkpt, funk_restore
    funk, validators = tgenesis.build_genesis(n_validators=2)
    raw = _ckpt(funk_checkpt, funk)
    ours = funk_restore(Funk, io.BytesIO(raw))
    theirs = jrestore(JFunk, io.BytesIO(raw))
    assert ours.root_items().keys() == funk.root_items().keys() \
        == theirs.root_items().keys()
    ident = validators[0][0]
    dest = b"\x77" * 32
    msg = build_message([ident], [dest, SYSTEM_PROGRAM_ID], b"\x11" * 32,
                        [(2, bytes([0, 1]),
                          struct.pack("<IQ", 2, 1 << 20))],
                        n_ro_unsigned=1)
    txn = build_txn([bytes(64)], msg)
    got = []
    for f, db_cls, ex_cls in ((ours, AccDb, TxnExecutor),
                              (theirs, JAccDb, JExecutor)):
        f.txn_prepare(None, "blk")
        db = db_cls(f)
        r = ex_cls(db).execute("blk", txn)
        got.append((r.status, db.lamports("blk", dest),
                    db.lamports("blk", ident)))
    assert got[0] == got[1]
    assert got[0][:2] == ("ok", 1 << 20)


def test_oversized_user_pool_refused_by_both():
    """The synth signer pool wraps at 16 keys: 16 users fund exactly the
    payers, 17 and more are refused alike."""
    assert len(tgenesis.build_genesis(1, 16)[0].root_items()) == 19
    for mod in (tgenesis, jgenesis):
        with pytest.raises(ValueError, match="capped at 16"):
            mod.build_genesis(n_user_accounts=17)
        with pytest.raises(ValueError, match="capped"):
            mod.build_genesis(n_user_accounts=100)


def test_genesis_cli_prints_as_the_reference(tmp_path, capsys):
    """Both CLIs on the same arguments: the same lines and the same
    checkpoint bytes, whose epoch-1 stake is validators x stake."""
    from firedancer_tpu_torch.flamenco.stakes import total_stake
    from firedancer_tpu_torch.funk.funk import Funk
    from firedancer_tpu_torch.utils.checkpt import funk_restore
    outs, files = [], []
    for mod, name in ((tgenesis, "t.ckpt"), (jgenesis, "j.ckpt")):
        path = str(tmp_path / name)
        assert mod.main([path, "--validators", "2", "--stake", "99"]) == 0
        outs.append(capsys.readouterr().out)
        with open(path, "rb") as f:
            files.append(f.read())
    assert outs[0] == outs[1]
    assert "2 validators" in outs[0]
    assert files[0] == files[1]
    funk = funk_restore(Funk, io.BytesIO(files[0]))
    assert total_stake(funk, None, 1) == 198
