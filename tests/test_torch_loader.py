"""The port's upgradeable loader (firedancer_tpu_torch/svm/loader.py, loader
v3) against the JAX package's svm/loader.py, through both packages'
TxnExecutor side by side (tests/torch_svm_parity.py): the scenarios of
tests/test_loader_v3.py (deploy and execute through the programdata
indirection, the Write authority, a broken ELF, Upgrade with its
authority check, the repointing and live-programdata pins, the Write
offset bound), an Upgrade whose new ELF must miss the loaded-program
cache, and the instructions the reference answers with
unknown_instruction (SetAuthority, Close). Status, fee, logs, return
data and every account of the fork equal (exact)."""
import hashlib
import struct

import pytest

from firedancer_tpu.svm import loader as jloader
from firedancer_tpu_torch.pack.cost import BPF_UPGRADEABLE_LOADER_ID
from firedancer_tpu_torch.svm import loader as tloader
from firedancer_tpu_torch.tools import sbpf_family
from test_elf_cpi import RODATA_MSG, _build_elf
from torch_svm_parity import Both, k, txn

LOADER = BPF_UPGRADEABLE_LOADER_ID
PAYER, BUFFER, PROGRAM, PROGDATA = k(1), k(0x21), k(0x22), k(0x23)
EVIL = k(0x66)


def env(slot=50):
    accts = {PAYER: 1 << 30, EVIL: 1 << 30}
    for a in (BUFFER, PROGRAM, PROGDATA, k(0x31), k(0x41), k(0x42),
              k(0x43)):
        accts[a] = dict(lamports=1, owner=LOADER)
    return Both(accts, enforce_rent=False, slot=slot)


def run(b, accts, data, signers=(PAYER,)):
    """One loader instruction over `accts` (signers first in the key
    list), as tests/test_loader_v3.py's `_run` builds it."""
    extra = [a for a in accts if a not in signers] + [LOADER]
    keys = list(signers) + extra
    return b.run(txn(list(signers), extra, [(len(keys) - 1, [
        keys.index(a) for a in accts], data)], n_ro_unsigned=1))


def deploy(b, elf, signer=PAYER, buf=BUFFER, prog=PROGRAM, pd=PROGDATA,
           max_len=None):
    signers = (signer,)
    assert run(b, [buf, signer], tloader.ix_init_buffer(), signers) == "ok"
    mid = len(elf) // 2
    assert run(b, [buf, signer], tloader.ix_write(0, elf[:mid]),
               signers) == "ok"
    assert run(b, [buf, signer], tloader.ix_write(mid, elf[mid:]),
               signers) == "ok"
    return run(b, [prog, pd, buf, signer],
               tloader.ix_deploy(max_len or len(elf)), signers)


def invoke(b, prog=PROGRAM, data=b""):
    return b.result(txn([PAYER], [prog], [(1, [], data)], n_ro_unsigned=1))


def test_encoders_and_parser_match_reference():
    for name in ("BUFFER_META_SZ", "PROGRAMDATA_META_SZ", "IX_INIT_BUFFER",
                 "IX_WRITE", "IX_DEPLOY", "IX_UPGRADE", "IX_SET_AUTHORITY",
                 "IX_CLOSE", "ST_UNINIT", "ST_BUFFER", "ST_PROGRAM",
                 "ST_PROGRAMDATA"):
        assert getattr(tloader, name) == getattr(jloader, name), name
    for fn, args in (("buffer_state", (PAYER,)), ("buffer_state", (None,)),
                     ("program_state", (PROGDATA,)),
                     ("programdata_state", (7, PAYER)),
                     ("programdata_state", (7, None)),
                     ("ix_init_buffer", ()), ("ix_write", (5, b"abc")),
                     ("ix_deploy", (4096,)), ("ix_upgrade", ())):
        data = getattr(tloader, fn)(*args)
        assert data == getattr(jloader, fn)(*args)
        if fn.endswith("_state"):
            assert tloader.parse_state(data + b"elf") == \
                jloader.parse_state(data + b"elf")
    for bad in (b"", b"\x01\x00\x00\x00", b"\x02\x00\x00\x00" + bytes(8),
                b"\x03\x00\x00\x00" + bytes(20), b"\x09\x00\x00\x00"):
        outs = []
        for mod in (jloader, tloader):
            try:
                outs.append(mod.parse_state(bad))
            except ValueError as e:
                outs.append(str(e))
        assert outs[1] == outs[0]


def test_deploy_and_execute():
    b = env()
    elf = _build_elf()
    assert deploy(b, elf) == "ok"
    acct = b.account(PROGRAM)
    assert acct.executable
    st, info = tloader.parse_state(b.account(PROGDATA).data)
    assert info["elf"] == elf and info["slot"] == 50
    status, _, logs, _ = invoke(b)
    assert status == "ok" and any(RODATA_MSG.decode() in ln for ln in logs)


def test_write_requires_buffer_authority():
    b = env()
    assert run(b, [BUFFER, PAYER], tloader.ix_init_buffer()) == "ok"
    assert run(b, [BUFFER, EVIL], tloader.ix_write(0, b"x" * 8),
               signers=(EVIL,)) == "missing_required_signature"


def test_deploy_rejects_broken_elf():
    b = env()
    assert run(b, [BUFFER, PAYER], tloader.ix_init_buffer()) == "ok"
    assert run(b, [BUFFER, PAYER],
               tloader.ix_write(0, b"\x7fELFjunk" * 4)) == "ok"
    assert run(b, [PROGRAM, PROGDATA, BUFFER, PAYER],
               tloader.ix_deploy(64)) == "bad_instruction_data"
    assert not b.account(PROGRAM).executable


def test_upgrade_swaps_elf_and_misses_the_program_cache():
    """The hash program v1 deployed, run, upgraded to v2 (same length, so
    the padded programdata differs only in its ELF), run again: the
    second run is v2's (its log line and version word), so the cache
    keyed by the programdata's digest missed; a wrong authority is
    refused."""
    images = sbpf_family.elfs()
    v1, v2 = images["hash"], images["hash_v2"]
    assert len(v1) == len(v2) and v1 != v2
    b = env()
    assert deploy(b, v1, max_len=4096) == "ok"
    status, _, logs, rdata = invoke(b, data=b"abc")
    assert status == "ok" and "hash v1" in logs
    assert rdata == hashlib.sha256(b"abc").digest()
    buf2 = k(0x31)
    assert run(b, [buf2, PAYER], tloader.ix_init_buffer()) == "ok"
    for off in range(0, len(v2), 700):
        assert run(b, [buf2, PAYER],
                   tloader.ix_write(off, v2[off:off + 700])) == "ok"
    assert run(b, [PROGDATA, PROGRAM, buf2, EVIL], tloader.ix_upgrade(),
               signers=(EVIL,)) == "invalid_account_owner"
    b.set(slot=60)
    assert run(b, [PROGDATA, PROGRAM, buf2, PAYER],
               tloader.ix_upgrade()) == "ok"
    _, info = tloader.parse_state(b.account(PROGDATA).data)
    assert info["slot"] == 60 and info["elf"][:len(v2)] == v2
    status, _, logs, rdata = invoke(b, data=b"abc")
    assert status == "ok" and "hash v2" in logs and "hash v1" not in logs
    assert rdata == hashlib.sha256(b"abc").digest()


def test_upgrade_cannot_repoint_foreign_program():
    b = env()
    assert deploy(b, _build_elf()) == "ok"
    a_pd, a_buf, a_prog = k(0x41), k(0x42), k(0x43)
    assert deploy(b, _build_elf(), signer=EVIL, buf=a_buf, prog=a_prog,
                  pd=a_pd, max_len=4096) == "ok"
    assert run(b, [a_buf, EVIL], tloader.ix_init_buffer(),
               signers=(EVIL,)) == "ok"
    assert run(b, [a_buf, EVIL], tloader.ix_write(0, _build_elf()),
               signers=(EVIL,)) == "ok"
    assert run(b, [a_pd, PROGRAM, a_buf, EVIL], tloader.ix_upgrade(),
               signers=(EVIL,)) == "invalid_account_owner"
    _, info = tloader.parse_state(b.account(PROGRAM).data)
    assert info["programdata"] == PROGDATA


def test_deploy_cannot_overwrite_live_programdata():
    b = env()
    assert deploy(b, _build_elf()) == "ok"
    a_buf, a_prog = k(0x42), k(0x43)
    assert run(b, [a_buf, EVIL], tloader.ix_init_buffer(),
               signers=(EVIL,)) == "ok"
    assert run(b, [a_buf, EVIL], tloader.ix_write(0, _build_elf()),
               signers=(EVIL,)) == "ok"
    assert run(b, [a_prog, PROGDATA, a_buf, EVIL], tloader.ix_deploy(4096),
               signers=(EVIL,)) == "invalid_account_owner"
    _, info = tloader.parse_state(b.account(PROGDATA).data)
    assert info["authority"] == PAYER


def test_write_offset_bounded():
    b = env()
    assert run(b, [BUFFER, PAYER], tloader.ix_init_buffer()) == "ok"
    assert run(b, [BUFFER, PAYER], tloader.ix_write(0xFFFF_FF00, b"x")) \
        == "bad_instruction_data"
    assert len(b.account(BUFFER).data) < 1024


@pytest.mark.parametrize("disc,accts,want", [
    (tloader.IX_SET_AUTHORITY, [PROGDATA, PAYER, k(0x55)],
     "unknown_instruction"),
    (tloader.IX_CLOSE, [BUFFER, k(0x55), PAYER], "unknown_instruction"),
    (9, [BUFFER, PAYER], "unknown_instruction"),
    (tloader.IX_WRITE, [BUFFER, PAYER], "bad_instruction_data"),
    (tloader.IX_DEPLOY, [PROGRAM, PROGDATA], "bad_instruction_data"),
])
def test_other_instructions_match_reference(disc, accts, want):
    """SetAuthority and Close, which the reference's loader does not
    implement, an unknown discriminant, and short instructions."""
    b = env()
    assert deploy(b, _build_elf()) == "ok"
    assert run(b, accts, struct.pack("<I", disc)) == want


def test_upgradeable_program_without_programdata_is_unknown():
    """A loader-v3 executable account whose Program state names no live
    programdata (resolve_program_elf -> None)."""
    b = env()
    b.write(k(0x77), lamports=1, data=tloader.program_state(k(0x78)),
            owner=LOADER, executable=True)
    assert invoke(b, prog=k(0x77))[0] == "unknown_program"
    b.write(k(0x78), lamports=1, data=tloader.buffer_state(PAYER),
            owner=LOADER)
    assert invoke(b, prog=k(0x77))[0] == "unknown_program"
