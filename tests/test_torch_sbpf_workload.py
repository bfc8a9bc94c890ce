"""The general workload's sBPF family (firedancer_tpu_torch/tools/
sbpf_family.py) on the CPU: the whole workload at a small size through
`general_exec.PlainBank` (bank0's exec="general" path in process, device
"cpu") in microblocks at their slots, held to the family's own
arithmetic (`SbpfOracle.check`, as chip_smoke.py 23a holds bank0's
store): the vault PDAs', escrows' and recipients' lamports, the
programdata of the deployed and upgraded programs byte for byte, the
consumed buffers, each txn's status, return data and log; the compute
units and host time a program; a tampered store fails the check; and
the door run's groups cut after the deploy sequence's slots."""
import struct

import pytest

from firedancer_tpu_torch.tools import general_exec as gx
from firedancer_tpu_torch.tools import sbpf_family as sf


@pytest.fixture(scope="module")
def fed(tmp_path_factory):
    wl = gx.build(8, 8, tables=2, table_addrs=8, scale=0.1)
    genesis = gx.write_genesis(
        wl, str(tmp_path_factory.mktemp("sbpf") / "genesis.ckpt"))
    bank = gx.PlainBank(genesis, 64, wl.family())
    frames = []
    for s in range(sf.SLOTS):
        txns = [p for slot, p, _ in wl.traffic if slot == s]
        for i in range(0, len(txns), 16):
            grp = txns[i:i + 16]
            frames.append(struct.pack("<HHQQ", 0, len(grp), len(frames),
                                      10 + s)
                          + b"".join(struct.pack("<H", len(t)) + t
                                     for t in grp))
    m = bank.feed(frames)
    return wl, bank, m


def test_plain_bank_holds_the_arithmetic(fed):
    wl, bank, m = fed
    assert m["exec_fail"] == wl.designed_fail
    out = wl.sbpf.check(gx.root_state(bank.bank.funk), bank.results)
    st = out["statuses"]
    assert st["loader:ok"] == 8 and st["loader:unknown_instruction"] == 2
    assert st["loader:bad_instruction_data"] == 1
    assert st["spin:program_failed"] == 1
    assert st["vault:invalid_account_owner"] == 1
    assert st["vault:sum_of_lamports_changed"] == 1
    assert sum(st.values()) == len(wl.sbpf.expect)
    assert 10 <= out["hash2_slot"] < 10 + sf.SLOTS


def test_host_costs_by_program(fed):
    wl, bank, _ = fed
    costs = wl.sbpf.host_costs(bank.results, bank.ns)
    assert set(costs) == {"vault", "hash", "spin", "curve"}
    for prog, c in costs.items():
        assert c["txns"] > 0 and c["cu"] > 0 and c["us_per_cu"] > 0, prog
    # the spin's meter: five instructions an iteration, the log's 100
    spins = [(p, w) for p, w in wl.sbpf.expect.items()
             if w["program"] == "spin" and w["status"] == "ok"]
    for p, w in spins:
        count = int(w["log"].split()[0], 16)
        assert 5 * count + 100 < bank.results[p][3] < 5 * count + 150


@pytest.mark.parametrize("what", ["lamports", "programdata", "buffer",
                                  "status", "return_data"])
def test_oracle_catches_a_tampered_run(fed, what):
    wl, bank, _ = fed
    state = gx.root_state(bank.bank.funk)
    results = dict(bank.results)
    o = wl.sbpf
    if what == "lamports":
        key = next(iter(o.lamports))
        lam, *rest = state[key]
        state[key] = (lam + 1, *rest)
    elif what == "programdata":
        key = o.programdata["hash2"]
        lam, data, *rest = state[key]
        state[key] = (lam, data[:-1] + b"\x01", *rest)
    elif what == "buffer":
        key = o.buffers["deploy"]
        lam, data, *rest = state[key]
        state[key] = (lam, b"\x01\x00\x00\x00", *rest)
    else:
        p = next(p for p, w in o.expect.items() if "return_data" in w)
        status, rdata, logs, cu = results[p]
        results[p] = ("program_failed", rdata, logs, cu) \
            if what == "status" else (status, rdata[::-1], logs, cu)
    with pytest.raises(AssertionError):
        o.check(state, results)


def test_door_groups_cut_after_the_sequence_slots(fed):
    wl, _, _ = fed
    groups = gx._groups(wl)
    assert len(groups) == len(sf.BARRIERS) + 1
    assert [p for g in groups for p in g] == [p for _, p, _ in wl.traffic]
    slot_of = {p: s for s, p, _ in wl.traffic}
    for i, g in enumerate(groups[:-1]):
        assert {slot_of[p] for p in g} == {sf.BARRIERS[i]}
    assert {slot_of[p] for p in groups[-1]} == set(range(4, sf.SLOTS))
