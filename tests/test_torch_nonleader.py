"""The voting non-leader as the system runs it, on the CPU: the port's
firedancer_tpu_torch/cfg/leader.toml + cfg/cluster.toml (the leader, its
shred tile dropping every fourth slot from turbine) and cfg/nonleader.toml
(sock -> repair -> shred recover -> replay -> tower -> send -> sign),
booted side by side by tools/cluster.py at tests/test_repair_replay.py's
size (24 synth txns, 16 hashes a tick, 4 ticks a slot; a tick every 40
ms), with that test's
asserts (:331-359); every block frame's bank hash equals the JAX
package's ReplayCore over the leader's complete slices (its shred mirror,
tapped and recovered by the JAX package's ShredRecoverCore; replayed
there without its PoH check, which the bank hash does not depend on),
and every vote is a TowerSync signed by the non-leader for a replayed
slot's bank hash. Every wait is on a metric, never on a clock. And the
two TOMLs boot and run together through `app.run --device cpu`, moved
to free ports by an overlay layer each."""
import os
import signal
import socket
import subprocess
import sys
import time

from firedancer_tpu.disco.tiles import _synth_genesis
from firedancer_tpu.tiles import replay as jreplay
from firedancer_tpu.tiles.shred import ShredRecoverCore
from firedancer_tpu_torch.tiles.tower import parse_block
from firedancer_tpu_torch.tools import cluster as tcluster
from tests.test_repair_replay import _CaptureRing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 24
HPT, TICKS = 16, 4
WAIT_S = 300.0
# poh ticks once a housekeeping: at the stem's 10 ms the plain-version
# replay of a loaded CPU falls behind the slots poh makes while the
# leader's verify works through its batches; 40 ms a tick (160 ms slots)
POH_LAZY_NS = 40_000_000


def test_nonleader_repairs_replays_and_votes():
    c = tcluster.Cluster(
        "tnl", "cpu",
        leader_tiles=[{"name": "synth", "count": FRAMES, "unique": FRAMES},
                      {"name": "poh", "hashes_per_tick": HPT,
                       "ticks_per_slot": TICKS, "lazy_ns": POH_LAZY_NS}],
        nonleader_tiles=[{"name": "replay", "hashes_per_tick": HPT}])
    try:
        c.start(boot_timeout_s=WAIT_S)
        a, b = c.a, c.b
        # the leader drops whole slots from turbine...
        c.wait(lambda: a.metrics("shred")["dropped"] > 0, WAIT_S,
               "a dropped slot")
        # ...the non-leader notices the gaps and repairs them from it
        c.wait(lambda: b.metrics("repair")["reqs_sent"] >= 1, WAIT_S,
               "a repair request")
        c.wait(lambda: a.metrics("arepair")["reqs_served"] >= 1, WAIT_S,
               "a served request")
        c.wait(lambda: b.metrics("repair")["resps_in"] >= 1, WAIT_S,
               "a repair response")
        d = c.drain(FRAMES, WAIT_S)
        slots = d["slots"]
        # replay crosses at least two dropped slots (8+ contiguous)
        assert slots >= 8
        c.wait(lambda: b.metrics("tower")["votes_out"] >= 1, WAIT_S,
               "a vote")
        c.wait(lambda: len(c.votes()) >= 1, WAIT_S, "a vote datagram")
        got = c.stop()
    finally:
        c.close()
    la, nb = got["metrics"]["leader"], got["metrics"]["nonleader"]
    r = nb["replay"]
    assert la["bank0"]["txns"] + d["dropped"] == FRAMES
    assert r["slots_replayed"] >= slots and r["poh_fail"] == 0
    assert r["parse_fail"] == 0 and r["exec_fail"] == 0
    assert r["txns"] == la["bank0"]["txns"] > 0
    assert nb["send"]["sign_fail"] == 0 and nb["sign"]["refused"] == 0
    assert nb["repair"]["sign_fail"] == 0
    # a vote frame still in the link at the halt is never sent
    assert 1 <= nb["send"]["sent"] <= nb["tower"]["votes_out"]
    assert la["arepair"]["reqs_served"] >= 1 and la["shred"]["dropped"] > 0
    # the dropped slots reached the non-leader by repair alone: every one
    # below `slots` was replayed
    blocks = [parse_block(f) for f in got["replay_tower"]]
    replayed = {s for s, *_ in blocks}
    assert set(tcluster.dropped_slots(slots)) <= replayed
    # the reference recovers and replays what the leader made, not what
    # the non-leader's turbine and repair brought in
    mirror = _CaptureRing()
    rec = ShredRecoverCore(tcluster.Cluster.leader_identity(), mirror, None)
    for w in got["shreds_mirror"]:
        rec.on_shred(w)
    assert rec.metrics["parse_fail"] == 0
    ref = jreplay.ReplayCore(genesis=_synth_genesis(768),
                             hashes_per_tick=HPT, verify_poh=False)
    for f, _ in mirror.frames:
        ref.on_slice(f)
    assert ref.metrics["txns"] == r["txns"]
    for slot, parent, bid, pid in blocks:
        assert ref.bank_hash_of[slot] == bid, slot
        assert ref.bank_hash_of[parent if slot else -1] == pid, slot
    votes = tcluster.check_votes(c.vote_log, c.nonleader_identity(),
                                 {s: ref.bank_hash_of[s] for s in replayed})
    assert len(votes) == nb["send"]["sent"]


def _overlays(tmp_path):
    """An overlay TOML for each node that moves the TOMLs' fixed ports
    (the non-leader's sock on 9910, the leader's serve-only repair on
    9930, the votes' dest 9920) to free ones, so that two runs on one
    host never contend for a port. -> (non-leader's, leader's)."""
    held = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for _ in range(3)]
    for h in held:
        h.bind(("127.0.0.1", 0))
    sock, rep, vote = (h.getsockname()[1] for h in held)
    for h in held:
        h.close()
    leader = tcluster.Cluster.leader_identity().hex()
    nonleader = tcluster.Cluster.nonleader_identity().hex()
    b = tmp_path / "nonleader-ports.toml"
    b.write_text(f"""
[[tile]]
name = "sock"
port = {sock}

[[tile]]
name = "repair"
peers = [{{ pubkey_hex = "{leader}", addr = "127.0.0.1:{rep}" }}]

[[tile]]
name = "send"
dest = "127.0.0.1:{vote}"
""")
    a = tmp_path / "leader-ports.toml"
    a.write_text(f"""
[[tile]]
name = "shred"
cluster = [
  {{ pubkey_hex = "{nonleader}", stake = 100, addr = "127.0.0.1:{sock}" }},
]

[[tile]]
name = "arepair"
port = {rep}
""")
    return str(b), str(a)


def test_app_run_boots_the_two_node_cluster_on_the_cpu(tmp_path):
    """`app.run cfg/nonleader.toml --device cpu` and `app.run
    cfg/leader.toml cfg/cluster.toml --device cpu` boot and run together,
    each with an overlay of free ports after its TOMLs: the leader runs
    its duration and exits 0; the non-leader receives its shreds, and
    exits 0 on SIGINT."""
    cfg = os.path.join(ROOT, "firedancer_tpu_torch", "cfg")
    b_ports, a_ports = _overlays(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = [sys.executable, "-m", "firedancer_tpu_torch.app.run"]
    b = subprocess.Popen(
        run + [os.path.join(cfg, "nonleader.toml"), b_ports,
               "--device", "cpu",
               "--interval", "1", "--name", f"tnlb{os.getpid()}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        a = subprocess.run(
            run + [os.path.join(cfg, "leader.toml"),
                   os.path.join(cfg, "cluster.toml"), a_ports,
                   "--device", "cpu",
                   "--duration", "3", "--interval", "60",
                   "--name", f"tnla{os.getpid()}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert a.returncode == 0, a.stdout[-2000:] + a.stderr[-2000:]
        for tn in ("shred", "arepair", "sign", "shredsink"):
            assert f"\n{tn} " in a.stdout, tn
    finally:
        time.sleep(1.0)
        b.send_signal(signal.SIGINT)
        out, err = b.communicate(timeout=120)
    assert b.returncode == 0, out[-2000:] + err[-2000:]
    for tn in ("sock", "repair", "shred", "replay", "tower", "send",
               "sign"):
        assert f"\n{tn} " in out, tn
    assert "slots_done=" in out
