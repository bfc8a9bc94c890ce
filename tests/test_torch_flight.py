"""The port's fdflight (firedancer_tpu_torch.flight and `monitor
--archive`) against the JAX package's on the same inputs: frames byte
for byte, archives written by either package read by the other's
reader to the same frames, rotation and retention, the torn tail after
a kill, the query helpers and the CLI's output, the monitor's archive
replay, and the recorder tile on a port topology: the archive equal to
the live metrics (read after the halt), and an SLO-breach incident
bundle that survives SIGKILL of every tile.

Every wait has a timeout, and every runner is halted and closed."""
import json
import os
import signal
import time

import pytest

from firedancer_tpu import flight as jflight
from firedancer_tpu.disco import monitor as jmonitor
from firedancer_tpu.flight import archive as jarchive
from firedancer_tpu.flight import cli as jcli
from firedancer_tpu.flight import codec as jcodec
from firedancer_tpu_torch import flight as tflight
from firedancer_tpu_torch.disco import Topology, TopologyRunner
from firedancer_tpu_torch.disco import monitor as tmonitor
from firedancer_tpu_torch.flight import archive as tarchive
from firedancer_tpu_torch.flight import cli as tcli
from firedancer_tpu_torch.flight import codec as tcodec
from firedancer_tpu_torch.flight.codec import (FRAME_SZ, KIND_HIST,
                                               KIND_LINK, KIND_MARK,
                                               KIND_METRIC, KIND_PROF,
                                               KIND_SLO, KIND_TRACE)

FIELDS = [(KIND_METRIC, 123_456_789, 7, "verify", "rx", -42, 1),
          (KIND_LINK, 5, 0, "a_b", "backpressure", 9, 0),
          (KIND_HIST, 1 << 63, 65535, "dedup", "work_p99_ns", 10 ** 9, 1),
          (KIND_SLO, 7, 1, "ingest-backpressure", "breach", 4426, 3),
          (KIND_TRACE, 8, 2, "controller", "tune", 300, 20 | 4 << 16),
          (KIND_PROF, 9, 3, "tile_with_longéname", "m" * 40, 1, 0),
          (KIND_MARK, 10, 4, "tunedemo", "halt", 1234, 0),
          (99, -1, 1 << 17, "", "", (1 << 64) + 5, 1 << 33)]


@pytest.mark.parametrize("fields", FIELDS, ids=range(len(FIELDS)))
def test_frames_are_the_references_byte_for_byte(fields):
    kind, ts, node, source, name, value, aux = fields
    got = tcodec.encode_frame(kind, ts, node, source, name, value, aux)
    want = jcodec.encode_frame(kind, ts, node, source, name, value, aux)
    assert got == want and len(got) == FRAME_SZ
    assert tcodec.decode_frame(want) == jcodec.decode_frame(got)
    assert tcodec.decode_frame(got[:FRAME_SZ - 1]) is None
    bad = got[:20] + bytes([got[20] ^ 0x5A]) + got[21:]
    assert tcodec.decode_frame(bad) is None is jcodec.decode_frame(bad)


def test_decode_frames_counts_torn_slots_as_the_reference():
    good = b"".join(tcodec.encode_frame(*f) for f in FIELDS[:3])
    for buf in (good + b"\xde\xad\xbe", good[:FRAME_SZ] + bytes(FRAME_SZ)
                + good[FRAME_SZ:], b"", bytes(3 * FRAME_SZ)):
        assert tcodec.decode_frames(buf) == jcodec.decode_frames(buf)


FLIGHT_OK = [{"dir": "/tmp/x"}, {"dir": "/tmp/y", "hz": 1000,
                                 "sources": ["links", "trace"]},
             {"dir": "d", "segment_mb": 1, "retain_mb": 1, "node_id": 65535,
              "incident_window_s": 0}]
FLIGHT_BAD = [{"segmnt_mb": 4.0}, {"hz": 0}, {"hz": 2000},
              {"segment_mb": 8.0, "retain_mb": 1.0}, {"dir": ""},
              {"node_id": 1 << 16}, {"sources": ["linkz"]},
              {"sources": "links"}, [], {"incident_window_s": -1}]


@pytest.mark.parametrize("spec", FLIGHT_OK, ids=range(len(FLIGHT_OK)))
def test_normalize_flight_equals_the_reference(spec):
    assert tflight.normalize_flight(spec) == jflight.normalize_flight(spec)
    got = tflight.effective_sources(tflight.normalize_flight(spec))
    assert got == jflight.effective_sources(jflight.normalize_flight(spec))
    # the default archive directory follows the port's prefix
    dflt = tflight.normalize_flight(None)
    assert dflt["dir"] == "/tmp/fdtt-flight/default"
    assert {**dflt, "dir": None} == \
        {**jflight.normalize_flight(None), "dir": None}


@pytest.mark.parametrize("spec", FLIGHT_BAD, ids=range(len(FLIGHT_BAD)))
def test_normalize_flight_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError) as want:
        jflight.normalize_flight(spec)
    with pytest.raises(ValueError) as got:
        tflight.normalize_flight(spec)
    assert str(got.value) == str(want.value)


def _write(mod, d, n=200, **kw):
    w = mod.ArchiveWriter(d, **kw)
    for i in range(n):
        f = FIELDS[i % 7]
        w.append(f[0], 1000 + i, f[3], f[4], f[5] + i, f[6])
    w.close()
    return w


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_archives_read_across_packages(tmp_path, writer):
    """An archive either package writes reads to the same frames through
    both readers, rotation and retention included."""
    mods = {"port": tarchive, "ref": jarchive}
    d = str(tmp_path / "arch")
    w = _write(mods[writer], d, segment_mb=0.001, retain_mb=0.002,
               node_id=3)
    assert w.frames == 200 and w.rotations > 5 and w.aged_out > 0
    got, want = tarchive.read_frames(d), jarchive.read_frames(d)
    assert got == want and got[1] == 0
    frames = got[0]
    assert 0 < len(frames) < 200 and frames[-1]["ts"] == 1199
    assert all(f["node"] == 3 for f in frames)
    assert tarchive.read_frames(d, 1100, 1150, {KIND_LINK}) == \
        jarchive.read_frames(d, 1100, 1150, {KIND_LINK})
    for fn in ("window_summary", "saturating_hop", "sources_index"):
        assert getattr(tarchive, fn)(frames) == \
            getattr(jarchive, fn)(frames)
    s = tarchive.series(frames, "a_b", "backpressure")
    assert s == jarchive.series(frames, "a_b", "backpressure")
    assert tarchive.cumulative(s) == jarchive.cumulative(s)
    # the same writes through each package's writer: same frames
    d2 = str(tmp_path / "other")
    _write(mods["ref" if writer == "port" else "port"], d2,
           segment_mb=0.001, retain_mb=0.002, node_id=3)
    assert tarchive.read_frames(d2) == got
    segs = sorted(p for p in os.listdir(d) if p.endswith(".fdf"))
    assert 0 < len(segs) <= 4


def test_retention_and_the_torn_tail_after_a_kill(tmp_path):
    d = str(tmp_path / "arch")
    w = tarchive.ArchiveWriter(d, segment_mb=0.001, retain_mb=0.001)
    for i in range(40):
        w.append(KIND_METRIC, i, "t", "m", 1)
    w.flush()
    assert tarchive.read_frames(d)[0][-1]["ts"] == 39  # active segment kept
    seg = w._f.name
    w.close()
    with open(seg, "ab") as f:     # the killed writer's partial frame
        f.write(tcodec.encode_frame(KIND_METRIC, 99, 0, "t", "m", 1)[:17])
    got, want = tarchive.read_frames(d), jarchive.read_frames(d)
    assert got == want and got[1] == 1
    assert all(f["ts"] != 99 for f in got[0])
    path = str(tmp_path / "inc.json")
    tarchive.write_atomic_json(path, {"ok": 1})
    assert json.load(open(path)) == {"ok": 1}
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def _synthetic_archive(d: str):
    w = tarchive.ArchiveWriter(d, node_id=3)
    t0 = 1_000_000_000
    w.append(KIND_MARK, t0, "demo", "boot", 1)
    w.append(KIND_METRIC, t0 + 100, "sink", "rx", 5)
    w.append(KIND_LINK, t0 + 100, "a_b", "backpressure", 2)
    w.append(KIND_METRIC, t0 + 200, "sink", "rx", 7)
    w.append(KIND_METRIC, t0 + 200, "sink", "depth", 4, aux=1)
    w.append(KIND_SLO, t0 + 250, "lat", "breach", 9, 1)
    w.append(KIND_MARK, t0 + 300, "demo", "halt", 1)
    w.close()
    tarchive.write_atomic_json(os.path.join(d, "incident-1.json"), {
        "target": "lat", "value": 9, "saturating_hop": "a_b",
        "frames": [], "chrome": {"traceEvents": [{"ph": "i"}]}})
    return t0


def test_cli_output_equals_the_reference(tmp_path, capsys):
    """summary, slice, series, kind filters, incidents and diff print the
    reference's output on one archive."""
    d = str(tmp_path / "arch")
    t0 = _synthetic_archive(d)
    cases = [[d], [d, "--since", str(t0 + 150), "--ndjson"],
             [d, "--series", "sink.rx", "--cumulative"],
             [d, "--series", "sink.rx"], [d, "--kind", "slo", "--csv"],
             [d, "--kind", "mark", "--kind", "link", "--ndjson"],
             [d, "--incident"], [d, "--incident", "incident-1"],
             [d, "diff", f"{t0}:{t0 + 150}", f"{t0 + 150}:{t0 + 300}"]]
    for argv in cases:
        assert tcli.main(argv) == 0
        got = capsys.readouterr().out
        assert jcli.main(argv) == 0
        assert got == capsys.readouterr().out, argv
    assert tcli.main(["summary", d]) == 0          # the named default
    assert "7 frames" in capsys.readouterr().out
    out = str(tmp_path / "chrome.json")
    assert tcli.main([d, "--incident", "incident-1", "--out", out]) == 0
    assert json.load(open(out))["traceEvents"]
    with pytest.raises(SystemExit):
        tcli.main([d, "--kind", "nosuch"])


def test_monitor_archive_equals_the_reference(tmp_path, capsys):
    d = str(tmp_path / "arch")
    t0 = _synthetic_archive(d)
    docs = tmonitor.archive_snapshots(d)
    assert docs == jmonitor.archive_snapshots(d)
    assert [x["tiles"]["sink"]["rx"] for x in docs] == [5, 12]
    assert tmonitor.archive_snapshots(d, since_ns=t0 + 100) == \
        jmonitor.archive_snapshots(d, since_ns=t0 + 100)
    assert tmonitor.main(["--archive", d, "--since", str(t0)]) == 0
    got = capsys.readouterr().out
    assert jmonitor.main(["--archive", d, "--since", str(t0)]) == 0
    assert got == capsys.readouterr().out
    assert [json.loads(ln)["ts"] for ln in got.splitlines()] == \
        [t0 + 100, t0 + 200]


def test_recorder_archive_equals_live_metrics(tmp_path):
    """Counters ride as deltas from zero, so the archive re-integrated is
    the live value exactly; the live value is read after the halt (the
    halt path's final drain), and the archive holds the run's marks."""
    d = str(tmp_path / "arch")
    count = 900
    topo = (Topology(f"ttfleq{os.getpid()}", wksp_size=1 << 22,
                     flight={"dir": d, "hz": 100.0, "node_id": 5,
                             "incident_window_s": 0.0})
            .link("a_b", depth=64, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=count, unique=32,
                  burst=16)
            .tile("b", "sink", ins=["a_b"])
            .tile("flight", "flight"))
    runner = TopologyRunner(topo.build()).start()
    try:
        runner.wait_running(timeout_s=120)
        runner.wait_idle("b", "rx", count, timeout_s=120)
        runner.wait_idle("flight", "drains", 2, timeout_s=60)
        runner.halt(tiles=["a", "b"])
        runner.halt()
        assert all(p.exitcode == 0 for p in runner.procs.values())
        live_rx = runner.metrics("b")["rx"]
        live_tx = runner.metrics("a")["tx"]
    finally:
        runner.halt()
        runner.close()
    frames, dropped = tarchive.read_frames(d)
    assert (frames, dropped) == jarchive.read_frames(d)
    assert dropped == 0 and all(f["node"] == 5 for f in frames)

    def total(src, name):
        return sum(f["value"] for f in frames if f["kind"] == KIND_METRIC
                   and f["source"] == src and f["name"] == name)
    assert total("b", "rx") == live_rx == count
    assert total("a", "tx") == live_tx == count
    marks = [f["name"] for f in frames if f["kind"] == KIND_MARK]
    assert marks[0] == "boot" and marks[-1] == "halt"
    assert {f["source"] for f in frames if f["kind"] == KIND_LINK} == {"a_b"}


def test_slo_breach_incident_survives_sigkill(tmp_path):
    """stall_fseq chaos on the sink drives an SLO breach; the flight tile
    seals a self-contained incident bundle; every tile is then
    SIGKILLed, and the bundle still lists, loads and exports its chrome
    trace through the CLI, from disk alone."""
    from firedancer_tpu_torch.disco.slo import slo_dump_path
    d = str(tmp_path / "arch")
    name = f"ttflinc{os.getpid()}"
    topo = (Topology(name, wksp_size=1 << 22,
                     trace={"enable": True, "depth": 1024, "sample": 1},
                     slo={"fast_window_s": 0.5, "slow_window_s": 10.0,
                          "target": [{"name": "sink-bp",
                                      "expr": "link.a_b.backpressure "
                                              "rate < 5/s"}]},
                     flight={"dir": d, "hz": 50.0,
                             "incident_window_s": 0.5})
            .link("a_b", depth=32, mtu=256)
            .tile("a", "synth", outs=["a_b"], count=1_000_000, unique=16,
                  burst=8)
            .tile("b", "sink", ins=["a_b"],
                  chaos={"events": [{"action": "stall_fseq", "at_rx": 8}]})
            .tile("metric", "metric", port=0)
            .tile("flight", "flight"))
    runner = TopologyRunner(topo.build()).start()
    sealed = None
    try:
        runner.wait_running(timeout_s=120)
        deadline = time.time() + 60
        while sealed is None and time.time() < deadline:
            runner.check_failures()
            incs = tarchive.incident_paths(d)
            sealed = incs[0] if incs else None
            time.sleep(0.05)
        assert sealed, (runner.metrics("metric"), runner.metrics("flight"))
        for p in runner.procs.values():
            if p.pid and p.is_alive():
                os.kill(p.pid, signal.SIGKILL)
        time.sleep(0.2)
    finally:
        runner.halt(join_timeout_s=5)
        runner.close()
        try:
            os.unlink(slo_dump_path(name, "sink-bp"))
        except OSError:
            pass
    doc = json.load(open(sealed))
    assert doc["target"] == "sink-bp" and doc["value"] > 0
    assert doc["slo_dump"]["kind"] == "breach"
    assert doc["saturating_hop"] == "a_b"
    bp = [f for f in doc["frames"] if f["kind"] == KIND_LINK
          and f["name"] == "backpressure"]
    assert bp and sum(f["value"] for f in bp) > 0
    assert any(f["kind"] == KIND_TRACE for f in doc["frames"])
    out = str(tmp_path / "incident.chrome.json")
    assert tcli.main([d, "--incident", os.path.basename(sealed),
                      "--out", out]) == 0
    assert json.load(open(out))["traceEvents"]
    # both readers take the killed archive the same way, torn tail and all
    frames, dropped = tarchive.read_frames(d)
    assert (frames, dropped) == jarchive.read_frames(d)
    assert any(f["kind"] == KIND_SLO and f["name"] == "breach"
               for f in frames)
