"""fdtrace event schema: the binary record vocabulary (copy of the JAX
package's trace/events.py; the ids and names are the schema's ABI, shared
with the reference's readers).

On the card the two device spans keep their names: `tpu_dispatch`
(EV_TPU_DISPATCH) times the verify tile's CUDA launch (the H2D copy, the
kernel launches and the verdicts' D2H copy being queued), and
`tpu_readback` (EV_TPU_READBACK) the wait on the CUDA event recorded after
that copy.
EV_CPU_FALLBACK keeps its id so the reference's rings decode, but no
writer of the port emits it: the port's verify tile never degrades to
the CPU.

One flat u16 event-type space shared by every writer (stem, verify
tile, adapters, supervisor) — the moral equivalent of Chrome's
trace-event categories/phases (the Perfetto timeline model): SPAN
events carry a duration (record.arg = ns, record.ts = END of the
span), INSTANT events mark a point. Frag-scoped events additionally
carry the frag's `sig` (the dedup tag for verify-pipeline traffic), so
one transaction microbatch can be followed across rings by matching
sigs — the cross-tile lineage the exporter turns into Perfetto flow
arrows.

Record wire layout lives in runtime/tango.py::TraceRing; this module
owns only the meaning of the words.
"""
from __future__ import annotations

# -- event types (u16) ------------------------------------------------------

EV_BOOT = 1          # instant: stem entered RUN
EV_HALT = 2          # instant: clean halt path taken
EV_FAIL = 3          # instant: tile raised / external CNC_FAIL observed
EV_WAIT = 4          # span: idle streak waiting on upstream frags
EV_WORK = 5          # span: productive poll_once time (count = frags;
                     #   with sample>1 one record SUMS the last
                     #   `sample` productive polls — attribution stays
                     #   exact, only the record rate is thinned)
EV_HOUSEKEEP = 6     # span: one housekeeping pass
EV_CONSUME = 7       # instant, frag-scoped: frag consumed (sig, link)
EV_PUBLISH = 8       # instant, frag-scoped: frag published (sig, link)
EV_BACKPRESSURE = 9  # span: blocked on downstream credits (link)
EV_TPU_DISPATCH = 10  # span: device dispatch call (count = lanes)
EV_TPU_READBACK = 11  # span: verdict readback wait (count = chunks)
EV_CPU_FALLBACK = 12  # instant: verify degraded to the CPU path
EV_CHAOS = 13        # instant: chaos fault fired (count = action id)
EV_WATCHDOG = 14     # instant: supervisor wedge-watchdog trip (sup-written)
EV_RESTART = 15      # instant: supervisor respawned the tile (sup-written)
EV_DOWN = 16         # instant: supervisor observed abnormal death
EV_SLO = 17          # instant: SLO breach (metric-tile-written;
                     #   arg = measured value, count = target index
                     #   into the plan's [slo] target list)
EV_COMPILE = 18      # instant: jit cache grew — a compile the padding
                     #   discipline should have prevented (fdprof
                     #   CompileWatch; arg = device mem bytes,
                     #   count = total compiled variants)
EV_PROF_CAPTURE = 19  # span: bounded device-trace window (fdprof
                     #   DeviceCapture; count = doorbell req id)
EV_TUNE = 20         # instant: controller knob decision (fdtune;
                     #   arg = new knob value, count = knob index into
                     #   the plan's tune_knobs list, link = the
                     #   saturating hop that justified the move)

NAMES = {
    EV_BOOT: "boot", EV_HALT: "halt", EV_FAIL: "fail",
    EV_WAIT: "wait", EV_WORK: "work", EV_HOUSEKEEP: "housekeep",
    EV_CONSUME: "consume", EV_PUBLISH: "publish",
    EV_BACKPRESSURE: "backpressure",
    EV_TPU_DISPATCH: "tpu_dispatch", EV_TPU_READBACK: "tpu_readback",
    EV_CPU_FALLBACK: "cpu_fallback", EV_CHAOS: "chaos",
    EV_WATCHDOG: "watchdog", EV_RESTART: "restart", EV_DOWN: "down",
    EV_SLO: "slo", EV_COMPILE: "compile",
    EV_PROF_CAPTURE: "prof_capture", EV_TUNE: "tune",
}

# span events: record.ts is the END, record.arg the duration in ns
SPANS = {EV_WAIT, EV_WORK, EV_HOUSEKEEP, EV_BACKPRESSURE,
         EV_TPU_DISPATCH, EV_TPU_READBACK, EV_PROF_CAPTURE}

# frag-scoped events (sig is a lineage key, not 0-means-nothing)
FRAG_EVENTS = {EV_CONSUME, EV_PUBLISH}

# chaos action ids (record.count of an EV_CHAOS event); kept in lockstep
# with utils/chaos.py ACTIONS so a dumped trace names the exact fault
CHAOS_ACTION_IDS = {
    "crash": 1, "freeze_hb": 2, "wedge": 3, "stall_fseq": 4,
    "fail_dispatch": 5,
    # adversarial traffic plans (r14): injected hostile TRAFFIC, not
    # infrastructure faults — recorded before the frames flow so a
    # black-box dump names the attack even when the tile died mid-flood
    "flood_forged": 6, "flood_torsion": 7, "flood_dup": 8,
    "flood_malformed_quic": 9, "flood_crds_spam": 10,
    # snapshot/replay robustness drills (r17): the catch-up surface's
    # seeded faults — adapter-routed, recorded before the fault fires
    "crash_mid_snapshot": 11, "corrupt_checkpt_frame": 12,
    "stale_snapshot_offer": 13, "diverge_block": 14,
}
CHAOS_ACTION_NAMES = {v: k for k, v in CHAOS_ACTION_IDS.items()}


def decode(rec, link_names: list[str] | None = None) -> dict:
    """One raw (4,) u64 record -> a plain dict (the export/JSON shape).
    link_names is the plan's sorted link-name list; an out-of-range id
    (TRACE_LINK_NONE, or a torn record) decodes to link=None."""
    from ..runtime.tango import TRACE_LINK_NONE
    ts, sig, arg, meta = (int(rec[0]), int(rec[1]), int(rec[2]),
                          int(rec[3]))
    etype = meta & 0xFFFF
    link_id = (meta >> 16) & 0xFFFF
    count = meta >> 32
    link = None
    if link_names is not None and link_id != TRACE_LINK_NONE \
            and link_id < len(link_names):
        link = link_names[link_id]
    return {"ts": ts, "ev": NAMES.get(etype, f"?{etype}"),
            "etype": etype, "sig": sig, "arg": arg, "link": link,
            "count": count}
