"""fdtrace: the shared-memory flight recorder (copy of the JAX package's
trace/ package; the port's shm names are `fdtt_`).

Counters (disco/metrics.py) say THAT a link stalled; the flight
recorder says WHICH frag stalled it and where the microseconds went
between verify dispatch and bank commit. Each traced tile owns a
fixed-depth binary event ring in the workspace (runtime/tango.py
TraceRing, carved by disco/topo.py next to the metric slots), written
by cheap hooks in the stem run loop and the verify tile, with frag
lineage carried through the existing sig/seq discipline — one
transaction microbatch is followable synth -> verify -> dedup -> sink
across rings.

Layout of the package:

    events.py     the event-type vocabulary + record decode
    recorder.py   [trace] config schema, TraceWriter, plan helpers
    export.py     rings -> Perfetto/Chrome JSON, text summary,
                  supervisor black-box dumps
    cli.py        `python -m firedancer_tpu_torch.trace`

Disabled-path contract: an untraced tile's TileCtx.trace is None and
every hook is a single cached-attribute None check — untraced
topologies pay nothing per frag.
"""
from . import events  # noqa: F401
from .export import (  # noqa: F401
    blackbox_path, dump_blackbox, lineage, read_rings, summary,
    to_chrome,
)
from .recorder import (  # noqa: F401
    TILE_TRACE_KEYS, TRACE_DEFAULTS, TraceWriter, chaos_event,
    effective_trace, link_ids, link_names, normalize_trace, writer_for,
)
