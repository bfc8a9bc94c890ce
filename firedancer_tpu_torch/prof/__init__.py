"""fdprof: the whole-topology continuous profiler (copy of the JAX
package's prof/ package less bench_diff.py, the BENCH file diff, which no
path runs).

fdmetrics says WHICH hop saturates, fdtrace says WHEN; fdprof says WHY:
which Python frames, which kernel loads, which device windows take the
time. Three surfaces over one shm and clock discipline:

    recorder.py   [prof] config schema, the per-tile ProfRegion
                  (folded-stack table, timestamped sample ring, capture
                  doorbell), the host Sampler thread
    device.py     torch.profiler capture windows and kernel-load events
                  (verify tile housekeeping), driven by the doorbell
    export.py     merged Perfetto bundle (fdtrace spans, host slices and
                  captured kernels on the utils/tempo clock), folded
                  text, top-k summaries (bench.py's e2e_profile)
    cli.py        `python -m firedancer_tpu_torch.prof`

Disabled-path contract (as fdtrace's): an unprofiled tile's TileCtx.prof
is None, the stem starts no sampler thread and writes no attribution
state; an unprofiled topology pays one attribute check a poll.
"""
from .export import (  # noqa: F401
    folded_text, merged_chrome, profile_summary, read_folded,
    read_samples, summary_text,
)
from .recorder import (  # noqa: F401
    PROF_DEFAULTS, STATE_NAMES, TILE_PROF_KEYS, ProfRegion, ProfState,
    Sampler, effective_prof, normalize_prof, region_for,
)
