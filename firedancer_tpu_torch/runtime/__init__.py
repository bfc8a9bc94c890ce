"""Host runtime: ctypes bindings to the port's native tango layer."""
from .tango import (  # noqa: F401
    Workspace, Ring, Fseq, Cnc, Tcache, Store, TraceRing, KnobMailbox, lib,
    CNC_BOOT, CNC_RUN, CNC_HALT, CNC_FAIL, FSEQ_STALE, TRACE_LINK_NONE,
    TUNE_HDR_U64, TUNE_SLOT_U64,
)
