"""disco: the tile layer copied from the JAX package: topology
model and build, stem run loop, process launcher/supervisor, metrics and
monitor (ref: src/disco/topo/fd_topo.h:36-684, src/disco/stem/
fd_stem.c:1-168)."""
from .topo import Topology  # noqa: F401
from .stem import Stem  # noqa: F401
from .launch import TopologyRunner, tile_main  # noqa: F401
