"""App layer: layered TOML config + run command (copy of the JAX
package's app/, ref: src/app/fdctl/main.c,
src/app/shared/commands/run/run.c)."""
from .config import build_topology, load_config

__all__ = ["build_topology", "load_config"]
