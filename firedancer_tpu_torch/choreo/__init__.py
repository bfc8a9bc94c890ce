"""choreo: consensus components (copies of the JAX package's choreo/;
ref: src/choreo/fd_choreo.h:1-12).

tower — TowerBFT vote tower + lockout/threshold/switch checks; the vote
        program's on-chain state (svm/vote.py)
ghost — LMD-GHOST weighted fork choice tree
eqvoc — equivocation (duplicate block/shred) detection
notar — confirmation tracking (propagated / duplicate / optimistic)
hfork — hard-fork (consensus-divergence) detection
voter — direct-offset vote-account accessors
"""
from .eqvoc import EqvocDetector, EquivocationProof, FecMeta  # noqa: F401
from .ghost import Ghost, GhostNode  # noqa: F401
from .hfork import HardFork, HforkDetector  # noqa: F401
from .notar import Confirmation, Notar  # noqa: F401
from .tower import (  # noqa: F401
    MAX_LOCKOUT_HISTORY, SWITCH_RATIO, THRESHOLD_DEPTH, THRESHOLD_RATIO,
    Tower, TowerVote,
)
