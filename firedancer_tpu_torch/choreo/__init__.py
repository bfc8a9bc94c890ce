"""choreo: consensus components (copies of the JAX package's
choreo/ghost.py and choreo/tower.py; ref: src/choreo/fd_choreo.h:1-12).

tower — TowerBFT vote tower + lockout/threshold/switch checks; the vote
        program's on-chain state (svm/vote.py)
ghost — LMD-GHOST weighted fork choice tree

The reference's eqvoc, notar, hfork and voter come with the tower tile
(ROADMAP.md queue A item 13), which reuses these two.
"""
from .ghost import Ghost, GhostNode  # noqa: F401
from .tower import (  # noqa: F401
    MAX_LOCKOUT_HISTORY, SWITCH_RATIO, THRESHOLD_DEPTH, THRESHOLD_RATIO,
    Tower, TowerVote,
)
