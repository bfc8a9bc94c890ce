"""repair: block recovery — forest ancestry tracking + request policy
(copies of the JAX package's repair/; ref: src/discof/forest/,
src/discof/repair/)."""
from .forest import Forest, ForestBlk  # noqa: F401
from .policy import (  # noqa: F401
    DISC_ANCESTOR_HASHES, DISC_HIGHEST_WINDOW, DISC_ORPHAN,
    DISC_WINDOW_INDEX, RepairPolicy, pack_request, parse_request,
)
