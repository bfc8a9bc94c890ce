"""gossip: CRDS store + push/pull/prune protocol logic (copy of the JAX
package's gossip/, with gossvf on the port's kernels;
ref: src/flamenco/gossip/)."""
from .active_set import ActiveSet, PruneFinder  # noqa: F401
from .bloom import Bloom  # noqa: F401
from .crds import (  # noqa: F401
    KIND_CONTACT_INFO, KIND_DUPLICATE_SHRED, KIND_EPOCH_SLOTS, KIND_LOWEST_SLOT,
    KIND_SNAPSHOT_HASHES, KIND_VOTE, CrdsStore, CrdsValue,
)
from .protocol import GossipNode  # noqa: F401
