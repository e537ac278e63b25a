"""Ownership, home nodes, and location caches (paper §B.1.1, §B.2.3);
the twin of `repro/core/ownership.py`.

Every key has a statically assigned *home node* (hash partitioning) that is
the routing fallback: it always knows the current *owner* (the node holding
the primary copy).  Nodes route messages with *location caches* (last known
owner); a message routed to a stale owner is forwarded to the current owner
via the home node (extra hop), exactly as in Lapse.

The state itself lives in vectorized arrays in `core.engine.OwnerTable`;
this module keeps the seed's scalar `OwnershipDirectory` API as a thin
adapter over it for tests and per-key callers."""

from __future__ import annotations

import numpy as np

from .engine import OwnerTable, home_nodes  # noqa: F401  (re-exported)

_FIB = 11400714819323198485


def home_node(key: int, n_nodes: int) -> int:
    """Static hash partitioning of keys to home nodes (Fibonacci hashing —
    cheap, well-spread for dense integer key ranges).  The vectorized
    `engine.home_nodes` matches this exactly."""
    return ((key * _FIB) >> 32) % n_nodes


class OwnershipDirectory:
    """Global ownership state, as distributedly known — scalar adapter over
    `engine.OwnerTable`.

    The owner array is ground truth (the home node always tracks it —
    location updates are piggybacked on sync messages); per-node caches hold
    each node's last known owner.  ``route(n, k)`` returns the number of
    hops a message from node n to key k's owner takes (1 = direct, 2/3 = via
    stale cache or home forward), charging the realistic cost of the
    Lapse-style protocol.
    """

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self.table = OwnerTable(n_nodes)

    def owner_of(self, key: int) -> int:
        return self.table.owner_of(key)

    def route(self, src: int, key: int, update_cache: bool = True) -> int:
        """Hops for a message src -> current owner of ``key``: direct if the
        location cache (or home-node identity) is correct; otherwise the
        stale target forwards via the home node.  Responses carry the
        owner's identity, refreshing the cache."""
        self.table.ensure_capacity(key + 1)
        return int(self.table.route_batch(
            src, np.array([key], np.int64), update_cache)[0])

    def relocate(self, key: int, new_owner: int) -> None:
        """Transfer ownership.  The old owner informs the home node
        (piggybacked); caches of other nodes go stale silently."""
        self.table.ensure_capacity(key + 1)
        self.table.relocate_batch(np.array([key], np.int64),
                                  np.array([new_owner], np.int64))
