"""The intent engine's pieces the serving path uses (paper §4.1).

`StreamingIntentBuffer` holds the open-ended intent of queued serving
requests; `concurrent_intent` and `intent_miss_bound` are the window
classifiers the planner (`pm.planner.IntentPlanner`) routes its placement
decisions through: concurrent intent on >= 2 nodes -> replicate,
single-node intent -> owner path, and the exact per-step miss bound that
sizes the compact miss buffer.  The discrete-event simulator engine is not
part of this package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class StreamingIntentBuffer:
    """Streaming intent for the online serving runtime (DESIGN.md §9).

    Training intent arrives in fixed windows (the loader signals step
    ``s`` for clock ``[s, s+1)``); serving intent *streams*: a request's
    key set is known the moment it is enqueued, and the intent stays live
    until the request is served.  This buffer is the SoA store for those
    open-ended windows — ``ingest`` on enqueue, ``expire`` on serve — and
    ``snapshot`` projects the live intent onto the scheduler's logical
    clock so the window classifiers above (`concurrent_intent`,
    `intent_miss_bound`) apply unchanged: a queued request at position
    ``p`` runs in micro-batch ``p // batch_size`` (the clock tick) at slot
    ``p % batch_size`` (the "node" — concurrent intent from >= 2 requests
    in one batch -> replicate, §4.1).
    """

    __slots__ = ("key", "req", "n")

    def __init__(self, cap: int = 256):
        self.key = np.empty(cap, np.int64)
        self.req = np.empty(cap, np.int64)
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def _grow(self, need: int) -> None:
        cap = len(self.key)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("key", "req"):
            old = getattr(self, name)
            new = np.empty(cap, old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def ingest(self, req_id: int, keys) -> None:
        """Signal: request ``req_id`` will touch ``keys`` when scheduled."""
        keys = np.atleast_1d(np.asarray(keys, np.int64))
        self.ingest_batch(np.full(len(keys), req_id, np.int64), keys)

    def ingest_batch(self, req_ids: np.ndarray, keys: np.ndarray) -> None:
        """Vectorized ingest: ``req_ids[i]`` will touch ``keys[i]`` —
        one append for a whole admission wave instead of a Python loop
        per request (the enqueue path is on the serving hot path)."""
        keys = np.asarray(keys, np.int64)
        m = len(keys)
        if m == 0:
            return
        self._grow(self.n + m)
        self.key[self.n: self.n + m] = keys
        self.req[self.n: self.n + m] = np.asarray(req_ids, np.int64)
        self.n += m

    def expire(self, req_ids) -> None:
        """Serving a request expires its intent (the §4.1 expiry arm:
        replicas for keys nobody still wants fall out at the next plan)."""
        req_ids = np.atleast_1d(np.asarray(req_ids, np.int64))
        if len(req_ids) == 0 or self.n == 0:
            return
        keep = ~np.isin(self.req[: self.n], req_ids)
        m = int(keep.sum())
        self.key[:m] = self.key[: self.n][keep]
        self.req[:m] = self.req[: self.n][keep]
        self.n = m

    def snapshot(self, order: np.ndarray, batch_size: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Project live intent onto the queue order: ``order`` is the
        queued request ids front-to-back.  Returns (keys, slots, ticks)
        for the window classifiers.  Intent of in-flight requests (popped
        but not yet served/expired) is not in ``order`` and is dropped
        from the snapshot — their future is the executing batch."""
        z = np.zeros(0, np.int64)
        order = np.asarray(order, np.int64)
        if self.n == 0 or len(order) == 0:
            return z, z, z
        key, req = self.key[: self.n], self.req[: self.n]
        sidx = np.argsort(order, kind="stable")
        j = np.searchsorted(order[sidx], req)
        j = np.clip(j, 0, len(order) - 1)
        pos = sidx[j]
        queued = order[pos] == req
        pos = pos[queued]
        return (key[queued],
                pos % batch_size,
                pos // batch_size)


def concurrent_intent(keys: np.ndarray, nodes: np.ndarray,
                      clocks: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Window classification for the planner: intent i says ``nodes[i]``
    accesses ``keys[i]`` at clock ``clocks[i]``.  Per clock tick, a key with
    intent from >= 2 nodes is *concurrent* (-> replicate, weighted by the
    node count, summed over ticks); single-node keys stay on the owner path
    (§4.1).  Returns (uniq_keys, replicate_weight, single_count)."""
    keys = np.asarray(keys, np.int64)
    nodes = np.asarray(nodes, np.int64)
    clocks = np.asarray(clocks, np.int64)
    uniq = np.unique(keys)
    if len(keys) == 0:
        z = np.zeros(0, np.int64)
        return uniq, z, z
    kidx = np.searchsorted(uniq, keys)
    # dedupe (clock, key, node), then count nodes per (clock, key)
    trip = (clocks * len(uniq) + kidx) * np.int64(nodes.max() + 1) + nodes
    _, first = np.unique(trip, return_index=True)
    pair = clocks[first] * len(uniq) + kidx[first]
    pairs, counts = np.unique(pair, return_counts=True)
    pair_key = (pairs % len(uniq)).astype(np.int64)
    multi = counts >= 2
    weight = np.bincount(pair_key[multi], weights=counts[multi],
                         minlength=len(uniq)).astype(np.int64)
    single = np.bincount(pair_key[~multi], minlength=len(uniq))
    return uniq, weight, single.astype(np.int64)


def intent_miss_bound(keys: np.ndarray, nodes: np.ndarray,
                      clocks: np.ndarray, cached: np.ndarray, *,
                      per_node: bool = True) -> int:
    """Exact worst cache-miss count over a window — the planner's static
    miss-buffer bound out of dynamic intent knowledge.

    ``per_node=True`` (simulator semantics) counts per (clock, node): each
    node serves its own misses.  ``per_node=False`` counts *unique* missed
    keys per clock across all nodes — the bound for a lookup that
    deduplicates misses over the whole step's batch (the SPMD managed
    embedding compacts one buffer per step, so a key missed by several
    shards occupies one slot)."""
    keys = np.asarray(keys, np.int64)
    if len(keys) == 0:
        return 0
    miss = ~np.isin(keys, cached)
    if not np.any(miss):
        return 0
    clocks = np.asarray(clocks, np.int64)
    if per_node:
        group = clocks * (np.int64(np.max(nodes)) + 1) \
            + np.asarray(nodes, np.int64)
        _, cnt = np.unique(group[miss], return_counts=True)
        return int(cnt.max())
    # unique (clock, key) pairs, then the worst per-clock unique count
    pair = clocks[miss] * (np.int64(np.max(keys)) + 1) + keys[miss]
    uniq_pair = np.unique(pair)
    _, cnt = np.unique(uniq_pair // (np.int64(np.max(keys)) + 1),
                       return_counts=True)
    return int(cnt.max())

