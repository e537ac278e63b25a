"""Unified vectorized intent engine (paper §3-§4, §B) — structure-of-arrays.

This module is the single place where intent is *exploited*.  Both consumers
route their placement decisions through it:

  * the discrete-event simulator policies (`core.manager.AdaPM`, the
    baselines in `core.baselines`) drive the full `IntentEngine` state
    machine below — intent tables, per-key management state (owned /
    replicated / relocating), the owner-side decision rule (§4.1) and
    Algorithm 1 action timing;
  * the SPMD planner (`pm.planner.IntentPlanner`) calls the vectorized
    window classifiers (`concurrent_intent`, `intent_miss_bound`) that
    implement the same §4.1 rule over a planning window: concurrent intent
    on >= 2 nodes -> replicate, single-node intent -> owner path.

Everything is numpy structure-of-arrays instead of per-key dicts and heaps:
an int32 owner array, uint64 replica/active/dirty holder bitmasks (node
count <= 64), growable window arrays for pending/announced intents, and
per-round vectorized activation/expiry/decision/sync passes.  The twin of
`repro/core/engine.py`: the same decisions, traffic charges and metrics,
exactly (`tests/test_torch_simulator.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .api import CostModel, Metrics, RoundLedger
from .timing import ActionTimer

# Fibonacci multiplier of the seed's `home_node`, split into 32-bit halves so
# the vectorized hash reproduces Python's arbitrary-precision
# ``(key * FIB) >> 32`` exactly (uint64 arithmetic alone would wrap).
_FIB = 11400714819323198485
_FIB_HI = np.uint64(_FIB >> 32)
_FIB_LO = np.uint64(_FIB & 0xFFFFFFFF)

_NO_CACHE = np.int32(-1)
_INF_CLOCK = np.int64(2 ** 62)


def home_nodes(keys: np.ndarray, n_nodes: int) -> np.ndarray:
    """Vectorized static hash partitioning; exact match of
    ``ownership.home_node`` for all keys < 2**32."""
    k = np.asarray(keys).astype(np.uint64)
    h = k * _FIB_HI + ((k * _FIB_LO) >> np.uint64(32))
    return (h % np.uint64(n_nodes)).astype(np.int64)


def single_bit_index(x: np.ndarray) -> np.ndarray:
    """Bit index for masks known to hold exactly one set bit (exact: all
    uint64 powers of two are representable in float64)."""
    return np.log2(x.astype(np.float64)).astype(np.int64)


class Windows:
    """Growable SoA of intent windows (key, c_start, c_end, worker-slot)."""

    __slots__ = ("key", "c_start", "c_end", "worker", "n")

    def __init__(self, cap: int = 64):
        self.key = np.empty(cap, np.int64)
        self.c_start = np.empty(cap, np.int64)
        self.c_end = np.empty(cap, np.int64)
        self.worker = np.empty(cap, np.int32)
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def _grow(self, need: int) -> None:
        cap = len(self.key)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("key", "c_start", "c_end", "worker"):
            old = getattr(self, name)
            new = np.empty(cap, old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def append(self, keys, c_start, c_end, worker) -> None:
        keys = np.atleast_1d(np.asarray(keys, np.int64))
        m = len(keys)
        if m == 0:
            return
        self._grow(self.n + m)
        sl = slice(self.n, self.n + m)
        self.key[sl] = keys
        self.c_start[sl] = c_start
        self.c_end[sl] = c_end
        self.worker[sl] = worker
        self.n += m

    def keep(self, mask: np.ndarray) -> None:
        idx = np.nonzero(mask)[0]
        m = len(idx)
        for name in ("key", "c_start", "c_end", "worker"):
            arr = getattr(self, name)
            arr[:m] = arr[: self.n][idx]
        self.n = m

    def view(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        n = self.n
        return (self.key[:n], self.c_start[:n], self.c_end[:n],
                self.worker[:n])


class WorkerRegistry:
    """Dense worker-id -> slot mapping with a per-slot clock array."""

    __slots__ = ("ids", "index", "clock", "clocked")

    def __init__(self):
        self.ids: List[int] = []
        self.index: Dict[int, int] = {}
        self.clock = np.zeros(8, np.int64)
        self.clocked = np.zeros(8, bool)

    def slot(self, worker: int) -> int:
        s = self.index.get(worker)
        if s is None:
            s = len(self.ids)
            self.index[worker] = s
            self.ids.append(worker)
            if s >= len(self.clock):
                self.clock = np.concatenate(
                    [self.clock, np.zeros(len(self.clock), np.int64)])
                self.clocked = np.concatenate(
                    [self.clocked, np.zeros(len(self.clocked), bool)])
        return s

    def set_clock(self, worker: int, clock: int) -> None:
        s = self.slot(worker)
        self.clock[s] = clock
        self.clocked[s] = True


class IntentStore:
    """Vectorized node-local intent table (§3): stores signaled windows and
    answers the activation queries the manager needs.  Backs the per-key
    `intent.IntentTable` API and the satellite activation-semantics tests."""

    def __init__(self):
        self.windows = Windows()
        self.workers = WorkerRegistry()

    def signal(self, keys, c_start: int, c_end: int, worker: int) -> None:
        self.windows.append(keys, c_start, c_end, self.workers.slot(worker))

    def _clocks_by_slot(self, clocks: Dict[int, int]) -> np.ndarray:
        out = np.zeros(max(1, len(self.workers.ids)), np.int64)
        for w, c in clocks.items():
            s = self.workers.index.get(w)
            if s is not None:
                out[s] = c
        return out

    def states(self, clocks: Dict[int, int]) -> np.ndarray:
        """Per-window state vs ``Intent.state``: 0 inactive, 1 active,
        2 expired — the vectorized activation semantics."""
        key, c_start, c_end, worker = self.windows.view()
        clk = self._clocks_by_slot(clocks)[worker]
        return np.where(clk < c_start, 0, np.where(clk < c_end, 1, 2))

    def active_workers(self, key: int, clocks: Dict[int, int]) -> Set[int]:
        keys, c_start, c_end, worker = self.windows.view()
        clk = self._clocks_by_slot(clocks)[worker]
        m = (keys == key) & (c_start <= clk) & (clk < c_end)
        return {self.workers.ids[s] for s in np.unique(worker[m])}

    def has_active(self, key: int, clocks: Dict[int, int]) -> bool:
        keys, c_start, c_end, worker = self.windows.view()
        clk = self._clocks_by_slot(clocks)[worker]
        return bool(np.any((keys == key) & (c_start <= clk) & (clk < c_end)))

    def earliest_future_start(self, key: int, clocks: Dict[int, int]):
        keys, c_start, _c_end, worker = self.windows.view()
        clk = self._clocks_by_slot(clocks)[worker]
        m = (keys == key) & (clk < c_start)
        if not np.any(m):
            return None
        i = np.nonzero(m)[0][np.argmin(c_start[m])]
        return int(c_start[i]), self.workers.ids[int(worker[i])]

    def last_end(self, key: int) -> int:
        keys, _s, c_end, _w = self.windows.view()
        m = keys == key
        return int(c_end[m].max()) if np.any(m) else 0

    def gc(self, clocks: Dict[int, int]) -> None:
        _keys, _s, c_end, worker = self.windows.view()
        clk = self._clocks_by_slot(clocks)[worker]
        self.windows.keep(clk < c_end)

    def keys(self) -> np.ndarray:
        return np.unique(self.windows.view()[0])

    def __len__(self) -> int:
        """Number of distinct keys with any stored window."""
        return len(self.keys())


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


class OwnerTable:
    """Vectorized ownership + location caches (§B.1.1, §B.2.3).

    ``owner`` is ground truth (home node always knows it); ``cache[n, k]``
    is node n's last known owner (-1 = believe the home node).  Routing
    semantics match the seed's Lapse-style `OwnershipDirectory`."""

    def __init__(self, n_nodes: int, capacity: int = 0):
        self.n_nodes = n_nodes
        self.capacity = 0
        self.owner = np.empty(0, np.int32)
        self.cache = np.empty((n_nodes, 0), np.int32)
        if capacity:
            self.ensure_capacity(capacity)

    def ensure_capacity(self, n: int) -> None:
        if n <= self.capacity:
            return
        cap = max(64, self.capacity)
        while cap < n:
            cap *= 2
        owner = np.empty(cap, np.int32)
        owner[: self.capacity] = self.owner[: self.capacity]
        owner[self.capacity:] = home_nodes(
            np.arange(self.capacity, cap), self.n_nodes)
        cache = np.full((self.n_nodes, cap), _NO_CACHE, np.int32)
        cache[:, : self.capacity] = self.cache[:, : self.capacity]
        self.owner, self.cache, self.capacity = owner, cache, cap

    def owners(self, keys: np.ndarray) -> np.ndarray:
        return self.owner[keys]

    def owner_of(self, key: int) -> int:
        self.ensure_capacity(key + 1)
        return int(self.owner[key])

    def homes(self, keys: np.ndarray) -> np.ndarray:
        return home_nodes(keys, self.n_nodes)

    def route_batch(self, src: int, keys: np.ndarray,
                    update_cache: bool = True) -> np.ndarray:
        """Hops per message src -> owner (0 when src owns; +1 via stale
        home, +2 via stale non-home cache), with response cache refresh."""
        keys = np.asarray(keys, np.int64)
        if len(keys) == 0:
            return np.zeros(0, np.int64)
        self.ensure_capacity(int(keys.max()) + 1)
        true_owner = self.owner[keys].astype(np.int64)
        home = self.homes(keys)
        believed = self.cache[src, keys].astype(np.int64)
        believed = np.where(believed == _NO_CACHE, home, believed)
        hops = np.ones(len(keys), np.int64)
        stale = believed != true_owner
        hops += stale * np.where(believed == home, 1, 2)
        hops[true_owner == src] = 0
        if update_cache:
            self.cache[src, keys] = true_owner
        return hops

    def relocate_batch(self, keys: np.ndarray, dsts: np.ndarray) -> None:
        self.owner[keys] = dsts
        self.cache[dsts, keys] = dsts

    def owned_counts(self) -> np.ndarray:
        return np.bincount(self.owner[: self.capacity],
                           minlength=self.n_nodes)


# --------------------------------------------------------------------------
# §4.1 decision rule, vectorized — the single shared decision procedure.
# --------------------------------------------------------------------------

def decide_on_activate(active_after: np.ndarray, holder_mask: np.ndarray,
                       owners: np.ndarray, node: int, *,
                       relocation: bool, replication: bool
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Owner-side rule when ``node`` announces active intent for a batch of
    keys: exactly-one active node and no replicas -> relocate; concurrent
    active intent -> selective replica; relocation never happens while
    replicas exist (§B.2.4).  Returns (relocate_mask, replicate_mask) over
    the batch (owner's own keys must be excluded by the caller)."""
    bit = np.uint64(1 << node)
    others = (active_after & ~bit) != 0
    has_repl = holder_mask != 0
    reloc = relocation & ~has_repl & ~others
    repl = ~reloc & replication & (owners != node)
    return reloc, repl


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


class IntentEngine:
    """Full AdaPM state machine over structure-of-arrays state.

    Owns: per-node pending/announced intent windows, Algorithm-1 action
    timers, the ownership/location-cache table, replica holder bitmasks with
    versioned delta-sync bookkeeping, and the §4.1 owner decision rule.
    Charges traffic to the policy's `RoundLedger` and counts into its
    `Metrics` — the policy (`core.manager.AdaPM`) is a thin shell."""

    def __init__(self, n_nodes: int, cost: CostModel, ledger: RoundLedger,
                 metrics: Metrics, *, relocation: bool = True,
                 replication: bool = True, immediate: bool = False,
                 alpha: float = 0.1, p: float = 0.9999, lam0: float = 10.0,
                 trace_keys: Optional[Set[int]] = None):
        if n_nodes > 64:
            raise ValueError("bitmask engine supports at most 64 nodes")
        self.n_nodes = n_nodes
        self.cost = cost
        self.ledger = ledger
        self.metrics = metrics
        self.relocation = relocation
        self.replication = replication
        self.immediate = immediate
        self.owners = OwnerTable(n_nodes)
        self.timers = [ActionTimer(alpha=alpha, p=p, lam0=lam0)
                       for _ in range(n_nodes)]
        self.workers = [WorkerRegistry() for _ in range(n_nodes)]
        self.pending = [Windows() for _ in range(n_nodes)]
        self.announced = [Windows() for _ in range(n_nodes)]
        # per-key SoA management state
        self.capacity = 0
        self.active_mask = np.empty(0, np.uint64)   # nodes w/ active intent
        self.holder_mask = np.empty(0, np.uint64)   # replica holders
        self.dirty_mask = np.empty(0, np.uint64)    # wrote since last round
        self.version = np.empty(0, np.int64)        # replica delta version
        self.ann_count = np.empty((n_nodes, 0), np.int32)
        self.sync_version = np.empty((n_nodes, 0), np.int64)
        self.sync_time = np.empty((n_nodes, 0), np.float64)
        self._repl_keys: Set[int] = set()           # keys w/ replica state
        self.holder_count = np.zeros(n_nodes, np.int64)
        self.owned_extra = np.zeros(n_nodes, np.int64)
        self.n_keys_hint = 0
        self.trace_keys = trace_keys or set()
        self.trace: List[Tuple[float, int, int, str]] = []

    # ------------------------------------------------------------ capacity
    def ensure_capacity(self, n: int) -> None:
        if n <= self.capacity:
            return
        self.owners.ensure_capacity(n)
        cap = self.owners.capacity
        old = self.capacity

        def grow1(arr, fill, dtype):
            new = np.full(cap, fill, dtype)
            new[:old] = arr[:old]
            return new

        def grow2(arr, fill, dtype):
            new = np.full((self.n_nodes, cap), fill, dtype)
            new[:, :old] = arr[:, :old]
            return new

        self.active_mask = grow1(self.active_mask, 0, np.uint64)
        self.holder_mask = grow1(self.holder_mask, 0, np.uint64)
        self.dirty_mask = grow1(self.dirty_mask, 0, np.uint64)
        self.version = grow1(self.version, 0, np.int64)
        self.ann_count = grow2(self.ann_count, 0, np.int32)
        self.sync_version = grow2(self.sync_version, 0, np.int64)
        self.sync_time = grow2(self.sync_time, 0.0, np.float64)
        self.capacity = cap

    def _ensure_keys(self, keys: np.ndarray) -> None:
        if len(keys):
            self.ensure_capacity(int(keys.max()) + 1)

    # ------------------------------------------------------------ tracing
    def _trace_batch(self, now: float, keys: np.ndarray, nodes,
                     ev: str) -> None:
        if not self.trace_keys or len(keys) == 0:
            return
        nodes = np.broadcast_to(np.asarray(nodes), keys.shape)
        for k, n in zip(keys, nodes):
            if int(k) in self.trace_keys:
                self.trace.append((now, int(k), int(n), ev))

    # ---------------------------------------------------------- sim hooks
    def signal(self, node: int, keys, c_start: int, c_end: int,
               worker: int) -> None:
        keys = np.atleast_1d(np.asarray(keys, np.int64))
        self._ensure_keys(keys)
        self.pending[node].append(
            keys, c_start, c_end, self.workers[node].slot(worker))

    def advance_clock(self, node: int, worker: int, clock: int) -> None:
        self.workers[node].set_clock(worker, clock)

    # -------------------------------------------------------------- round
    def step(self, now: float) -> None:
        c = self.cost
        for node in range(self.n_nodes):
            reg = self.workers[node]
            timer = self.timers[node]
            nw = len(reg.ids)
            # Algorithm 1 lines 1-6: per-worker rate estimates (clocked
            # workers only, matching the seed's clocks-dict iteration).
            for s in range(nw):
                if reg.clocked[s]:
                    timer.observe_round(reg.ids[s], int(reg.clock[s]))
            # per-worker action thresholds (Alg. 1 soft upper bound)
            thr = np.full(max(1, nw), _INF_CLOCK, np.int64)
            if not self.immediate:
                for s in range(nw):
                    thr[s] = reg.clock[s] + timer.horizon(reg.ids[s])
                clocked = reg.clocked[:nw]
                if np.any(clocked):
                    scan_bound = int(thr[:nw][clocked].max())
                else:
                    scan_bound = timer.horizon(0)
                thr = np.minimum(thr, scan_bound)

            # pending scan: act / expire / keep (vectorized Alg. 1)
            pend = self.pending[node]
            pk, ps, pe, pw = pend.view()
            clk = reg.clock[pw]
            dead = pe <= clk
            act = ~dead & (ps < thr[pw])
            newly_k, newly_e = pk[act].copy(), pe[act].copy()
            newly_w = pw[act].copy()
            pend.keep(~(dead | act))

            # expirations of announced windows (§B.2.1 aggregated intent),
            # evaluated before this round's announcements merge — keys
            # re-announced in their expiry round lose that announcement
            # (seed behavior, pinned by the equivalence tests).
            ann = self.announced[node]
            ak, _as_, ae, aw = ann.view()
            exp = reg.clock[aw] >= ae
            counts = self.ann_count[node]
            if np.any(exp):
                np.subtract.at(counts, ak[exp], 1)
                exp_keys = np.unique(ak[exp])
                exp_keys = exp_keys[counts[exp_keys] == 0]
            else:
                exp_keys = np.empty(0, np.int64)
            ann.keep(~exp)

            # merge the newly announced windows; first announcements are
            # keys with no live window before this round
            first_keys = np.empty(0, np.int64)
            if len(newly_k):
                drop = np.isin(newly_k, exp_keys)
                keep_k, keep_e = newly_k[~drop], newly_e[~drop]
                u = np.unique(keep_k)
                first_keys = u[counts[u] == 0]
                ann.append(keep_k, 0, keep_e, newly_w[~drop])
                np.add.at(counts, keep_k, 1)

            # grouped signaling messages to owners + owner decisions
            dests: Set[int] = set()
            if len(first_keys):
                owners = self.owners.owners(first_keys)
                rem = first_keys[owners != node]
                if len(rem):
                    hops = self.owners.route_batch(node, rem)
                    self.ledger.charge(node, c.signal_bytes * int(hops.sum()))
                    dests.update(int(o) for o in np.unique(owners)
                                 if o != node)
                self._on_activate(first_keys, node, now)
            if len(exp_keys):
                owners_e = self.owners.owners(exp_keys)
                rem_e = exp_keys[owners_e != node]
                if len(rem_e):
                    hops = self.owners.route_batch(node, rem_e)
                    self.ledger.charge(node, c.signal_bytes * int(hops.sum()))
                    dests.update(int(o) for o in np.unique(owners_e)
                                 if o != node)
                self._on_expire(exp_keys, node, now)
            # one grouped request + response per peer (§B.2.2)
            self.ledger.charge(node, 0.0, nmsgs=2 * len(dests))

        self._sync_replicas(now)

    # ------------------------------------------------------ owner decisions
    def _on_activate(self, keys: np.ndarray, node: int, now: float) -> None:
        """§4.1 decision at the owner for a batch of first announcements."""
        bit = np.uint64(1 << node)
        self.active_mask[keys] |= bit
        own = self.owners.owners(keys) == node
        self._trace_batch(now, keys[own], node, "own-local")
        rest = keys[~own]
        if len(rest) == 0:
            return
        reloc, repl = decide_on_activate(
            self.active_mask[rest], self.holder_mask[rest],
            self.owners.owners(rest), node,
            relocation=self.relocation, replication=self.replication)
        if np.any(reloc):
            rk = rest[reloc]
            self._relocate(rk, np.full(len(rk), node, np.int64), now)
        if np.any(repl):
            self._create_replicas(rest[repl], node, now)

    def _on_expire(self, keys: np.ndarray, node: int, now: float) -> None:
        bit = np.uint64(1 << node)
        self.active_mask[keys] &= ~bit
        held = (self.holder_mask[keys] & bit) != 0
        if np.any(held):
            hk = keys[held]
            # destroy replicas exactly when intent expires (§4.1)
            self.holder_mask[hk] &= ~bit
            self.dirty_mask[hk] &= ~bit
            self.holder_count[node] -= len(hk)
            self._trace_batch(now, hk, node, "replica-destroy")
        if not self.relocation:
            return
        act = self.active_mask[keys]
        single = (act != 0) & ((act & (act - np.uint64(1))) == 0)
        if not np.any(single):
            return
        cand = keys[single]
        m = single_bit_index(act[single])
        owners = self.owners.owners(cand)
        hm = self.holder_mask[cand]
        only_m = hm == (np.uint64(1) << m.astype(np.uint64))
        go = (m != owners) & ((hm == 0) | only_m)
        if np.any(go):
            # single remaining active node -> relocate to it (Fig. 4d/11)
            self._relocate(cand[go], m[go], now)

    def _relocate(self, keys: np.ndarray, dsts: np.ndarray,
                  now: float) -> None:
        c = self.cost
        srcs = self.owners.owners(keys).astype(np.int64)
        dst_bit = np.uint64(1) << dsts.astype(np.uint64)
        dst_holds = (self.holder_mask[keys] & dst_bit) != 0
        if np.any(dst_holds):
            # dst already holds the value: ownership transfer + fresh delta
            self.holder_mask[keys[dst_holds]] &= ~dst_bit[dst_holds]
            np.subtract.at(self.holder_count, dsts[dst_holds], 1)
        nbytes = np.where(dst_holds, c.value_bytes, c.value_bytes + 64)
        np.add.at(self.ledger.bytes_out, srcs, nbytes.astype(np.float64))
        self.owners.relocate_batch(keys, dsts)
        np.subtract.at(self.owned_extra, srcs, 1)
        np.add.at(self.owned_extra, dsts, 1)
        self.metrics.n_relocations += len(keys)
        self._trace_batch(now, keys, dsts, "relocate-in")

    def _create_replicas(self, keys: np.ndarray, node: int,
                         now: float) -> None:
        c = self.cost
        bit = np.uint64(1 << node)
        fresh = (self.holder_mask[keys] & bit) == 0
        keys = keys[fresh]
        if len(keys) == 0:
            return
        self.holder_mask[keys] |= bit
        self.sync_version[node, keys] = self.version[keys]
        self.sync_time[node, keys] = now
        owners = self.owners.owners(keys).astype(np.int64)
        np.add.at(self.ledger.bytes_out, owners, float(c.value_bytes))
        self.holder_count[node] += len(keys)
        self.metrics.n_replica_creates += len(keys)
        self._repl_keys.update(int(k) for k in keys)
        self._trace_batch(now, keys, node, "replica-create")

    # --------------------------------------------------------- replica sync
    def _sync_replicas(self, now: float) -> None:
        """Versioned delta sync via the owner hub, batched (§B.1.2)."""
        c = self.cost
        if not self._repl_keys:
            self.metrics.rounds += 1
            return
        keys = np.fromiter(self._repl_keys, np.int64, len(self._repl_keys))
        hm = self.holder_mask[keys]
        gone = keys[hm == 0]
        if len(gone):
            # replica state dies with the last holder (seed: entry deleted)
            self.dirty_mask[gone] = 0
            self._repl_keys.difference_update(int(k) for k in gone)
        keys = keys[hm != 0]
        if len(keys) == 0:
            self.metrics.rounds += 1
            return
        hm = self.holder_mask[keys]
        dm = self.dirty_mask[keys]
        owners = self.owners.owners(keys).astype(np.int64)
        ver = self.version[keys]
        for n in range(self.n_nodes):
            bit = np.uint64(1 << n)
            # upstream: dirty non-owner holders push deltas to the owner
            n_dirty = int(np.count_nonzero(((dm & bit) != 0) & (owners != n)))
            if n_dirty:
                self.ledger.charge(n, n_dirty * c.value_bytes, nmsgs=0)
            # downstream: stale holders get the owner's fresh delta
            stale = ((hm & bit) != 0) & (self.sync_version[n, keys] < ver)
            if np.any(stale):
                sk = keys[stale]
                np.add.at(self.ledger.bytes_out, owners[stale],
                          float(c.value_bytes))
                self.sync_version[n, sk] = ver[stale]
                self.sync_time[n, sk] = now
        self.dirty_mask[keys] = 0
        self.metrics.rounds += 1

    # ----------------------------------------------------------- accesses
    def classify(self, node: int, keys: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(owned, replicated-here) masks for a batch of keys."""
        self._ensure_keys(keys)
        own = self.owners.owners(keys) == node
        held = (self.holder_mask[keys] & np.uint64(1 << node)) != 0
        return own, held

    def replica_reads(self, node: int, keys: np.ndarray, times: np.ndarray,
                      write: bool) -> None:
        """Accounting for a batch of replica accesses at ``node``."""
        if len(keys) == 0:
            return
        if write:
            self.dirty_mask[keys] |= np.uint64(1 << node)
            self.version[keys] += 1
        stale = np.maximum(0.0, times - self.sync_time[node, keys])
        self.metrics.staleness_sum += float(stale.sum())
        self.metrics.n_replica_reads += len(keys)

    def remote_accesses(self, node: int, keys: np.ndarray) -> None:
        """Synchronous remote round trips (un-signaled accesses, §4)."""
        if len(keys) == 0:
            return
        hops = int(self.owners.route_batch(node, keys).sum())
        self.metrics.n_remote += len(keys)
        self.ledger.charge(node, 2 * self.cost.value_bytes * len(keys)
                           + 64 * hops, nmsgs=len(keys) + hops)

    # -------------------------------------------------------------- views
    def holders(self, key: int) -> Set[int]:
        if key >= self.capacity:
            return set()
        m = int(self.holder_mask[key])
        return {n for n in range(self.n_nodes) if m >> n & 1}

    def mem_bytes(self, node: int) -> float:
        base = self.n_keys_hint / self.n_nodes
        return (base + int(self.owned_extra[node])
                + int(self.holder_count[node])) * self.cost.value_bytes
