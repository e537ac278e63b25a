"""The AdaPM parameter manager (paper §4, §B), as a simulator-drivable policy
(the twin of `repro/core/manager.py`).

All mechanism lives in the vectorized `core.engine.IntentEngine` — intent
tables, Algorithm 1 action timing, the §4.1 owner-side decision rule,
ownership/location caches, and versioned replica delta sync.  This module is
the thin policy shell that adapts the engine to the `PMPolicy` interface and
keeps the seed's public surface (``dir``, ``_repl``, ``trace``).  Its
metrics equal the reference's exactly on the same workload
(`tests/test_torch_simulator.py`).

Faithful mechanisms (see `engine.py` for the implementation):
  * per-worker logical clocks and intent tables (§3);
  * Algorithm 1 adaptive action timing on the signaling node (§4.2, §B.2.1);
  * owner-side decision rule (§4.1): exactly-one active node and no replicas
    -> relocate; concurrent active intent -> selective replicas exactly while
    intent is active; relocation never happens while replicas exist (§B.2.4);
  * responsibility follows allocation (§B.1); versioned delta replica sync,
    batched per round (§B.1.2, §B.2.2); home-node fallback routing with
    location caches (§B.2.3); intent is optional — un-signaled accesses fall
    back to synchronous remote access (§4).

Ablation variants (paper §5.5, §5.8): ``relocation=False`` (replication
only), ``replication=False`` (relocation only), ``immediate_action=True``
(skip Algorithm 1, act on signals as soon as they arrive).
"""

from __future__ import annotations

from typing import Optional, Sequence, Set, Tuple

import numpy as np

from .api import AccessResult, CostModel, PMPolicy, budget_prefix
from .engine import IntentEngine
from .intent import Intent


class _ReplicaView:
    """Read-only stand-in for the seed's per-key ``_ReplicaState``."""

    __slots__ = ("_engine", "_key")

    def __init__(self, engine: IntentEngine, key: int):
        self._engine = engine
        self._key = key

    @property
    def holders(self) -> Set[int]:
        return self._engine.holders(self._key)

    @property
    def version(self) -> int:
        if self._key >= self._engine.capacity:
            return 0
        return int(self._engine.version[self._key])


class _ReplMap:
    """Dict-like view of the engine's replica bitmasks (seed ``_repl``)."""

    def __init__(self, engine: IntentEngine):
        self._engine = engine

    def __contains__(self, key: int) -> bool:
        return bool(self._engine.holders(key))

    def __getitem__(self, key: int) -> _ReplicaView:
        return _ReplicaView(self._engine, key)

    def get(self, key: int, default=None):
        return self[key] if key in self else default


class AdaPM(PMPolicy):
    name = "AdaPM"

    def __init__(self, n_nodes: int, cost: CostModel, *,
                 relocation: bool = True, replication: bool = True,
                 immediate_action: bool = False,
                 alpha: float = 0.1, p: float = 0.9999, lam0: float = 10.0,
                 trace_keys: Optional[Set[int]] = None):
        super().__init__(n_nodes, cost)
        self.relocation = relocation
        self.replication = replication
        self.immediate = immediate_action
        if not relocation:
            self.name = "AdaPM w/o relocation"
        if not replication:
            self.name = "AdaPM w/o replication"
        if immediate_action:
            self.name = "AdaPM immediate action"
        self.engine = IntentEngine(
            n_nodes, cost, self.ledger, self.metrics,
            relocation=relocation, replication=replication,
            immediate=immediate_action, alpha=alpha, p=p, lam0=lam0,
            trace_keys=trace_keys)
        self.dir = self.engine.owners

    # ------------------------------------------------------- compat views
    @property
    def trace(self):
        return self.engine.trace

    @property
    def _repl(self) -> _ReplMap:
        return _ReplMap(self.engine)

    @property
    def _n_keys_hint(self) -> int:
        return self.engine.n_keys_hint

    @_n_keys_hint.setter
    def _n_keys_hint(self, n: int) -> None:
        self.engine.n_keys_hint = n
        self.engine.ensure_capacity(n)

    # ------------------------------------------------------------ sim hooks
    def signal_intent(self, node: int, intent: Intent, now: float) -> None:
        self.engine.signal(node, np.asarray(intent.keys, np.int64),
                           intent.c_start, intent.c_end, intent.worker_id)

    def advance_clock(self, node: int, worker: int, clock: int) -> None:
        self.engine.advance_clock(node, worker, clock)

    def access(self, node: int, worker: int, key: int,
               now: float, write: bool = True) -> AccessResult:
        self.metrics.n_accesses += 1
        e = self.engine
        e.ensure_capacity(key + 1)
        if e.owners.owner[key] == node:
            return AccessResult(local=True, staleness=0.0)
        if int(e.holder_mask[key]) >> node & 1:
            stale = max(0.0, now - float(e.sync_time[node, key]))
            e.replica_reads(node, np.array([key], np.int64),
                            np.array([now]), write)
            return AccessResult(local=True, staleness=stale)
        e.remote_accesses(node, np.array([key], np.int64))
        return AccessResult(local=False)

    def access_batch(self, node: int, worker: int, keys: Sequence[int],
                     now: float, dur: float, budget: float
                     ) -> Tuple[int, float]:
        keys = np.asarray(keys, np.int64)
        own, held = self.engine.classify(node, keys)
        local = own | held
        costs = np.where(local, self.cost.t_local, self.cost.t_remote)
        n, spent, excl = budget_prefix(costs, budget)
        keys, own, held = keys[:n], own[:n], held[:n]
        self.metrics.n_accesses += n
        rr = ~own & held
        if np.any(rr):
            times = now + (dur - budget) + excl[:n]
            self.engine.replica_reads(node, keys[rr], times[rr], True)
        rem = ~own & ~held
        if np.any(rem):
            self.engine.remote_accesses(node, keys[rem])
        return n, budget - spent

    def run_round(self, now: float, round_duration_hint: float) -> None:
        self.engine.step(now)

    def mem_bytes(self, node: int) -> float:
        return self.engine.mem_bytes(node)
