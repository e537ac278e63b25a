"""Baseline parameter-management policies the paper compares against (§2, §5,
Appendix A): static full replication, static parameter partitioning, selective
replication (Petuum-style SSP / ESSP), and a NuPS-style static multi-technique
manager (hot keys fully replicated, cold keys relocation-managed with
application-triggered ``localize`` calls at a fixed relocation offset).
The twin of `repro/core/baselines.py`.

All baselines are thin policies over the vectorized engine primitives
(`engine.home_nodes`, `engine.OwnerTable`): per-key state is
structure-of-arrays and accesses are accounted batch-at-a-time through
``access_batch`` so the same workloads run at 10x+ more keys.
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from .api import AccessResult, CostModel, PMPolicy, budget_prefix
from .engine import OwnerTable, home_nodes
from .intent import Intent
from .ownership import home_node


class _NodeArrays:
    """Per-(node, key) growable SoA used by the replication baselines."""

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self.capacity = 0
        self.rep_clock = np.empty((n_nodes, 0), np.int64)   # -1 = no replica
        self.rep_time = np.empty((n_nodes, 0), np.float64)

    def ensure_capacity(self, n: int) -> None:
        if n <= self.capacity:
            return
        cap = max(64, self.capacity)
        while cap < n:
            cap *= 2
        clock = np.full((self.n_nodes, cap), -1, np.int64)
        clock[:, : self.capacity] = self.rep_clock[:, : self.capacity]
        time = np.zeros((self.n_nodes, cap), np.float64)
        time[:, : self.capacity] = self.rep_time[:, : self.capacity]
        self.rep_clock, self.rep_time, self.capacity = clock, time, cap


class StaticFullReplication(PMPolicy):
    """Every node holds a replica of the full model (§A.1).

    All accesses are local.  Replicas are synchronized every ``sync_every``
    rounds with a dense AllReduce over the *entire* model (mirrored/DDP
    semantics: the synchronization is oblivious to which values were
    actually written — the over-communication the paper criticizes, §A.1;
    ~2 bytes move per value per node in a ring).  Infeasible when the model
    exceeds node memory.
    """

    name = "Full replication"

    def __init__(self, n_nodes: int, cost: CostModel, n_keys: int,
                 sync_every: int = 1):
        super().__init__(n_nodes, cost)
        self.n_keys = n_keys
        self.sync_every = sync_every
        self._last_sync_time = 0.0
        self._round = 0
        model_bytes = n_keys * cost.value_bytes
        if model_bytes > cost.node_mem_bytes:
            self.metrics.oom = True
        self.metrics.peak_mem_bytes = model_bytes

    def access(self, node, worker, key, now, write=True):
        if self.metrics.oom:
            return AccessResult(local=False)
        self.metrics.n_accesses += 1
        stale = max(0.0, now - self._last_sync_time)
        self.metrics.staleness_sum += stale
        self.metrics.n_replica_reads += 1
        return AccessResult(local=True, staleness=stale)

    def access_batch(self, node, worker, keys, now, dur, budget):
        m = len(keys)
        if self.metrics.oom:
            costs = np.full(m, self.cost.t_remote)
            n, spent, _ = budget_prefix(costs, budget)
            return n, budget - spent
        costs = np.full(m, self.cost.t_local)
        n, spent, excl = budget_prefix(costs, budget)
        times = now + (dur - budget) + excl[:n]
        self.metrics.n_accesses += n
        self.metrics.n_replica_reads += n
        self.metrics.staleness_sum += float(
            np.maximum(0.0, times - self._last_sync_time).sum())
        return n, budget - spent

    def run_round(self, now, round_duration_hint):
        self.metrics.rounds += 1
        self._round += 1
        if self._round % self.sync_every != 0:
            return
        nbytes = 2.0 * self.n_keys * self.cost.value_bytes
        for node in range(self.n_nodes):
            self.ledger.charge(node, nbytes, nmsgs=2 * (self.n_nodes - 1))
        self._last_sync_time = now

    def mem_bytes(self, node):
        return self.n_keys * self.cost.value_bytes


class StaticPartitioning(PMPolicy):
    """Classic parameter server: keys hash-partitioned, every non-local
    access is a synchronous network round trip (§A.2)."""

    name = "Static partitioning"

    def __init__(self, n_nodes: int, cost: CostModel):
        super().__init__(n_nodes, cost)

    def access(self, node, worker, key, now, write=True):
        self.metrics.n_accesses += 1
        if home_node(key, self.n_nodes) == node:
            return AccessResult(local=True, staleness=0.0)
        nbytes = 2 * self.cost.value_bytes
        self.metrics.n_remote += 1
        self.ledger.charge(node, nbytes, nmsgs=2)
        return AccessResult(local=False)

    def access_batch(self, node, worker, keys, now, dur, budget):
        keys = np.asarray(keys, np.int64)
        local = home_nodes(keys, self.n_nodes) == node
        costs = np.where(local, self.cost.t_local, self.cost.t_remote)
        n, spent, _ = budget_prefix(costs, budget)
        n_rem = int(np.count_nonzero(~local[:n]))
        self.metrics.n_accesses += n
        self.metrics.n_remote += n_rem
        self.ledger.charge(node, 2 * self.cost.value_bytes * n_rem,
                           nmsgs=2 * n_rem)
        return n, budget - spent

    def run_round(self, now, round_duration_hint):
        self.metrics.rounds += 1


class SelectiveReplicationSSP(PMPolicy):
    """Petuum-style selective replication (§A.3).

    Replicas are created *reactively*: the first access of a key at a node
    blocks on a synchronous fetch.  A replica may serve reads while it is at
    most ``staleness_bound`` clocks old (SSP); once it exceeds the bound the
    next access blocks on a synchronous refresh.  Writes are pushed to the
    key's home node once per round.  ``staleness_bound=None`` gives ESSP:
    replicas are kept (and synchronized every round) forever, converging to
    full replication traffic.
    """

    def __init__(self, n_nodes: int, cost: CostModel,
                 staleness_bound: Optional[int] = None):
        super().__init__(n_nodes, cost)
        self.bound = staleness_bound
        self.name = ("ESSP" if staleness_bound is None
                     else f"SSP(bound={staleness_bound})")
        self._arr = _NodeArrays(n_nodes)
        # per node: all keys ever replicated there (replicas are never
        # dropped) and the keys written since the last round
        self._held: List[List[np.ndarray]] = [[] for _ in range(n_nodes)]
        self._held_count = np.zeros(n_nodes, np.int64)
        self._dirty: List[List[np.ndarray]] = [[] for _ in range(n_nodes)]
        self._clock: List[int] = [0] * n_nodes  # max worker clock per node

    def advance_clock(self, node, worker, clock):
        if clock > self._clock[node]:
            self._clock[node] = clock

    def access(self, node, worker, key, now, write=True):
        self.metrics.n_accesses += 1
        if home_node(key, self.n_nodes) == node:
            return AccessResult(local=True, staleness=0.0)
        self._arr.ensure_capacity(key + 1)
        rep_clock = self._arr.rep_clock[node]
        rep_time = self._arr.rep_time[node]
        clk = self._clock[node]
        fresh = rep_clock[key] >= 0 and (
            self.bound is None or clk - rep_clock[key] <= self.bound)
        stalled = False
        if not fresh:
            # synchronous fetch/refresh (blocks the worker)
            self.metrics.n_remote += 1
            self.ledger.charge(node, self.cost.value_bytes + 64, nmsgs=2)
            if rep_clock[key] < 0:
                self._held[node].append(np.array([key], np.int64))
                self._held_count[node] += 1
            rep_clock[key] = clk
            rep_time[key] = now
            stalled = True
        if write:
            self._dirty[node].append(np.array([key], np.int64))
        stale = max(0.0, now - float(rep_time[key]))
        self.metrics.staleness_sum += stale
        self.metrics.n_replica_reads += 1
        return AccessResult(local=True, staleness=stale, stalled=stalled)

    def access_batch(self, node, worker, keys, now, dur, budget):
        keys = np.asarray(keys, np.int64)
        self._arr.ensure_capacity(int(keys.max()) + 1 if len(keys) else 0)
        home = home_nodes(keys, self.n_nodes) == node
        rep_clock = self._arr.rep_clock[node]
        rep_time = self._arr.rep_time[node]
        clk = self._clock[node]
        exists = rep_clock[keys] >= 0
        if self.bound is None:
            fresh = exists
        else:
            fresh = exists & (clk - rep_clock[keys] <= self.bound)
        stall = ~home & ~fresh
        costs = np.where(home | fresh, self.cost.t_local, self.cost.t_remote)
        n, spent, excl = budget_prefix(costs, budget)
        keys, home, fresh, stall, exists = (
            a[:n] for a in (keys, home, fresh, stall, exists))
        times = now + (dur - budget) + excl[:n]
        self.metrics.n_accesses += n
        # synchronous fetch/refresh for stale/missing replicas
        n_miss = int(np.count_nonzero(stall))
        if n_miss:
            self.metrics.n_remote += n_miss
            self.ledger.charge(node, (self.cost.value_bytes + 64) * n_miss,
                               nmsgs=2 * n_miss)
            mk = keys[stall]
            new = mk[~exists[stall]]
            if len(new):
                self._held[node].append(new)
                self._held_count[node] += len(new)
            rep_clock[mk] = clk
            rep_time[mk] = times[stall]
        repl = ~home
        n_repl = int(np.count_nonzero(repl))
        if n_repl:
            self._dirty[node].append(keys[repl].copy())
            stale = np.maximum(0.0, times[repl] - rep_time[keys[repl]])
            self.metrics.staleness_sum += float(stale.sum())
            self.metrics.n_replica_reads += n_repl
        return n, budget - spent

    def run_round(self, now, round_duration_hint):
        self.metrics.rounds += 1
        for node in range(self.n_nodes):
            if self._dirty[node]:
                # push accumulated writes to the keys' home nodes
                n_dirty = len(np.unique(np.concatenate(self._dirty[node])))
                self.ledger.charge(node, n_dirty * self.cost.value_bytes,
                                   nmsgs=self.n_nodes - 1)
                self._dirty[node] = []
            if self.bound is None and self._held_count[node]:
                # ESSP: every held replica is refreshed every round
                # (downstream traffic, charged to this node as
                # receiver-side share of the home nodes' fan-out)
                held = np.concatenate(self._held[node])
                self._held[node] = [held]
                self.ledger.charge(node, len(held) * self.cost.value_bytes,
                                   nmsgs=self.n_nodes - 1)
                self._arr.rep_clock[node, held] = self._clock[node]
                self._arr.rep_time[node, held] = now

    def mem_bytes(self, node):
        return int(self._held_count[node]) * self.cost.value_bytes


class NuPSStatic(PMPolicy):
    """NuPS-style static multi-technique PM (§A.5).

    The application declares, *before training*, a hot set (here: the true
    ``hot_frac`` most frequent keys, i.e. the best-case oracle statistics)
    that is fully replicated on all nodes and synchronized every round.  All
    other keys are relocation-managed: the application calls ``localize``
    (modeled through ``signal_intent``) ``reloc_offset`` clocks before the
    access; the relocation is executed at the next round boundary.  Accesses
    to cold keys that are not (yet, or anymore) on the node are synchronous
    remote accesses — including *relocation conflicts*, where another node
    localized the key away in the meantime (§5.7).

    Relocations are applied vectorized: queued localizes are grouped by key
    and replayed as an ownership chain (same final owner and relocation
    count as the seed's FIFO loop; forwarding for the intra-round chain tail
    is charged at one hop).
    """

    def __init__(self, n_nodes: int, cost: CostModel, n_keys: int,
                 hot_keys: Set[int], reloc_offset: int = 64):
        super().__init__(n_nodes, cost)
        self.name = f"NuPS(hot={len(hot_keys)},off={reloc_offset})"
        self.hot = hot_keys
        self._hot_arr = np.fromiter(sorted(hot_keys), np.int64,
                                    len(hot_keys))
        self.reloc_offset = reloc_offset
        self.owners = OwnerTable(n_nodes, capacity=n_keys)
        self._dirty_hot: List[List[np.ndarray]] = [
            [] for _ in range(n_nodes)]
        self._last_hot_sync = 0.0
        # localize requests queued until the next round
        self._pend_node: List[np.ndarray] = []
        self._pend_key: List[np.ndarray] = []
        self._pend_start: List[np.ndarray] = []
        self._clock: List[int] = [0] * n_nodes
        self.metrics.peak_mem_bytes = (
            len(hot_keys) + n_keys / n_nodes) * cost.value_bytes

    def advance_clock(self, node, worker, clock):
        if clock > self._clock[node]:
            self._clock[node] = clock

    def signal_intent(self, node: int, intent: Intent, now: float) -> None:
        # The application issues localize() reloc_offset ahead; intents that
        # arrive earlier are still queued at the fixed offset semantics —
        # NuPS has no action timing, it acts on whatever was localized at
        # the next round (the offset is the app's tuning knob).
        keys = np.asarray(intent.keys, np.int64)
        cold = keys[~np.isin(keys, self._hot_arr)]
        if len(cold):
            self._pend_node.append(np.full(len(cold), node, np.int64))
            self._pend_key.append(cold)
            self._pend_start.append(
                np.full(len(cold), intent.c_start, np.int64))

    def access(self, node, worker, key, now, write=True):
        self.metrics.n_accesses += 1
        if key in self.hot:
            if write:
                self._dirty_hot[node].append(np.array([key], np.int64))
            stale = max(0.0, now - self._last_hot_sync)
            self.metrics.staleness_sum += stale
            self.metrics.n_replica_reads += 1
            return AccessResult(local=True, staleness=stale)
        if self.owners.owner_of(key) == node:
            return AccessResult(local=True, staleness=0.0)
        # relocation conflict or missed localize -> synchronous remote access
        hops = int(self.owners.route_batch(
            node, np.array([key], np.int64))[0])
        nbytes = 2 * self.cost.value_bytes + hops * 64
        self.metrics.n_remote += 1
        self.ledger.charge(node, nbytes, nmsgs=1 + hops)
        return AccessResult(local=False)

    def access_batch(self, node, worker, keys, now, dur, budget):
        keys = np.asarray(keys, np.int64)
        self.owners.ensure_capacity(int(keys.max()) + 1 if len(keys) else 0)
        hot = np.isin(keys, self._hot_arr)
        own = self.owners.owners(keys) == node
        local = hot | (own & ~hot)
        costs = np.where(local, self.cost.t_local, self.cost.t_remote)
        n, spent, excl = budget_prefix(costs, budget)
        keys, hot, own = keys[:n], hot[:n], own[:n]
        times = now + (dur - budget) + excl[:n]
        self.metrics.n_accesses += n
        n_hot = int(np.count_nonzero(hot))
        if n_hot:
            self._dirty_hot[node].append(keys[hot].copy())
            self.metrics.staleness_sum += float(np.maximum(
                0.0, times[hot] - self._last_hot_sync).sum())
            self.metrics.n_replica_reads += n_hot
        rem = ~hot & ~own
        n_rem = int(np.count_nonzero(rem))
        if n_rem:
            hops = int(self.owners.route_batch(node, keys[rem]).sum())
            self.metrics.n_remote += n_rem
            self.ledger.charge(
                node, 2 * self.cost.value_bytes * n_rem + 64 * hops,
                nmsgs=n_rem + hops)
        return n, budget - spent

    def run_round(self, now, round_duration_hint):
        self.metrics.rounds += 1
        c = self.cost
        # hot-set AllReduce-ish sync every round
        for node in range(self.n_nodes):
            if self._dirty_hot[node]:
                n_dirty = len(np.unique(
                    np.concatenate(self._dirty_hot[node])))
                self.ledger.charge(node, 2.0 * n_dirty * c.value_bytes,
                                   nmsgs=2 * (self.n_nodes - 1))
                self._dirty_hot[node] = []
        self._last_hot_sync = now
        # execute queued relocations whose access is within the offset window
        if not self._pend_key:
            return
        nodes = np.concatenate(self._pend_node)
        keys = np.concatenate(self._pend_key)
        starts = np.concatenate(self._pend_start)
        self._pend_node, self._pend_key, self._pend_start = [], [], []
        clock = np.asarray(self._clock, np.int64)
        due = starts - clock[nodes] <= self.reloc_offset
        if not np.all(due):
            self._pend_node = [nodes[~due]]
            self._pend_key = [keys[~due]]
            self._pend_start = [starts[~due]]
        nodes, keys = nodes[due], keys[due]
        if len(keys) == 0:
            return
        # replay the localize queue as per-key ownership chains
        order = np.argsort(keys, kind="stable")
        ks, ns = keys[order], nodes[order]
        first = np.empty(len(ks), bool)
        first[0] = True
        first[1:] = ks[1:] != ks[:-1]
        prev = np.empty(len(ks), np.int64)
        prev[first] = self.owners.owners(ks[first])
        prev[~first] = ns[np.nonzero(~first)[0] - 1]
        moves = prev != ns
        self.metrics.n_relocations += int(np.count_nonzero(moves))
        # head-of-chain moves pay routed hops; chain tails forward directly
        head = first & moves
        for node in range(self.n_nodes):
            hm = head & (ns == node)
            if np.any(hm):
                hops = self.owners.route_batch(node, ks[hm])
                np.add.at(self.ledger.bytes_out, prev[hm],
                          c.value_bytes + 64.0 * hops)
        tail = ~first & moves
        if np.any(tail):
            np.add.at(self.ledger.bytes_out, prev[tail],
                      float(c.value_bytes + 64))
        last = np.empty(len(ks), bool)
        last[-1] = True
        last[:-1] = ks[1:] != ks[:-1]
        self.owners.relocate_batch(ks[last], ns[last])
