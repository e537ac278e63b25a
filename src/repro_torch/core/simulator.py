"""Discrete-event cluster simulator for parameter-management policies
(the twin of `repro/core/simulator.py`).

Models the paper's execution environment (§5.1): N nodes, W worker threads
per node, a data loader per worker that prepares batches ``signal_offset``
batches ahead (and signals intent when a batch is prepared), and background
communication rounds.  Time advances in rounds; a round's duration is the
max over nodes of its grouped sync traffic (bytes / bandwidth + per-message
overhead), floored at ``base_round``.  During a round every worker computes:
each key access costs ``t_local`` when the key is locally available (owned
or replicated at the node) and ``t_remote`` (a synchronous network stall)
otherwise; finishing a batch costs ``t_batch`` and advances the worker's
logical clock.

The simulator is the only omniscient party; policies only use node-local
information through the `PMPolicy` hooks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .api import CostModel, Metrics, PMPolicy
from .intent import Intent


@dataclass
class Workload:
    """Pre-generated access streams.  ``streams[node][worker]`` is a list of
    batches; each batch is a 1-D int array of distinct keys accessed while
    training on that batch."""

    name: str
    n_keys: int
    streams: List[List[List[np.ndarray]]]

    @property
    def n_nodes(self) -> int:
        return len(self.streams)

    @property
    def workers_per_node(self) -> int:
        return len(self.streams[0])

    def key_frequencies(self) -> np.ndarray:
        freq = np.zeros(self.n_keys, dtype=np.int64)
        for node_streams in self.streams:
            for stream in node_streams:
                for batch in stream:
                    np.add.at(freq, batch, 1)
        return freq

    def hot_keys(self, frac: float) -> set:
        freq = self.key_frequencies()
        k = max(1, int(frac * self.n_keys))
        top = np.argpartition(freq, -k)[-k:]
        return set(int(x) for x in top if freq[x] > 0)


@dataclass
class SimConfig:
    signal_offset: int = 100       # batches the loader runs ahead
    intent_window: int = 1         # clocks an intent spans (one batch)
    max_rounds: int = 500_000
    track_mem_every: int = 64


@dataclass
class _WorkerState:
    batch_idx: int = 0
    key_idx: int = 0
    clock: int = 0
    carry: float = 0.0             # budget carried across round boundaries
    loader_next: int = 0           # next batch the loader will prepare


def _worker_gid(node: int, worker: int, wpn: int) -> int:
    return node * wpn + worker


def simulate(policy: PMPolicy, workload: Workload, cfg: SimConfig) -> Metrics:
    """Run one epoch of ``workload`` under ``policy``; returns its metrics."""
    cost = policy.cost
    n_nodes = workload.n_nodes
    wpn = workload.workers_per_node
    if hasattr(policy, "_n_keys_hint"):
        policy._n_keys_hint = workload.n_keys

    states: Dict[int, _WorkerState] = {}
    for node in range(n_nodes):
        for w in range(wpn):
            gid = _worker_gid(node, w, wpn)
            st = _WorkerState()
            states[gid] = st
            policy.advance_clock(node, gid, 0)

    def signal_up_to(node: int, w: int, now: float) -> None:
        """Loader keeps ``signal_offset`` batches prepared ahead."""
        gid = _worker_gid(node, w, wpn)
        st = states[gid]
        stream = workload.streams[node][w]
        limit = min(len(stream), st.batch_idx + cfg.signal_offset)
        while st.loader_next < limit:
            b = st.loader_next
            policy.signal_intent(
                node,
                Intent(keys=stream[b], c_start=b,
                       c_end=b + cfg.intent_window, worker_id=gid),
                now)
            st.loader_next += 1

    now = 0.0
    for node in range(n_nodes):
        for w in range(wpn):
            signal_up_to(node, w, now)

    metrics = policy.metrics
    unfinished = sum(len(workload.streams[n][w]) > 0
                     for n in range(n_nodes) for w in range(wpn))
    prev_dur = cost.base_round
    rounds = 0
    while unfinished > 0 and rounds < cfg.max_rounds:
        # collect last round's traffic (sync + ad-hoc remote accesses)
        metrics.total_bytes += float(np.sum(policy.ledger.bytes_out))
        policy.ledger.reset()
        policy.run_round(now, prev_dur)
        comm = max(
            float(policy.ledger.bytes_out[n]) / cost.bandwidth
            + int(policy.ledger.msgs[n]) * cost.per_msg
            for n in range(n_nodes))
        dur = max(cost.base_round, comm)
        # compute phase: every worker gets `dur` seconds; accesses are
        # accounted batch-at-a-time through `PMPolicy.access_batch`
        for node in range(n_nodes):
            for w in range(wpn):
                gid = _worker_gid(node, w, wpn)
                st = states[gid]
                stream = workload.streams[node][w]
                if st.batch_idx >= len(stream):
                    continue
                budget = dur + st.carry
                while budget > 0.0 and st.batch_idx < len(stream):
                    batch = stream[st.batch_idx]
                    if st.key_idx < len(batch):
                        n_done, budget = policy.access_batch(
                            node, gid, batch[st.key_idx:], now, dur, budget)
                        st.key_idx += n_done
                    if st.key_idx >= len(batch) and budget > 0.0:
                        budget -= cost.t_batch
                        st.key_idx = 0
                        st.batch_idx += 1
                        st.clock = st.batch_idx
                        policy.advance_clock(node, gid, st.clock)
                        signal_up_to(node, w, now + (dur - max(budget, 0.0)))
                        if st.batch_idx >= len(stream):
                            unfinished -= 1
                st.carry = min(budget, 0.0)
        now += dur
        prev_dur = dur
        rounds += 1
        if rounds % cfg.track_mem_every == 0:
            peak = max(policy.mem_bytes(n) for n in range(n_nodes))
            metrics.peak_mem_bytes = max(metrics.peak_mem_bytes, peak)
    metrics.total_bytes += float(np.sum(policy.ledger.bytes_out))
    metrics.epoch_time = now
    metrics.bytes_per_node = metrics.total_bytes / n_nodes
    return metrics


def single_node_epoch_time(workload: Workload, cost: CostModel) -> float:
    """Efficient shared-memory single-node baseline (§5.2): all accesses are
    local; the (same) global work is executed by the same number of worker
    threads on one node."""
    per_worker_times = []
    for node_streams in workload.streams:
        for stream in node_streams:
            t = sum(len(b) * cost.t_local + cost.t_batch for b in stream)
            per_worker_times.append(t)
    # workers run in parallel threads; epoch ends when the slowest finishes,
    # but on ONE node all streams run concurrently on that node's cores:
    # with the same total thread count as the cluster, time is the max of
    # per-thread times scaled by the node/cluster thread ratio.
    n_total = len(per_worker_times)
    wpn = len(workload.streams[0])
    scale = n_total / wpn  # one node has wpn threads, cluster has n_total
    return max(per_worker_times) * scale
