"""Common interface between parameter-management policies and the cluster
simulator, plus the metric containers every policy reports (the twin of
`repro/core/api.py`), and the latency accounting the serving scheduler
shares (`LatencyRecorder`).  Numpy only.

A *policy* owns all PM state (ownership, replicas, intent tables) and is
driven by the simulator through the hooks below.  The simulator owns time,
workers, clocks, and the access streams.  Traffic is charged to per-node,
per-round byte/message counters held by the policy's ``RoundLedger``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .intent import Intent


@dataclass
class CostModel:
    """Network / compute cost model for the simulated cluster.

    Defaults loosely model the paper's testbed: 100 Gbit/s links
    (~12.5 GB/s; we use an effective per-node bandwidth), sub-ms round
    latencies, microsecond local accesses, ~100 microsecond synchronous
    remote accesses (request + response + queueing).
    """

    value_bytes: int = 4 * 500          # one parameter value (dim 500 fp32)
    bandwidth: float = 6e9              # effective B/s per node
    per_msg: float = 20e-6              # s per (grouped) message
    base_round: float = 2e-3            # s floor per communication round
    t_local: float = 0.8e-6             # s per local key access
    t_remote: float = 120e-6            # s stall per synchronous remote access
    t_batch: float = 200e-6             # s compute per batch (besides access)
    signal_bytes: int = 16              # per aggregated intent transition
    node_mem_bytes: float = 512e9       # per-node memory capacity


def budget_prefix(costs: np.ndarray, budget: float
                  ) -> Tuple[int, float, np.ndarray]:
    """Batched compute-budget rule shared by every ``access_batch``: access
    i runs iff the budget *before* it is positive (the final access may push
    the budget negative; the simulator carries the deficit).  Returns
    ``(n_processed, spent, exclusive_cumsum)`` — ``(0, 0.0, ...)`` when no
    access fits or ``costs`` is empty."""
    cum = np.cumsum(costs)
    excl = cum - costs
    n = int(np.count_nonzero(budget - excl > 0.0))
    spent = float(cum[n - 1]) if n else 0.0
    return n, spent, excl


@dataclass
class RoundLedger:
    """Per-round traffic accumulator (reset by the simulator each round).

    Holds numpy arrays so vectorized policies (the intent engine) can charge
    whole batches at once with ``np.add.at``."""

    n_nodes: int
    bytes_out: np.ndarray = field(default_factory=lambda: np.zeros(0))
    msgs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        self.reset()

    def reset(self):
        self.bytes_out = np.zeros(self.n_nodes, np.float64)
        self.msgs = np.zeros(self.n_nodes, np.int64)

    def charge(self, node: int, nbytes: float, nmsgs: int = 0):
        self.bytes_out[node] += nbytes
        self.msgs[node] += nmsgs


@dataclass
class Metrics:
    """Per-run metrics (one epoch unless stated otherwise)."""

    epoch_time: float = 0.0
    bytes_per_node: float = 0.0         # mean over nodes, total for run
    total_bytes: float = 0.0
    n_accesses: int = 0
    n_remote: int = 0
    staleness_sum: float = 0.0          # seconds, summed over replica reads
    n_replica_reads: int = 0
    n_relocations: int = 0
    n_replica_creates: int = 0
    peak_mem_bytes: float = 0.0
    oom: bool = False
    rounds: int = 0

    @property
    def remote_fraction(self) -> float:
        return self.n_remote / max(1, self.n_accesses)

    @property
    def mean_staleness(self) -> float:
        return self.staleness_sum / max(1, self.n_replica_reads)

    def as_dict(self) -> Dict[str, float]:
        return {
            "epoch_time_s": round(self.epoch_time, 4),
            "gb_per_node": round(self.bytes_per_node / 1e9, 4),
            "remote_frac": round(self.remote_fraction, 6),
            "mean_staleness_ms": round(self.mean_staleness * 1e3, 3),
            "relocations": self.n_relocations,
            "replica_creates": self.n_replica_creates,
            "rounds": self.rounds,
            "oom": self.oom,
        }


@dataclass
class AccessResult:
    local: bool
    staleness: Optional[float] = None   # set for replica reads
    stalled: bool = False               # worker blocked on the network
    # (remote accesses always stall; a *local* access can still stall when
    #  the policy had to fetch/refresh synchronously first, e.g. SSP)

    @property
    def worker_stalled(self) -> bool:
        return self.stalled or not self.local


class PMPolicy:
    """Interface the simulator drives.  All hooks are node-local in the
    information they may use; the simulator is the only omniscient party."""

    name: str = "abstract"

    def __init__(self, n_nodes: int, cost: CostModel):
        self.n_nodes = n_nodes
        self.cost = cost
        self.ledger = RoundLedger(n_nodes)
        self.metrics = Metrics()

    # --- intent & clocks -------------------------------------------------
    def signal_intent(self, node: int, intent: Intent, now: float) -> None:
        """Loader on ``node`` signals an intent.  Optional for policies that
        ignore intent (static baselines)."""

    def advance_clock(self, node: int, worker: int, clock: int) -> None:
        """Worker finished a batch; its logical clock is now ``clock``."""

    # --- access path ------------------------------------------------------
    def access(self, node: int, worker: int, key: int,
               now: float, write: bool = True) -> AccessResult:
        """One parameter access during batch processing.  Returns whether the
        access was local; charges remote traffic to the ledger otherwise."""
        raise NotImplementedError

    def access_batch(self, node: int, worker: int, keys: Sequence[int],
                     now: float, dur: float, budget: float
                     ) -> Tuple[int, float]:
        """Process ``keys`` (distinct, in order) during the compute phase of
        the round ``[now, now + dur)`` until ``budget`` is exhausted; each
        access costs ``t_local`` or ``t_remote`` depending on whether the
        worker stalls.  Returns ``(n_processed, remaining_budget)`` — the
        budget may go negative on the final access (carried by the
        simulator).  The default implementation loops over ``access()``;
        vectorized policies override it with batched accounting."""
        n_done = 0
        for k in keys:
            if budget <= 0.0:
                break
            t_access = now + (dur - max(budget, 0.0))
            res = self.access(node, worker, int(k), t_access)
            budget -= (self.cost.t_remote if res.worker_stalled
                       else self.cost.t_local)
            n_done += 1
        return n_done, budget

    # --- communication rounds ----------------------------------------------
    def run_round(self, now: float, round_duration_hint: float) -> None:
        """Executed at a round boundary: exchange grouped sync messages,
        make decisions, apply relocations/replications, charge traffic."""
        raise NotImplementedError

    def mem_bytes(self, node: int) -> float:
        """Current PM memory footprint on ``node`` (for OOM checks)."""
        return 0.0

    def finalize(self) -> Metrics:
        return self.metrics


class LatencyRecorder:
    """Streaming latency accounting: record seconds, read percentiles."""

    def __init__(self):
        self._vals: List[float] = []

    def record(self, seconds: float) -> None:
        self._vals.append(float(seconds))

    def extend(self, seconds: Sequence[float]) -> None:
        self._vals.extend(float(s) for s in seconds)

    def __len__(self) -> int:
        return len(self._vals)

    def reset(self) -> None:
        self._vals.clear()

    def percentile(self, q: float) -> float:
        if not self._vals:
            return 0.0
        return float(np.percentile(np.asarray(self._vals), q))

    def mean(self) -> float:
        return float(np.mean(self._vals)) if self._vals else 0.0

    def summary_ms(self, qs: Tuple[float, ...] = (50.0, 99.0)
                   ) -> Dict[str, float]:
        out = {f"p{q:g}_ms": round(self.percentile(q) * 1e3, 4)
               for q in qs}
        out["mean_ms"] = round(self.mean() * 1e3, 4)
        out["count"] = len(self._vals)
        return out
