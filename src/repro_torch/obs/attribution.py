"""Plan-vs-actual attribution at replan boundaries (DESIGN.md §14).

The controller moves knobs and the planner promises miss rates; this
module is the audit trail that says whether reality agreed.  The serving
runtime feeds every executed batch's token-level hit mask into a
`PlanAttribution` tracker (host-side numpy, admission-time — no device
readbacks), and at each replan boundary `flush()` closes the outgoing
plan's tenure into one `AttributionRecord`:

  * predicted vs realized miss rate — the outgoing plan's
    ``predicted_miss_rate`` against what the executed batches measured;
  * per-owner-shard miss counts — which shard's rows the misses landed
    on (``owner = id // ceil(V / owner_shards)``, the engine's affine
    ownership rule), the signal the mesh route capacity is sized by;
  * top-K hot keys behind the uncovered misses — the specific ids a
    better plan would have cached, ranked by missed-access count;
  * the knob/capacity decisions taken during the window with their
    triggering signal — read back from the telemetry bus's ``ctl.*`` /
    capacity-resize events, so "why did the knob move" and "what did it
    cost" live in one record.

Records are emitted onto the telemetry bus (``attr.replan`` events),
kept on the tracker (``records``), and serialize to schema-versioned
JSON for the `obs.export.JsonlSink` — `python -m repro_torch.obs.report`
renders them as the miss-attribution table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.telemetry import Telemetry, json_safe

# the JAX package's format name: exported files are read by either
# package's report
ATTRIBUTION_SCHEMA = "repro.obs.attribution/v1"


@dataclass
class AttributionRecord:
    """One closed plan tenure: what the plan promised, what happened."""

    round: int                   # replan boundary (runtime round / step)
    plan_version: int            # outgoing plan (0 = no plan yet)
    cause: str                   # what triggered the replan that closed it
    batches: int                 # executed batches in the tenure
    tokens: int                  # token-level accesses observed
    misses: int                  # token-level cache misses observed
    predicted_miss_rate: float   # the outgoing plan's promise
    realized_miss_rate: Optional[float]  # None: no batch executed
    per_owner_misses: Dict[int, int]     # owner shard -> missed accesses
    top_keys: List[Tuple[int, int]]      # (key, miss count), hottest first
    capacity: int                # replica-cache capacity at the boundary
    miss_capacity: int           # the new plan's compact-buffer bucket
    knobs: Dict[str, object]     # live knob values at the boundary
    prefetch_hits: int = 0       # miss slots served from the tenure's
    #   staged prefetch buffer (DESIGN.md §15)
    prefetch_stale: int = 0      # miss slots the stage did not cover —
    #   they paid the residual collective gather
    decisions: List[dict] = field(default_factory=list)
    #   ctl.* / capacity-resize bus events during the tenure (each carries
    #   its own ``cause`` — the triggering signal)

    @property
    def miss_rate_error(self) -> Optional[float]:
        """Realized minus predicted (positive: plan was optimistic)."""
        if self.realized_miss_rate is None:
            return None
        return self.realized_miss_rate - self.predicted_miss_rate

    def to_json(self) -> dict:
        return json_safe({
            "schema": ATTRIBUTION_SCHEMA,
            "round": self.round,
            "plan_version": self.plan_version,
            "cause": self.cause,
            "batches": self.batches,
            "tokens": self.tokens,
            "misses": self.misses,
            "predicted_miss_rate": round(self.predicted_miss_rate, 6),
            "realized_miss_rate": (
                None if self.realized_miss_rate is None
                else round(self.realized_miss_rate, 6)),
            "per_owner_misses": {str(k): v for k, v in
                                 sorted(self.per_owner_misses.items())},
            "top_keys": [[k, c] for k, c in self.top_keys],
            "capacity": self.capacity,
            "miss_capacity": self.miss_capacity,
            "knobs": dict(self.knobs),
            "prefetch_hits": self.prefetch_hits,
            "prefetch_stale": self.prefetch_stale,
            "decisions": self.decisions,
        })


class PlanAttribution:
    """Accumulates per-batch observations, flushes one record per replan.

    ``owner_shards``/``vocab`` enable the per-owner split (0 = no owner
    accounting, matching non-mesh backends); ``telemetry`` is the bus the
    decision events are read back from (and the records are published
    to) — the same bus the runtime and controller share."""

    def __init__(self, *, owner_shards: int = 0, vocab: int = 0,
                 top_k: int = 8, telemetry: Optional[Telemetry] = None):
        self.owner_shards = int(owner_shards)
        self.vocab = int(vocab)
        self.top_k = int(top_k)
        self.telemetry = telemetry
        self.records: List[AttributionRecord] = []
        self._pending: List[np.ndarray] = []   # missed ids, per batch
        self._tokens = 0
        self._misses = 0
        self._batches = 0
        self._prefetch_hits = 0
        self._prefetch_stale = 0
        self._last_seq = -1      # high-water mark into the bus event log

    # ----------------------------------------------------- accumulation
    def note_batch(self, tokens: np.ndarray, hit: np.ndarray) -> None:
        """One executed batch: flat token ids and the aligned boolean
        cache-hit mask (both come straight from the admission probe).
        Hot-path cheap on purpose — the missed ids are stashed raw and
        only aggregated (`np.unique`) once per tenure, at `flush`."""
        tokens = np.asarray(tokens).reshape(-1)
        hit = np.asarray(hit, bool).reshape(-1)
        self._batches += 1
        self._tokens += tokens.size
        missed = tokens[~hit]                  # boolean index: a copy
        self._misses += missed.size
        if missed.size:
            self._pending.append(missed)

    def note_prefetch(self, hits: int, stale: int) -> None:
        """One executed batch's staged-prefetch outcome: how many of its
        unique miss slots the tenure's staging buffer covered (``hits``)
        vs fell through to the residual collective gather (``stale``)."""
        self._prefetch_hits += int(hits)
        self._prefetch_stale += int(stale)

    # ----------------------------------------------------------- flush
    def _window_decisions(self) -> List[dict]:
        if self.telemetry is None:
            return []
        out = []
        for ev in self.telemetry.events():
            if ev["_seq"] <= self._last_seq:
                continue
            name = ev["_name"]
            if name.startswith("ctl.") or name.endswith("capacity_resize"):
                out.append(json_safe(ev))
        if out:
            self._last_seq = max(ev["_seq"] for ev in out)
        return out

    def flush(self, *, rnd: int, plan, cause: str,
              knobs: Dict[str, object], capacity: int,
              miss_capacity: int = 0) -> AttributionRecord:
        """Close the outgoing plan's tenure (``plan`` — None before the
        first replan) into a record and reset the accumulators."""
        realized = (self._misses / self._tokens
                    if self._tokens else None)
        miss_counts: Dict[int, int] = {}
        if self._pending:
            keys, counts = np.unique(np.concatenate(self._pending),
                                     return_counts=True)
            miss_counts = dict(zip(keys.tolist(), counts.tolist()))
        per_owner: Dict[int, int] = {}
        if self.owner_shards > 0 and self.vocab > 0 and miss_counts:
            block = -(-self.vocab // self.owner_shards)
            for k, c in miss_counts.items():
                o = int(k) // block
                per_owner[o] = per_owner.get(o, 0) + c
        top = sorted(miss_counts.items(),
                     key=lambda kc: (-kc[1], kc[0]))[: self.top_k]
        rec = AttributionRecord(
            round=int(rnd),
            plan_version=int(plan.version) if plan is not None else 0,
            cause=cause,
            batches=self._batches,
            tokens=self._tokens,
            misses=self._misses,
            predicted_miss_rate=(float(plan.predicted_miss_rate)
                                 if plan is not None else 0.0),
            realized_miss_rate=realized,
            per_owner_misses=per_owner,
            top_keys=[(int(k), int(c)) for k, c in top],
            capacity=int(capacity),
            miss_capacity=int(miss_capacity),
            knobs=json_safe(dict(knobs)),
            prefetch_hits=self._prefetch_hits,
            prefetch_stale=self._prefetch_stale,
            decisions=self._window_decisions(),
        )
        self.records.append(rec)
        if self.telemetry is not None:
            self.telemetry.event(
                "attr.replan", round=rec.round,
                plan_version=rec.plan_version, cause=cause,
                predicted=rec.predicted_miss_rate,
                realized=rec.realized_miss_rate, misses=rec.misses,
                tokens=rec.tokens)
        self._pending = []
        self._tokens = 0
        self._misses = 0
        self._batches = 0
        self._prefetch_hits = 0
        self._prefetch_stale = 0
        return rec
