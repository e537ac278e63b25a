"""Online serving runtime over the intent-managed embedding (§9, §13);
the PyTorch twin of `repro/serve/runtime.py`.

The loop that closes the paper's adaptation story *online*: enqueued
requests have already signaled intent for the rows they will touch
(`RequestQueue.enqueue` -> `StreamingIntentBuffer`), the planner
continuously re-plans the replica cache from that streaming intent
(`IntentPlanner.replan_from_queue` over the queued horizon), and batches
execute through the read-only serving data path — the hand-written CUDA
kernels or their plain versions (`ServeConfig.kernel`), over the emulated
collective backend (DESIGN.md §10) or the vocab-parallel mesh
(``collective="mesh"``: every rank of the started process group runs
this runtime on the same request stream and holds its block of the
table; only each owner's run of a batch's unique misses crosses the
wire, and admission bounds the misses per owner), no VJP, no optimizer.
The runtime runs on the card unless it is given ``device="cpu"``.

Re-planning is feedback-driven: a plan carries its own predicted miss
rate (exact over the horizon it was built from), and the runtime replans
early the moment observed misses say the workload drifted away from the
plan —

    replan  iff  rounds_since_plan >= replan_every        (cadence floor)
             or  batch overflowed its miss buffer          (hard signal)
             or  miss_rate > drift_factor * predicted      (soft signal)

Zero-tuning (DESIGN.md §13): every runtime knob accepts ``"auto"`` — the
default for capacity and cadence — and is then owned by the online
controller (`pm.controller.OnlineController`) instead of an operator:

  cache_capacity   steered by the *intent signal* at every replan: the
                   queued horizon's cache-worthy demand
                   (`PlacementPlan.demand`) picks the power-of-two bucket
                   (grow immediately, shrink with hysteresis).  Mid-run
                   resizes are exact — the new plan, cache ids and cache
                   rows are installed atomically at a replan boundary, so
                   no batch ever sees a mixed capacity (tested
                   byte-identical across resize boundaries).
  replan_every /   epsilon-greedy hill-climb on measured epoch throughput
  batch_requests / (requests/s between replan boundaries), one knob in
  pipeline_depth   flight at a time; the depth starts at 1.

Every adaptation signal the runtime acts on — miss rate, overflow and
requeue counts, replan causes, capacity resizes, per-round latency — is
published to the `repro.obs.telemetry` bus (``serve.*`` records); the
controller consumes the bus at replan boundaries, so benches, tests and
the controller all read the same source of truth.

Because the whole index stage runs on the host at admission
(`probe_host`), every drift signal is known *before* the batch executes —
which is what makes the admission loop pipelineable: the runtime
dispatches batch t to the device and, while it executes, enqueues /
replans / probes batch t+1 on the host; batch t is only blocked one
round later — on one CUDA event per batch, the only place the host waits
for the device.  Semantics are identical to the serial loop (tested).

Overflowed requests are NEVER served zeros: their rows come back flagged,
the requests re-enter the queue front, and the overflow itself is the
drift signal that triggers the replan that will fit them.  Replica
refresh follows the table's declared mutability: with ``refresh_every >
0`` the cache is re-gathered on every replan and every ``refresh_every``
rounds in between, so an out-of-band table update (e.g. a trainer
checkpoint swap) reaches replicas within one refresh round — the serving
analogue of the training loop's bounded staleness.  With ``refresh_every
== 0`` (read-only table, the serving default) a replan that kept the
cache contents skips the (C, D) re-gather entirely
(``serve.refresh_skipped``) — steady-state replans then cost plan
arithmetic only.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import StreamingIntentBuffer
from repro_torch.device import resolve_device
from repro_torch.obs.attribution import PlanAttribution
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.trace import SpanTracer, make_tracer
from repro_torch.pm.collectives import make_backend, resolve, route_block
from repro_torch.pm.controller import (AUTO, Knob, OnlineController,
                                       capacity_ladder, is_auto,
                                       pow2_ladder, resolve_knob)
from repro_torch.pm.embedding import (CacheProbeView, plain_serve_lookup,
                                      planned_serve_lookup, probe_host)
from repro_torch.pm.planner import IntentPlanner, PlacementPlan
from repro_torch.serve.requests import RequestQueue
from repro_torch.serve.scheduler import MicroBatchScheduler


@dataclass
class ServeConfig:
    vocab: int
    batch_requests: Union[int, str] = 32   # requests per micro-batch;
    #   "auto": hill-climbed over a power-of-two ladder
    keys_per_request: int = 16
    cache_capacity: Union[int, str] = AUTO  # replica-cache rows; "auto"
    #   (the default): intent-steered power-of-two buckets, resized
    #   mid-run at replan boundaries (DESIGN.md §13)
    managed: bool = True         # False: plain vocab-parallel baseline
    n_shards: int = 1            # emulated vocab shards (collective cost)
    collective: str = "emulated"  # collective backend for the lookup
    #   data path: "emulated" | "mesh" (pm/collectives.py)
    model_shards: int = 0        # mesh size for collective="mesh" (0 =
    #   every rank of the started process group)
    kernel: bool = True          # the lookup's row copies run in the
    #   hand-written CUDA kernels (plain versions on CPU tensors); False
    #   runs the plain PyTorch versions on every device
    pipeline_depth: Union[int, str] = AUTO  # N-deep admission->probe->
    #   prefetch->dispatch pipeline (DESIGN.md §15): up to N batches stay
    #   dispatched-but-unblocked while the host stages the next rounds,
    #   and each plan tenure prefetches its queued horizon's miss rows
    #   into a staging buffer so steady-state batches pay only the
    #   residual collective gather.  0 = the fully synchronous loop.
    #   "auto" (default): starts at 1 (the staging prefetch is pure
    #   work elimination) and the controller hill-climbs the depth.
    replan_every: Union[int, str] = AUTO  # cadence floor (rounds between
    #   replans); "auto": hill-climbed.  0 = feedback-only mode: replan
    #   solely on drift signals (overflow / miss-rate), never on cadence
    #   or window exhaustion
    refresh_every: Union[int, str] = AUTO  # extra replica re-gathers
    #   between replans.  "auto" resolves to 0 — replan rounds only, the
    #   right value for a read-only serving table (set >0 explicitly when
    #   a trainer swaps the table out-of-band)
    drift_factor: float = 2.0    # soft replan: observed > factor*predicted
    max_attempts: int = 8        # loud failure, never a silent zero row
    summary: bool = True         # print the one-line telemetry summary at
    #   the end of the runtime's first run (the shutdown line)
    trace: bool = False          # span tracing (DESIGN.md §14): default
    #   OFF — disabled call sites cost one early-return branch; enabled
    #   at trace_sample=1.0 the serve bench pins the cost under 2%
    trace_sample: float = 1.0    # deterministic per-rid sampling for
    #   request spans (phase spans always record when tracing is on)
    trace_capacity: int = 1 << 15  # span ring size (oldest spans evicted)
    seed: int = 0


@dataclass
class ServeResult:
    served: int = 0
    rounds: int = 0
    replans: int = 0
    refreshes: int = 0
    requeues: int = 0            # requests re-queued after overflow
    overflow_batches: int = 0    # batches whose unique misses exceeded M
    zero_served: int = 0         # MUST stay 0: served rows with overflow
    capacity_resizes: int = 0    # mid-run replica-cache bucket changes
    throughput_rps: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    mean_ms: float = 0.0
    wall_s: float = 0.0
    miss_trace: List[Tuple[int, float]] = field(default_factory=list)
    #   (round, token-level miss rate) per executed batch
    replan_rounds: List[int] = field(default_factory=list)
    plan_miss_capacities: List[int] = field(default_factory=list)
    capacity_trace: List[Tuple[int, int]] = field(default_factory=list)
    #   (round, cache_capacity) per mid-run resize
    knobs: Dict[str, object] = field(default_factory=dict)
    #   the runtime's knob values at the end of the run (auto knobs land
    #   wherever the controller drove them)
    outputs: Dict[int, np.ndarray] = field(default_factory=dict)
    #   rid -> (K, D) served rows (only when run(collect_outputs=True))

    def steady_miss_rate(self, lo: int, hi: int) -> Optional[float]:
        """Mean batch miss rate over rounds [lo, hi); None when no batch
        executed in the window (callers must not treat an unmeasured
        window as a perfect one)."""
        vals = [m for r, m in self.miss_trace if lo <= r < hi]
        return float(np.mean(vals)) if vals else None


@dataclass
class _InFlight:
    """A dispatched-but-not-yet-blocked batch (pipelined admission):
    everything bookkeeping needs was decided at dispatch time from the
    host-side probe — blocking only realizes the rows and the clock."""

    out: torch.Tensor            # the (T, D) rows, possibly in flight
    done: Optional[torch.cuda.Event]  # recorded after the batch's work
    #                              (None on the CPU, where work is eager)
    reqs: list                   # the batch's real requests
    served: list                 # probe-decided: requests to serve
    served_mask: np.ndarray      # per-req bool aligned with ``reqs``
    tokens_shape: tuple


class ServingRuntime:
    """Queue -> intent -> plan -> execute, one micro-batch per round."""

    def __init__(self, table, cfg: ServeConfig,
                 telemetry: Optional[Telemetry] = None,
                 tracer: Optional[SpanTracer] = None, device=None):
        """``table``: (vocab, D) numpy array or tensor, moved to
        ``device`` (None: ``cuda``, which must then be available).  On
        the mesh only this rank's block of it is moved, and ``device``
        must be of the process group's kind."""
        self.cfg = cfg
        self.device = resolve_device(device)
        table = torch.as_tensor(table)
        if table.dim() != 2 or table.shape[0] != cfg.vocab:
            raise ValueError(f"table shape {tuple(table.shape)} does "
                             f"not match vocab={cfg.vocab}")
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # span tracer: an injected instance wins (the bench shares one
        # across runtimes); otherwise built from the cfg — default off
        self.tracer = make_tracer(cfg.trace, cfg.trace_sample,
                                  cfg.trace_capacity, tracer)
        self.backend = make_backend(cfg.collective, cfg.model_shards)
        if self.backend is not None:
            if self.device.type != self.backend.device.type:
                raise ValueError(f"the mesh's ranks run on "
                                 f"{self.backend.device.type}, the runtime "
                                 f"was asked for {self.device}")
            self.device = self.backend.device
            self.table = self.backend.place_table(table)
        else:
            self.table = table.to(self.device)

        # ---- knob resolution: "auto" fields belong to the controller
        self._auto = {name for name, v in (
            ("cache_capacity", cfg.cache_capacity),
            ("replan_every", cfg.replan_every),
            ("refresh_every", cfg.refresh_every),
            ("batch_requests", cfg.batch_requests),
            ("pipeline_depth", cfg.pipeline_depth)) if is_auto(v)}
        cap_ladder = capacity_ladder(cfg.vocab)
        self.cache_capacity = int(resolve_knob(cfg.cache_capacity,
                                               cap_ladder[0]))
        self.replan_every = int(resolve_knob(cfg.replan_every, 4))
        # a read-only serving table never needs refreshes between replans
        self.refresh_every = int(resolve_knob(cfg.refresh_every, 0))
        self.batch_requests = int(resolve_knob(cfg.batch_requests, 16))
        self.pipeline_depth = int(resolve_knob(cfg.pipeline_depth, 1))
        self._ctl: Optional[OnlineController] = None
        if cfg.managed and self._auto - {"refresh_every"}:
            knobs = []
            if "cache_capacity" in self._auto:
                # intent-steered, not hill-climbed (adapt=False): the
                # queued horizon's demand computes the bucket directly
                knobs.append(Knob("cache_capacity", cap_ladder,
                                  index=cap_ladder.index(
                                      self.cache_capacity),
                                  adapt=False, prefer_low=True))
            if "replan_every" in self._auto:
                ladder = (2, 4, 8, 16, 32)
                knobs.append(Knob("replan_every", ladder,
                                  index=ladder.index(self.replan_every)))
            if "batch_requests" in self._auto:
                ladder = pow2_ladder(8, 256)
                knobs.append(Knob("batch_requests", ladder,
                                  index=ladder.index(self.batch_requests)))
            if "pipeline_depth" in self._auto:
                # the lookup is exact at every depth (the pipeline only
                # moves blocking and staging traffic), so the hill-climb
                # probes freely
                ladder = (0, 1, 2, 4)
                knobs.append(Knob("pipeline_depth", ladder,
                                  index=ladder.index(self.pipeline_depth),
                                  prefer_low=True))
            self._ctl = OnlineController(knobs, self.telemetry,
                                         seed=cfg.seed)

        self.intent = StreamingIntentBuffer() if cfg.managed else None
        self.queue = RequestQueue(self.intent)
        self.scheduler = MicroBatchScheduler(self.batch_requests,
                                             cfg.keys_per_request)
        # the mesh bounds admission PER OWNER SHARD too: the planner
        # publishes `route_capacity` (the per-owner unique-miss bound over
        # the queued horizon) and the routed gather carries blocks of that
        # size (DESIGN.md §12); the emulated backend has no owner shards,
        # so this is 0 and the routed checks are off
        self._owner_shards = (self.backend.n_shards
                              if self.backend is not None
                              and self.backend.mesh_real else 0)
        # n_nodes = REQUESTER SLOTS within a micro-batch, NOT vocab
        # shards: serving maps §4.1's "nodes" onto batch positions (a key
        # wanted by >= 2 queued requests in the same batch is concurrent
        # intent), so the node count is the micro-batch width
        self.planner = IntentPlanner(
            cfg.vocab, self.cache_capacity,
            n_nodes=self.batch_requests,
            plan_every=self.replan_every,
            owner_shards=self._owner_shards,
            telemetry=self.telemetry) if cfg.managed else None
        # plan-vs-actual audit trail (DESIGN.md §14): only when the
        # config asks for tracing — one record per replan boundary, over
        # the same bus.  Keyed on the config, not on the tracer, so an
        # injected tracer changes no work the runtime does
        self.attribution: Optional[PlanAttribution] = (
            PlanAttribution(owner_shards=self._owner_shards,
                            vocab=cfg.vocab, telemetry=self.telemetry)
            if cfg.managed and cfg.trace else None)
        self.plan: Optional[PlacementPlan] = None
        self._cache_ids = None           # device copy (refresh input)
        self._cache_ids_np = None        # host copy (admission-time probe)
        self._cache_rows = None
        # the probe's id -> cache-row table, one for the runtime's life
        # (the per-batch probe then never re-sorts the cache side)
        self._probe_view: Optional[CacheProbeView] = None
        # staged prefetch (pipeline_depth >= 1): the tenure's predicted
        # miss rows, gathered once per replan/refresh instead of riding
        # every batch's collective
        self._staged_ids: Optional[np.ndarray] = None   # host, sorted asc
        self._staged_ids_dev = None      # V-padded device ids (re-gather)
        self._staging_rows = None        # (S, D) device rows
        self._cache_ext = None           # (C+S, D) cache ++ staging concat
        # accrual top-up state (one tenure's scope): per-id residual-miss
        # counts and the ids that crossed the recurrence threshold since
        # the last merge — see `_note_residual`
        self._miss_counts: Optional[np.ndarray] = None
        self._stage_pending: List[np.ndarray] = []
        self._pending_replan = False     # e.g. an out-of-band resize
        # lifetime round clock: `run()` can be called repeatedly on one
        # runtime (resize segments, drain calls) and the planner's rate
        # estimator requires a monotone clock across those calls
        self._lifetime_rounds = 0
        self._warmed = False
        self._summary_printed = False
        # controller reward epochs: measured between replan boundaries
        self._epoch_t0: Optional[float] = None
        self._epoch_served0 = 0

    def _route_block(self, ids: np.ndarray, m: int,
                     route_cap: int = 0) -> int:
        """The mesh's routed block for an ``m``-row buffer of the host ids
        ``ids`` (`pm.collectives.route_block`); 0 off the mesh."""
        if not self._owner_shards:
            return 0
        return route_block(ids, self.cfg.vocab, self._owner_shards, m,
                           route_cap)

    def _refresh_rows(self, ids_dev: torch.Tensor, ids: np.ndarray):
        """The backend's replica gather of ``ids_dev``, the device copy of
        the host ids ``ids``."""
        return resolve(self.backend).refresh_rows(
            self.table, ids_dev,
            route_cap=self._route_block(ids, ids_dev.shape[0]))

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a numpy array.  Non-blocking: a
        blocking copy would wait for every batch still in flight on the
        stream; from pageable memory the source is staged before the call
        returns, so ``a`` may be dropped at once."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _mark_done(self) -> Optional[torch.cuda.Event]:
        """An event after the work queued so far on the current stream
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ----------------------------------------------------------- control
    def current_knobs(self) -> Dict[str, object]:
        """The live knob values (auto knobs: wherever the controller has
        driven them so far)."""
        return {"cache_capacity": self.cache_capacity,
                "replan_every": self.replan_every,
                "refresh_every": self.refresh_every,
                "batch_requests": self.batch_requests,
                "pipeline_depth": self.pipeline_depth}

    def _warm_up(self) -> None:
        """One untimed dispatch of the managed lookup at the floor shapes
        (a cache of the first ids, a miss buffer of the planner ladder's
        floor bucket), so the kernel library's load and first launch
        fall in set-up, before the stream's first arrivals.  Every rank
        of a mesh makes the same calls.  A failed kernel build or launch
        raises here: nothing is caught."""
        cfg = self.cfg
        T = self.batch_requests * cfg.keys_per_request
        tok = np.random.default_rng(0).integers(
            0, cfg.vocab, size=T).astype(np.int32)
        cache_ids = np.arange(min(self.cache_capacity, cfg.vocab),
                              dtype=np.int32)
        cache_rows = self._refresh_rows(self._to_dev(cache_ids), cache_ids)
        p = probe_host(cache_ids, tok, max(1, min(64, T)))
        idx = self._to_dev(np.stack([p.hit.astype(np.int32), p.cache_slot,
                                     p.buf_slot]))
        planned_serve_lookup(self.table, cache_rows, self._to_dev(p.buf_ids),
                             idx[0], idx[1], idx[2], n_shards=cfg.n_shards,
                             kernel=cfg.kernel, backend=self.backend)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True

    def summary(self) -> str:
        """The single human-readable shutdown line: final knob values,
        which of them the controller owned, and the headline telemetry."""
        t = self.telemetry
        knobs = " ".join(f"{k}={v}" for k, v in
                         self.current_knobs().items())
        auto = ",".join(sorted(self._auto)) or "none"
        return (f"[serve] shutdown: {knobs} auto=({auto}) "
                f"replans={int(t.counter_value('serve.replans'))} "
                f"resizes={int(t.counter_value('serve.capacity_resizes'))} "
                f"overflows={int(t.counter_value('serve.overflow_batches'))}"
                f" miss_rate~{t.gauge_value('serve.miss_rate', 0.0):.3f}")

    def report(self) -> str:
        """The traced run's full shutdown report (latency/attribution/
        knob-timeline — the same renderer ``python -m repro.obs.report``
        applies to exported files)."""
        from repro_torch.obs.report import render_report
        records = [dict({"kind": "event"}, name=ev.pop("_name"),
                        event_seq=ev.pop("_seq"), fields=ev)
                   for ev in self.telemetry.events()]
        if self.attribution is not None:
            records.extend(dict(r.to_json(), kind="attribution")
                           for r in self.attribution.records)
        return render_report(
            self.tracer.to_chrome()["traceEvents"] or None,
            records or None, title="serve shutdown report")

    def resize_capacity(self, cache_capacity: int) -> None:
        """Mid-run replica-cache resize (the controller's hook; also
        public for operators/tests).  Takes effect atomically at the next
        replan boundary: the new plan, cache ids and cache rows are
        installed together, so no batch ever executes against a mixed
        capacity — results across the resize stay exact."""
        self._set_capacity(int(cache_capacity), rnd=-1)
        self._pending_replan = True

    def _set_capacity(self, cache_capacity: int, rnd: int) -> None:
        if cache_capacity == self.cache_capacity:
            return
        self.cache_capacity = cache_capacity
        self.planner.set_capacity(cache_capacity)
        self.telemetry.inc("serve.capacity_resizes")
        self.telemetry.set("serve.cache_capacity", cache_capacity)
        self.telemetry.event("serve.capacity_resize", round=rnd,
                             capacity=cache_capacity)

    def _set_batch_requests(self, b: int) -> None:
        self.batch_requests = b
        self.scheduler.B = b
        self.telemetry.set("serve.batch_requests", b)

    def _controller_step(self, rnd: int, res: ServeResult) -> None:
        """Measured hill-climb decision at a replan boundary: reward is
        the epoch's served requests/s (the epoch = rounds since the last
        boundary).  Applied BEFORE the new plan is built so the plan sees
        the new cadence/batch width."""
        now = time.perf_counter()
        if self._ctl is not None and self._epoch_t0 is not None:
            wall = now - self._epoch_t0
            served = self.scheduler.n_served - self._epoch_served0
            if wall > 0 and served > 0:
                # one clock for all ranks of a mesh: the same knob path
                reward = resolve(self.backend).agree(served / wall)
                self.telemetry.set("ctl.reward", reward)
                for name, v in self._ctl.observe(reward).items():
                    self._apply_knob(name, v, rnd, res)
        self._epoch_t0 = now
        self._epoch_served0 = self.scheduler.n_served

    def _apply_knob(self, name: str, v, rnd: int, res: ServeResult) -> None:
        if name == "cache_capacity":
            self._set_capacity(int(v), rnd)
        elif name == "replan_every":
            self.replan_every = int(v)
            self.planner.plan_every = int(v)
            self.telemetry.set("serve.replan_every", v)
        elif name == "batch_requests":
            self._set_batch_requests(int(v))
        elif name == "pipeline_depth":
            self.pipeline_depth = int(v)
            self.telemetry.set("serve.pipeline_depth", v)

    # ---------------------------------------------------------------- plan
    def _replan(self, rnd: int, res: ServeResult, cause: str) -> None:
        old_plan = self.plan     # the tenure the attribution flush closes
        tr = self.tracer
        with tr.span("serve.plan.ctl", a=rnd):
            self._controller_step(rnd, res)
        with tr.span("serve.plan.snapshot", a=rnd):
            keys, slots, ticks = self.intent.snapshot(
                self.queue.order_ids(), self.batch_requests)
        if len(keys) == 0:
            return
        with tr.span("serve.plan.solve", a=rnd):
            plan = self.planner.replan_from_queue(keys, slots, ticks)
        if self._ctl is not None and "cache_capacity" in self._auto:
            # intent-signal capacity steering: the plan's demand count IS
            # the bucket; a changed bucket re-plans over the same snapshot
            # so plan/ids/rows stay mutually consistent
            new_cap = self._ctl.steer_capacity("cache_capacity",
                                               plan.demand)
            if new_cap is not None:
                self._set_capacity(int(new_cap), rnd)
                res.capacity_resizes += 1
                res.capacity_trace.append((rnd, int(new_cap)))
                with tr.span("serve.plan.solve", a=rnd):
                    plan = self.planner.replan_from_queue(keys, slots,
                                                          ticks)
        # a replan that kept the cache contents (sorted ids are canonical,
        # so set-equality IS array-equality) needs no re-gather when the
        # serving table is declared read-only (refresh_every == 0: no
        # out-of-band updates to sync) — steady-state replans then cost
        # plan arithmetic only, not a (C, D) gather
        same_cache = (self._cache_ids_np is not None
                      and self._cache_rows is not None
                      and np.array_equal(plan.cache_ids,
                                         self._cache_ids_np))
        self.plan = plan
        if same_cache and self.refresh_every == 0:
            self.telemetry.inc("serve.refresh_skipped")
        else:
            with tr.span("serve.plan.refresh", a=rnd):
                self._cache_ids_np = self.plan.cache_ids
                self._cache_ids = self._to_dev(self.plan.cache_ids)
                # new cache generation: the probe's table moves by the
                # rows that left and entered, O(C) and never O(V); each
                # batch then adds one O(T_miss log C) search of its misses
                if self._probe_view is None:
                    self._probe_view = CacheProbeView(
                        self._cache_ids_np, self.cfg.vocab,
                        telemetry=self.telemetry)
                else:
                    self._probe_view.advance(self._cache_ids_np)
                self._staged_ids = None  # rebuilt below for the new tenure
                self._refresh(res)
        # per-tenure staged prefetch (DESIGN.md §15): the snapshot's
        # queued-horizon keys the new plan does NOT cache are exactly this
        # tenure's predicted miss set — gather them once into the staging
        # buffer so steady-state batches skip the per-batch collective
        if self.pipeline_depth >= 1:
            with self.tracer.span("prefetch.stage", a=rnd):
                self._stage(keys)
        else:
            self._staged_ids = None
            self._staged_ids_dev = None
            self._staging_rows = None
            self._cache_ext = None
        self._pending_replan = False
        res.replans += 1
        res.replan_rounds.append(rnd)
        res.plan_miss_capacities.append(self.plan.miss_capacity)
        self.telemetry.inc("serve.replans")
        self.telemetry.inc("serve.replans", cause=cause)
        self.telemetry.set("serve.predicted_miss_rate",
                           self.plan.predicted_miss_rate)
        self.telemetry.event("serve.replan", round=rnd, cause=cause,
                             capacity=self.cache_capacity,
                             miss_capacity=self.plan.miss_capacity,
                             demand=self.plan.demand)
        if self.attribution is not None:
            # close the OUTGOING plan's tenure: its promise vs the batches
            # that executed under it (None before the first replan)
            self.attribution.flush(
                rnd=rnd, plan=old_plan, cause=cause,
                knobs=self.current_knobs(), capacity=self.cache_capacity,
                miss_capacity=self.plan.miss_capacity)

    def _stage(self, keys: np.ndarray) -> None:
        """Build the tenure's staging buffer: the queued-horizon keys the
        active plan left uncached AND that recur in the horizon, gathered
        once (locally on the emulated backend — the same cost-model rule
        as the replica refresh; the routed owner-block gather on the
        mesh).  The multiplicity >= 2 gate is the work-elimination
        break-even: a key queued once costs the staging gather exactly
        the one per-batch gather it saves, so prefetching it is pure
        overhead — only recurring misses amortize (a key queued k times
        saves k gathers for one staging row).  Singletons ride the
        residual collective instead; correctness is unaffected either
        way (both paths read the same table rows)."""
        uniq, counts = np.unique(np.asarray(keys, np.int64),
                                 return_counts=True)
        staged = np.setdiff1d(uniq[counts >= 2],
                              np.asarray(self.plan.cache_ids, np.int64))
        # new tenure: the accrual counts and pending top-ups scope to one
        # staging generation (the cache/staged split they counted against
        # just changed)
        if self._miss_counts is None:
            self._miss_counts = np.zeros(self.cfg.vocab, np.int32)
        else:
            self._miss_counts[:] = 0
        self._stage_pending = []
        if staged.size == 0:
            self._staged_ids = None
            self._staged_ids_dev = None
            self._staging_rows = None
            self._cache_ext = None
            return
        self._install_staging(staged)

    def _install_staging(self, staged: np.ndarray) -> None:
        """(Re)build the staging buffer for ``staged`` (sorted unique
        ascending), reusing already-gathered rows where possible: rows
        present in the current buffer are copied device-side; only the
        genuinely new ids are gathered from the table (`refresh_rows` —
        the replica-sync cost rule: a local gather, NOT the per-shard
        collective the residual path pays)."""
        # pow2 bucket with V-pads: few distinct buffer shapes; the pads
        # gather zero rows no probe slot ever points at
        n = max(64, 1 << (int(staged.size) - 1).bit_length())
        ids_p = np.full(n, self.cfg.vocab, np.int32)
        ids_p[:staged.size] = staged
        ids_dev = self._to_dev(ids_p)
        old = self._staged_ids
        if old is not None and old.size:
            pos = np.searchsorted(old, staged)
            posc = np.minimum(pos, old.size - 1)
            reuse = old[posc] == staged
            new_ids = staged[~reuse]
        else:
            reuse = np.zeros(staged.size, bool)
            new_ids = staged
        if old is None or new_ids.size == staged.size:
            self._staging_rows = self._refresh_rows(ids_dev, staged)
        else:
            # merge: one local gather of the new rows + one take over the
            # concatenated (old ++ new ++ zero) source — pads read the
            # zero row, reused rows copy device-side without re-gathering
            nn = max(8, 1 << max(0, int(new_ids.size) - 1).bit_length())
            nids_p = np.full(nn, self.cfg.vocab, np.int32)
            nids_p[:new_ids.size] = new_ids
            new_rows = self._refresh_rows(self._to_dev(nids_p), new_ids)
            # offsets index the DEVICE concat: the old buffer's padded
            # row count, not the real staged-id count
            off = int(self._staging_rows.shape[0])
            src = np.full(n, off + nn, np.int32)            # pad: zero row
            src[:staged.size] = np.where(
                reuse, posc,
                off + np.cumsum(~reuse) - 1).astype(np.int32)
            zero = self._staging_rows.new_zeros((1, self.table.shape[1]))
            self._staging_rows = torch.cat(
                [self._staging_rows, new_rows, zero]).index_select(
                    0, self._to_dev(src))
        self._staged_ids = staged
        self._staged_ids_dev = ids_dev
        # the fold-in concat the staged dispatch reads: staged miss slots
        # address rows [C, C+S) of this buffer (one per-tenure concat in
        # place of per-round staging gathers/masks on the device)
        self._cache_ext = torch.cat([self._cache_rows, self._staging_rows])
        self.telemetry.set("serve.staged_rows", int(staged.size))

    def _note_residual(self, res_ids: np.ndarray) -> None:
        """Accrual top-up (DESIGN.md §15): count this batch's residual
        misses against the tenure, and once an id has missed the staging
        buffer twice — proven recurring intent the replan snapshot never
        saw (it arrived after the snapshot) — fold it into the staging
        buffer so its later recurrences read locally instead of riding
        the per-shard collective again.  Merges are batched (>= 64 ids)
        to amortize the buffer rebuild; the same multiplicity >= 2
        break-even as the snapshot gate, applied online."""
        if res_ids.size == 0 or self._miss_counts is None:
            return
        self._miss_counts[res_ids] += 1
        crossed = res_ids[self._miss_counts[res_ids] == 2]
        if crossed.size:
            self._stage_pending.append(crossed)
        pending = sum(a.size for a in self._stage_pending)
        if pending < 64:
            return
        new_ids = np.concatenate(self._stage_pending)
        self._stage_pending = []
        base = (self._staged_ids if self._staged_ids is not None
                else np.empty(0, np.int64))
        self._install_staging(np.union1d(base, new_ids))
        self.telemetry.inc("serve.stage_topups")
        self.telemetry.inc("serve.stage_topup_rows", int(new_ids.size))

    def _lookup_operands(self, probe):
        """The managed lookup's operands for a probed batch: ``(cache_rows,
        buf_ids, rows, n_miss, ids)`` — the cache side, the host miss
        buffer, the three (T,) index rows (hit, cache slot, buffer slot),
        the unique-miss count and the host ids the buffer routes.

        With a staging buffer (``pipeline_depth >= 1``) the split folds it
        into the cache side: staged miss tokens become extended-cache
        hits (slot C+pos into the per-tenure ``cache_rows ++
        staging_rows`` concat) and only the residual bucket rides the
        collective — the device path is the same managed lookup over a
        smaller miss buffer, with no extra gathers or masks per round.
        All host-side numpy on the compact (M,) slots plus three (T,) LUT
        reads; the round's bookkeeping (miss rate, overflow, zero-served)
        stays on the raw probe, so semantics are bitwise the sequential
        loop's (tested).  Either way the batch's residual misses accrue
        (`_note_residual`)."""
        M = probe.buf_ids.shape[0]
        nm = min(probe.n_miss, M)
        ids = probe.buf_ids[:nm]
        plain = (self._cache_rows, probe.buf_ids,
                 (probe.hit.astype(np.int32), probe.cache_slot,
                  probe.buf_slot), probe.n_miss, ids)
        if self.pipeline_depth < 1:
            return plain
        if self._staged_ids is None:
            # no staging buffer this tenure: every miss is residual —
            # accrue so the buffer can bootstrap the moment recurring
            # intent shows up
            self._note_residual(ids)
            return plain
        C = self._cache_rows.shape[0]
        pos = np.searchsorted(self._staged_ids, ids)
        posc = np.minimum(pos, self._staged_ids.size - 1)
        stg = self._staged_ids[posc] == ids
        n_res = int(nm - np.count_nonzero(stg))
        r_cap = max(8, 1 << max(0, n_res - 1).bit_length())
        res_ids = np.full(r_cap, self.cfg.vocab, np.int32)
        res_ids[:n_res] = ids[~stg]
        # per-slot LUTs: extended-cache slot for staged slots, residual
        # rank otherwise (pads + trash -> the residual trash row r_cap)
        ext_lut = np.zeros(M + 1, np.int32)
        ext_lut[:nm] = np.where(stg, C + posc, 0)
        res_lut = np.full(M + 1, r_cap, np.int32)
        res_lut[:nm] = np.where(
            stg, r_cap, np.cumsum(~stg) - 1).astype(np.int32)
        stg_lut = np.zeros(M + 1, bool)
        stg_lut[:nm] = stg
        staged_tok = stg_lut[probe.buf_slot]
        n_hits = int(np.count_nonzero(stg))
        self.telemetry.inc("serve.prefetch_hits", n_hits)
        self.telemetry.inc("serve.prefetch_stale", n_res)
        if self.attribution is not None:
            self.attribution.note_prefetch(n_hits, n_res)
        self._note_residual(ids[~stg])
        return (self._cache_ext, res_ids,
                ((probe.hit | staged_tok).astype(np.int32),
                 np.where(staged_tok, ext_lut[probe.buf_slot],
                          probe.cache_slot),
                 res_lut[probe.buf_slot]), n_res, res_ids[:n_res])

    def _refresh(self, res: ServeResult) -> None:
        self._cache_rows = self._refresh_rows(self._cache_ids,
                                              self._cache_ids_np)
        if self._staged_ids is not None:
            # the staging buffer obeys the same staleness bound as the
            # replica cache: re-gathered on every refresh round, so an
            # out-of-band table update reaches staged rows within one
            self._staging_rows = self._refresh_rows(self._staged_ids_dev,
                                                    self._staged_ids)
            self._cache_ext = torch.cat([self._cache_rows,
                                         self._staging_rows])
        res.refreshes += 1
        self.telemetry.inc("serve.refreshes")

    # ----------------------------------------------------------------- run
    def run(self, stream, rounds: int, *,
            warmup_backlog: Optional[int] = None, measure_from: int = 0,
            collect_outputs: bool = False) -> ServeResult:
        """Serve ``rounds`` scheduling rounds of ``stream`` arrivals.

        ``warmup_backlog`` rounds of arrivals are enqueued up front so the
        planner has a queued horizon before the first batch; the default
        ``replan_every + 2`` keeps the backlog (and with it the signaled
        horizon) deeper than the replan period, so every executed batch
        falls inside the window its miss bound was computed over — the
        serving latency/adaptivity trade: admitted-but-unscheduled work
        is exactly what intent planning can act on.  Stream rounds lead
        runtime rounds by ``warmup_backlog`` (a stream event at stream
        round R lands at runtime round ``R - warmup_backlog`` in
        `miss_trace`).  ``measure_from`` excludes warm-up/compile rounds
        from the latency/throughput accounting (the miss trace always
        covers every round).

        At ``pipeline_depth`` N >= 1 the loop is an N-slot pipeline: the
        round's batch is probed and *dispatched*, then batches older than
        the last N are blocked and bookkept — so the device executes
        batch t while the host enqueues, replans and probes batch t+1.
        Depth 0 blocks each batch in its own round (identical results, no
        overlap)."""
        cfg = self.cfg
        if cfg.managed and not self._warmed:
            self._warm_up()
        if warmup_backlog is None:
            warmup_backlog = self.replan_every + 2
        res = ServeResult()
        drift = False
        last_replan = -10 ** 9
        # N-deep pipeline: dispatched-but-unblocked batches, oldest first;
        # depth 0 drains immediately (the serial loop, bitwise)
        inflight: deque = deque()
        tr = self.tracer

        def finish(fl: _InFlight) -> None:
            with tr.span("serve.served", a=len(fl.served)):
                if fl.done is not None:
                    fl.done.synchronize()
            now = time.perf_counter()
            if tr.enabled:
                # per-request lifecycle spans (enqueue -> served): t0 is
                # the enqueue stamp — perf_counter and perf_counter_ns
                # share an origin, so the seconds clock converts exactly;
                # the whole batch lands as one batched ring append
                t0s, rids, atts, tids = [], [], [], []
                for r in fl.served:
                    if tr.sampled(r.rid):
                        t0s.append(int(r.t_enqueue * 1e9))
                        rids.append(r.rid)
                        atts.append(r.attempts)
                        tids.append(1 + r.rid % 8)
                if rids:
                    tr.record_many("serve.request", t0s, tr.now_ns(),
                                   tids=tids, a=rids, b=atts)
            with tr.span("serve.note", a=len(fl.served)):
                self.scheduler.note_served(fl.served, now)
            with tr.span("serve.expire", a=len(fl.served)):
                self.queue.served(fl.served)
            res.served += len(fl.served)
            if collect_outputs:
                out_h = fl.out.cpu().numpy().reshape(
                    fl.tokens_shape + (-1,))
                for i, req in enumerate(fl.reqs):
                    if fl.served_mask[i]:
                        res.outputs[req.rid] = out_h[i]

        for rnd in range(-warmup_backlog, 0):
            with tr.span("serve.enqueue", a=rnd):
                self.queue.enqueue_many(
                    stream.arrivals(rnd + warmup_backlog),
                    time.perf_counter())
        t0 = time.perf_counter()
        for rnd in range(rounds):
            rnd_t0 = time.perf_counter()
            res.rounds += 1
            with tr.span("serve.enqueue", a=rnd):
                self.queue.enqueue_many(
                    stream.arrivals(rnd + warmup_backlog),
                    time.perf_counter())
            if rnd == measure_from:
                # drain the pipeline before the measurement window opens
                while inflight:
                    finish(inflight.popleft())
                self.scheduler.latency.reset()
                self.scheduler.n_served = 0
                self._epoch_t0 = None
                t0 = time.perf_counter()

            if cfg.managed:
                self.planner.observe_round(self._lifetime_rounds + rnd)
                # replan on: cadence, drift feedback, a pending resize, or
                # window exhaustion (each round consumes one tick of the
                # plan's queued horizon — running past it would serve
                # batches the miss bound never saw, the serving
                # `should_replan` analogue); replan_every=0 disables both
                # scheduled triggers
                window_done = (self.plan is not None
                               and rnd - last_replan
                               >= max(1, self.plan.window[1] - 1))
                scheduled = self.replan_every > 0 and (
                    rnd - last_replan >= self.replan_every or window_done)
                if (self.plan is None or drift or self._pending_replan
                        or scheduled) and len(self.queue):
                    cause = ("initial" if self.plan is None else
                             "drift" if drift else
                             "resize" if self._pending_replan else
                             "window" if window_done else "cadence")
                    with tr.span("serve.plan", a=rnd):
                        self._replan(rnd, res, cause)
                    last_replan = rnd
                    drift = False
                elif self.plan is not None and self.refresh_every > 0 \
                        and rnd - last_replan > 0 \
                        and (rnd - last_replan) % self.refresh_every == 0:
                    self._refresh(res)

            with tr.span("serve.admit", a=rnd):
                batch = self.scheduler.admit(self.queue)
            if batch is None or (cfg.managed and self.plan is None):
                if batch is not None:        # nothing planned yet: put back
                    self.queue.requeue(batch.reqs)
                while inflight:              # idle round: drain the pipe
                    finish(inflight.popleft())
                continue

            if cfg.managed:
                # admission-time host probe: intent means the batch's miss
                # set is known before the batch runs — the device executes
                # pure data movement, and drift feedback (miss rate,
                # overflow flags) costs zero device readbacks, so every
                # serve/requeue/replan decision below happens pre-execution
                B, K = batch.tokens.shape
                route_cap = (min(self.plan.route_capacity,
                                 self.plan.miss_capacity)
                             if self._owner_shards else 0)
                with tr.span("serve.probe", a=rnd):
                    # table probe — byte-identical to `probe_host` on
                    # this cache generation (tests/test_torch_probe.py)
                    probe = self._probe_view.probe(
                        batch.tokens.reshape(B * K),
                        self.plan.miss_capacity,
                        owner_shards=self._owner_shards,
                        route_capacity=route_cap)
                with tr.span("serve.split", a=rnd):
                    cache_rows, buf_ids, rows, n_miss, ids = \
                        self._lookup_operands(probe)
                with tr.span("serve.dispatch", a=rnd):
                    # one packed H2D transfer for the three (T,) index
                    # rows; the name is resolved here, at call time, so a
                    # caller that patches the module's lookup sees every
                    # batch
                    idx = self._to_dev(np.stack(rows))
                    out = planned_serve_lookup(
                        self.table, cache_rows, self._to_dev(buf_ids),
                        idx[0], idx[1], idx[2], n_shards=cfg.n_shards,
                        kernel=cfg.kernel, backend=self.backend,
                        n_miss=n_miss, route_cap=self._route_block(
                            ids, buf_ids.shape[0], route_cap))
                with tr.span("serve.book", a=rnd):
                    hit_h = probe.hit.reshape(B, K)
                    over_h = probe.overflow.reshape(B, K)
                    nv = len(batch.reqs)
                    miss_rate = float(1.0 - hit_h[:nv].mean())
                    res.miss_trace.append((rnd, miss_rate))
                    self.telemetry.set("serve.miss_rate", miss_rate)
                    if self.attribution is not None:
                        self.attribution.note_batch(batch.tokens[:nv],
                                                    hit_h[:nv])
                    row_over = over_h[:nv].any(axis=1)
                    served_mask = ~row_over
                    served = [r for r, o in zip(batch.reqs, row_over) if not o]
                    failed = [r for r, o in zip(batch.reqs, row_over) if o]
                    if failed:
                        res.overflow_batches += 1
                        res.requeues += len(failed)
                        self.telemetry.inc("serve.overflow_batches")
                        self.telemetry.inc("serve.requeues", len(failed))
                        for req in failed:
                            self.telemetry.inc("serve.requeued",
                                               tenant=req.tenant)
                            if tr.enabled and tr.sampled(req.rid):
                                tr.point("serve.requeue",
                                         tid=1 + req.rid % 8, a=req.rid,
                                         b=req.attempts + 1)
                            if req.attempts + 1 > cfg.max_attempts:
                                raise RuntimeError(
                                    f"request {req.rid} overflowed the miss "
                                    f"buffer {req.attempts + 1} times — the "
                                    "planner never caught up with the drift")
                        self.queue.requeue(failed)
                        drift = True            # hard drift signal
                    elif miss_rate > cfg.drift_factor * max(
                            self.plan.predicted_miss_rate, 1e-3):
                        drift = True            # soft drift signal
                    # invariant counter: a served row never contains a token
                    # that landed on the trash slot.  Recomputed from the
                    # probe's slot arrays — NOT from the row_over mask the
                    # served/failed split was derived from — so a future bug
                    # in that split shows up as zero_served > 0 instead of
                    # passing vacuously (silently served zeros).
                    trash_slot = probe.buf_ids.shape[0]
                    zeroed = ((probe.buf_slot == trash_slot)
                              & ~probe.hit).reshape(B, K)
                    n_zeroed = int(np.count_nonzero(
                        zeroed[:nv].any(axis=1) & served_mask))
                    res.zero_served += n_zeroed
                    if n_zeroed:
                        self.telemetry.inc("serve.zero_served", n_zeroed)
            else:
                out = plain_serve_lookup(self.table,
                                         self._to_dev(batch.tokens),
                                         n_shards=cfg.n_shards,
                                         backend=self.backend)
                served_mask = np.ones(len(batch.reqs), bool)
                served = batch.reqs

            # N-deep pipeline: older batches are blocked only AFTER this
            # round's host work (probe + staging split + dispatch above)
            # — while that happened, the device was executing them.  At
            # depth 0 the batch drains immediately (the serial loop)
            with tr.span("serve.pipe", a=rnd):
                # the new batch's completion event is made here and the
                # finished batches' are freed here (each a CUDA call)
                inflight.append(_InFlight(
                    out, self._mark_done(), batch.reqs, served,
                    served_mask, batch.tokens.shape))
                while len(inflight) > self.pipeline_depth:
                    finish(inflight.popleft())
            if tr.enabled:
                # the executed round's envelope (idle rounds have no
                # batch and no envelope — the phase spans still show);
                # rnd_t0 converts exactly: shared perf_counter origin
                tr.record("serve.round", int(rnd_t0 * 1e9), tr.now_ns(),
                          a=rnd)

        while inflight:                      # drain the pipeline
            finish(inflight.popleft())
        self._lifetime_rounds += rounds
        res.wall_s = time.perf_counter() - t0
        res.throughput_rps = self.scheduler.n_served / max(res.wall_s, 1e-9)
        lat = self.scheduler.latency
        res.p50_ms = lat.percentile(50) * 1e3
        res.p99_ms = lat.percentile(99) * 1e3
        res.mean_ms = lat.mean() * 1e3
        res.knobs = self.current_knobs()
        self.telemetry.set("serve.throughput_rps", res.throughput_rps)
        if cfg.summary and not self._summary_printed:
            print(self.summary())
            if tr.enabled:
                print(self.report())
            self._summary_printed = True
        return res
