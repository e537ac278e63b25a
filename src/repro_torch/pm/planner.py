"""Host-side placement planner: turns intent signals from the data loader
into placement plans for the intent-managed embedding (DESIGN.md §3b).

This is where the faithful AdaPM logic (repro_torch.core) plugs into the SPMD
runtime.  The planner treats each *data shard* as a node and routes its
placement decisions through the shared intent engine
(`repro_torch.core.engine`) — the same §4.1 decision procedure the simulator
policies use:

  * rows with active intent on >= 2 shards in the planning window are
    *replicated* -> placed in the device replica cache (AdaPM §4.1:
    concurrent intent -> selective replication), weighted by the summed
    shard count (`engine.concurrent_intent`, read off the window's one
    sort, `engine.IntentWindow`);
  * rows with single-shard intent stay owner-sharded (the relocation arm
    degenerates under SPMD: ownership is affine in the row id, so
    "relocate" means "serve via the compact miss path", which moves the
    value exactly once to exactly the shard that needs it — the same bytes
    a relocation would move);
  * Algorithm 1 (ActionTimer) decides how many steps of lookahead the plan
    must cover, i.e. when to act on the loader's intent signals.

Because intent is exact, the planner also knows the exact per-step
cache-miss count (`engine.intent_miss_bound`) and sizes the compact miss
buffer (bucketed powers of two) — static shapes out of dynamic
workload knowledge.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engine import IntentWindow, largest_group
from repro_torch.core.timing import ActionTimer
from repro_torch.obs.telemetry import Telemetry


@dataclass(frozen=True)
class PlacementPlan:
    version: int
    cache_ids: np.ndarray        # (C,) sorted int32, padded with V
    miss_capacity: int           # bucketed exact bound from intent
    window: tuple                # (start_step, end_step) the plan covers
    predicted_miss_rate: float = 0.0   # expected per-access miss fraction
    #   over the signaled window — the serving runtime's drift baseline
    #   (observed miss rate far above it = the workload left the plan)
    route_capacity: int = 0      # bucketed exact per-OWNER-shard unique-
    #   miss bound (planners built with ``owner_shards > 0``): the static
    #   per-destination block of the mesh backend's routed gather
    #   (DESIGN.md §12) — admission capacity for the all_to_all path,
    #   where `miss_capacity` sizes the shared compact buffer.  0 = no
    #   owner accounting (non-mesh backends).
    demand: int = 0              # cache-worthy ids in the window (score >
    #   0 under this plan's ranking): the intent-derived signal the
    #   zero-tuning controller steers replica-cache capacity by
    #   (`pm.controller.OnlineController.steer_capacity`, DESIGN.md §13)
    signals: int = 0             # intent signals the plan classified (the
    #   ``plan.signals`` gauge: a trace reads the solve's time per signal)


def _bucket(n: int, floor: int = 64) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


class IntentPlanner:
    """Consumes per-step, per-shard intent (the upcoming batches' row ids)
    and emits `PlacementPlan`s."""

    def __init__(self, vocab_size: int, cache_capacity: int,
                 n_nodes: Optional[int] = None, plan_every: int = 8,
                 per_node_bound: bool = False, owner_shards: int = 0,
                 alpha: float = 0.1, p: float = 0.9999, lam0: float = 10.0,
                 n_shards: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None):
        # ``n_nodes`` is the number of §4.1 *nodes* intent signals arrive
        # from — what counts as a node depends on the caller: the training
        # loop's data shards, or the serving runtime's requester slots
        # within a micro-batch.  (``n_shards`` is the older name, kept
        # as an alias; it misread as vocab sharding at serving call sites,
        # where a "shard" is really a request slot.)
        if n_nodes is None:
            n_nodes = n_shards
        if n_nodes is None:
            raise TypeError("IntentPlanner requires n_nodes (the number "
                            "of intent-signaling nodes)")
        self.V = vocab_size
        self.C = cache_capacity
        self.n_nodes = n_nodes
        self.plan_every = plan_every
        # owner_shards > 0: additionally bound unique misses per OWNER
        # shard (owner = id // (V / owner_shards), the engine's affine
        # ownership rule) and publish it as `PlacementPlan.route_capacity`
        # — the per-destination admission capacity of the mesh backend's
        # routed miss path.  Note this is a bound over owner shards (where
        # the row lives), not over signaling nodes (who wants it): the
        # compact buffer is shared, so `miss_capacity` stays the global
        # bound either way.
        self.owner_shards = owner_shards
        # miss-capacity scope, threaded from the collective backend
        # (DESIGN.md §10): False sizes the buffer by the worst per-step
        # GLOBAL unique-miss count (the emulated single-buffer lookup);
        # True sizes it per signaling shard (`intent_miss_bound(
        # per_node=True)`) — the mesh backend's per-shard capacity, where
        # each data shard compacts its own misses.  With one data shard
        # the two bounds coincide; multi-shard mesh configs stay correct
        # through the lookup's non-strict dense fallback.
        self.per_node_bound = per_node_bound
        self.timer = ActionTimer(alpha=alpha, p=p, lam0=lam0)
        # step -> list over shards of id arrays (the intent signal buffer;
        # decisions over it are made by the engine classifiers)
        self._intents: Dict[int, List[np.ndarray]] = {}
        self._version = 0
        self._last_planned_step = -1
        # optional shared bus (DESIGN.md §13): the planner publishes what
        # each plan promised (``plan.*`` gauges) on the SAME bus the
        # runtime/controller use — callers pass their runtime's bus, so
        # there is never a second, divergent bus
        self.telemetry = telemetry

    @property
    def n_shards(self) -> int:
        """Older alias for `n_nodes` (see __init__)."""
        return self.n_nodes

    def set_capacity(self, cache_capacity: int) -> None:
        """Retarget the replica-cache capacity (the zero-tuning
        controller's resize hook); takes effect at the next plan."""
        self.C = int(cache_capacity)

    # ------------------------------------------------------------ signals
    def signal(self, step: int, shard: int, ids: np.ndarray) -> None:
        """Loader signals: ``shard`` will access ``ids`` at ``step``
        (Intent(P, step, step+1) in the paper's API)."""
        per_shard = self._intents.setdefault(
            step, [None] * self.n_nodes)  # type: ignore[list-item]
        per_shard[shard] = np.asarray(ids, dtype=np.int64)

    def signaled_ids(self, step: int) -> Optional[np.ndarray]:
        """Union of ids signaled for ``step`` (host-side; None if the
        signals were never received or already collected)."""
        per_shard = self._intents.get(step)
        if per_shard is None:
            return None
        ids = [i for i in per_shard if i is not None and len(i)]
        return np.unique(np.concatenate(ids)) if ids else None

    def observe_round(self, step: int) -> None:
        """One planning round passed; the training step counter is the
        worker clock (Algorithm 1 rate estimation)."""
        self.timer.observe_round(0, step)

    # ------------------------------------------------------------- plans
    def lookahead(self) -> int:
        """How far ahead a plan must cover: one planning period *plus* the
        Alg. 1 soft upper bound on clock advance.  Covering only the
        horizon would make `should_replan` true one step after every plan
        (window_end = step + horizon moves in lockstep with the replan
        threshold), degenerating into a replan-every-round loop."""
        return self.plan_every + self.timer.horizon(0)

    def _window_signals(self, lo: int, hi: int):
        """Flatten the signal buffer over ``[lo, hi)`` into parallel
        (keys, shards, steps) arrays for the engine classifiers."""
        keys, shards, steps = [], [], []
        for s in range(lo, hi):
            per_shard = self._intents.get(s)
            if per_shard is None:
                continue
            for sh, ids in enumerate(per_shard):
                if ids is None or len(ids) == 0:
                    continue
                keys.append(ids)
                shards.append(np.full(len(ids), sh, np.int64))
                steps.append(np.full(len(ids), s, np.int64))
        if not keys:
            z = np.zeros(0, np.int64)
            return z, z, z
        return (np.concatenate(keys), np.concatenate(shards),
                np.concatenate(steps))

    def _build_plan(self, keys: np.ndarray, nodes: np.ndarray,
                    steps: np.ndarray, window: tuple, *,
                    cache_singles: bool = False,
                    commit: bool = True) -> PlacementPlan:
        """Shared §4.1 plan construction over flattened (keys, nodes,
        steps) signals — used by the training-window `plan` and the online
        `replan_from_queue` entry points.

        ``cache_singles=False`` (training): only concurrent-intent keys
        are replicated; single-shard keys stay on the owner/miss path.
        ``cache_singles=True`` (serving): single-requester keys compete
        for leftover cache capacity ranked by total demand — on a serving
        node §4.1's *relocation* arm (single active node -> move the value
        to it) degenerates to cache residency, because the requester IS
        this node; concurrent keys still rank first.

        ``commit=False`` builds a *candidate*: pure arithmetic, no
        version bump, no telemetry — safe to run off-thread while the
        training step is in flight (`plan_candidate`).  A candidate
        becomes the active plan only through `adopt`, which stamps the
        next version and publishes, ON the caller's thread."""
        # §4.1 via the engine: concurrent intent -> replicate (weighted),
        # single-node intent -> owner path; one sort of the signals
        # (`IntentWindow`) serves the ranking and every miss count below
        win = IntentWindow(keys, nodes, steps)
        weight, single = win.weight, win.single
        if cache_singles:
            score = weight * (np.int64(np.max(single) + 1)
                              if len(single) else 1) + single
        else:
            score = weight
        top = np.flatnonzero(score > 0)
        demand = len(top)
        if demand > self.C:
            top = self._top(score, top)
        cached = np.zeros(len(win.uniq), bool)
        cached[top] = True
        cache_ids = np.full((self.C,), self.V, dtype=np.int32)
        cache_ids[: len(top)] = win.uniq[top].astype(np.int32)
        cache_ids = np.sort(cache_ids)

        # exact per-step miss counts over the window -> capacity
        # (per_node=False: the managed lookup dedups misses over the whole
        # step's batch, so unique ids per step is the exact bound;
        # per_node=True: per-shard capacity for the mesh backend — the
        # loader signals unique ids per shard, so per-(step, shard)
        # counts are per-shard unique counts)
        worst_miss = max(1, win.miss_bound(cached,
                                           per_node=self.per_node_bound))
        plan = PlacementPlan(
            version=self._version + 1,
            cache_ids=cache_ids,
            miss_capacity=_bucket(worst_miss),
            window=window,
            predicted_miss_rate=(win.missed(cached) / win.n
                                 if win.n else 0.0),
            route_capacity=self._route_capacity(win, cached),
            demand=demand,
            signals=win.n,
        )
        return self._commit(plan) if commit else plan

    def _commit(self, plan: PlacementPlan) -> PlacementPlan:
        """Make ``plan`` the planner's next version and publish it —
        always on the owner's thread (the uncommitted `plan_candidate`
        path must never touch `_version` or the bus from a worker)."""
        self._version += 1
        plan = replace(plan, version=self._version)
        if self.telemetry is not None:
            self.telemetry.set("plan.version", plan.version)
            self.telemetry.set("plan.predicted_miss_rate",
                               plan.predicted_miss_rate)
            self.telemetry.set("plan.miss_capacity", plan.miss_capacity)
            self.telemetry.set("plan.demand", plan.demand)
            self.telemetry.set("plan.signals", plan.signals)
            self.telemetry.event("plan.built", version=plan.version,
                                 window=list(plan.window),
                                 predicted=plan.predicted_miss_rate,
                                 miss_capacity=plan.miss_capacity,
                                 demand=plan.demand)
        return plan

    def _top(self, score: np.ndarray, cands: np.ndarray) -> np.ndarray:
        """The ``C`` best of ``cands`` (indices into ``score``, ascending)
        in the order a stable descending sort of ``score`` would rank
        them: score first, ties to the smaller index — one
        ``(max - score) * U + index`` int64 per candidate, partitioned at
        the C-th place.  Unordered; a score range too wide for the
        packing takes the stable sort itself."""
        U = len(score)
        top = int(score[cands].max())
        if top * U < 1 << 62:
            rank = score[cands]
            np.subtract(top, rank, out=rank)
            rank *= U
            rank += cands
            rank.partition(self.C - 1)
            return rank[: self.C] % U
        order = np.argsort(-score[cands], kind="stable")
        return cands[order[: self.C]]

    def _route_capacity(self, win: IntentWindow,
                        cached: np.ndarray) -> int:
        """Exact per-owner-shard unique-miss bound over the window: the
        worst, over (step, owner) pairs, count of distinct missed ids the
        owner must serve in one step — the routed gather's per-destination
        block size.  Bucketed with a smaller floor than the global bound
        (per-owner counts are ~n_shards-fold smaller) and clamped to the
        global capacity at the use site."""
        if self.owner_shards <= 0:
            return 0
        block = -(-self.V // self.owner_shards)
        # distinct missed (step, key) pairs, counted per (step, owner)
        group = win.uniq[win.pair_kidx] // block
        group += win.pair_clock * self.owner_shards
        worst = largest_group(group, self.owner_shards << win.clock_bits,
                              ~cached[win.pair_kidx])
        return _bucket(max(1, worst), floor=16)

    def plan_window(self, current_step: int) -> tuple:
        """The window `plan(current_step)` would cover right now: one
        lookahead, clipped to the steps with signals in hand — a window
        running past the loader's prefetch horizon would under-count
        misses for the signal-less tail (the bound must stay exact).
        Exposed so the prefetch pipeline can pin a background candidate's
        window on the main thread (`max` iterates the intent dict, which
        only the main thread may do while signals keep arriving)."""
        end = current_step + self.lookahead()
        if self._intents:
            end = max(current_step + 1,
                      min(end, max(self._intents) + 1))
        return (current_step, end)

    def plan(self, current_step: int) -> PlacementPlan:
        """Build the plan for [current_step, current_step + lookahead)."""
        window = self.plan_window(current_step)
        keys, shards, steps = self._window_signals(*window)
        plan = self._build_plan(keys, shards, steps, window)
        self._last_planned_step = current_step
        return plan

    # ------------------------------------------------- prefetch pipeline
    def plan_candidate(self, window: tuple) -> PlacementPlan:
        """Uncommitted plan over ``window`` — the background half of the
        plan-ahead pipeline (DESIGN.md §15).  ``window`` must come from a
        main-thread `plan_window` call at submission time; the build then
        only issues GIL-atomic ``dict.get`` reads against the signal
        buffer, and is safe to run concurrently with new signals because
        a step's signals are inserted in one shot for steps AT OR BEYOND
        the submission-time window end (the loader's prefetch horizon
        already covered every step inside it).  No planner state is
        mutated; the result is inert until `adopt`."""
        keys, shards, steps = self._window_signals(*window)
        return self._build_plan(keys, shards, steps, tuple(window),
                                commit=False)

    def adopt(self, candidate: Optional[PlacementPlan],
              current_step: int) -> Optional[PlacementPlan]:
        """Promote a background candidate to the active plan IFF it is
        exactly the plan a synchronous `plan(current_step)` call would
        build now: the windows must match (the Alg.-1 horizon — and with
        it `lookahead` — can shift between submission and the replan
        boundary via `observe_round`).  On a match, stamp the next
        version and publish; on a mismatch return None and let the
        caller fall back to the synchronous build — the pipeline is an
        optimization, never a semantics change."""
        if candidate is None:
            return None
        if tuple(candidate.window) != self.plan_window(current_step):
            return None
        plan = self._commit(candidate)
        self._last_planned_step = current_step
        return plan

    def replan_from_queue(self, keys: np.ndarray, slots: np.ndarray,
                          ticks: np.ndarray) -> PlacementPlan:
        """Online serving entry point (DESIGN.md §9): plan from the
        *queued* — already-signaled — horizon instead of a fixed training
        window.  The inputs are a `StreamingIntentBuffer.snapshot` of the
        request queue: ``ticks`` are the micro-batches the scheduler will
        form (the serving logical clock), ``slots`` are request positions
        within a batch (the "nodes" of §4.1 — a key wanted by >= 2 queued
        requests in the same batch is concurrent intent -> replicated;
        leftover capacity goes to single-requester keys by demand — the
        relocation arm lands on this node, see `_build_plan` — and
        everything else rides the compact miss buffer, whose capacity is
        the exact `intent_miss_bound` over the queued horizon)."""
        keys = np.asarray(keys, np.int64)
        end = int(ticks.max()) + 1 if len(keys) else 1
        return self._build_plan(keys, np.asarray(slots, np.int64),
                                np.asarray(ticks, np.int64), (0, end),
                                cache_singles=True)

    def should_replan(self, current_step: int,
                      active: Optional[PlacementPlan]) -> bool:
        """Act-on-intent decision: replan when the Alg.-1 horizon says the
        worker may run past the active plan's window before the *next*
        planning round completes.  Planning rounds come at most every
        ``plan_every`` steps (the plan's window cannot outrun the loader's
        signal horizon, so without this floor the horizon test degenerates
        into replanning — and re-gathering the replica cache — every
        step); an exhausted window forces a replan regardless."""
        if active is None:
            return True
        if current_step >= active.window[1]:
            return True
        if current_step - self._last_planned_step < self.plan_every:
            return False
        horizon = self.timer.horizon(0)
        return active.window[1] < current_step + horizon

    def gc(self, before_step: int) -> None:
        for s in [s for s in self._intents if s < before_step]:
            del self._intents[s]
