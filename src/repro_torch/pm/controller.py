"""Zero-tuning online controller for runtime knobs (DESIGN.md §13).

The paper's contract is that the *task* signals (easy) while the
*manager* adapts (hard, automatic) — yet a runtime with fixed knobs
exposes hand-set constants: replica-cache capacity, replan/refresh
cadence, serve micro-batch size, pipeline depth.  This module closes
the loop, extending the measured block autotuner's
pattern (probe, cache per bucket, never re-measure a shape) from kernel
tiles to runtime parameters.  Two mechanisms, by information source:

  signal rules   knobs the intent signals fully determine get *computed*,
                 not searched: replica-cache capacity follows the queued
                 horizon's cache-worthy demand (`steer_capacity` — grow
                 immediately on the hard signal, shrink only after the
                 demand stays low for ``shrink_patience`` consecutive
                 replans).  This is "Towards Self-Tuning Parameter
                 Servers"'s observation specialized by exact intent: when
                 the workload is known in advance, the right capacity is
                 arithmetic, and measurement is only a refinement.
  hill-climb     knobs whose effect is a wall-clock property of THIS host
                 (replan and refresh cadence, micro-batch size, pipeline
                 depth) are
                 searched online: epsilon-greedy coordinate hill-climb
                 over small bucketed ladders (MLtuner's trial-and-revert,
                 one knob in flight at a time so reward attribution stays
                 clean).  A trial epoch's reward is compared against the
                 epoch before it; improving moves stick, worsening moves
                 revert, and ties follow the knob's ``prefer_low`` bias
                 (e.g. shrink capacity on a plateau — same throughput for
                 less memory).

Every knob value lives on a bucketed ladder (powers of two for capacity),
so buffers keep a handful of shapes and revisiting a bucket reuses
the caching allocator's blocks of that size.

Decisions and their causes are published to the telemetry bus
(``ctl.*`` events), so benches and tests can assert on *why* a knob
moved, not just where it ended up.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.telemetry import Telemetry

AUTO = "auto"


def is_auto(v) -> bool:
    """True when a config field asks for controller management."""
    return isinstance(v, str) and v == AUTO


def resolve_knob(v, default):
    """Initial (untuned) value for a config field: explicit values pass
    through; ``"auto"`` starts at ``default`` and is adapted online."""
    return default if is_auto(v) else v


def pow2_ladder(lo: int, hi: int) -> Tuple[int, ...]:
    """Powers of two in [lo, hi] (ladder buckets == shape buckets)."""
    vals = []
    v = 1
    while v < lo:
        v *= 2
    while v <= hi:
        vals.append(v)
        v *= 2
    return tuple(vals) or (lo,)


def capacity_ladder(vocab: int, floor: int = 64,
                    max_frac: int = 8) -> Tuple[int, ...]:
    """Replica-cache capacity buckets: powers of two from ``floor`` up to
    ``vocab / max_frac``.  The cap is scale-free on purpose (a fraction of
    the table, not a tuned row count): replicating more than 1/8 of the
    vocabulary stops being *selective* replication and the refresh gather
    starts to dominate the replan."""
    return pow2_ladder(floor, max(floor, vocab // max_frac))


@dataclass
class Knob:
    """One controlled parameter on a bucketed ladder.

    ``adapt=False`` knobs are rule-steered only (`steer_capacity` /
    `force_at_least`) and skipped by the hill-climb; ``prefer_low`` breaks
    reward ties toward the smaller ladder index (cheaper resource)."""

    name: str
    ladder: Tuple
    index: int = 0
    adapt: bool = True
    prefer_low: bool = False

    def __post_init__(self) -> None:
        self.ladder = tuple(self.ladder)
        self.index = max(0, min(self.index, len(self.ladder) - 1))

    @property
    def value(self):
        return self.ladder[self.index]


@dataclass
class _Trial:
    name: str
    old_index: int
    new_index: int
    base_reward: float


class OnlineController:
    """Epsilon-greedy coordinate hill-climb plus signal rules over a set
    of `Knob`s.  The owner calls `observe(reward)` once per decision
    boundary (a replan round with a measured epoch behind it) and applies
    the returned ``{name: value}`` changes."""

    def __init__(self, knobs: Sequence[Knob], telemetry: Telemetry = None,
                 *, epsilon: float = 0.2, tol: float = 0.05,
                 shrink_patience: int = 2, settle_after: int = 2,
                 seed: int = 0):
        self.knobs: Dict[str, Knob] = {k.name: k for k in knobs}
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.epsilon = epsilon
        self.tol = tol
        self.shrink_patience = shrink_patience
        # exploration budget: a knob whose last ``settle_after`` trials
        # all reverted is SETTLED (frozen out of the climb) — trial
        # epochs run at a deliberately wrong value, so unbounded
        # exploration taxes steady-state throughput for nothing once the
        # neighborhood is known flat.  A signal-rule move (`force_at_
        # least` / `steer_capacity`) un-settles every knob: the regime
        # changed, the old verdicts are stale.
        self.settle_after = settle_after
        self._rng = np.random.default_rng(seed)
        self._adjustable: List[str] = [
            k.name for k in knobs if k.adapt and len(k.ladder) > 1]
        self._cycle = itertools.cycle(self._adjustable) \
            if self._adjustable else None
        self._trial: Optional[_Trial] = None
        self._last_dir: Dict[str, int] = {}
        self._low_streak: Dict[str, int] = {}
        self._revert_streak: Dict[str, int] = {}
        self.decisions = 0

    def _settled(self, name: str) -> bool:
        return self._revert_streak.get(name, 0) >= self.settle_after

    def _unsettle(self) -> None:
        self._revert_streak.clear()

    # ------------------------------------------------------------- reads
    def value(self, name: str):
        return self.knobs[name].value

    def values(self) -> Dict[str, object]:
        return {n: k.value for n, k in self.knobs.items()}

    # ------------------------------------------------------ signal rules
    def force_at_least(self, name: str, target,
                       cause: str = "signal") -> Optional[object]:
        """Hard signal: jump ``name`` to the first ladder bucket >=
        ``target`` (clamped to the top).  Returns the new value when the
        knob moved, else None.  Cancels any in-flight trial on the knob —
        a forced move invalidates the trial's reward attribution."""
        knob = self.knobs[name]
        idx = next((i for i, v in enumerate(knob.ladder) if v >= target),
                   len(knob.ladder) - 1)
        if idx <= knob.index:
            return None
        self._cancel_trial(name)
        self._unsettle()
        knob.index = idx
        # `target` rides along: the triggering signal (e.g. the intent
        # demand count), so attribution records show WHY the knob moved
        self.telemetry.event("ctl.force", knob=name, value=knob.value,
                             cause=cause, target=int(target))
        return knob.value

    def steer_capacity(self, name: str, demand: int,
                       headroom: float = 1.0) -> Optional[object]:
        """Intent-signal capacity rule: the queued horizon says exactly
        how many rows are worth caching (``demand``), so the bucket is
        computed, not searched.  Growth applies immediately (misses are
        being paid NOW); shrink waits for ``shrink_patience`` consecutive
        low-demand replans and a >= 4x gap (hysteresis: a drift spike must
        not thrash the shape buckets).  Returns the new value or None."""
        knob = self.knobs[name]
        target = max(1, int(demand * headroom))
        grown = self.force_at_least(name, target, cause="demand")
        if grown is not None:
            self._low_streak[name] = 0
            return grown
        if target * 4 <= knob.value and knob.index > 0:
            self._low_streak[name] = self._low_streak.get(name, 0) + 1
            if self._low_streak[name] >= self.shrink_patience:
                self._low_streak[name] = 0
                self._cancel_trial(name)
                self._unsettle()
                idx = next((i for i, v in enumerate(knob.ladder)
                            if v >= target), len(knob.ladder) - 1)
                knob.index = idx
                self.telemetry.event("ctl.force", knob=name,
                                     value=knob.value, cause="demand_low",
                                     target=int(target))
                return knob.value
        else:
            self._low_streak[name] = 0
        return None

    # ---------------------------------------------------- measured climb
    def observe(self, reward: float) -> Dict[str, object]:
        """One decision boundary with the epoch's measured reward (higher
        is better, e.g. served requests/s or loss-drop/s).  Concludes the
        in-flight trial (accept or revert) or proposes the next move;
        returns the knob values the caller must apply ({} = no change)."""
        self.decisions += 1
        self.telemetry.set("ctl.decisions", self.decisions)
        changed: Dict[str, object] = {}
        if self._trial is not None:
            t, self._trial = self._trial, None
            knob = self.knobs[t.name]
            down = t.new_index < t.old_index
            gate = (1.0 - self.tol) if (down and knob.prefer_low) \
                else (1.0 + self.tol)
            accept = reward >= t.base_reward * gate
            if accept:
                self._last_dir[t.name] = 1 if t.new_index > t.old_index \
                    else -1
                self._revert_streak[t.name] = 0
            else:
                knob.index = t.old_index
                changed[t.name] = knob.value
                self._last_dir[t.name] = -self._last_dir.get(t.name, 1)
                self._revert_streak[t.name] = \
                    self._revert_streak.get(t.name, 0) + 1
                if self._settled(t.name):
                    self.telemetry.event("ctl.settle", knob=t.name,
                                         value=knob.value)
            self.telemetry.event(
                "ctl.trial", knob=t.name, accepted=accept,
                value=knob.value, reward=round(reward, 3),
                baseline=round(t.base_reward, 3))
            return changed
        if self._cycle is None:
            return changed
        active = [n for n in self._adjustable if not self._settled(n)]
        if not active:
            return changed
        if self._rng.random() < self.epsilon:
            name = active[int(self._rng.integers(len(active)))]
            direction = int(self._rng.choice((-1, 1)))
        else:
            name = next(self._cycle)
            for _ in range(len(self._adjustable)):
                if not self._settled(name):
                    break
                name = next(self._cycle)
            direction = self._last_dir.get(name, 1)
        knob = self.knobs[name]
        new_index = knob.index + direction
        if not 0 <= new_index < len(knob.ladder):
            direction = -direction
            new_index = knob.index + direction
        if not 0 <= new_index < len(knob.ladder):
            return changed
        self._trial = _Trial(name, knob.index, new_index, reward)
        knob.index = new_index
        changed[name] = knob.value
        self.telemetry.event("ctl.propose", knob=name, value=knob.value,
                             direction=direction)
        return changed

    def _cancel_trial(self, name: str) -> None:
        if self._trial is not None and self._trial.name == name:
            self._trial = None
