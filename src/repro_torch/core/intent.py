"""Intent signaling primitives (paper §3); the twin of
`repro/core/intent.py`.

An *intent* is a declaration by one worker that it will access a set of
parameter keys in a logical-clock window ``[c_start, c_end)``.  Each worker
owns an independent logical clock that it advances with ``advance()`` (cheap,
only raises the counter).  Intents are signaled *before* the access so the
parameter manager can act proactively.

States of an intent w.r.t. its worker's clock ``C`` (paper §3):
  inactive: C <  c_start
  active:   c_start <= C < c_end
  expired:  c_end <= C
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Iterable, Sequence, Set, Tuple

import numpy as np


class IntentType(enum.Enum):
    """Optional intent type. AdaPM treats all types identically (§4.1)."""

    READ = "read"
    WRITE = "write"
    READ_WRITE = "read+write"


@dataclass(frozen=True)
class Intent:
    """One signaled intent: worker ``worker_id`` will access ``keys`` in
    the clock window ``[c_start, c_end)`` of *its own* logical clock.
    ``keys`` may be any integer sequence (tuple or ndarray)."""

    keys: Sequence[int]
    c_start: int
    c_end: int
    worker_id: int
    type: IntentType = IntentType.READ_WRITE

    def __post_init__(self):
        if self.c_end <= self.c_start:
            raise ValueError(
                f"empty intent window [{self.c_start}, {self.c_end})")

    def state(self, clock: int) -> str:
        if clock < self.c_start:
            return "inactive"
        if clock < self.c_end:
            return "active"
        return "expired"


class LogicalClock:
    """Per-worker logical clock.  ``advance()`` is cheap by design (§3)."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    def advance(self, by: int = 1) -> int:
        if by < 0:
            raise ValueError("clocks are monotone")
        self.value += by
        return self.value


class IntentTable:
    """Node-local store of signaled intents, indexed by key.

    Tracks, per key, the union of intent windows of this node's workers.
    Supports the queries the manager needs:
      * is there *active* intent for key k (given current worker clocks)?
      * is there *inactive* (future) intent, and what is its earliest start?
      * garbage-collect expired windows.

    Workers can signal overlapping/extending intents freely (§3); the table
    simply stores all windows and reasons over the union.  Storage and the
    activation queries are the vectorized `engine.IntentStore`; this class
    is the per-`Intent` adapter.
    """

    def __init__(self):
        from .engine import IntentStore
        self._store = IntentStore()

    def signal(self, intent: Intent) -> None:
        self._store.signal(np.asarray(intent.keys, np.int64),
                           intent.c_start, intent.c_end, intent.worker_id)

    def keys_with_any_intent(self) -> Iterable[int]:
        return [int(k) for k in self._store.keys()]

    def has_active(self, key: int, clocks: Dict[int, int]) -> bool:
        return self._store.has_active(key, clocks)

    def active_workers(self, key: int, clocks: Dict[int, int]) -> Set[int]:
        return self._store.active_workers(key, clocks)

    def earliest_future_start(self, key: int, clocks: Dict[int, int]):
        """Earliest c_start among *inactive* windows for ``key`` together
        with its worker, or ``None`` if no inactive intent exists."""
        return self._store.earliest_future_start(key, clocks)

    def last_end(self, key: int) -> int:
        """Max c_end over all windows (used for expiry bookkeeping)."""
        return self._store.last_end(key)

    def gc(self, clocks: Dict[int, int]) -> None:
        """Drop expired windows; drop keys with no windows left."""
        self._store.gc(clocks)

    def __len__(self) -> int:
        return len(self._store)
