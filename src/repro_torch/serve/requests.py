"""Request generation + queueing for the online serving runtime (§9).

A serving request names the embedding rows it will touch (a user/session
feature lookup, the prompt's token set, a GNN neighborhood — anything the
frontend knows at admission time).  That is exactly an intent signal: the
moment a request is *enqueued* its key set enters the
`StreamingIntentBuffer`, so by the time the scheduler forms a batch the
planner already knows every row the queued horizon needs — the serving
analogue of the training loader signaling on batch preparation.

`DriftingZipfStream` generates the latency-bound skewed-read scenarios the
paper-style fixed training window cannot express: Zipf access with a
rotating hot set ("rotate"), arrival-rate bursts ("burst"), and a flash
crowd piling onto one previously-cold key ("flash").
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Iterable, List, Optional

import numpy as np

from repro_torch.core.engine import StreamingIntentBuffer
from repro_torch.data.pipeline import DriftingZipfCorpus

SCENARIOS = ("steady", "rotate", "burst", "flash")


@dataclass(eq=False)
class ServeRequest:
    """One enqueued lookup request: ``keys`` are the embedding rows it
    will read when scheduled (fixed length per stream for static batch
    shapes; duplicates allowed — the lookup dedups)."""

    rid: int
    keys: np.ndarray
    t_enqueue: float = 0.0
    attempts: int = 0
    tenant: str = "default"      # accounting label only (no admission
    #   policy): per-tenant serve.requeued telemetry


class DriftingZipfStream:
    """Per-round request arrivals over a drifting-hot-set Zipf workload.

    scenario:
      steady : fixed Zipf head, ``arrival_rate`` requests per round;
      rotate : the hot set rotates every ``rotate_every`` rounds
               (``rotation_rounds`` records when, for drift tests);
      burst  : every ``burst_every`` rounds the arrival count multiplies
               by ``burst_mult`` for one round (queue-depth shock);
      flash  : every ``flash_every`` rounds a previously-cold key is drawn
               and injected into ``flash_frac`` of arrivals for
               ``flash_len`` rounds (flash crowd on one entity).
    """

    def __init__(self, vocab: int, keys_per_request: int = 16, *,
                 zipf_a: float = 1.1, arrival_rate: int = 32,
                 scenario: str = "steady", rotate_every: int = 32,
                 burst_every: int = 16, burst_mult: int = 4,
                 flash_every: int = 32, flash_len: int = 8,
                 flash_frac: float = 0.5, seed: int = 0):
        if scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r}")
        self.V = vocab
        self.K = keys_per_request
        self.rate = arrival_rate
        self.scenario = scenario
        self.rotate_every = rotate_every
        self.burst_every = burst_every
        self.burst_mult = burst_mult
        self.flash_every = flash_every
        self.flash_len = flash_len
        self.flash_frac = flash_frac
        self.corpus = DriftingZipfCorpus(vocab, zipf_a=zipf_a, seed=seed)
        self.rng = np.random.default_rng(seed + 11)
        self.rotation_rounds: List[int] = []
        self._flash_key: Optional[int] = None
        self._flash_until = -1
        self._next_rid = 0

    def _make(self, n: int) -> List[ServeRequest]:
        toks = self.corpus.tokens((n, self.K)).astype(np.int64)
        if self._flash_key is not None:
            crowd = self.rng.random(n) < self.flash_frac
            toks[crowd, 0] = self._flash_key
        reqs = [ServeRequest(self._next_rid + i, toks[i])
                for i in range(n)]
        self._next_rid += n
        return reqs

    def arrivals(self, rnd: int) -> List[ServeRequest]:
        """Requests arriving during round ``rnd`` (call once per round)."""
        n = self.rate
        if self.scenario == "rotate" and rnd > 0 \
                and rnd % self.rotate_every == 0:
            self.corpus.rotate()
            self.rotation_rounds.append(rnd)
        elif self.scenario == "burst" and rnd > 0 \
                and rnd % self.burst_every == 0:
            n *= self.burst_mult
        elif self.scenario == "flash":
            if rnd >= self._flash_until:
                self._flash_key = None
            if rnd > 0 and rnd % self.flash_every == 0:
                # a cold key (deep tail of the live perm) catches fire
                self._flash_key = int(
                    self.corpus.perm[self.rng.integers(self.V // 2, self.V)])
                self._flash_until = rnd + self.flash_len
        return self._make(n)


class ReplayStream:
    """Fixed pre-generated arrival schedule — replays the same trace into
    several runtimes so managed-vs-plain comparisons serve identical
    requests (each replay deep-copies the requests: timing/attempt fields
    are per-run state)."""

    def __init__(self, per_round: List[List[ServeRequest]],
                 rotation_rounds: Optional[List[int]] = None):
        self.per_round = per_round
        self.rotation_rounds = list(rotation_rounds or [])

    @classmethod
    def record(cls, stream: DriftingZipfStream, rounds: int
               ) -> "ReplayStream":
        per_round = [stream.arrivals(r) for r in range(rounds)]
        return cls(per_round, stream.rotation_rounds)

    def arrivals(self, rnd: int) -> List[ServeRequest]:
        if rnd >= len(self.per_round):
            return []
        return [ServeRequest(r.rid, r.keys, tenant=r.tenant)
                for r in self.per_round[rnd]]


class RequestQueue:
    """FIFO request queue whose enqueue path *signals intent*: admission
    is the intent signal (paper §3 — information is provided where it is
    naturally known).  Overflowed requests re-enter at the front
    (``requeue``) with their intent still live — it only expires when the
    request is actually served."""

    def __init__(self, intent: Optional[StreamingIntentBuffer] = None):
        self.intent = intent
        self._q: Deque[ServeRequest] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def enqueue(self, req: ServeRequest, now: float) -> None:
        req.t_enqueue = now
        self._q.append(req)
        if self.intent is not None:
            self.intent.ingest(req.rid, req.keys)

    def enqueue_many(self, reqs: List[ServeRequest], now: float) -> None:
        """One vectorized intent ingest for a whole arrival wave."""
        if not reqs:
            return
        for req in reqs:
            req.t_enqueue = now
            self._q.append(req)
        if self.intent is not None:
            self.intent.ingest_batch(
                np.repeat(np.asarray([r.rid for r in reqs], np.int64),
                          [len(r.keys) for r in reqs]),
                np.concatenate([r.keys for r in reqs]))

    def requeue(self, reqs: Iterable[ServeRequest]) -> None:
        """Front-insert (preserving relative order) — overflowed requests
        are already the oldest work in the system."""
        for req in reversed(list(reqs)):
            req.attempts += 1
            self._q.appendleft(req)

    def pop_batch(self, n: int) -> List[ServeRequest]:
        return [self._q.popleft() for _ in range(min(n, len(self._q)))]

    def order_ids(self) -> np.ndarray:
        """Queued request ids front-to-back (the planner's horizon)."""
        return np.fromiter((r.rid for r in self._q), np.int64, len(self._q))

    def served(self, reqs: Iterable[ServeRequest]) -> None:
        """Expire the served requests' intent."""
        if self.intent is not None:
            self.intent.expire(np.asarray([r.rid for r in reqs], np.int64))
