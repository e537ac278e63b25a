"""Micro-batching admission scheduler for the serving runtime (§9).

Groups queued requests into fixed-shape ``(batch_requests,
keys_per_request)`` token batches (static shapes, so the device
buffers keep one shape per miss-capacity bucket), asks the planner for a
miss buffer sized by `intent_miss_bound` over the *queued* horizon, and
accounts per-request latency (enqueue -> served) and throughput.

Host-side and numpy-only on purpose: the scheduler never touches device
state.  `LatencyRecorder` lives in `repro_torch.core.api`; it is
re-exported here for serving callers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.api import LatencyRecorder  # noqa: F401  (re-export)

from .requests import RequestQueue, ServeRequest


@dataclass
class MicroBatch:
    """One admitted fixed-shape batch (rows past ``len(reqs)`` are
    padding clones)."""

    reqs: List[ServeRequest]     # the real requests (<= batch_requests)
    tokens: np.ndarray           # (batch_requests, keys_per_request) int32


class MicroBatchScheduler:
    """Admission control: fixed-shape micro-batches off the queue.

    Row padding repeats each request's own first key out to
    ``keys_per_request`` and clones the first admitted request's row for
    empty request slots — pad tokens therefore only ever name keys already
    counted in the queued-intent horizon, so they cannot push the batch
    past the planner's exact miss bound."""

    def __init__(self, batch_requests: int, keys_per_request: int):
        self.B = batch_requests
        self.K = keys_per_request
        self.latency = LatencyRecorder()
        self.n_served = 0
        self.n_batches = 0

    def admit(self, queue: RequestQueue) -> Optional[MicroBatch]:
        reqs = queue.pop_batch(self.B)
        if not reqs:
            return None
        tokens = np.empty((self.B, self.K), np.int32)
        for i, req in enumerate(reqs):
            k = len(req.keys)
            if k > self.K:
                # loud, never silent: truncating would serve a partial
                # request while expiring its full intent (the runtime's
                # never-silently-wrong contract)
                raise ValueError(
                    f"request {req.rid} has {k} keys > keys_per_request="
                    f"{self.K}; split it upstream")
            tokens[i, :k] = req.keys
            tokens[i, k:] = req.keys[0]
        tokens[len(reqs):] = tokens[0]        # clone row, never a new key
        self.n_batches += 1
        return MicroBatch(reqs, tokens)

    def note_served(self, reqs: Sequence[ServeRequest],
                    now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        for req in reqs:
            self.latency.record(now - req.t_enqueue)
        self.n_served += len(reqs)
