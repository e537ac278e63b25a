"""The device trace of a ``--trace 1`` run: `torch.profiler` over the
measured window, device activity only (kernels, copies, fills), reduced
here to what the per-layer metrics and the result's ``device`` and
``breakdown`` read.

The profiler stamps its events on the wall clock (Unix ns); the host's
spans and the window use `time.perf_counter_ns`.  `DeviceTrace.start`
notes both clocks at once, and events are moved onto the host's clock
by that offset.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

Interval = Tuple[str, int, int]          # (name, start ns, end ns)


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Interval], t0: int, t1: int) -> List[Interval]:
    """The parts of ``intervals`` inside ``[t0, t1]``."""
    return [(n, max(s, t0), min(e, t1)) for n, s, e in intervals
            if e > t0 and s < t1]


def busy_ns(ops: Sequence[Interval]) -> int:
    return sum(e - s for s, e in union([(s, e) for _, s, e in ops]))


def top_ops(ops: Sequence[Interval], k: int = 10) -> List[list]:
    """Device time by operation name, the ``k`` largest, in seconds."""
    by: dict = {}
    for n, s, e in ops:
        by[n] = by.get(n, 0) + (e - s)
    return [[n[:120], v / 1e9] for n, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(ops: Sequence[Interval], spans: Sequence[Interval], t0: int,
              t1: int, k: int = 10) -> List[list]:
    """The device's idle time inside ``[t0, t1]``, summed by what the
    host was doing at each gap's middle: the innermost program span
    there, or "no span"; the ``k`` largest, in seconds."""
    busy = union([(s, e) for _, s, e in ops])
    gaps, last = [], t0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    # sweep the gaps' middles in time order beside the spans, keeping the
    # spans open at each middle (a few at a time: spans nest or follow)
    order = sorted(spans, key=lambda sp: sp[1])
    by: dict = {}
    nxt, open_ = 0, []
    for s, e in gaps:
        mid = (s + e) // 2
        while nxt < len(order) and order[nxt][1] <= mid:
            open_.append(order[nxt])
            nxt += 1
        open_ = [sp for sp in open_ if sp[2] >= mid]
        name = max(open_, key=lambda sp: sp[1])[0] if open_ else "no span"
        by[name] = by.get(name, 0) + (e - s)
    return [[n, v / 1e9] for n, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:k]]


@dataclass
class DeviceTrace:
    """Starts and stops `torch.profiler` (device activity only) and keeps
    the device operations on the host's clock."""

    ops: List[Interval] = field(default_factory=list)
    prof: Optional[object] = None
    offset_ns: int = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.prof.stop()
        off = self.offset_ns
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA and ev.duration_ns() > 0:
                s = ev.start_ns() - off
                self.ops.append((ev.name(), s, s + ev.duration_ns()))
        self.prof = None
