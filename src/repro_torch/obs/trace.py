"""Low-overhead ring-buffered span tracer (DESIGN.md §14).

Answers "where did this request's latency go?" without perturbing the
thing it measures: a closed span is one tuple appended to a bounded
deque (no per-span dict, no string formatting, no numpy boxing, no I/O
on the hot path — names are interned to small ints first), the clock
is `time.perf_counter_ns` (monotonic, the same clock the runtime's
latency accounting already uses), and the buffer is a ring — the
deque's ``maxlen`` makes a long serve run overwrite its oldest spans
instead of growing without bound (`dropped` counts the evictions, so
an export can never silently claim full coverage).

Tracing is **default-off**.  A disabled tracer's `span()` returns one
shared no-op context manager and `record()`/`point()` return before
touching the buffer — the instrumented call sites stay in the code with
no measurable cost (the serve bench's paired overhead guard pins the
*enabled* cost under 2%; disabled is a branch).

Per-entity sampling (`sampled(rid)`) is deterministic — a multiplicative
hash of the id against `sample` — so the same request is either fully
traced or fully absent, across requeues and across runs; phase spans
(few per round) are always recorded when the tracer is enabled.

Span vocabulary (names are interned; two int64 arg slots ``a``/``b``
ride in the arrays):

  serving   serve.round > serve.enqueue / serve.plan / serve.admit /
            serve.probe / serve.split / serve.dispatch / serve.book /
            serve.pipe; serve.plan > serve.plan.ctl / serve.plan.snapshot
            / serve.plan.solve / serve.plan.refresh / prefetch.stage;
            serve.pipe > serve.served / serve.note / serve.expire for each
            batch it finishes (a=round; serve.served, serve.note and
            serve.expire a=requests); per-request ``serve.request``
            (enqueue -> served, a=rid b=attempts) and ``serve.requeue``
            instant points (a=rid)
  training  train.signal / train.plan / train.refresh / train.step
            (a=step), and the device marks ``train.mark.<part>`` (a=step)
            for each part the step names (`enter_phase`: forward,
            backward, update, update/adagrad, update/rows; a Falcon-H1
            layer's forward/ssm, forward/attn, forward/mlp) and
            ``train.mark.end`` as the step function returns
  prefetch  the intent-lead-time pipeline stages (DESIGN.md §15):
            ``prefetch.plan`` — background plan-ahead (an instant at
            submission, a span when the boundary joins the candidate;
            a=target step); ``prefetch.refresh`` — the delta replica
            re-gather that replaced a full train.refresh (a=step);
            ``prefetch.drain`` — a deferred step's loss block (a=step);
            ``prefetch.stage`` — the serving tenure's staging-buffer
            gather (a=round)

Device marks (`mark_device`) are zero-length records of when the
device's stream reached a point, on the same `perf_counter_ns` clock as
the spans: a CUDA event is recorded on the current stream and kept
pending, and `resolve_device` places each completed one at an anchor's
host time plus the device time from the anchor to it.  An anchor is an
event recorded while the device is empty (synchronize, record,
synchronize, read the clock); one is taken when marking starts and
again at each ``resolve_device(anchor=True)``, which keeps the float32
milliseconds of `torch.cuda.Event.elapsed_time` within about 2 us.  On a
CPU tensor device the work is synchronous and a mark is the host's time
at once.  Marks sit on a lane of their own (``tid`` `MARK_TID`).

`to_chrome()` renders the buffer as Chrome trace-event JSON ("X"
complete events + "i" instants, ts/dur in microseconds) — loadable in
Perfetto / chrome://tracing; `repro_torch.obs.report` turns the same events
into the shutdown latency report.
"""

from __future__ import annotations

import json
import time
from collections import deque
from operator import itemgetter
from typing import Dict, List, Optional

import numpy as np
import torch

_DEFAULT_CAPACITY = 1 << 15
#: the Chrome-trace lane of the device marks (request spans use 1..8)
MARK_TID = 9

#: callables told the name of each part of a training step as it starts
#: (the loop's device marks, a dry run's step counter)
PHASE_LISTENERS: list = []


def enter_phase(name: str) -> None:
    """Tells `PHASE_LISTENERS` that the step's part ``name`` starts."""
    for listen in PHASE_LISTENERS:
        listen(name)


class _NullSpan:
    """Shared no-op context manager: the disabled tracer's span()."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span: records itself into the ring on exit."""

    __slots__ = ("_tr", "_name", "_tid", "_a", "_b", "_t0")

    def __init__(self, tr: "SpanTracer", name: str, tid: int,
                 a: int, b: int):
        self._tr = tr
        self._name = name
        self._tid = tid
        self._a = a
        self._b = b
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tr.record(self._name, self._t0, time.perf_counter_ns(),
                        tid=self._tid, a=self._a, b=self._b)
        return False


class SpanTracer:
    """Bounded ring of (name_id, t0, t1, tid, a, b) span tuples."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 sample: float = 1.0, enabled: bool = True):
        self.enabled = bool(enabled)
        self.sample = float(sample)
        self.capacity = int(capacity)
        assert self.capacity > 0
        self._buf: deque = deque(maxlen=self.capacity)
        self._n = 0                       # total spans ever recorded
        self._names: List[str] = []       # interning table: id -> name
        self._name_ids: Dict[str, int] = {}
        # trace origin: exports are relative to construction time, so ts
        # stays small and positive (perf_counter_ns shares this origin
        # with perf_counter, so seconds-clock timestamps convert exactly)
        self.epoch_ns = time.perf_counter_ns()
        # the wall clock (Unix ns) less this clock, noted once at the
        # epoch: lays an export over a `torch.profiler` trace
        self.wall_offset_ns = time.time_ns() - self.epoch_ns
        # device marks: CUDA events not yet placed on the host's clock,
        # (name, event, a, b) in stream order, and the anchor they are
        # placed from, (event, host ns, device)
        self._pending: deque = deque()
        self._anchor: Optional[tuple] = None

    # ------------------------------------------------------------ writes
    def now_ns(self) -> int:
        return time.perf_counter_ns()

    def sampled(self, i: int) -> bool:
        """Deterministic per-entity coin: the same id is always in or
        always out at a given sampling rate (requeued requests keep
        their verdict)."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return ((int(i) * 2654435761) & 0xFFFFFFFF) < \
            self.sample * 4294967296.0

    def _name_id(self, name: str) -> int:
        nid = self._name_ids.get(name)
        if nid is None:
            nid = len(self._names)
            self._names.append(name)
            self._name_ids[name] = nid
        return nid

    def record(self, name: str, t0_ns: int, t1_ns: int, *, tid: int = 0,
               a: int = 0, b: int = 0) -> None:
        """Append one closed span (the fast path: one tuple append —
        measurably cheaper than per-field numpy scalar stores)."""
        if not self.enabled:
            return
        nid = self._name_ids.get(name)
        if nid is None:
            nid = self._name_id(name)
        self._buf.append((nid, t0_ns, t1_ns, tid, a, b))
        self._n += 1

    def record_many(self, name: str, t0s_ns, t1_ns: int, *,
                    tids=None, a=None, b=None) -> None:
        """Batched append of spans sharing one name and end time — the
        per-request lifecycle spans of a served batch land as one
        `deque.extend` instead of a Python loop of `record` calls (the
        serve bench's 2% overhead budget is won here).  ``t0s_ns`` /
        ``tids`` / ``a`` / ``b`` accept lists or numpy arrays."""
        if not self.enabled:
            return
        t0s = (t0s_ns.tolist() if isinstance(t0s_ns, np.ndarray)
               else list(t0s_ns))
        n = len(t0s)
        if n == 0:
            return
        nid = self._name_id(name)
        t1 = int(t1_ns)

        def _col(v):
            if v is None:
                return (0,) * n
            return v.tolist() if isinstance(v, np.ndarray) else list(v)

        self._buf.extend(zip((nid,) * n, t0s, (t1,) * n,
                             _col(tids), _col(a), _col(b)))
        self._n += n

    def point(self, name: str, *, tid: int = 0, a: int = 0,
              b: int = 0) -> None:
        """Instant event (t1 == t0): requeues, knob flips, markers."""
        if not self.enabled:
            return
        t = time.perf_counter_ns()
        self.record(name, t, t, tid=tid, a=a, b=b)

    def span(self, name: str, *, tid: int = 0, a: int = 0, b: int = 0):
        """Context manager measuring the enclosed block.  Disabled
        tracers return one shared no-op — no allocation, no clock."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tid, a, b)

    def mark_device(self, name: str, *, a: int = 0, b: int = 0,
                    device=None) -> None:
        """Mark the point the work queued so far on ``device``'s current
        stream reaches (a zero-length record once `resolve_device` places
        it).  Off a CUDA device the mark is the host's time at once."""
        if not self.enabled:
            return
        if getattr(device, "type", device) != "cuda":
            t = time.perf_counter_ns()
            self.record(name, t, t, tid=MARK_TID, a=a, b=b)
            return
        if self._anchor is None:
            self._take_anchor(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        self._pending.append((name, ev, a, b))

    def resolve_device(self, anchor: bool = False) -> None:
        """Place every completed pending mark on the host's clock, in
        stream order.  With ``anchor``, wait for the device, place them
        all, and take a new anchor for the marks to come."""
        if self._anchor is None:
            return
        ev0, t0, dev = self._anchor
        if anchor:
            torch.cuda.synchronize(dev)
        while self._pending and self._pending[0][1].query():
            name, ev, a, b = self._pending.popleft()
            t = t0 + round(ev0.elapsed_time(ev) * 1e6)
            self.record(name, t, t, tid=MARK_TID, a=a, b=b)
        if anchor:
            self._take_anchor(dev)

    def _take_anchor(self, device) -> None:
        """An event recorded on an empty device, and the host's time just
        after it completed."""
        torch.cuda.synchronize(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        torch.cuda.synchronize(device)
        self._anchor = (ev, time.perf_counter_ns(), device)

    # ------------------------------------------------------------- reads
    @property
    def count(self) -> int:
        """Total spans ever recorded (evicted ones included)."""
        return self._n

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring (recorded but no longer held)."""
        return max(0, self._n - self.capacity)

    def events(self) -> List[dict]:
        """Held spans and placed marks, by start time, decoded to dicts
        (export surface).  The ring holds them in the order they were
        recorded — a span when it closes, after the spans it encloses, a
        device mark when it is placed — so they are sorted here (stably:
        records that start at one time keep the ring's order)."""
        names = self._names
        return [{
            "name": names[nid],
            "t0_ns": int(t0),
            "t1_ns": int(t1),
            "tid": int(tid),
            "a": int(a),
            "b": int(b),
        } for nid, t0, t1, tid, a, b in sorted(self._buf,
                                                 key=itemgetter(1))]

    # ----------------------------------------------------------- exports
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (the object form Perfetto loads).

        Spans become "X" complete events (required fields: name, ph, ts,
        pid, tid, plus dur), zero-duration records become "i" instants;
        ts/dur are microseconds relative to the tracer's epoch, which
        ``otherData`` gives on this clock (``epoch_ns``) and on the wall
        clock (``epoch_ns + wall_offset_ns``, Unix ns)."""
        trace_events = []
        for e in self.events():
            ts = (e["t0_ns"] - self.epoch_ns) / 1e3
            dur = (e["t1_ns"] - e["t0_ns"]) / 1e3
            ev = {
                "name": e["name"],
                "cat": e["name"].split(".", 1)[0],
                "ph": "X" if dur > 0 else "i",
                "ts": ts,
                "pid": 0,
                "tid": e["tid"],
                "args": {"a": e["a"], "b": e["b"]},
            }
            if ev["ph"] == "X":
                ev["dur"] = dur
            else:
                ev["s"] = "t"       # instant scope: thread
            trace_events.append(ev)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "spans_recorded": self._n,
                "spans_dropped": self.dropped,
                "sample": self.sample,
                "clock": "perf_counter_ns",
                "epoch_ns": self.epoch_ns,
                "wall_offset_ns": self.wall_offset_ns,
            },
        }

    def dump(self, path: str) -> None:
        """Write `to_chrome()` to ``path`` as JSON."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def make_tracer(enabled: bool, sample: float = 1.0,
                capacity: int = _DEFAULT_CAPACITY,
                tracer: Optional[SpanTracer] = None) -> SpanTracer:
    """Resolve a runtime's tracer: an injected instance wins; otherwise
    build one in the requested state (disabled tracers keep every call
    site branch-free and cost one early return per record)."""
    if tracer is not None:
        return tracer
    return SpanTracer(capacity=capacity, sample=sample, enabled=enabled)
