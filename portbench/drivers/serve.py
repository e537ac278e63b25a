"""Serving cells: `repro_torch.serve.runtime.ServingRuntime.run` over the
configuration's embedding table, made on the device from the seed, with
the runtime's own defaults (the intent-managed lookup through the
hand-written kernels, "auto" knobs).

The traffic's ``loop`` is "open" or "closed"; its other parameters
(rate, rate profile, key distribution, rotation, backlog) are data that
`portbench.generator` reads.

* open: a fixed schedule of requests due at a fixed mean rate
  (`generator.open_schedule`); every call of the stream's ``arrivals``
  hands the runtime each request that is due by then.  A request's
  latency runs from when it was due to when the runtime handed its rows
  out (the ``now`` of `MicroBatchScheduler.note_served`, after the
  batch's device work has finished).  ``serve_p95_ms`` is the 95th
  percentile over every request due in the window; one never served
  counts as late beyond any limit.
* closed: the stream keeps ``backlog`` requests outstanding, topping up
  at every ``arrivals`` call; ``serve_requests_per_s`` counts the
  requests served inside the window over its length.

The window is ``[warm_s, warm_s + seconds)`` of the stream's clock,
which starts at the runtime's first ``arrivals`` call.  Once every
request of the window has been served (at most ``grace_s`` after it
closed), the stream ends the run: ``arrivals`` raises `Done`, with no
request of the window left in flight.

The check: a sample of the window's requests, drawn from the seed, has
its served rows copied as the runtime produces them (the runtime's
lookup is observed, not changed), and once the window has closed and the
runtime is freed they are held bit for bit against the rows of a table
drawn again from the seed (`torch.equal`; an exact comparison, limit 0).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.devtrace import DeviceTrace, clip
from portbench.generator import ClosedKeys, open_schedule, sample_ids
from portbench.harness import Outcome, Run, Window


class Done(Exception):
    """Raised by the stream once the run's requests are all served."""


def make_table(config: dict, seed: int, device) -> torch.Tensor:
    """The (vocab, d_model) fp32 table, drawn on ``device`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.empty((config["vocab_size"], config["d_model"]),
                       dtype=torch.float32, device=device).normal_(
                           generator=gen)


def p95(values: np.ndarray) -> float:
    """The nearest-rank 95th percentile of all ``values``."""
    v = np.sort(values)
    return float(v[int(np.ceil(0.95 * v.size)) - 1])


class Stream:
    """The runtime's request source, on the host clock; records when each
    request was handed out and served."""

    def __init__(self, r: Run, keys_of):
        from repro_torch.serve.requests import ServeRequest
        self.request = ServeRequest
        t = r.cell.traffic
        self.warm, self.seconds = t["warm_s"], r.seconds
        self.grace = t.get("grace_s", 60.0)
        self.keys_of = keys_of
        self.t0: Optional[float] = None
        self.handed_t: List[float] = []
        self.served_t: Dict[int, float] = {}
        self.served_try: Dict[int, int] = {}
        self.lo, self.hi = 0, 0            # the window's requests, if known
        self.window_served = 0

    @property
    def t_open(self) -> float:
        return self.t0 + self.warm

    @property
    def t_close(self) -> float:
        return self.t_open + self.seconds

    def hand(self, lo: int, hi: int, now: float) -> list:
        self.handed_t.extend([now] * (hi - lo))
        return [self.request(i, self.keys_of(i)) for i in range(lo, hi)]

    def served(self, reqs, now: float) -> None:
        for q in reqs:
            self.served_t[q.rid] = now
            self.served_try[q.rid] = q.attempts
            self.window_served += self.lo <= q.rid < self.hi

    def start(self, now: float) -> None:
        """Start the stream's clock at its first call."""
        if self.t0 is None:
            self.t0 = now


class OpenStream(Stream):
    def __init__(self, r: Run, sched):
        super().__init__(r, lambda i: sched.keys[i])
        self.due = sched.due_s
        self.next = 0
        # the requests of the window: due in [warm, warm + seconds)
        self.lo = int(np.searchsorted(self.due, self.warm))
        self.hi = int(np.searchsorted(self.due, self.warm + r.seconds))

    def arrivals(self, rnd: int) -> list:
        now = time.perf_counter()
        self.start(now)
        if now >= self.t_close and (
                self.window_served == self.hi - self.lo
                or now >= self.t_close + self.grace):
            raise Done
        hi = int(np.searchsorted(self.due, now - self.t0, side="right"))
        out = self.hand(self.next, hi, now)
        self.next = hi
        return out

    def window_latency_s(self, end: float) -> np.ndarray:
        """Each window request's latency from its due time; one never
        served is taken as served at ``end``, when the run gave up."""
        return np.array([self.served_t.get(i, end)
                         - (self.t0 + self.due[i])
                         for i in range(self.lo, self.hi)])


class ClosedStream(Stream):
    def __init__(self, r: Run, keys: ClosedKeys, backlog: int):
        super().__init__(r, keys.keys)
        self.backlog = backlog
        self.next = 0

    def arrivals(self, rnd: int) -> list:
        now = time.perf_counter()
        self.start(now)
        outstanding = self.next - len(self.served_t)
        if now >= self.t_close:
            if outstanding == 0 or now >= self.t_close + self.grace:
                raise Done
            return []
        out = self.hand(self.next, self.next + self.backlog - outstanding,
                        now)
        self.next += len(out)
        return out


def run(r: Run) -> Outcome:
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.obs.trace import SpanTracer
    from repro_torch.serve import runtime as rt_mod
    cell, config, traffic = r.cell, r.cell.config, r.cell.traffic
    dev = r.device
    cuda = dev.type == "cuda"
    K = traffic["keys_per_request"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    table = make_table(config, r.seed, dev)
    dtrace = DeviceTrace() if r.trace else None
    if traffic["loop"] == "open":
        span = traffic["warm_s"] + r.seconds + traffic["tail_s"]
        sched = open_schedule(config["vocab_size"], K, traffic["rate"],
                              span, dist=traffic.get("dist", "zipf"),
                              zipf_a=traffic.get("zipf_a", 1.1),
                              rotate_s=traffic.get("rotate_s", 0.0),
                              profile=traffic.get("profile"), seed=r.seed)
        stream = OpenStream(r, sched)
        keys_of = sched.keys.__getitem__
        sample = set((stream.lo + sample_ids(
            stream.hi - stream.lo, traffic["check_requests"], r.seed))
            .tolist())
    else:
        keys = ClosedKeys(config["vocab_size"], K, r.seed,
                          dist=traffic.get("dist", "uniform"),
                          zipf_a=traffic.get("zipf_a", 1.1))
        stream = ClosedStream(r, keys, traffic["backlog"])
        keys_of = keys.keys
        stride = traffic["check_stride"]
        offset = int(np.random.default_rng(r.seed + 3).integers(stride))
        sample = None

    def sampled(rid: int) -> bool:
        return rid in sample if sample is not None \
            else rid % stride == offset

    class Bus(Telemetry):
        """The runtime's bus, keeping each batch's miss rate with the
        host clock (the runtime sets it as a gauge)."""

        def __init__(self):
            super().__init__()
            self.miss: List[Tuple[float, float]] = []

        def set(self, name, v, **labels):
            if name == "serve.miss_rate":
                self.miss.append((time.perf_counter(), v))
            super().set(name, v, **labels)

    bus = Bus()
    tracer = SpanTracer(capacity=1 << 20, sample=0.0) if r.trace else None
    scfg = rt_mod.ServeConfig(vocab=config["vocab_size"],
                              keys_per_request=K, summary=False,
                              **traffic.get("serve", {}))
    rt = rt_mod.ServingRuntime(table, scfg, telemetry=bus, tracer=tracer,
                               device=dev)
    # observe the runtime: each admitted batch, the rows its lookup
    # produces for sampled requests, and when each request is served
    rows: Dict[Tuple[int, int], torch.Tensor] = {}
    batches: List[Tuple[float, np.ndarray]] = []
    last = {}
    admit, note = rt.scheduler.admit, rt.scheduler.note_served
    lookup = rt_mod.planned_serve_lookup

    def admit_watched(queue):
        b = admit(queue)
        last["batch"] = b
        if b is not None and r.trace:
            batches.append((time.perf_counter(), b.tokens))
        return b

    def lookup_watched(*args, **kwargs):
        out = lookup(*args, **kwargs)
        b = last.get("batch")
        for i, q in enumerate(b.reqs if b is not None else ()):
            if sampled(q.rid):
                rows[(q.rid, q.attempts)] = out[i * K:(i + 1) * K].clone()
        return out

    def note_watched(reqs, now=None):
        note(reqs, now)
        stream.served(reqs, now)

    rt.scheduler.admit = admit_watched
    rt.scheduler.note_served = note_watched
    rt_mod.planned_serve_lookup = lookup_watched
    if dtrace is not None:
        # before the stream's clock starts: the profiler's start would
        # stall an open loop and pile its queue up
        dtrace.start()
    try:
        rt.run(stream, 1 << 62)
    except Done:
        pass
    finally:
        rt_mod.planned_serve_lookup = lookup
    if cuda:
        torch.cuda.synchronize(dev)
    if dtrace is not None:
        dtrace.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    t_open, t_close = stream.t_open, stream.t_close
    zero_served = int(bus.counter_value("serve.zero_served"))
    if traffic["loop"] == "open":
        lat = stream.window_latency_s(time.perf_counter())
        attempted = int(lat.size)
        failed = attempted - stream.window_served
        metrics = {"serve_p95_ms": p95(lat) * 1e3}
        fifth = max(1, lat.size // 5)
        detail = {"p50_ms": float(np.median(lat)) * 1e3,
                  "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                  "first_fifth_p50_ms": float(np.median(lat[:fifth])) * 1e3,
                  "last_fifth_p50_ms": float(np.median(lat[-fifth:])) * 1e3,
                  "offered_per_s": lat.size / r.seconds}
        judged = [i for i in range(stream.lo, stream.hi)
                  if sampled(i) and i in stream.served_t]
    else:
        handed = np.asarray(stream.handed_t)
        in_win = np.flatnonzero((handed >= t_open) & (handed < t_close))
        attempted = int(in_win.size)
        failed = int(sum(i not in stream.served_t for i in in_win))
        served_in = sum(t_open <= t < t_close
                        for t in stream.served_t.values())
        metrics = {"serve_requests_per_s": served_in / (t_close - t_open)}
        detail = {}
        judged = [i for i, t in stream.served_t.items()
                  if sampled(i) and t_open <= t < t_close]
    metrics["setup_s"] = t_open - r.t_start
    detail["batches_in_window"] = sum(t_open <= t < t_close
                                      for t, _ in bus.miss)
    detail.update(knobs=rt.current_knobs(),
                  overlap_ratio=bus.gauge_value("serve.overlap_ratio"),
                  replans=bus.counter_value("serve.replans"),
                  proposals=[(e["knob"], e["value"]) for e in
                             bus.events("ctl.propose")][:40])

    # the check, with the runtime's state freed: served rows against the
    # rows of the table drawn again
    got = {i: rows.get((i, stream.served_try[i])) for i in judged}
    window = None
    if r.trace:
        t0, t1 = int(t_open * 1e9), int(t_close * 1e9)
        spans = [(e["name"], e["t0_ns"], e["t1_ns"])
                 for e in tracer.events()]
        window = Window(cell, t0, t1, clip(dtrace.ops, t0, t1),
                        clip(spans, t0, t1), {
                            "batch_tokens": [tk for t, tk in batches
                                             if t_open <= t < t_close],
                            "miss_rates": [m for t, m in bus.miss
                                           if t_open <= t < t_close],
                            "device_kind": torch.cuda.get_device_name(dev)
                            if cuda else "cpu"})
    del rt, table, rows, admit, note
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = make_table(config, r.seed, dev)
    wrong = 0
    for i, g in got.items():
        want = ref[torch.as_tensor(keys_of(i), device=dev)]
        if g is None or not torch.equal(g, want):
            wrong += 1
    detail["reference_s"] = time.perf_counter() - t_ref
    checks = {"rows_wrong": (wrong, r.cell.limits["rows_wrong"]),
              "rows_checked_short": (
                  max(0, r.cell.limits["rows_checked_min"] - len(got)), 0),
              "zero_served": (zero_served, 0)}
    return Outcome(metrics, attempted, failed, checks, peak, window, detail)
