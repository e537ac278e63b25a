"""Structured telemetry bus: counters, gauges, latency reservoirs, events
(DESIGN.md §13).

One `Telemetry` instance is the signal plane of a runtime (the serving
runtime and the training loop each own one; the kernel autotuner publishes
into a process-wide default bus).  Producers publish with one call —

    bus.inc("serve.overflow_batches")
    bus.set("serve.miss_rate", 0.03)
    bus.observe("serve.round_ms", dt * 1e3)
    bus.event("serve.replan", cause="overflow", round=12)

— and consumers (the online controller, benches, tests) read the same
records back by name: `counter_value` / `gauge_value` / `latency(...)
.percentile(99)` / `events("serve.replan")`.  Everything is host-side
numpy; nothing here ever touches JAX or the device, so publishing from
admission-time code costs nanoseconds, not readbacks.

Records are keyed by ``name`` plus optional keyword labels (e.g.
``bus.counter("serve.replans", cause="drift")``); the label-free parent
is NOT implicitly aggregated — publishers that want both a total and a
per-cause split publish both (cheap, explicit, greppable).

`snapshot()` renders the whole bus as one JSON-ready dict (the benches
embed it), and `summary_line()` is the single human-readable line a
runtime prints at shutdown — the replacement for the ad-hoc calibration
prints this bus retired.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# reservoirs keep at most this many samples (uniform reservoir sampling
# past it): percentile queries stay O(maxlen log maxlen) and a long-lived
# runtime cannot grow memory with its uptime
_RESERVOIR_MAXLEN = 4096


def json_safe(obj):
    """Recursively convert ``obj`` into plain JSON types: numpy scalars
    and arrays become Python numbers/lists, non-finite floats become
    None (JSON has no NaN/Inf), dict keys become strings.  The bus
    accepts whatever producers publish (counters bumped with np.int64,
    events carrying array fields), so every export surface —
    `Telemetry.snapshot`, the JSONL sink, attribution records — funnels
    through this to stay strictly `json.dumps`-able."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [json_safe(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, np.floating):
        obj = float(obj)
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    return obj


class Counter:
    """Monotonically increasing count (overflows, replans, requeues)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def add(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins measurement (miss rate, overlap ratio, capacity)."""

    __slots__ = ("value", "updates")

    def __init__(self) -> None:
        self.value: Optional[float] = None
        self.updates = 0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.updates += 1


class Reservoir:
    """Latency/size distribution with p50/p99 queries.

    Keeps every sample up to ``maxlen``, then switches to uniform
    reservoir sampling (Vitter's algorithm R) so the percentile estimate
    stays unbiased over the whole stream without unbounded memory."""

    __slots__ = ("_vals", "_n", "_maxlen", "_rng")

    def __init__(self, maxlen: int = _RESERVOIR_MAXLEN, seed: int = 0):
        self._vals: List[float] = []
        self._n = 0
        self._maxlen = maxlen
        self._rng = np.random.default_rng(seed)

    def record(self, v: float) -> None:
        self._n += 1
        if len(self._vals) < self._maxlen:
            self._vals.append(float(v))
        else:
            j = int(self._rng.integers(0, self._n))
            if j < self._maxlen:
                self._vals[j] = float(v)

    def extend(self, vs) -> None:
        for v in vs:
            self.record(v)

    @property
    def count(self) -> int:
        return self._n

    def values(self) -> List[float]:
        """Copy of the held samples (the serve bench pools these across
        paired runs for its trace-overhead estimator)."""
        return list(self._vals)

    def percentile(self, p: float) -> float:
        # empty-safe by contract: 0.0, never a raise or NaN (callers ask
        # for p50/p99 at shutdown whether or not anything was observed)
        if not self._vals:
            return 0.0
        return float(np.percentile(np.asarray(self._vals), p))

    def mean(self) -> float:
        return float(np.mean(self._vals)) if self._vals else 0.0

    def reset(self) -> None:
        self._vals.clear()
        self._n = 0

    _EMPTY_STATS = {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0}

    def stats(self) -> Dict[str, float]:
        """p50/p99 summary; an untouched reservoir returns the
        well-defined all-zero record (count distinguishes it)."""
        if not self._vals:
            return dict(self._EMPTY_STATS, count=self.count)
        return {"count": self.count, "mean": round(self.mean(), 6),
                "p50": round(self.percentile(50), 6),
                "p99": round(self.percentile(99), 6)}


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    lab = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{lab}}}"


class Telemetry:
    """The signal bus: named counters / gauges / reservoirs + an event
    log, lazily created on first touch."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._reservoirs: Dict[str, Reservoir] = {}
        self._events: List[Tuple[int, str, dict]] = []
        self._seq = 0
        # flat key -> (name, labels): exact label structure for exporters
        # (the flat key is lossy — a label value may itself contain "="
        # or "," — so Prometheus rendering reads this, not the key)
        self._meta: Dict[str, Tuple[str, dict]] = {}

    # ------------------------------------------------------------ handles
    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter()
            self._meta[k] = (name, labels)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge()
            self._meta[k] = (name, labels)
        return g

    def latency(self, name: str, **labels) -> Reservoir:
        k = _key(name, labels)
        r = self._reservoirs.get(k)
        if r is None:
            r = self._reservoirs[k] = Reservoir()
            self._meta[k] = (name, labels)
        return r

    def key_meta(self, flat_key: str) -> Tuple[str, dict]:
        """(name, labels) for a flat snapshot key (exporter surface)."""
        return self._meta.get(flat_key, (flat_key, {}))

    # --------------------------------------------------------- one-liners
    def inc(self, name: str, n: float = 1, **labels) -> None:
        self.counter(name, **labels).add(n)

    def set(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.latency(name, **labels).record(v)

    def event(self, name: str, **fields) -> None:
        self._events.append((self._seq, name, fields))
        self._seq += 1

    # -------------------------------------------------------------- reads
    def counter_value(self, name: str, **labels) -> float:
        c = self._counters.get(_key(name, labels))
        return c.value if c is not None else 0.0

    def gauge_value(self, name: str, default: Optional[float] = None,
                    **labels) -> Optional[float]:
        g = self._gauges.get(_key(name, labels))
        return g.value if g is not None and g.value is not None else default

    def events(self, name: Optional[str] = None) -> List[dict]:
        return [dict(fields, _seq=seq, _name=nm)
                for seq, nm, fields in self._events
                if name is None or nm == name]

    # ----------------------------------------------------------- exports
    def snapshot(self) -> dict:
        """JSON-ready dump of the whole bus (bench/test surface).
        Strictly `json.dumps`-able: event fields and values pass through
        `json_safe` (producers publish numpy scalars freely)."""
        return json_safe({
            "counters": {k: c.value for k, c in sorted(
                self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "latencies": {k: r.stats() for k, r in sorted(
                self._reservoirs.items())},
            "events": self.events(),
        })

    def summary_line(self, prefix: str = "telemetry") -> str:
        """The single human-readable shutdown line: headline counters,
        gauges, and latency p50/p99s, in name order."""
        parts: List[str] = []
        for k, c in sorted(self._counters.items()):
            parts.append(f"{k}={int(c.value)}")
        for k, g in sorted(self._gauges.items()):
            if g.value is not None:
                parts.append(f"{k}={g.value:.4g}")
        for k, r in sorted(self._reservoirs.items()):
            if r.count:
                parts.append(f"{k}[p50={r.percentile(50):.3g},"
                             f"p99={r.percentile(99):.3g}]")
        return f"[{prefix}] " + " ".join(parts)


_DEFAULT: Optional[Telemetry] = None


def default_bus() -> Telemetry:
    """Process-wide bus for publishers without a runtime of their own
    (e.g. the kernel block autotuner, whose cache is process-global)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Telemetry()
    return _DEFAULT
