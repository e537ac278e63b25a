"""Metrics export: Prometheus text format + schema-versioned JSONL sink
(DESIGN.md §14).

Two ways out of the process for the telemetry bus:

* `prometheus_text(bus)` renders counters/gauges as Prometheus
  exposition text and reservoirs as summaries (``{quantile="0.5"}`` /
  ``{quantile="0.99"}`` + ``_count``/``_sum``) — scrape-ready without a
  client library.  Pass the `Telemetry` itself when you can (exact label
  structure via `key_meta`); a bare `snapshot()` dict is accepted with
  best-effort label parsing of the flat keys.

* `JsonlSink` appends schema-versioned JSON lines (``{"schema":
  "repro.obs/v1", "kind": ..., ...}``) with periodic flush — every
  ``flush_every`` records or ``flush_s`` seconds, whichever first — so a
  killed run loses at most one flush window.  `write_bus` dumps a bus as
  one ``snapshot`` record plus one ``event`` record per bus event;
  attribution records go in as ``attribution``.  `repro_torch.obs.report`
  reads these lines back into the shutdown report, and CI fails if a
  schema change breaks that round trip.
"""

from __future__ import annotations

import json
import re
import time
from typing import IO, Optional, Union

from repro_torch.obs.telemetry import Telemetry, json_safe

# the JAX package's format name: exported files are read by either
# package's report
SCHEMA_VERSION = "repro.obs/v1"

_METRIC_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset (dots -> _)."""
    name = _METRIC_OK.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        v = v.replace("\\", "\\\\").replace('"', '\\"').replace("\n",
                                                                "\\n")
        parts.append(f'{_metric_name(str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def _split_flat_key(flat: str):
    """Best-effort (name, labels) from a ``name{k=v,...}`` snapshot key —
    the fallback when only a snapshot dict is available (values
    containing ``,``/``=`` need the live bus's `key_meta`)."""
    if "{" not in flat or not flat.endswith("}"):
        return flat, {}
    name, _, rest = flat.partition("{")
    labels = {}
    for part in rest[:-1].split(","):
        k, eq, v = part.partition("=")
        if eq:
            labels[k] = v
    return name, labels


def prometheus_text(source: Union[Telemetry, dict]) -> str:
    """Render a bus (or its `snapshot()`) as Prometheus text format."""
    if isinstance(source, Telemetry):
        snap = source.snapshot()
        meta = source.key_meta
    else:
        snap = source
        meta = _split_flat_key
    lines = []
    typed = set()

    def emit(kind: str, flat: str, value, suffix: str = "",
             extra_labels: Optional[dict] = None) -> None:
        name, labels = meta(flat)
        family = _metric_name(name)
        metric = family + suffix
        if (family, kind) not in typed:
            # one TYPE line per metric FAMILY, before its first sample —
            # a summary's _count/_sum samples belong to the base family
            # and must not get their own TYPE line
            typed.add((family, kind))
            lines.append(f"# TYPE {family} {kind}")
        if extra_labels:
            labels = dict(labels, **extra_labels)
        if value is None:
            value = float("nan")
        lines.append(f"{metric}{_label_str(labels)} {value}")

    for flat, v in snap.get("counters", {}).items():
        emit("counter", flat, v)
    for flat, v in snap.get("gauges", {}).items():
        emit("gauge", flat, v)
    for flat, st in snap.get("latencies", {}).items():
        emit("summary", flat, st["p50"], extra_labels={"quantile": "0.5"})
        emit("summary", flat, st["p99"], extra_labels={"quantile": "0.99"})
        emit("summary", flat, st["count"], suffix="_count")
        # approximate: the reservoir subsamples, so sum = mean * count
        emit("summary", flat, round(st["mean"] * st["count"], 6),
             suffix="_sum")
    return "\n".join(lines) + "\n"


class JsonlSink:
    """Append-only JSONL with a schema version stamped on every line."""

    def __init__(self, path_or_file: Union[str, IO], *,
                 flush_every: int = 64, flush_s: float = 5.0):
        if isinstance(path_or_file, str):
            self._f = open(path_or_file, "w")
            self._owns = True
        else:
            self._f = path_or_file
            self._owns = False
        self.flush_every = int(flush_every)
        self.flush_s = float(flush_s)
        self.written = 0
        self._since_flush = 0
        self._last_flush = time.perf_counter()

    def write(self, kind: str, record: dict) -> None:
        line = {"schema": SCHEMA_VERSION, "kind": kind, "seq": self.written}
        line.update(json_safe(record))
        self._f.write(json.dumps(line) + "\n")
        self.written += 1
        self._since_flush += 1
        now = time.perf_counter()
        if self._since_flush >= self.flush_every \
                or now - self._last_flush >= self.flush_s:
            self.flush()

    def write_bus(self, bus: Telemetry, *, label: str = "") -> None:
        """One ``snapshot`` record (counters/gauges/latencies) plus one
        ``event`` record per bus event — the report CLI's input shape."""
        snap = bus.snapshot()
        events = snap.pop("events")
        self.write("snapshot", {"label": label, **snap})
        for ev in events:
            self.write("event", {"name": ev.pop("_name"),
                                 "event_seq": ev.pop("_seq"),
                                 "fields": ev})

    def write_attribution(self, records) -> None:
        for rec in records:
            self.write("attribution", rec.to_json())

    def flush(self) -> None:
        self._f.flush()
        self._since_flush = 0
        self._last_flush = time.perf_counter()

    def close(self) -> None:
        self.flush()
        if self._owns:
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str):
    """Parse a sink file back into records (the report CLI's loader);
    raises ValueError on a line that is not valid JSON."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: bad JSONL line: {e}")
    return out
