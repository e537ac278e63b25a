"""Observability report: trace/metrics files -> the shutdown report
(DESIGN.md §14).

``python -m repro_torch.obs.report trace.json metrics.jsonl`` renders, from a
Chrome trace-event file (`obs.trace.SpanTracer.dump`) and/or a JSONL
metrics sink (`obs.export.JsonlSink`), the same report a traced serve or
train run prints at shutdown:

  * per-request latency — p50/p99/mean over ``serve.request`` spans,
    plus a per-phase breakdown (where a round's time went);
  * miss attribution — per replan tenure: predicted vs realized miss
    rate, the top hot keys behind the uncovered misses, per-owner-shard
    miss counts;
  * knob timeline — every controller/capacity decision in order, with
    the triggering signal.

Loading *validates*: a trace event missing a Chrome trace-event required
field (name/ph/ts/pid/tid, dur for "X") or an unparseable JSONL line
raises — CI runs this CLI on the serve bench's artifacts so a schema
break fails the build instead of a future reader.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.export import read_jsonl

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_chrome(doc: dict) -> List[dict]:
    """Check trace-event JSON against the format's required fields;
    returns the event list."""
    if "traceEvents" not in doc:
        raise ValueError("not a Chrome trace: no 'traceEvents' key")
    events = doc["traceEvents"]
    for i, ev in enumerate(events):
        for field in _REQUIRED:
            if field not in ev:
                raise ValueError(
                    f"traceEvents[{i}] missing required field "
                    f"{field!r}: {ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(
                f"traceEvents[{i}] is a complete event without 'dur'")
    return events


def load_trace(path: str) -> List[dict]:
    with open(path) as f:
        return validate_chrome(json.load(f))


def _pct(vals, p):
    return float(np.percentile(np.asarray(vals), p))


def _request_section(events: List[dict]) -> List[str]:
    spans: Dict[str, List[float]] = {}
    for ev in events:
        if ev["ph"] != "X":
            continue
        spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)  # -> ms
    out = []
    req = spans.pop("serve.request", None)
    if req:
        out.append(f"  requests traced: {len(req)}  "
                   f"p50 {_pct(req, 50):.3f} ms  "
                   f"p99 {_pct(req, 99):.3f} ms  "
                   f"mean {float(np.mean(req)):.3f} ms")
    requeues = sum(1 for ev in events if ev["name"] == "serve.requeue")
    if requeues:
        out.append(f"  requeues traced: {requeues}")
    if spans:
        out.append("  phase breakdown (ms, p50/p99 over spans):")
        for name in sorted(spans):
            vs = spans[name]
            out.append(f"    {name:<18} n={len(vs):<6} "
                       f"p50 {_pct(vs, 50):8.3f}  p99 {_pct(vs, 99):8.3f}")
    return out


def _attribution_section(records: List[dict]) -> List[str]:
    attrs = [r for r in records if r.get("kind") == "attribution"]
    if not attrs:
        return []
    out = ["  round  plan  cause     predicted  realized   misses  "
           "top keys (key:count)"]
    errors = []
    for r in attrs:
        realized = r.get("realized_miss_rate")
        if realized is not None and r.get("batches"):
            errors.append(abs(realized - r["predicted_miss_rate"]))
        top = " ".join(f"{k}:{c}" for k, c in r.get("top_keys", [])[:4])
        out.append(
            f"  {r['round']:>5}  {r['plan_version']:>4}  "
            f"{r['cause']:<8}  {r['predicted_miss_rate']:>9.4f}  "
            f"{('%8.4f' % realized) if realized is not None else '     n/a'}"
            f"  {r['misses']:>7}  {top}")
        owners = r.get("per_owner_misses") or {}
        if owners:
            owned = " ".join(f"shard{k}:{v}" for k, v in
                             sorted(owners.items(), key=lambda kv:
                                    int(kv[0])))
            out.append(f"         per-owner misses: {owned}")
        ph, ps = r.get("prefetch_hits", 0), r.get("prefetch_stale", 0)
        if ph or ps:
            total = ph + ps
            out.append(f"         prefetch: {ph}/{total} miss slots "
                       f"staged ({ps} residual)")
    if errors:
        out.append(f"  plan-vs-actual |error|: mean "
                   f"{float(np.mean(errors)):.4f}  max "
                   f"{float(np.max(errors)):.4f} over {len(errors)} "
                   f"measured tenures")
    return out


def _knob_section(records: List[dict]) -> List[str]:
    out = []
    for r in records:
        if r.get("kind") == "event":
            name = r.get("name", "")
            if not (name.startswith("ctl.")
                    or name.endswith("capacity_resize")):
                continue
            f = r.get("fields", {})
            detail = " ".join(f"{k}={v}" for k, v in sorted(f.items()))
            out.append(f"  [{r.get('event_seq', '?'):>4}] {name:<22} "
                       f"{detail}")
        elif r.get("kind") == "attribution":
            for d in r.get("decisions", []):
                detail = " ".join(f"{k}={v}" for k, v in sorted(d.items())
                                  if not k.startswith("_"))
                out.append(f"  [{d.get('_seq', '?'):>4}] "
                           f"{d.get('_name', '?'):<22} {detail}")
    # attribution decisions duplicate bus events when both files are
    # given; dedup on the event sequence tag, keeping order
    seen = set()
    uniq = []
    for line in out:
        tag = line.split("]")[0]
        if tag in seen:
            continue
        seen.add(tag)
        uniq.append(line)
    return uniq


def _counter_section(records: List[dict]) -> List[str]:
    snaps = [r for r in records if r.get("kind") == "snapshot"]
    if not snaps:
        return []
    snap = snaps[-1]
    out = []
    counters = snap.get("counters", {})
    if counters:
        out.append("  " + "  ".join(f"{k}={int(v)}" for k, v in
                                    sorted(counters.items())))
    for key, st in sorted(snap.get("latencies", {}).items()):
        if st.get("count"):
            out.append(f"  {key}: n={st['count']} p50={st['p50']:.3f} "
                       f"p99={st['p99']:.3f}")
    return out


def render_report(trace_events: Optional[List[dict]] = None,
                  records: Optional[List[dict]] = None,
                  title: str = "observability report") -> str:
    """The shutdown report: whatever sections the inputs support."""
    lines = [f"=== {title} ==="]
    sections = []
    if trace_events:
        sections.append(("request latency (trace)",
                         _request_section(trace_events)))
    if records:
        sections.append(("miss attribution (plan vs actual)",
                         _attribution_section(records)))
        sections.append(("knob timeline", _knob_section(records)))
        sections.append(("final counters", _counter_section(records)))
    wrote = False
    for header, body in sections:
        if not body:
            continue
        lines.append(f"-- {header}")
        lines.extend(body)
        wrote = True
    if not wrote:
        lines.append("(no spans or records to report)")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or any(a in ("-h", "--help") for a in argv):
        print(__doc__)
        return 0 if argv else 2
    trace_events: List[dict] = []
    records: List[dict] = []
    for path in argv:
        if path.endswith(".jsonl"):
            records.extend(read_jsonl(path))
        else:
            trace_events.extend(load_trace(path))
    print(render_report(trace_events or None, records or None,
                        title="observability report: " + " ".join(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
