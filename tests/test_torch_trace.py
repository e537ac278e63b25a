"""The port's span tracer inside the training step and the serving round:
the train step's device marks (`obs.trace.SpanTracer.mark_device`,
`train.loop._PhaseMarks`), the serving runtime's child spans, and what
an enabled tracer may not change.  CPU tests, apart from the one
``cuda`` case, which checks the CUDA-event marks on the card and skips
without one.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.trace import MARK_TID, SpanTracer
from repro_torch.serve import (DriftingZipfStream, ReplayStream, ServeConfig,
                               ServingRuntime)
from repro_torch.train import loop as loop_mod
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import PHASE_LISTENERS, enter_phase

PARTS = ("forward", "backward", "update", "update/adagrad", "update/rows",
         "end")
V, D = 2048, 8
ROUNDS = 30


def train(tracer, steps: int = 3):
    """A few steps of the small untied nemotron-4-15b (the fused arm: the
    row AdaGrad runs as its own part) on the CPU."""
    cfg = get_config("nemotron-4-15b", smoke=True)
    assert not cfg.tie_embeddings
    return train_loop(cfg, LoopConfig(steps=steps, batch=2, seq=16,
                                      kernel=True, log_every=0),
                      tracer=tracer, device="cpu")


def marks_by_step(tracer):
    by = {}
    for e in tracer.events():
        if e["name"].startswith("train.mark."):
            assert e["t0_ns"] == e["t1_ns"] and e["tid"] == MARK_TID
            by.setdefault(e["a"], []).append(
                (e["name"][len("train.mark."):], e["t0_ns"]))
    return by


def test_each_step_marks_its_parts_in_order():
    tr = SpanTracer()
    before = list(PHASE_LISTENERS)
    train(tr)
    assert PHASE_LISTENERS == before
    by = marks_by_step(tr)
    assert sorted(by) == [0, 1, 2]
    steps = {e["a"]: e for e in tr.events() if e["name"] == "train.step"}
    for step, marks in by.items():
        assert [p for p, _ in marks] == list(PARTS)
        times = [t for _, t in marks]
        assert times == sorted(times)
        # the marks lie inside the step's own host span on the CPU
        assert steps[step]["t0_ns"] <= times[0]
        assert times[-1] <= steps[step]["t1_ns"]
    # the export sorts by start and keeps the marks on their own lane
    ev = tr.events()
    assert [e["t0_ns"] for e in ev] == sorted(e["t0_ns"] for e in ev)
    doc = tr.to_chrome()
    lanes = {e["tid"] for e in doc["traceEvents"]
             if e["name"].startswith("train.mark.")}
    assert lanes == {MARK_TID}
    assert doc["otherData"]["clock"] == "perf_counter_ns"
    wall = doc["otherData"]["epoch_ns"] + doc["otherData"]["wall_offset_ns"]
    assert abs(wall - time.time_ns()) < 600e9


def test_listeners_are_restored_when_the_loop_raises(monkeypatch):
    seen = []
    PHASE_LISTENERS.append(seen.append)
    make = loop_mod.make_train_step

    def failing(*args, **kwargs):
        make(*args, **kwargs)

        def step(model, opt_state, batch):
            enter_phase("forward")
            raise RuntimeError("the step failed")
        return step

    monkeypatch.setattr(loop_mod, "make_train_step", failing)
    tr = SpanTracer()
    try:
        with pytest.raises(RuntimeError, match="the step failed"):
            train(tr)
        assert PHASE_LISTENERS == [seen.append]
    finally:
        PHASE_LISTENERS.remove(seen.append)
    assert seen == ["forward"]
    # the failed step marked its start, and no end
    assert [p for p, _ in marks_by_step(tr)[0]] == ["forward"]


def test_a_disabled_tracer_records_and_registers_nothing():
    counts = []

    def listen(part):
        counts.append(len(PHASE_LISTENERS))

    PHASE_LISTENERS.append(listen)
    tr = SpanTracer(enabled=False)
    try:
        res = train(tr)
    finally:
        PHASE_LISTENERS.remove(listen)
    assert len(res.losses) == 3
    assert counts and set(counts) == {1}
    assert tr.count == 0 and tr.events() == [] and not tr._pending


def test_a_cpu_mark_is_the_host_time_at_once():
    tr = SpanTracer()
    t0 = time.perf_counter_ns()
    tr.mark_device("m", a=7, device=torch.device("cpu"))
    t1 = time.perf_counter_ns()
    tr.resolve_device(anchor=True)
    (e,) = tr.events()
    assert e["name"] == "m" and e["a"] == 7 and e["tid"] == MARK_TID
    assert t0 <= e["t0_ns"] == e["t1_ns"] <= t1


def serve_config(**kw):
    args = dict(vocab=V, batch_requests=16, keys_per_request=8,
                cache_capacity=256, replan_every=6, refresh_every=0,
                pipeline_depth=2, n_shards=4, summary=False)
    args.update(kw)
    return ServeConfig(**args)


def serve(tracer=None, **kw):
    table = np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)
    stream = ReplayStream.record(DriftingZipfStream(
        V, 8, zipf_a=1.2, arrival_rate=16, scenario="rotate",
        rotate_every=10, seed=5), 50)
    rt = ServingRuntime(table, serve_config(**kw), tracer=tracer,
                        device="cpu")
    return rt, rt.run(stream, ROUNDS, collect_outputs=True)


def inside(child, parent) -> bool:
    return parent["t0_ns"] <= child["t0_ns"] <= child["t1_ns"] \
        <= parent["t1_ns"]


def test_serving_spans_nest_in_their_parents():
    tr = SpanTracer()
    rt, res = serve(tr)
    assert res.served > 0 and res.replans > 1
    ev = tr.events()
    by = {}
    for e in ev:
        by.setdefault(e["name"], []).append(e)
    for name in ("serve.plan.ctl", "serve.plan.snapshot", "serve.plan.solve",
                 "serve.plan.refresh", "serve.admit", "serve.split",
                 "serve.book", "serve.pipe", "serve.note", "serve.expire"):
        assert by.get(name), name
    for name in ("serve.plan.ctl", "serve.plan.snapshot", "serve.plan.solve",
                 "serve.plan.refresh", "prefetch.stage"):
        for e in by[name]:
            assert any(inside(e, p) for p in by["serve.plan"]), name
    for rnd in by["serve.round"]:
        for name in ("serve.admit", "serve.split", "serve.book",
                     "serve.probe", "serve.dispatch", "serve.pipe"):
            assert sum(inside(e, rnd) for e in by[name]) == 1, name
    # a round's pipeline finishes a batch once it holds its two; the
    # drains outside rounds (measurement start, idle rounds, the end)
    # lie outside every round
    for name in ("serve.served", "serve.note", "serve.expire"):
        within = 0
        for e in by[name]:
            hit = any(inside(e, p) for p in by["serve.pipe"])
            within += hit
            if not hit:
                assert all(e["t1_ns"] <= r["t0_ns"]
                           or e["t0_ns"] >= r["t1_ns"]
                           for r in by["serve.round"]), name
        assert within >= len(by["serve.round"]) - 2, name


def test_tracing_serves_the_same_rows():
    _, want = serve()
    _, got = serve(SpanTracer())
    _, got_cfg = serve(trace=True)
    for res in (got, got_cfg):
        for f in ("served", "rounds", "requeues", "replans", "replan_rounds",
                  "plan_miss_capacities", "miss_trace", "zero_served",
                  "overflow_batches", "refreshes"):
            assert getattr(res, f) == getattr(want, f), f
        assert set(res.outputs) == set(want.outputs)
        for rid, rows in want.outputs.items():
            np.testing.assert_array_equal(res.outputs[rid].view(np.uint32),
                                          rows.view(np.uint32))


def test_attribution_follows_the_config_not_the_tracer():
    rt, _ = serve(SpanTracer())
    assert rt.tracer.enabled and rt.attribution is None
    rt, _ = serve(trace=True)
    assert rt.attribution is not None and rt.attribution.records


def test_served_requests_publish_no_per_request_records():
    tr = SpanTracer()
    rt, res = serve(tr)
    bus = rt.telemetry
    snap = bus.snapshot()
    names = {bus.key_meta(k)[0] for part in ("counters", "gauges",
                                             "latencies")
             for k in snap[part]}
    for gone in ("serve.requests", "serve.latency", "serve.round_ms"):
        assert gone not in names, gone
    assert rt.scheduler.n_served == res.served
    assert len(rt.scheduler.latency) == res.served
    assert 0 < res.p50_ms <= res.p99_ms


def test_the_loop_keeps_its_step_latency():
    """``train.step_ms`` stays: `chip_smoke.train_profile` reads it."""
    bus = Telemetry()
    cfg = get_config("nemotron-4-15b", smoke=True)
    train_loop(cfg, LoopConfig(steps=2, batch=2, seq=16, log_every=0),
               telemetry=bus, device="cpu")
    assert bus.latency("train.step_ms").count == 2


@pytest.mark.cuda
def test_device_marks_follow_the_stream_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the marks are CUDA events there")
    dev = torch.device("cuda")
    tr = SpanTracer()
    x = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize(dev)
    t_before = time.perf_counter_ns()
    tr.mark_device("m", a=0, device=dev)      # takes the first anchor
    for i in range(1, 4):
        for _ in range(20):
            x = x @ x
            x = x / x.norm()
        tr.mark_device("m", a=i, device=dev)
    tr.resolve_device()
    torch.cuda.synchronize(dev)
    t_after = time.perf_counter_ns()
    tr.resolve_device(anchor=True)
    ev = [e for e in tr.events() if e["name"] == "m"]
    assert [e["a"] for e in ev] == [0, 1, 2, 3]
    ts = [e["t0_ns"] for e in ev]
    assert ts == sorted(ts) and len(set(ts)) == 4
    # on the host's clock: after the first call, before the last sync
    # returned (the anchor's host time is read just after the device
    # passed it: 50 us of room, the budget of a mark against the trace)
    assert t_before - 50_000 <= ts[0] and ts[-1] <= t_after + 50_000
    assert not tr._pending
    # a new anchor places a later mark after the host's time of marking
    torch.cuda.synchronize(dev)
    t_mark = time.perf_counter_ns()
    tr.mark_device("late", device=dev)
    tr.resolve_device(anchor=True)
    (late,) = [e for e in tr.events() if e["name"] == "late"]
    assert late["t0_ns"] >= t_mark - 50_000
    assert late["t0_ns"] <= time.perf_counter_ns()
