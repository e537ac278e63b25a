"""The whole serving slice: `repro.serve.runtime.ServingRuntime` (JAX on
the CPU, ``kernel=False``) against the port's (``device="cpu"``) on the
same replayed request stream (V = 2048, D = 8, as tests/test_serve.py
builds it).  Every knob is pinned: automatic knobs hill-climb on wall
clock time and would let the two runtimes drift apart.  Everything the
runs report — served and requeued counts, replans, the miss trace, the
planned miss capacities and every served row — must agree exactly."""

import numpy as np
import pytest
import torch

import repro.serve as J
import repro_torch.serve as P
from repro_torch.kernels import ops

V, D = 2048, 8
ROUNDS = 30
CASES = {  # name: (ServeConfig overrides, stream overrides)
    **{f"depth{d}-shards{s}": (dict(pipeline_depth=d, n_shards=s), {})
       for d in (0, 1, 2) for s in (1, 4)},
    # a cache far below the hot set: staging, top-ups and V-padded
    # residual buckets on every tenure
    "staging-constrained": (dict(cache_capacity=64, pipeline_depth=2,
                                 n_shards=4), {}),
    "flash": (dict(pipeline_depth=1, n_shards=4),
              dict(scenario="flash", flash_every=8, flash_len=4)),
    # the one automatic knob steered by intent alone (never by the clock):
    # mid-run replica-cache resizes
    "auto-capacity": (dict(cache_capacity="auto", pipeline_depth=1,
                           n_shards=4), {}),
}


def table() -> np.ndarray:
    return np.random.default_rng(0).normal(size=(V, D)).astype(np.float32)


def replay(mod, **kw):
    args = dict(zipf_a=1.2, arrival_rate=16, scenario="rotate",
                rotate_every=10, seed=5)
    args.update(kw)
    return mod.ReplayStream.record(mod.DriftingZipfStream(V, 8, **args), 50)


def config(mod, **kw):
    args = dict(vocab=V, batch_requests=16, keys_per_request=8,
                cache_capacity=256, replan_every=6, refresh_every=0,
                pipeline_depth=1, summary=False)
    args.update(kw)
    return mod.ServeConfig(**args)


def run_pair(cfg_kw, stream_kw, **port_kw):
    want = J.ServingRuntime(table(), config(J, kernel=False, **cfg_kw)).run(
        replay(J, **stream_kw), ROUNDS, collect_outputs=True)
    rt = P.ServingRuntime(table(), config(P, **cfg_kw, **port_kw),
                          device="cpu")
    got = rt.run(replay(P, **stream_kw), ROUNDS, collect_outputs=True)
    return want, got, rt


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_matches_jax(name):
    want, got, rt = run_pair(*CASES[name])
    assert want.served > 0 and want.zero_served == 0
    for f in ("served", "rounds", "requeues", "replans", "replan_rounds",
              "plan_miss_capacities", "miss_trace", "zero_served",
              "overflow_batches", "refreshes", "capacity_resizes",
              "capacity_trace"):
        assert getattr(got, f) == getattr(want, f), f
    assert set(got.outputs) == set(want.outputs)
    for rid, rows in want.outputs.items():
        assert got.outputs[rid].dtype == rows.dtype
        np.testing.assert_array_equal(got.outputs[rid].view(np.uint32),
                                      rows.view(np.uint32))
    if name == "staging-constrained":
        assert rt.telemetry.counter_value("serve.prefetch_hits") > 0
        assert rt.telemetry.counter_value("serve.prefetch_stale") > 0
    if name == "auto-capacity":
        assert got.capacity_resizes > 0


@pytest.mark.parametrize("name", ["auto-capacity", "staging-constrained"])
def test_runtime_keeps_one_probe_view(name):
    """The runtime builds its probe view at the first cache generation
    and advances that one object on every later replan, writing the
    rows that moved (`serve.probe_rows`), so that after the run its
    table is the one a fresh view of the last generation builds."""
    cfg_kw, stream_kw = CASES[name]
    rt = P.ServingRuntime(table(), config(P, **cfg_kw), device="cpu")
    views, replan = [], rt._replan

    def noted(*args, **kwargs):
        replan(*args, **kwargs)
        views.append(rt._probe_view)

    rt._replan = noted
    res = rt.run(replay(P, **stream_kw), ROUNDS)
    assert res.refreshes > 1 and len(views) == res.replans
    assert all(v is views[0] for v in views)
    rows = rt.telemetry.counter_value("serve.probe_rows")
    assert 0 < rows < res.refreshes * V
    fresh = P.runtime.CacheProbeView(rt._cache_ids_np, V)
    np.testing.assert_array_equal(views[0]._slot_of, fresh._slot_of)
    if name == "auto-capacity":
        assert res.capacity_resizes > 0


def test_traced_attribution_matches_jax():
    """With span tracing on, the plan-vs-actual attribution records (one
    per replan boundary) agree, and the shutdown report renders."""
    kw = dict(pipeline_depth=2, n_shards=4, cache_capacity=64, trace=True)
    jrt = J.ServingRuntime(table(), config(J, kernel=False, **kw))
    jrt.run(replay(J), ROUNDS)
    prt = P.ServingRuntime(table(), config(P, **kw), device="cpu")
    prt.run(replay(P), ROUNDS)
    want = [r.to_json() for r in jrt.attribution.records]
    got = [r.to_json() for r in prt.attribution.records]
    for r in want:
        # the reference still reports the depth's old one-slot alias
        assert r["knobs"].pop("double_buffer") == \
            (r["knobs"]["pipeline_depth"] >= 1)
    assert len(got) == len(want) > 0
    assert got == want
    for c in ("serve.replans", "serve.refreshes", "serve.refresh_skipped",
              "serve.prefetch_hits", "serve.prefetch_stale",
              "serve.stage_topups", "serve.stage_topup_rows",
              "serve.requeues", "serve.overflow_batches"):
        assert prt.telemetry.counter_value(c) == \
            jrt.telemetry.counter_value(c), c
    assert "serve shutdown report" in prt.report()


def watched_run(**kw):
    """A run whose lookups go through a patch of the module's name, as
    the benchmark's check of served rows patches it; each call is noted
    as "warm" before the stream's first arrivals and "batch" after."""
    from repro_torch.serve import runtime as rt_mod
    calls, lookup = [], rt_mod.planned_serve_lookup
    stream = replay(P)
    arrivals = stream.arrivals

    def asked(r):
        calls.append("arrivals")
        return arrivals(r)

    def watched(*args, **kwargs):
        calls.append("batch" if "arrivals" in calls else "warm")
        return lookup(*args, **kwargs)

    stream.arrivals = asked
    rt = P.ServingRuntime(table(), config(P, cache_capacity=64, n_shards=4,
                                          **kw), device="cpu")
    rt_mod.planned_serve_lookup = watched
    try:
        res = rt.run(stream, ROUNDS)
    finally:
        rt_mod.planned_serve_lookup = lookup
    return rt, res, [c for c in calls if c != "arrivals"]


@pytest.mark.parametrize("depth", [0, "auto"])
def test_every_batch_goes_through_the_module_lookup(depth):
    """Every managed batch, staged (depth >= 1) or not (depth 0), goes
    through the module-level `planned_serve_lookup`, after exactly one
    warm-up call made before the stream's first arrivals.  With
    ``pipeline_depth="auto"`` the depth has one owner: the controller's
    one knob, which nothing forces."""
    rt, res, calls = watched_run(pipeline_depth=depth)
    assert calls[0] == "warm" and calls.count("warm") == 1
    assert calls.count("batch") == len(res.miss_trace) > 0
    staged = rt.telemetry.counter_value("serve.prefetch_hits")
    if depth == 0:
        assert staged == 0 and rt._ctl is None
        return
    assert staged > 0
    assert list(rt._ctl.knobs) == ["pipeline_depth"]
    assert rt.pipeline_depth == rt._ctl.value("pipeline_depth")
    assert not rt.telemetry.events("ctl.force")
    assert set(rt.current_knobs()) == {"cache_capacity", "replan_every",
                                       "refresh_every", "batch_requests",
                                       "pipeline_depth"}


def test_plain_versions_match_jax_too():
    """``kernel=False`` (the plain versions on every device) serves the
    same rows as the kernel path's CPU fallback."""
    want, got, _ = run_pair(*CASES["staging-constrained"], kernel=False)
    assert got.served == want.served
    for rid, rows in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], rows)


def test_unmanaged_baseline_matches_jax():
    want, got, _ = run_pair(dict(managed=False, n_shards=4), {})
    assert got.served == want.served > 0
    for rid, rows in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], rows)


@pytest.mark.parametrize("scenario", ["rotate", "burst", "flash"])
def test_stream_matches_jax(scenario):
    """A seed draws the same requests in both packages."""
    a, b = replay(J, scenario=scenario), replay(P, scenario=scenario)
    assert a.rotation_rounds == b.rotation_rounds
    for wa, wb in zip(a.per_round, b.per_round):
        assert [r.rid for r in wa] == [r.rid for r in wb]
        for ra, rb in zip(wa, wb):
            np.testing.assert_array_equal(ra.keys, rb.keys)


def test_cpu_run_launches_no_kernels():
    ops.reset_launch_counts()
    run_pair(*CASES["depth1-shards1"])
    assert ops.launch_counts() == {"embed_gather": 0, "pm_combine": 0,
                                   "adagrad_rows": 0, "scatter_rows": 0,
                                   "segment_scatter_rows": 0,
                                   "selective_scan": 0,
                                   "selective_scan_backward": 0}


def test_default_device_is_the_card():
    """Left to its default, the runtime runs on CUDA — and raises where
    there is none rather than falling back to the CPU."""
    if torch.cuda.is_available():
        rt = P.ServingRuntime(table(), config(P))
        assert rt.table.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.ServingRuntime(table(), config(P))


def test_mesh_backend_not_ported():
    """The mesh backend is ported now; without a started process group it
    raises instead of falling back to the emulated backend (the mesh
    itself is tested in test_torch_mesh.py)."""
    with pytest.raises(RuntimeError, match="process group"):
        P.ServingRuntime(table(), config(P, collective="mesh"),
                         device="cpu")
