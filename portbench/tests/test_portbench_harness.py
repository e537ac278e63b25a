"""The harness finds every cell's configuration, traffic, limits and
per-layer readers by name; `BENCHMARK.json` keeps to its contract; the
trace reductions and the readers read a synthetic window."""

import json
import re

import numpy as np
import pytest

from portbench import devtrace, harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_what_its_names_name(name):
    c = harness.find_cell(name, SPEC)
    assert c.chips in (1, 4)
    assert c.config["arch_id"] and c.traffic["kind"] in ("train", "serve")
    assert (harness.HERE / "drivers" / f"{c.traffic['kind']}.py").exists()
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m))
    assert c.limits


def test_benchmark_json_keeps_to_its_contract():
    sp = SPEC
    assert set(sp) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert sp["command"] == ["python3", "portbench/run.py"]
    assert 1 <= sp["run_seconds"] <= 51
    assert len(json.dumps(sp)) < 64 * 1024
    used = {w["config"] for w in sp["workloads"]}
    assert used == {c["name"] for c in sp["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in sp["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in sp["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg["published"]
            assert not re.search(r"dim|rank|d_model|d_ff|heads|state",
                                 k), k
    metrics = sp["end_to_end"] + sp["per_layer"]
    names = [x["name"] for x in metrics + sp["workloads"] + sp["configs"]]
    assert len(names) == len(set(names))
    for x in metrics:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
    for m in sp["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in sp["end_to_end"]}
    for m in sp["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            cell = next(x for x in sp["end_to_end"] if x["name"] == m["moves"])
            assert w in cell.get("workloads", [w]), (m["name"], w)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in sp["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    four = sum(w["chips"] == 4 for w in sp["workloads"])
    assert four <= max(1, len(sp["workloads"]) // 4)


def test_intervals_union_busy_and_gaps():
    ops = [("k1", 0, 10), ("k2", 5, 20), ("k1", 30, 40)]
    assert devtrace.union([(s, e) for _, s, e in ops]) == [(0, 20),
                                                           (30, 40)]
    assert devtrace.busy_ns(ops) == 30
    assert devtrace.clip(ops, 8, 35) == [("k1", 8, 10), ("k2", 8, 20),
                                         ("k1", 30, 35)]
    assert devtrace.top_ops(ops) == [["k1", 20e-9], ["k2", 15e-9]]
    spans = [("outer", 0, 100), ("inner", 22, 28), ("later", 41, 60)]
    gaps = devtrace.idle_gaps(ops, spans, 0, 50)
    # 20..30 lies in "inner" at its middle 25; 40..50 in "later"
    assert gaps == [["inner", 10e-9], ["later", 10e-9]]


def window(cell, **values):
    ops = [("void gather_kernel<float4>(...)", 0, 2_000_000),
           ("void adagrad_vec4_kernel<float>(...)", 2_000_000, 3_000_000),
           ("sgemm", 3_000_000, 8_000_000)]
    spans = [("train.plan", 0, 1_000_000), ("train.signal", 0, 500_000),
             ("serve.round", 0, 4_000_000), ("serve.round", 5_000_000,
                                             7_000_000)]
    return harness.Window(cell, 0, 10_000_000, ops, spans,
                          dict(device_kind="NVIDIA H100 80GB HBM3",
                               **values))


def test_readers_read_a_synthetic_window():
    c = harness.find_cell("nemotron-train-zipf", SPEC)
    tok = [np.arange(4096).reshape(2, 2048) % 1000]
    w = window(c, steps=1, step_tokens=tok, model_flops=6.7e11)
    assert harness.reader("train_pm_host_ms")(w) == pytest.approx(1.5)
    assert harness.reader("train_device_idle")(w) == pytest.approx(20.0)
    assert harness.reader("train_mfu")(w) == pytest.approx(
        100 * 6.7e11 / 0.01 / 67e12)
    want = (1000 + 4096) * 6144 * 4 + 5 * 1000 * 6144 * 4
    assert harness.reader("train_lookup_roofline")(w) == pytest.approx(
        100 * want / 3.35e12 / 3e-3)
    s = harness.find_cell("nemotron-serve-zipf", SPEC)
    ws = window(s, batch_tokens=tok, miss_rates=[0.1, 0.3])
    assert harness.reader("serve_round_host_ms.tail")(ws) == \
        pytest.approx(3.0)
    assert harness.reader("serve_miss_rate.tail")(ws) == pytest.approx(20)
    assert harness.reader("serve_lookup_roofline.tail")(ws) == \
        pytest.approx(100 * (1000 + 4096) * 6144 * 4 / 3.35e12 / 2e-3)
    # an empty window has nothing to read: no value, never a zero
    empty = harness.Window(c, 0, 10, [], [], {})
    for name in c.per_layer + s.per_layer:
        assert harness.reader(name)(empty) is None, name
