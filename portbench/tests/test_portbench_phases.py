"""The readers of the train step's device marks and the serving runtime's
child spans (`portbench.phases`) on synthetic windows: whole steps read,
steps cut by the window's edges or missing a mark left out, child spans
over the count of rounds."""

import pytest

from portbench import harness, phases

SPEC = harness.spec()
MS = 1_000_000
TRAIN = ("train_forward_device_ms", "train_backward_device_ms",
         "train_update_device_ms")


def step(t0, fwd, bwd, upd, parts=("forward", "backward", "update",
                                   "update/adagrad", "update/rows", "end")):
    """A step's marks from ``t0``: forward, then ``fwd`` ms to backward,
    ``bwd`` ms to update, ``upd`` ms to the end (the update's two parts
    in between)."""
    at = {"forward": t0, "backward": t0 + fwd * MS,
          "update": t0 + (fwd + bwd) * MS,
          "update/adagrad": t0 + (fwd + bwd) * MS + 1,
          "update/rows": t0 + (fwd + bwd + upd / 2) * MS,
          "end": t0 + (fwd + bwd + upd) * MS}
    return [("train.mark." + p, at[p], at[p]) for p in parts]


def train_window(spans):
    c = harness.find_cell("falcon-mamba-train-zipf", SPEC)
    return harness.Window(c, 0, 100 * MS, [], spans, {"steps": 3})


def test_training_readers_read_whole_steps_only():
    spans = (
        # cut by the window's opening: its forward lies before it
        step(-5 * MS, 2, 6, 1, parts=("backward", "update",
                                      "update/adagrad", "update/rows",
                                      "end"))
        + step(10 * MS, 2, 6, 1) + step(20 * MS, 4, 8, 3)
        # missing its backward mark: left out
        + step(40 * MS, 1, 1, 1, parts=("forward", "update", "end"))
        # cut by the window's closing: no end mark
        + step(90 * MS, 2, 6, 1, parts=("forward", "backward"))
        + [("train.step", 10 * MS, 11 * MS), ("train.signal", 0, MS)])
    w = train_window(sorted(spans, key=lambda s: (s[1], s[0])))
    assert len(phases.steps(w)) == 2
    want = {"train_forward_device_ms": 3.0,
            "train_backward_device_ms": 7.0,
            "train_update_device_ms": 2.0}
    for name in TRAIN:
        assert harness.reader(name)(w) == pytest.approx(want[name]), name


def test_training_readers_group_marks_by_time_not_by_order():
    spans = step(10 * MS, 2, 6, 1) + step(30 * MS, 2, 6, 1)
    w = train_window(list(reversed(spans)))
    assert harness.reader("train_backward_device_ms")(w) == \
        pytest.approx(6.0)


@pytest.mark.parametrize("name", TRAIN)
def test_training_readers_find_nothing_without_marks(name):
    # a program without the marks (as before them) and a window holding
    # only a cut step both read nothing
    assert harness.reader(name)(train_window([
        ("train.step", 0, 5 * MS), ("train.signal", 0, MS)])) is None
    assert harness.reader(name)(train_window(
        step(90 * MS, 2, 6, 1, parts=("forward", "backward")))) is None


def test_mark_overlap_reads_how_deep_a_mark_lies_inside_an_operation():
    w = train_window(step(10 * MS, 2, 6, 1, parts=("forward", "backward",
                                                    "update", "end")))
    assert phases.mark_overlap_ns(w) is None           # no operations
    # operations between the marks: none holds one
    w.ops = [("fwd", 10 * MS, 12 * MS), ("bwd", 12 * MS, 18 * MS),
             ("upd", 18 * MS, 19 * MS)]
    assert phases.mark_overlap_ns(w) == 0
    # a clock 30 us late puts the backward mark 30 us into "bwd"
    w.ops = [(n, s - 30_000, e - 30_000) for n, s, e in w.ops]
    assert phases.mark_overlap_ns(w) == 30_000
    w.spans = [("train.step", 0, MS)]
    assert phases.mark_overlap_ns(w) is None           # no marks


def serve_window(cell, spans):
    c = harness.find_cell(cell, SPEC)
    return harness.Window(c, 0, 100 * MS, [], spans, {})


SERVE = [
    ("serve.round", 0, 10 * MS),
    ("serve.plan", 0, 6 * MS),
    ("serve.plan.ctl", 0, MS // 2),
    ("serve.plan.snapshot", MS, 2 * MS),
    ("serve.plan.solve", 2 * MS, 4 * MS),
    ("serve.plan.solve", 4 * MS, 5 * MS),       # the steered re-plan
    ("serve.plan.refresh", 5 * MS, 6 * MS),
    ("serve.admit", 6 * MS, 7 * MS),
    ("serve.expire", 9 * MS, 10 * MS),
    ("serve.round", 20 * MS, 30 * MS),
    ("serve.expire", 28 * MS, 29 * MS),
    # a replan in an idle round, outside every round's envelope
    ("serve.plan", 40 * MS, 42 * MS),
    ("serve.plan.snapshot", 40 * MS, 41 * MS),
    ("serve.round", 50 * MS, 60 * MS),
    ("serve.round", 70 * MS, 80 * MS),
]


@pytest.mark.parametrize("cell,suffix", [("nemotron-serve-zipf", "tail"),
                                         ("nemotron-serve-uniform", "sat")])
def test_serving_readers_count_child_spans_per_round(cell, suffix):
    w = serve_window(cell, SERVE)
    # snapshot 1 + 1 ms, solve 2 + 1 ms, over 4 rounds
    assert harness.reader(f"serve_planner_host_ms.{suffix}")(w) == \
        pytest.approx(5.0 / 4)
    assert harness.reader(f"serve_expire_host_ms.{suffix}")(w) == \
        pytest.approx(2.0 / 4)
    # the same base as the round's own metric
    assert harness.reader(f"serve_round_host_ms.{suffix}")(w) == \
        pytest.approx(10.0)


@pytest.mark.parametrize("cell,suffix", [("nemotron-serve-zipf", "tail"),
                                         ("nemotron-serve-uniform", "sat")])
def test_serving_readers_find_nothing_without_their_spans(cell, suffix):
    # the runtime before its child spans: rounds and plans only
    old = [s for s in SERVE if s[0] in ("serve.round", "serve.plan")]
    no_rounds = [s for s in SERVE if s[0] != "serve.round"]
    for spans in (old, no_rounds, []):
        w = serve_window(cell, spans)
        for name in ("serve_planner_host_ms", "serve_expire_host_ms"):
            assert harness.reader(f"{name}.{suffix}")(w) is None, name


def test_each_new_reader_is_listed_in_its_cells():
    per = {m["name"]: m for m in SPEC["per_layer"]}
    for name in TRAIN:
        assert per[name]["workloads"] == ["nemotron-train-zipf",
                                          "falcon-mamba-train-zipf"]
        assert per[name]["layer"] == "train step"
    for base, layer in (("serve_planner_host_ms", "replica cache"),
                        ("serve_expire_host_ms", "serving loop")):
        assert per[base + ".tail"]["workloads"] == ["nemotron-serve-zipf"]
        assert per[base + ".sat"]["workloads"] == ["nemotron-serve-uniform"]
        assert per[base + ".tail"]["layer"] == layer
    for name in TRAIN + tuple(f"{b}.{s}" for b in (
            "serve_planner_host_ms", "serve_expire_host_ms")
            for s in ("tail", "sat")):
        assert (per[name]["unit"], per[name]["better"],
                per[name]["source"]) == ("ms", "lower", "program_span")
