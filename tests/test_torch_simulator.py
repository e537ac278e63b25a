"""The port's AdaPM core (`repro_torch.core`, `repro_torch.data.workloads`)
against the JAX package's, on the same numpy inputs, and the port's
twins of `examples/`.

Both cores are numpy on the host doing the same operations in the same
order, so everything is held exactly: hashes, intent activation, every
`Metrics` field of AdaPM (with and without relocation, replication or
Algorithm 1) and of the four baselines, the placement each leaves, the
per-key trace, and the workload streams array for array.  The
`seed_metrics.json` values are held as `tests/test_engine.py` holds them
(ints equal, floats within rel 1e-9).  The example twins run at tiny
sizes on the CPU; `pm_simulation`'s output equals the reference
example's, line for line.
"""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from test_engine import SEED_METRICS, tiny_workload
from repro.core import api as japi
from repro.core import baselines as jbase
from repro.core import simulator as jsim
from repro.core.engine import IntentStore as JIntentStore
from repro.core.engine import home_nodes as jhome_nodes
from repro.core.intent import Intent as JIntent
from repro.core.manager import AdaPM as JAdaPM
from repro.core.ownership import home_node as jhome_node
from repro.core.timing import ActionTimer as JActionTimer
from repro.data import workloads as jworkloads
from repro_torch.core import api, baselines, simulator
from repro_torch.core.engine import IntentStore, home_nodes
from repro_torch.core.intent import Intent
from repro_torch.core.manager import AdaPM
from repro_torch.core.ownership import home_node
from repro_torch.core.timing import ActionTimer
from repro_torch.data import workloads
from repro_torch.examples import (pm_simulation, quickstart, serve_decode,
                                  train_lm)

ROOT = Path(__file__).resolve().parents[1]


def port_workload(wl):
    """The reference's `Workload` as the port's (the same arrays)."""
    return simulator.Workload(wl.name, wl.n_keys, wl.streams)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_action_timer_should_act_and_rate_match(seed):
    """Algorithm 1's output: `ActionTimer.should_act` and `.rate` against
    the reference's on the same seeded clock sequences of three workers
    (pauses included), at every offset around the horizon, and at its
    boundary: ``horizon - 1`` acts, ``horizon`` does not."""
    rng = np.random.default_rng(seed)
    kw = dict(alpha=0.1 + 0.1 * seed, p=0.9999, lam0=10.0)
    port, ref = ActionTimer(**kw), JActionTimer(**kw)
    clocks = [0, 0, 0]
    for _ in range(40):
        for w in range(3):
            clocks[w] += int(rng.integers(0, 40)) * int(rng.random() > 0.2)
            port.observe_round(w, clocks[w])
            ref.observe_round(w, clocks[w])
            assert port.rate(w) == ref.rate(w)
            h = ref.horizon(w)
            assert port.horizon(w) == h
            for off in (-3, 0, h - 1, h, h + 2):
                c = clocks[w] + off
                assert port.should_act(w, clocks[w], c) \
                    == ref.should_act(w, clocks[w], c)
            assert port.should_act(w, clocks[w], clocks[w] + h - 1)
            assert not port.should_act(w, clocks[w], clocks[w] + h)


@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 64])
def test_home_nodes_match(n):
    rng = np.random.default_rng(n)
    keys = np.concatenate([np.arange(1000),
                           rng.integers(0, 2 ** 32, size=1000),
                           [2 ** 32 - 1]])
    np.testing.assert_array_equal(home_nodes(keys, n), jhome_nodes(keys, n))
    for k in keys[::50]:
        assert home_node(int(k), n) == jhome_node(int(k), n)


def test_intent_store_activation_matches():
    """A seeded sweep of windows and clocks: both stores classify every
    window alike, answer the per-key queries alike, and `Intent.state`
    agrees."""
    rng = np.random.default_rng(7)
    for _ in range(25):
        mine, ref, intents = IntentStore(), JIntentStore(), []
        for _ in range(int(rng.integers(1, 30))):
            s = int(rng.integers(0, 20))
            e = s + int(rng.integers(1, 10))
            w = int(rng.integers(0, 4))
            keys = rng.integers(0, 8, size=int(rng.integers(1, 5)))
            mine.signal(keys, s, e, w)
            ref.signal(keys, s, e, w)
            intents.append((s, e, w))
        clocks = {w: int(rng.integers(0, 40)) for w in range(4)}
        np.testing.assert_array_equal(mine.states(clocks),
                                      ref.states(clocks))
        for k in range(8):
            assert mine.active_workers(k, clocks) == \
                ref.active_workers(k, clocks)
            assert mine.earliest_future_start(k, clocks) == \
                ref.earliest_future_start(k, clocks)
            assert mine.last_end(k) == ref.last_end(k)
        for s, e, w in intents:
            assert Intent((0,), s, e, w).state(clocks[w]) == \
                JIntent((0,), s, e, w).state(clocks[w])
        mine.gc(clocks)
        ref.gc(clocks)
        np.testing.assert_array_equal(mine.keys(), ref.keys())


#: keys whose management events AdaPM traces
TRACE = {1, 7, 42, 399}


def policies(pkg_base, pkg_adapm, cost, wl):
    """name -> policy factory, for one package."""
    return {
        "adapm": lambda: pkg_adapm(wl_nodes(wl), cost, trace_keys=TRACE),
        "adapm_no_relocation":
            lambda: pkg_adapm(wl_nodes(wl), cost, relocation=False),
        "adapm_no_replication":
            lambda: pkg_adapm(wl_nodes(wl), cost, replication=False),
        "adapm_immediate":
            lambda: pkg_adapm(wl_nodes(wl), cost, immediate_action=True),
        "full_replication": lambda: pkg_base.StaticFullReplication(
            wl_nodes(wl), cost, wl.n_keys),
        "static_partitioning":
            lambda: pkg_base.StaticPartitioning(wl_nodes(wl), cost),
        "ssp20": lambda: pkg_base.SelectiveReplicationSSP(
            wl_nodes(wl), cost, 20),
        "essp": lambda: pkg_base.SelectiveReplicationSSP(
            wl_nodes(wl), cost, None),
        "nups": lambda: pkg_base.NuPSStatic(
            wl_nodes(wl), cost, wl.n_keys, wl.hot_keys(0.02),
            reloc_offset=16),
    }


def wl_nodes(wl) -> int:
    return len(wl.streams)


POLICIES = ("adapm", "adapm_no_relocation", "adapm_no_replication",
            "adapm_immediate", "full_replication", "static_partitioning",
            "ssp20", "essp", "nups")


@pytest.mark.parametrize("n_nodes,wpn,seed", [(2, 1, 0), (4, 2, 1),
                                              (8, 2, 2)])
def test_every_policy_metrics_equal_exactly(n_nodes, wpn, seed):
    """Every `Metrics` field, the final owners and replica holders, and
    the per-key trace, for AdaPM's variants and the four baselines."""
    wl = tiny_workload(n_nodes, wpn, 25, 400, 8, seed)
    cfg = dict(signal_offset=15)
    for name in POLICIES:
        ref = policies(jbase, JAdaPM, japi.CostModel(), wl)[name]()
        mine = policies(baselines, AdaPM, api.CostModel(),
                        port_workload(wl))[name]()
        jm = jsim.simulate(ref, wl, jsim.SimConfig(**cfg))
        m = simulator.simulate(mine, port_workload(wl),
                               simulator.SimConfig(**cfg))
        assert dataclasses.asdict(m) == dataclasses.asdict(jm), name
        assert m.as_dict() == jm.as_dict(), name
        if name.startswith("adapm"):
            np.testing.assert_array_equal(mine.engine.owners.owner,
                                          ref.engine.owners.owner)
            np.testing.assert_array_equal(mine.engine.holder_mask,
                                          ref.engine.holder_mask)
            assert mine.trace == ref.trace
            assert mine.trace or name != "adapm"
        assert mine.name == ref.name


@pytest.mark.parametrize("name", ["static_partitioning", "full_replication",
                                  "ssp20", "essp", "nups"])
def test_seed_metrics_hold(name):
    """`tests/test_engine.py::TestSeedMetrics`'s configuration through the
    port."""
    with open(SEED_METRICS) as f:
        want = json.load(f)[name]
    wl = port_workload(tiny_workload(n_nodes=4, wpn=2, n_batches=40,
                                     n_keys=800, kpb=8, seed=7))
    cost = api.CostModel()
    pol = {
        "static_partitioning": lambda: baselines.StaticPartitioning(4, cost),
        "full_replication":
            lambda: baselines.StaticFullReplication(4, cost, wl.n_keys),
        "ssp20": lambda: baselines.SelectiveReplicationSSP(4, cost, 20),
        "essp": lambda: baselines.SelectiveReplicationSSP(4, cost, None),
        "nups": lambda: baselines.NuPSStatic(4, cost, wl.n_keys,
                                             wl.hot_keys(0.02),
                                             reloc_offset=32),
    }[name]()
    m = simulator.simulate(pol, wl, simulator.SimConfig(signal_offset=20))
    for key, ref in want.items():
        got = getattr(m, key)
        if isinstance(ref, int):
            assert got == ref, key
        else:
            assert got == pytest.approx(ref, rel=1e-9, abs=1e-12), key


def test_tasks_are_the_references():
    assert tuple(workloads.TASKS) == tuple(jworkloads.TASKS)


@pytest.mark.parametrize("task", list(jworkloads.TASKS))
def test_workload_streams_equal(task):
    """The same seed draws the same streams, array for array (a small key
    space; ``scale`` cuts every stream)."""
    kw = dict(n_nodes=3, wpn=2, scale=0.1, n_keys=2000)
    mine = workloads.make_workload(task, **kw)
    ref = jworkloads.make_workload(task, **kw)
    assert (mine.name, mine.n_keys) == (ref.name, ref.n_keys)
    assert [[len(s) for s in n] for n in mine.streams] == \
        [[len(s) for s in n] for n in ref.streams]
    for node_m, node_r in zip(mine.streams, ref.streams):
        for s_m, s_r in zip(node_m, node_r):
            for b_m, b_r in zip(s_m, s_r):
                assert b_m.dtype == b_r.dtype
                np.testing.assert_array_equal(b_m, b_r)
    np.testing.assert_array_equal(mine.key_frequencies(),
                                  ref.key_frequencies())
    assert simulator.single_node_epoch_time(mine, api.CostModel()) == \
        jsim.single_node_epoch_time(ref, japi.CostModel())


def test_budget_prefix_equal():
    rng = np.random.default_rng(3)
    for _ in range(50):
        costs = np.where(rng.random(int(rng.integers(0, 40))) < 0.3,
                         120e-6, 0.8e-6)
        budget = float(rng.uniform(-1e-4, 3e-3))
        n, spent, excl = api.budget_prefix(costs, budget)
        jn, jspent, jexcl = japi.budget_prefix(costs, budget)
        assert (n, spent) == (jn, jspent)
        np.testing.assert_array_equal(excl, jexcl)


# ---------------------------------------------------------- the example twins


def test_pm_simulation_prints_what_the_reference_prints(capsys,
                                                       monkeypatch):
    args = ["--task", "MF", "--nodes", "2", "--scale", "0.05"]
    pm_simulation.main(args)
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["pm_simulation.py"] + args)
    runpy.run_path(str(ROOT / "examples" / "pm_simulation.py"),
                   run_name="__main__")
    assert mine == capsys.readouterr().out
    assert "per-key management trace" in mine


def test_quickstart_runs_both_parts_on_the_cpu(capsys):
    quickstart.main(["--nodes", "2", "--scale", "0.05", "--steps", "3",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("AdaPM", "Full replication", "Static partitioning",
                 "-> loss"):
        assert name in out
    assert "over 3 steps" in out


def test_train_lm_trains_on_the_cpu(capsys):
    res = train_lm.main(["--steps", "3", "--batch", "2", "--seq", "16",
                         "--device", "cpu"])
    assert len(res.losses) == 3 and np.all(np.isfinite(res.losses))
    assert "done: loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-medium",
                                  "zamba2-1.2b"])
def test_serve_decode_decodes_on_the_cpu(arch, capsys):
    ids = serve_decode.main(["--arch", arch, "--batch", "2",
                             "--prompt-len", "4", "--new-tokens", "2",
                             "--device", "cpu"])
    assert ids.shape == (2, 3)
    out = capsys.readouterr().out
    assert "decode state:" in out and "on cpu" in out


def test_twins_default_to_the_card(monkeypatch):
    """Without ``--device`` the twins that train or decode ask for
    ``cuda``; here, without a card, that raises."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_decode.main(["--new-tokens", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.part2_intent_managed_training(steps=1)
