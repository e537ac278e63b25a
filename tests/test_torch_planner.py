"""The port's planning layer against the JAX package's on the same
inputs: streaming intent snapshots, the window classifiers,
`IntentPlanner.replan_from_queue` and `plan`, and the online
controller's decisions, all exactly."""

from collections import Counter

import numpy as np
import pytest

from repro.core.engine import StreamingIntentBuffer as JBuffer
from repro.core.engine import concurrent_intent as j_concurrent_intent
from repro.core.engine import intent_miss_bound as j_intent_miss_bound
from repro.pm.controller import Knob as JKnob
from repro.pm.controller import OnlineController as JController
from repro.pm.planner import IntentPlanner as JPlanner
from repro_torch.core.engine import IntentWindow
from repro_torch.core.engine import StreamingIntentBuffer as TBuffer
from repro_torch.core.engine import concurrent_intent, intent_miss_bound
from repro_torch.pm.controller import Knob as TKnob
from repro_torch.pm.controller import OnlineController as TController
from repro_torch.pm.planner import IntentPlanner as TPlanner

V = 4096


def fill(buf, rng, n_req=96, k=8, zipf=1.3):
    """Enqueue ``n_req`` Zipf-keyed requests, then serve (expire) a
    third of them; returns the queue order of the rest."""
    rids = np.arange(n_req)
    keys = (rng.zipf(zipf, size=(n_req, k)) - 1) % V
    buf.ingest_batch(np.repeat(rids, k), keys.reshape(-1))
    buf.expire(rids[::3])
    return rng.permutation(np.setdiff1d(rids, rids[::3]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("batch", [4, 16])
def test_snapshot_matches_jax(seed, batch):
    order = fill(JBuffer(), np.random.default_rng(seed))
    jb, tb = JBuffer(), TBuffer()
    fill(jb, np.random.default_rng(seed))
    fill(tb, np.random.default_rng(seed))
    for a, b in zip(jb.snapshot(order, batch), tb.snapshot(order, batch)):
        np.testing.assert_array_equal(a, b)


def assert_same_plan(got, want):
    """Every field of the JAX package's `PlacementPlan`, exactly."""
    np.testing.assert_array_equal(got.cache_ids, want.cache_ids)
    assert got.cache_ids.dtype == want.cache_ids.dtype
    for f in ("version", "miss_capacity", "route_capacity", "demand",
              "predicted_miss_rate", "window"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity,owner_shards", [(64, 0), (256, 0),
                                                   (128, 8)])
def test_replan_from_queue_matches_jax(seed, capacity, owner_shards):
    buf = JBuffer()
    order = fill(buf, np.random.default_rng(seed))
    keys, slots, ticks = buf.snapshot(order, 16)
    jp = JPlanner(V, capacity, n_nodes=16, owner_shards=owner_shards)
    tp = TPlanner(V, capacity, n_nodes=16, owner_shards=owner_shards)
    for step in range(3):
        jp.observe_round(step)
        tp.observe_round(step)
        want = jp.replan_from_queue(keys, slots, ticks)
        got = tp.replan_from_queue(keys, slots, ticks)
        assert_same_plan(got, want)
        assert tp.lookahead() == jp.lookahead()


def test_controller_matches_jax():
    """Same knobs, seed, demands and rewards -> the same moves."""
    def make(Knob, Controller):
        return Controller([Knob("cache_capacity", (64, 128, 256, 512),
                                adapt=False, prefer_low=True),
                           Knob("replan_every", (2, 4, 8, 16), index=1),
                           Knob("batch_requests", (8, 16, 32), index=1)],
                          seed=3)
    jc, tc = make(JKnob, JController), make(TKnob, TController)
    rng = np.random.default_rng(0)
    for demand, reward in zip(rng.integers(1, 600, size=40),
                              rng.uniform(50, 150, size=40)):
        assert tc.steer_capacity("cache_capacity", int(demand)) == \
            jc.steer_capacity("cache_capacity", int(demand))
        assert tc.observe(float(reward)) == jc.observe(float(reward))
        assert tc.values() == jc.values()
    assert tc.force_at_least("replan_every", 16, cause="t") == \
        jc.force_at_least("replan_every", 16, cause="t")


# ---------------------------------------------------------------- solve
# the serving cells' shapes: a 256000-row table, 64 keys a request, 32
# request slots a micro-batch, the top of the capacity ladder

SERVE_V, SLOTS, SERVE_C = 256000, 32, 16384


def serving_queue(n_req, zipf, seed, k=64):
    """The snapshot of ``n_req`` queued requests of ``k`` keys each,
    uniform over the table (``zipf=None``) or Zipf-distributed."""
    rng = np.random.default_rng(seed)
    if zipf is None:
        keys = rng.integers(0, SERVE_V, size=(n_req, k))
    else:
        keys = (rng.zipf(zipf, size=(n_req, k)) - 1) % SERVE_V
    buf = JBuffer()
    buf.ingest_batch(np.repeat(np.arange(n_req), k), keys.reshape(-1))
    return buf.snapshot(np.arange(n_req), SLOTS)


@pytest.mark.parametrize("n_req,zipf,capacity,owner_shards", [
    (1024, None, SERVE_C, 0),      # nemotron-serve-uniform's queue
    (1024, None, SERVE_C, 8),
    (96, 1.1, SERVE_C, 0),
    (256, 1.1, SERVE_C, 0),
    (256, 1.1, 512, 0),            # the ranking cut through the Zipf head
    (256, 1.1, 512, 8),
])
def test_replan_matches_jax_at_the_serving_shapes(n_req, zipf, capacity,
                                                  owner_shards):
    keys, slots, ticks = serving_queue(n_req, zipf, seed=n_req)
    jp = JPlanner(SERVE_V, capacity, n_nodes=SLOTS,
                  owner_shards=owner_shards)
    tp = TPlanner(SERVE_V, capacity, n_nodes=SLOTS,
                  owner_shards=owner_shards)
    for _ in range(2):
        want = jp.replan_from_queue(keys, slots, ticks)
        got = tp.replan_from_queue(keys, slots, ticks)
        assert_same_plan(got, want)
    assert got.demand > 0 and got.signals == len(keys)


@pytest.mark.parametrize("capacity", [5, 6, 7, 9])
def test_ties_at_the_cut_go_to_the_smaller_key(capacity):
    """Two keys wanted by two requests of one batch score above ten keys
    each wanted once, all of equal score: the cut falls among the ten,
    which rank by ascending key however the queue orders them."""
    rng = np.random.default_rng(capacity)
    ids = rng.choice(SERVE_V, size=12, replace=False)
    hot, tied = ids[:2], ids[2:]
    keys = np.concatenate([hot, hot, rng.permutation(tied)])
    slots = np.concatenate([[0, 0], [1, 1], np.arange(10) % 4])
    ticks = np.concatenate([[0, 0, 0, 0], 1 + np.arange(10) // 4])
    want = JPlanner(SERVE_V, capacity, n_nodes=4).replan_from_queue(
        keys, slots, ticks)
    got = TPlanner(SERVE_V, capacity, n_nodes=4).replan_from_queue(
        keys, slots, ticks)
    assert_same_plan(got, want)
    cached = got.cache_ids[got.cache_ids < SERVE_V]
    assert set(hot) <= set(cached)
    assert set(cached) - set(hot) == set(np.sort(tied)[:capacity - 2])


@pytest.mark.parametrize("owner_shards", [0, 8])
def test_empty_snapshot_matches_jax(owner_shards):
    z = np.zeros(0, np.int64)
    want = JPlanner(SERVE_V, 64, n_nodes=SLOTS,
                    owner_shards=owner_shards).replan_from_queue(z, z, z)
    got = TPlanner(SERVE_V, 64, n_nodes=SLOTS,
                   owner_shards=owner_shards).replan_from_queue(z, z, z)
    assert_same_plan(got, want)
    assert got.signals == 0 and got.demand == 0


@pytest.mark.parametrize("per_node_bound", [False, True])
@pytest.mark.parametrize("n_nodes", [1, 4])
def test_training_plans_match_jax(n_nodes, per_node_bound):
    """The training loop's `plan` (and the prefetch pipeline's
    `plan_candidate` / `adopt`) over shards' Zipf batches at step numbers
    near 10**6, which the packed codes must not carry whole."""
    start, V = 999_990, 4096
    rng = np.random.default_rng(n_nodes)
    kw = dict(n_nodes=n_nodes, plan_every=4, per_node_bound=per_node_bound)
    jp, tp = JPlanner(V, 48, **kw), TPlanner(V, 48, **kw)
    for step in range(start, start + 28):
        for shard in range(n_nodes):
            ids = np.unique((rng.zipf(1.2, size=64) - 1) % V)
            jp.signal(step, shard, ids)
            tp.signal(step, shard, ids)
    j_active = t_active = None
    plans = 0
    for step in range(start, start + 20):
        jp.observe_round(step)
        tp.observe_round(step)
        assert tp.should_replan(step, t_active) == \
            jp.should_replan(step, j_active)
        if not jp.should_replan(step, j_active):
            continue
        window = jp.plan_window(step)
        assert tp.plan_window(step) == window
        assert_same_plan(tp.plan_candidate(window),
                         jp.plan_candidate(window))
        j_active, t_active = jp.plan(step), tp.plan(step)
        assert_same_plan(t_active, j_active)
        plans += 1
    assert plans >= 3


# ----------------------------------------------------------- classifiers

def window_signals(kind, seed):
    """(keys, nodes, clocks) of one kind of window."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(40, 300))
    keys = rng.integers(0, 40, size=m)
    nodes = rng.integers(0, 5, size=m)
    clocks = rng.integers(0, 7, size=m)
    if kind == "duplicates":       # every triple repeated, some thrice
        rep = rng.integers(2, 4, size=m)
        keys, nodes, clocks = (np.repeat(a, rep) for a in
                               (keys, nodes, clocks))
        order = rng.permutation(len(keys))
        keys, nodes, clocks = keys[order], nodes[order], clocks[order]
    elif kind == "one_key":
        keys = np.full(m, 17)
    elif kind == "one_node":
        nodes = np.full(m, 3)
    elif kind == "late_clocks":    # absolute step numbers
        clocks = clocks + 1_000_003
    return keys, nodes, clocks


KINDS = ["random", "duplicates", "one_key", "one_node", "late_clocks"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_classifiers_match_jax(kind, seed):
    keys, nodes, clocks = window_signals(kind, seed)
    for got, want in zip(concurrent_intent(keys, nodes, clocks),
                         j_concurrent_intent(keys, nodes, clocks)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    rng = np.random.default_rng(seed + 10)
    for cached in (np.zeros(0, np.int64), rng.integers(0, 45, size=12),
                   np.unique(keys)):
        for per_node in (True, False):
            assert intent_miss_bound(keys, nodes, clocks, cached,
                                     per_node=per_node) == \
                j_intent_miss_bound(keys, nodes, clocks, cached,
                                    per_node=per_node), (cached, per_node)


def test_classifiers_on_an_empty_window_match_jax():
    z = np.zeros(0, np.int64)
    for got, want in zip(concurrent_intent(z, z, z),
                         j_concurrent_intent(z, z, z)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for per_node in (True, False):
        assert intent_miss_bound(z, z, z, z, per_node=per_node) == 0


def counted(keys, nodes, clocks, cached):
    """The classification and both miss bounds by counting in Python."""
    weight, single = Counter(), Counter()
    for c in set(clocks.tolist()):
        per_key = Counter(k for k, _ in {(k, n) for k, n, cc in
                                         zip(keys.tolist(), nodes.tolist(),
                                             clocks.tolist()) if cc == c})
        for k, cnt in per_key.items():
            if cnt >= 2:
                weight[k] += cnt
            else:
                single[k] += 1
    cached = set(cached.tolist())
    per_node, per_clock = Counter(), {}
    for k, n, c in zip(keys.tolist(), nodes.tolist(), clocks.tolist()):
        if k not in cached:
            per_node[(c, n)] += 1
            per_clock.setdefault(c, set()).add(k)
    return (weight, single, max(per_node.values(), default=0),
            max(map(len, per_clock.values()), default=0))


@pytest.mark.parametrize("wide", ["keys", "clocks", "keys_and_clocks"])
def test_classifiers_on_wide_windows(wide):
    """Keys across the whole int64 range, or clocks 10**12 apart: the
    columns are packed as their dense ranks, or the tallies sort, and the
    answers are those of counting one signal at a time."""
    rng = np.random.default_rng(len(wide))
    m = 200
    keys = rng.integers(0, 30, size=m)
    nodes = rng.integers(0, 4, size=m)
    clocks = rng.integers(0, 5, size=m)
    if "keys" in wide:
        keys = np.array([-2**62, -7, 0, 2**40, 2**62])[keys % 5] + \
            keys // 5
    if "clocks" in wide:
        clocks = clocks * 10**12
    cached = keys[rng.integers(0, m, size=4)]
    weight, single, per_node, per_clock = counted(keys, nodes, clocks,
                                                  cached)
    uniq, w, s = concurrent_intent(keys, nodes, clocks)
    np.testing.assert_array_equal(uniq, np.unique(keys))
    assert {k: v for k, v in zip(uniq.tolist(), w.tolist()) if v} == weight
    assert {k: v for k, v in zip(uniq.tolist(), s.tolist()) if v} == single
    assert intent_miss_bound(keys, nodes, clocks, cached) == per_node
    assert intent_miss_bound(keys, nodes, clocks, cached,
                             per_node=False) == per_clock
    win = IntentWindow(keys, nodes, clocks)
    assert win.missed(np.isin(win.uniq, cached)) == \
        np.count_nonzero(~np.isin(keys, cached))
