"""The port's planning layer against the JAX package's on the same
inputs: streaming intent snapshots, `IntentPlanner.replan_from_queue`
and the online controller's decisions, all exactly."""

import numpy as np
import pytest

from repro.core.engine import StreamingIntentBuffer as JBuffer
from repro.pm.controller import Knob as JKnob
from repro.pm.controller import OnlineController as JController
from repro.pm.planner import IntentPlanner as JPlanner
from repro_torch.core.engine import StreamingIntentBuffer as TBuffer
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
        np.testing.assert_array_equal(got.cache_ids, want.cache_ids)
        assert got.cache_ids.dtype == want.cache_ids.dtype
        for f in ("version", "miss_capacity", "route_capacity", "demand",
                  "predicted_miss_rate", "window"):
            assert getattr(got, f) == getattr(want, f), f
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
