"""The traffic generator: the open loop's rate and rotation times, the
closed loop's backlog, and the training token stream against the port's
own corpus."""

import time

import numpy as np
import torch

from portbench import generator, harness
from portbench.drivers import serve
from portbench.tests import smallcells


def test_open_schedule_offers_a_fixed_count_at_the_rate():
    for seed in (0, 2 ** 31 + 7):
        s = generator.open_schedule(1000, 8, rate=500.0, span_s=12.0,
                                    rotate_s=5.0, seed=seed)
        assert s.due_s.size == s.keys.shape[0] == 6000
        assert np.all(np.diff(s.due_s) >= 0)
        assert 0.0 <= s.due_s[0] and s.due_s[-1] < 12.0
        # the rate holds within each second, as a Poisson process's would
        per_s = np.bincount(s.due_s.astype(int), minlength=12)
        assert abs(per_s.mean() - 500) < 1e-9
        assert np.all(np.abs(per_s - 500) < 5 * np.sqrt(500))
        assert s.keys.min() >= 0 and s.keys.max() < 1000


def test_open_schedule_rotates_the_hot_set_on_time():
    s = generator.open_schedule(1000, 16, rate=2000.0, span_s=15.0,
                                rotate_s=5.0, seed=3)
    modes = []
    for e in range(3):
        sel = (s.due_s >= 5.0 * e) & (s.due_s < 5.0 * (e + 1))
        modes.append(np.bincount(s.keys[sel].ravel(),
                                 minlength=1000).argmax())
        # the hot key holds through its epoch: both halves agree
        for part in (s.due_s < 5.0 * e + 2.5, s.due_s >= 5.0 * e + 2.5):
            k = s.keys[sel & part].ravel()
            assert np.bincount(k, minlength=1000).argmax() == modes[-1]
    assert len(set(modes)) == 3
    same = generator.open_schedule(1000, 16, rate=2000.0, span_s=15.0,
                                   rotate_s=5.0, seed=3)
    assert np.array_equal(same.keys, s.keys)


def test_a_rate_profile_shapes_arrivals_and_keeps_the_count():
    """Bursts are data: a profile of [seconds, relative rate] pieces,
    repeated, puts each piece's share of the arrivals in it; the count,
    the keys and (with no profile) the times are the flat schedule's."""
    kw = dict(rate=1000.0, span_s=20.0, rotate_s=5.0, seed=2 ** 31 + 1)
    flat = generator.open_schedule(1000, 8, **kw)
    burst = generator.open_schedule(1000, 8, profile=[[1.5, 1.0],
                                                      [0.5, 4.0]], **kw)
    assert burst.due_s.size == flat.due_s.size == 20000
    assert np.all(np.diff(burst.due_s) >= 0) and burst.due_s[-1] < 20.0
    in_burst = (burst.due_s % 2.0) >= 1.5
    # 0.5 s at 4x against 1.5 s at 1x: 2 / 3.5 of the arrivals
    assert abs(in_burst.mean() - 2.0 / 3.5) < 0.01
    per_s = np.bincount((burst.due_s * 2).astype(int), minlength=40)
    assert per_s[3::4].mean() > 3 * per_s[0::4].mean()
    assert np.array_equal(generator.open_schedule(1000, 8, profile=None,
                                                  **kw).due_s, flat.due_s)
    uni = generator.open_schedule(1000, 8, dist="uniform", **kw)
    assert uni.keys.min() >= 0 and uni.keys.max() < 1000
    assert np.bincount(uni.keys.ravel(), minlength=1000).max() < 300
    z = generator.ClosedKeys(1000, 8, seed=3, block=64, dist="zipf")
    hot = np.bincount(np.concatenate([z.keys(i) for i in range(256)]),
                      minlength=1000)
    assert hot.max() > 100


def test_closed_loop_keeps_its_backlog():
    c = smallcells.cell("nemotron-serve-uniform")
    r = harness.Run(c, 1, 5.0, False, torch.device("cpu"),
                    time.perf_counter())
    keys = generator.ClosedKeys(512, 64, seed=1, block=16)
    st = serve.ClosedStream(r, keys, backlog=64)
    first = st.arrivals(0)
    assert [q.rid for q in first] == list(range(64))
    assert st.arrivals(1) == []                 # nothing served yet
    st.served(first[:10], time.perf_counter())
    again = st.arrivals(2)
    assert [q.rid for q in again] == list(range(64, 74))
    assert st.next - len(st.served_t) == 64
    # a request's keys do not depend on the order they are asked for
    assert np.array_equal(generator.ClosedKeys(512, 64, seed=1, block=16)
                          .keys(70), again[6].keys)


def test_token_stream_draws_as_the_ports_corpus():
    from repro_torch.data.pipeline import SyntheticCorpus
    for seed in (0, 12345, 2 ** 31 + 11):
        ours = generator.TokenStream(4096, "zipf", 1.1, seed)
        port = SyntheticCorpus(4096, zipf_a=1.1, seed=seed)
        for _ in range(3):
            assert np.array_equal(ours.tokens((2, 64)),
                                  port.tokens((2, 64)))
        assert len(ours.handed) == 3
    u = generator.TokenStream(100, "uniform", seed=1).tokens((4, 8))
    assert u.shape == (4, 8) and u.max() < 100
