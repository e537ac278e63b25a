"""The port's host-side index stage against the JAX package's, exactly:
`host_compact` (the probe/compact arithmetic), `probe_host` with and
without the routed per-owner overflow flags, and the memoized
`CacheProbeView`."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import pm_forward as jpf
from repro.pm import embedding as jemb
from repro_torch.kernels import pm_forward as tpf
from repro_torch.pm import embedding as temb

V = 1000
CASES = ["plain", "empty_cache", "duplicates", "overflow"]
FIELDS = ("hit", "cache_slot", "buf_ids", "buf_slot", "overflow", "n_miss")


def case(name):
    """(cache_ids, tokens, M) for a named regime."""
    rng = np.random.default_rng(CASES.index(name))
    C = {"empty_cache": 0}.get(name, 64)
    cache = np.sort(rng.choice(V, size=C, replace=False)).astype(np.int32)
    if C:
        cache[-3:] = V                       # planner pads: match nothing
        cache = np.sort(cache)
    if name == "duplicates":
        tok = rng.choice(rng.choice(V, 12, replace=False), size=256)
    else:
        tok = rng.integers(0, V, size=256)
    M = 16 if name == "overflow" else 256
    return cache, tok.astype(np.int32), M



@pytest.mark.parametrize("name", CASES)
def test_host_compact_matches_jax(name):
    cache, tok, M = case(name)
    got = tpf.host_compact(cache, tok, M)
    want = jpf.host_compact(cache, tok, M)
    dev = jpf.probe_and_compact(jnp.asarray(cache), jnp.asarray(tok), M)
    for k in ("hit", "cache_slot", "buf_ids", "buf_slot", "overflow",
              "n_miss", "sorted_ids", "seg_slot", "n_uniq"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("hit", "cache_slot", "buf_ids", "buf_slot", "overflow",
              "n_miss"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(dev, k)),
                                      err_msg=k)
    if name == "overflow":
        assert got["overflow"].any()


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("routed", [False, True])
def test_probe_host_and_view_match_jax(name, routed):
    cache, tok, M = case(name)
    kw = dict(owner_shards=4, route_capacity=3) if routed else {}
    want = jemb.probe_host(cache, tok, M, vocab=V, **kw)
    got = temb.probe_host(cache, tok, M, vocab=V, **kw)
    view = temb.CacheProbeView(cache, V).probe(tok, M, **kw)
    jview = jemb.CacheProbeView(cache, V).probe(tok, M, **kw)
    for k in FIELDS:
        for other in (got, view, jview):
            np.testing.assert_array_equal(getattr(other, k),
                                          getattr(want, k), err_msg=k)
    if routed and name != "empty_cache":
        plain = temb.probe_host(cache, tok, M, vocab=V)
        assert got.overflow.sum() > plain.overflow.sum()


def generations():
    """A sequence of cache generations (sorted, V-padded) that a view
    advances through: disjoint, overlapping, grown, shrunk, all pads,
    empty, and one holding ids 0 and V - 1."""
    rng = np.random.default_rng(7)
    perm = rng.permutation(V)
    a = perm[:61]
    b = perm[61:125]                         # disjoint from a
    grown = np.concatenate([b[:32], perm[125:221]])  # overlaps b
    shrunk = grown[40:56]
    ends = np.concatenate([[0, V - 1], perm[300:330]])

    def gen(ids, pads):
        return np.sort(np.concatenate([ids, np.full(pads, V)])
                       ).astype(np.int32)

    return [gen(a, 3), gen(b, 0), gen(grown, 5), gen(shrunk, 0),
            gen(shrunk[:0], 8), gen(shrunk[:0], 0), gen(ends, 2),
            gen(perm[320:400], 0)]


def probe_tokens(cache, rng):
    """Tokens that hit (drawn from the cache's real ids) and miss."""
    real = cache[cache < V]
    tok = rng.integers(0, V, size=256)
    if real.size:
        tok[::2] = rng.choice(real, size=128)
    return np.concatenate([tok, [0, V - 1]]).astype(np.int32)


@pytest.mark.parametrize("order", ["forward", "reverse"])
@pytest.mark.parametrize("routed", [False, True])
def test_view_advances_through_generations(order, routed):
    """One view advanced through every generation probes each exactly
    as `probe_host` and a freshly built view do, in every field's bytes
    and dtype."""
    gens = generations()
    if order == "reverse":
        gens = gens[::-1]
    kw = dict(owner_shards=4, route_capacity=3) if routed else {}
    rng = np.random.default_rng(11)
    view = temb.CacheProbeView(gens[0], V)
    for i, cache in enumerate(gens):
        if i:
            view.advance(cache)
        tok = probe_tokens(cache, rng)
        for M in (24, 256):
            got = view.probe(tok, M, **kw)
            fresh = temb.CacheProbeView(cache, V).probe(tok, M, **kw)
            host = temb.probe_host(cache, tok, M, vocab=V, **kw)
            want = jemb.probe_host(cache, tok, M, vocab=V, **kw)
            for k in FIELDS:
                w = np.asarray(getattr(want, k))
                for other in (got, fresh, host):
                    o = np.asarray(getattr(other, k))
                    assert o.dtype == w.dtype, (i, M, k)
                    assert o.tobytes() == w.tobytes(), (i, M, k)
        assert 0 < got.hit.sum() or not (cache < V).any()
        assert (~got.hit).any()


def test_advance_counts_the_rows_it_writes():
    """`serve.probe_rows` grows by the old generation's real ids plus the
    new one's on each `advance` (the first generation alone at
    construction), never by the vocabulary."""
    from repro_torch.obs.telemetry import Telemetry
    bus = Telemetry()
    gens = generations()
    n_real = [int((g < V).sum()) for g in gens]
    view = temb.CacheProbeView(gens[0], V, telemetry=bus)
    total = n_real[0]
    assert bus.counter_value("serve.probe_rows") == total
    for prev, cur, g in zip(n_real, n_real[1:], gens[1:]):
        view.advance(g)
        total += prev + cur
        assert bus.counter_value("serve.probe_rows") == total
    assert total < V
