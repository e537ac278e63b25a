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
