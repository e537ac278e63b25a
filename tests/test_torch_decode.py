"""KV-cache decoding against the JAX package: the fused prefill into a
cache and the one-token serve steps, with the JAX weights carried across
(`params_from_jax`).  Both packages are fed the JAX run's greedy tokens,
and the logits agree within rtol 1e-4 / atol 1e-5 at every step.

mixtral-8x22b runs with its window cut to 4, as the reference's
`test_sliding_window_restricts_attention` cuts it: its cache then holds 4
positions.  Up to there the packages agree; one position further the
reference clamps the write index and overwrites the last slot, and the
port raises instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.models import layers as jlayers
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.train.steps import make_prefill_decode_step as jmake_prefill_decode
from repro.train.steps import make_prefill_step as jmake_prefill_step
from repro.train.steps import make_serve_step as jmake_serve_step
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import layers
from repro_torch.models.model import (cache_seq_len, init_cache, init_model,
                                      load_params, n_attn_apps,
                                      params_from_jax)
from repro_torch.train.steps import (make_prefill_decode_step,
                                     make_prefill_step, make_serve_step)

# arch -> (prompt length, decode steps); mixtral's 4-position cache
# holds 2 + 2
RUNS = {"smollm-135m": (6, 5), "qwen3-moe-30b-a3b": (6, 5),
        "mixtral-8x22b": (2, 2)}
B = 2


def configs(arch):
    """The smoke config of both packages (mixtral: window 4)."""
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    if arch == "mixtral-8x22b":
        cfg = dataclasses.replace(cfg, sliding_window=4)
        jcfg = dataclasses.replace(jcfg, sliding_window=4)
    return cfg, jcfg


def carried(arch, seed: int = 0):
    cfg, jcfg = configs(arch)
    jp = jinit_model(jcfg, jax.random.PRNGKey(seed))
    model = init_model(cfg, torch.Generator().manual_seed(seed))
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.array, jp)))
    return cfg, jcfg, jp, model


def prompt(cfg, P, seed: int = 1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", list(RUNS))
def test_prefill_and_serve_steps_match_jax(arch):
    cfg, jcfg, jp, model = carried(arch)
    P, N = RUNS[arch]
    max_seq = P + N
    tok = prompt(cfg, P)
    jcache = jinit_cache(jcfg, B, max_seq)
    cache = init_cache(cfg, B, max_seq, device="cpu")
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    jprefill = jax.jit(jmake_prefill_decode(jcfg))
    jserve = jax.jit(jmake_serve_step(jcfg))
    jl, jcache = jprefill(jp, jcache, jnp.asarray(tok))
    tl, cache = make_prefill_decode_step(cfg)(model, cache,
                                              torch.from_numpy(tok))
    assert cache["len"] == int(jcache["len"]) == P
    close(tl, jl)
    serve = make_serve_step(cfg)
    for _ in range(N):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        jl, jcache = jserve(jp, jcache, jnp.asarray(nxt))
        tl, cache = serve(model, cache, torch.from_numpy(nxt))
        close(tl, jl)
    assert cache["len"] == int(jcache["len"]) == P + N
    L = cache["len"]
    close(cache["k"][:, :, :L], jcache["k"][:, :, :L])
    close(cache["v"][:, :, :L], jcache["v"][:, :, :L])


def test_window_cache_raises_past_its_end():
    """The reference's cache with a window of 4 holds 4 positions; the
    fifth token's write is clamped there.  The port refuses it."""
    arch = "mixtral-8x22b"
    cfg, jcfg, jp, model = carried(arch)
    cache = init_cache(cfg, B, 16, device="cpu")
    assert cache["k"].shape[2] == cache_seq_len(jcfg, 16) == 4
    tok = prompt(cfg, 4)
    _, cache = make_prefill_decode_step(cfg)(model, cache,
                                             torch.from_numpy(tok))
    before = cache["k"].clone()
    nxt = np.zeros((B, 1), np.int32)
    with pytest.raises(ValueError, match="does not fit the 4-position"):
        make_serve_step(cfg)(model, cache, torch.from_numpy(nxt))
    assert torch.equal(cache["k"], before)          # nothing was written
    # the reference takes the step and overwrites position 3's slot
    _, jcache = jmake_prefill_decode(jcfg)(jp, jinit_cache(jcfg, B, 16),
                                           jnp.asarray(tok))
    _, jcache2 = jmake_serve_step(jcfg)(jp, jcache, jnp.asarray(nxt))
    assert int(jcache2["len"]) == 5
    k0, k1 = np.asarray(jcache["k"]), np.asarray(jcache2["k"])
    np.testing.assert_array_equal(k1[:, :, :3], k0[:, :, :3])
    assert not np.array_equal(k1[:, :, 3], k0[:, :, 3])
    with pytest.raises(ValueError, match="does not fit"):
        make_prefill_decode_step(cfg)(
            model, init_cache(cfg, B, 16, device="cpu"),
            torch.from_numpy(prompt(cfg, 5)))


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_matches_jax(last_only):
    arch = "qwen3-moe-30b-a3b"
    cfg, jcfg, jp, model = carried(arch)
    tok = prompt(cfg, 8)
    want = jmake_prefill_step(jcfg, last_only=last_only)(
        jp, {"tokens": jnp.asarray(tok)})
    got = make_prefill_step(cfg, last_only=last_only)(
        model, {"tokens": torch.from_numpy(tok)})
    close(got, want)


@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_matches_jax(window):
    """A 3-query chunk ending at position 6 of an 8-slot cache (GQA 4:2),
    causal within the chunk, with and without a window."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 8, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), 6, window=window)
    got = layers.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), 6, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_decode_equals_teacher_forcing_in_the_port():
    """The reference's `test_decode_matches_prefill_dense` on the port:
    one token at a time through the cache reproduces the full forward's
    logits (tolerance 2e-3, as there)."""
    cfg, _, _, model = carried("smollm-135m")
    tok = prompt(cfg, 8)
    with torch.no_grad():
        full, _, _ = model({"tokens": torch.from_numpy(tok)})
    cache = init_cache(cfg, B, 8, device="cpu")
    serve = make_serve_step(cfg)
    for t in range(8):
        lg, cache = serve(model, cache, torch.from_numpy(tok[:, t:t + 1]))
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_cache_layout_matches_jax():
    for arch in RUNS:
        cfg, jcfg = configs(arch)
        assert n_attn_apps(cfg) == 0
        for max_seq in (3, 4, 100):
            got = init_cache(cfg, 2, max_seq, device="cpu")
            want = jinit_cache(jcfg, 2, max_seq)
            assert got["len"] == 0
            for name in ("k", "v"):
                assert tuple(got[name].shape) == tuple(want[name].shape)


def test_every_arch_builds_its_decode_state_and_prefill():
    """Every architecture of the reference resolves, builds a decode
    state of the reference's layout and a prefill step; none is refused
    as not ported."""
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch, smoke=True), jget_config(arch,
                                                              smoke=True)
        got, want = init_cache(cfg, 1, 4, device="cpu"), jinit_cache(jcfg,
                                                                     1, 4)
        assert set(got) == set(want), arch
        for name in set(got) - {"len"}:
            assert tuple(got[name].shape) == tuple(want[name].shape), \
                (arch, name)
        assert callable(make_prefill_decode_step(cfg))
