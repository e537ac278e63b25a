"""`long_500k`'s decode step (`configs/shapes.py`: one sequence, a decode
against a long context) at the smoke configs of the two recurrent
families it runs for: falcon-mamba-7b (Mamba-1, O(1) state) and
zamba2-1.2b (Mamba-2 trunk and a shared attention block with one KV
cache per application).

A cache filled with seeded random numbers at ``len`` near its end (no
prefill: the state is what a long prompt would have left), then one-token
serve steps until the cache is full, against the reference's
`make_serve_step` on the same weights and cache: logits and every cache
tensor within 2e-3 (the smoke's decode tolerance).  No position enters a
Mamba-1 step: falcon-mamba's step at two ``len`` values on the same
state is the same bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import carried
from repro.configs.registry import get_config as jget_config
from repro.train.steps import make_serve_step as jmake_serve_step
from repro_torch.models.model import init_cache
from repro_torch.train.steps import make_serve_step

B, MAX_SEQ, LEFT = 2, 48, 3     # steps until the cache is full
TOL = 2e-3


def random_cache(cfg, seed: int, length: int):
    """numpy arrays of `init_cache`'s shapes, seeded normals (the conv ring
    and the KV caches at 0.5, ``h`` at 0.1), and ``len``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in init_cache(cfg, B, MAX_SEQ, device="cpu").items():
        if name == "len":
            continue
        scale = 0.1 if name == "h" else 0.5
        out[name] = (rng.standard_normal(tuple(t.shape)) * scale).astype(
            np.float32)
    out["len"] = length
    return out


def both(arr):
    cache = {k: torch.from_numpy(v.copy()) if k != "len" else v
             for k, v in arr.items()}
    jcache = {k: jnp.asarray(v) if k != "len" else jnp.int32(v)
              for k, v in arr.items()}
    return cache, jcache


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_serve_steps_near_the_end_of_the_cache_match_jax(arch):
    cfg, jp, model = carried(arch)
    jcfg = jget_config(arch, smoke=True)
    cache, jcache = both(random_cache(cfg, 3, MAX_SEQ - LEFT))
    serve, jserve = make_serve_step(cfg), jax.jit(jmake_serve_step(jcfg))
    tok = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    for _ in range(LEFT):
        jl, jcache = jserve(jp, jcache, jnp.asarray(tok))
        tl, cache = serve(model, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        assert np.isfinite(tl.numpy()).all()
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
    assert cache["len"] == int(jcache["len"]) == MAX_SEQ
    for name in set(cache) - {"len"}:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_mamba1_step_does_not_read_the_position():
    """The same state and token at ``len`` 45 and at ``len`` 5: logits and
    the new state bit for bit."""
    cfg, _, model = carried("falcon-mamba-7b")
    arr = random_cache(cfg, 5, MAX_SEQ - LEFT)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(B, 1)).astype(np.int32))
    serve = make_serve_step(cfg)
    out = []
    for length in (MAX_SEQ - LEFT, 5):
        cache, _ = both(dict(arr, len=length))
        logits, cache = serve(model, cache, tok)
        out.append((logits, cache))
    (la, ca), (lb, cb) = out
    assert torch.equal(la, lb)
    for name in ("conv", "h"):
        assert torch.equal(ca[name], cb[name]), name
    assert (ca["len"], cb["len"]) == (MAX_SEQ - LEFT + 1, 6)
