"""The hybrid family (zamba2-1.2b's smoke config: a Mamba-2 trunk with one
shared attention block before every ``attn_every``-th layer) against the
JAX package, with the JAX weights carried across on the same numpy inputs
(`test_torch_families`).

Tolerances: `mamba2_block`'s output and gradients within rtol 1e-5; the
model's forward within rtol 1e-5; one step of each arm and the loop's
loss trace within rtol 1e-4 / atol 1e-5; the fused prefill and serve
steps (the shared block's KV caches, one per application, beside the
Mamba state) within rtol 1e-4 / atol 1e-5; the weight carrier and
checkpoints bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import (check_decode, check_forward, check_loop,
                                 check_one_step, check_prefill_step,
                                 check_round_trip, jax_loop)
from test_torch_ssm import block_check, check_chunked_prefill
from test_torch_model import carried, leaves, warm_accum
from repro.ckpt import checkpoint as jckpt
from repro.configs.registry import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.model import forward as jforward
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro.optim.optimizers import AdaGradState
from repro.train.steps import make_prefill_decode_step as jmake_prefill
from repro.train.steps import make_serve_step as jmake_serve_step
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.models.model import (init_cache, init_model, load_params,
                                      n_attn_apps, params_from_jax)
from repro_torch.train.loop import checkpoint_tree, restore
from repro_torch.train.steps import (make_opt_init, make_prefill_decode_step,
                                     make_serve_step)

ARCH = "zamba2-1.2b"


def test_mamba2_block_matches_jax():
    """The per-head decay stays (B, S, nh, 1, 1) in the port and is
    materialised in the reference: the same products."""
    block_check(
        lambda key, c: jssm.init_mamba2(key, c.d_model, c.d_inner,
                                        c.ssm_state, c.ssm_conv,
                                        c.ssm_head_dim, jnp.float32),
        jssm.mamba2_block, ssm.mamba2_block,
        lambda c: dict(ssm_state=c.ssm_state, head_dim=c.ssm_head_dim))


def test_carrier_round_trip():
    """``layers.<i>.mamba.*`` stack as the reference stores them;
    ``shared_attn.*`` is one block, not stacked."""
    want = check_round_trip(ARCH)
    cfg = get_config(ARCH, smoke=True)
    nh = cfg.d_inner // cfg.ssm_head_dim
    assert want["layers/mamba/A_log"].shape == (cfg.n_layers, nh)
    assert want["shared_attn/attn/wq"].shape == \
        (cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert want["shared_attn/mlp/w_gate"].shape == (cfg.d_model, cfg.d_ff)


def test_forward_matches_jax():
    check_forward(ARCH)


def test_shared_block_runs_before_every_attn_every_th_layer():
    """Deeper than the smoke config, 3 layers: the shared block runs
    before layers 0 and 2, two applications, each with its own KV cache;
    the forward, the shared block's gradient (summed over its
    applications) and a prefill then serve step against JAX."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), n_layers=3)
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), n_layers=3)
    assert n_attn_apps(cfg) == 2
    jp = jinit_model(jcfg, jax.random.PRNGKey(4))
    model = init_model(cfg, torch.Generator().manual_seed(4))
    load_params(model, params_from_jax(jax.tree_util.tree_map(np.array,
                                                              jp)))
    tok = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32)

    def jsum(p):
        lg, _, _ = jforward(p, jcfg, {"tokens": jnp.asarray(tok)})
        return jnp.sum(lg * lg) / lg.size, lg

    (_, jl), jg = jax.value_and_grad(jsum, has_aux=True)(jp)
    lg, _, _ = model({"tokens": torch.from_numpy(tok)})
    ((lg * lg).sum() / lg.numel()).backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    for name, p in model.shared_attn.named_parameters():
        want = np.asarray(functools.reduce(lambda d, k: d[k],
                                           name.split("."),
                                           jg["shared_attn"]))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    cache = init_cache(cfg, 2, 9, device="cpu")
    jcache = jinit_cache(jcfg, 2, 9)
    assert cache["attn_k"].shape[0] == jcache["attn_k"].shape[0] == \
        n_attn_apps(cfg)
    jl, jcache = jax.jit(jmake_prefill(jcfg))(jp, jcache,
                                              jnp.asarray(tok[:, :6]))
    lg, cache = make_prefill_decode_step(cfg)(model, cache,
                                              torch.from_numpy(tok[:, :6]))
    nxt = tok[:, 6:7]
    jl, jcache = jax.jit(jmake_serve_step(jcfg))(jp, jcache,
                                                 jnp.asarray(nxt))
    lg, cache = make_serve_step(cfg)(model, cache, torch.from_numpy(nxt))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    for name in set(cache) - {"len"}:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_cache_layout_matches_jax():
    """One KV cache per application of the shared block, sized by
    ``max_seq``; the Mamba state is not."""
    cfg = get_config(ARCH, smoke=True)
    jcfg = jget_config(ARCH, smoke=True)
    for max_seq in (4, 40):
        got = init_cache(cfg, 2, max_seq, device="cpu")
        want = jinit_cache(jcfg, 2, max_seq)
        assert set(got) == set(want)
        for name in set(got) - {"len"}:
            assert tuple(got[name].shape) == tuple(want[name].shape), name
            assert got[name].dtype == torch.float32
    assert tuple(got["h"].shape) == (
        cfg.n_layers, 2, cfg.d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
        cfg.ssm_state)
    assert tuple(got["attn_k"].shape) == (n_attn_apps(cfg), 2, 40,
                                          cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("kernel", [False, True])
def test_one_step_matches_jax(kernel):
    check_one_step(ARCH, kernel)


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    return jax_loop(ARCH, tmp_path_factory.mktemp("hybrid") / "init", 12)


@pytest.mark.parametrize("kernel", [True, False])
def test_loop_trace_matches_jax(jax_trace, kernel):
    check_loop(ARCH, *jax_trace, kernel)


def test_checkpoints_cross_both_ways(tmp_path):
    """A checkpoint the port writes (``shared_attn`` included, not
    stacked) loads in the JAX package, and the JAX package's loads in
    the port: every parameter and accumulator leaf bit for bit."""
    cfg, jp, model = carried(ARCH)
    state = make_opt_init()(model)
    jacc = warm_accum(jp)
    for k, v in params_from_jax(jacc).items():
        state.accum[k].copy_(torch.from_numpy(np.array(v)))
    tckpt.save(str(tmp_path / "port"), checkpoint_tree(model, state), 3)
    like = {"params": jp, "opt": AdaGradState(jacc)}
    got, step = jckpt.load(str(tmp_path / "port"), like)
    assert step == 3
    for want, have in ((jp, got["params"]), (jacc, got["opt"].accum)):
        want, have = leaves(want), leaves(have)
        assert set(want) == set(have)
        assert any(k.startswith("shared_attn/") for k in have)
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    jckpt.save(str(tmp_path / "jax"), like, 5)
    other = init_model(cfg, torch.Generator().manual_seed(9))
    other_state = make_opt_init()(other)
    assert restore(str(tmp_path / "jax"), other, other_state) == 5
    for k, p in model.named_parameters():
        assert torch.equal(dict(other.named_parameters())[k], p), k
        assert torch.equal(other_state.accum[k], state.accum[k]), k


def test_prefill_and_serve_steps_match_jax():
    """The fused prefill against the reference's ``prefill_scan``, then
    serve steps; logits, the Mamba state and the KV caches."""
    check_decode(ARCH)


def test_fused_prefill_equals_a_token_loop():
    check_chunked_prefill(ARCH)


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_matches_jax(last_only):
    check_prefill_step(ARCH, last_only)


def test_launch_train_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch",
                       "2", "--seq", "16", "--kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "0 overflow" in out
