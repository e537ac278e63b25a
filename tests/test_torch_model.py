"""The dense model, its optimizers and one training step of each arm
against the JAX package, with the JAX weights carried across
(`params_from_jax`) on the same numpy batches.

Tolerances: the forward and loss within rtol 1e-5 (XLA and PyTorch sum
matmuls in other orders); one step within rtol 1e-4 / atol 1e-5 on loss
and every parameter and accumulator leaf.  The steps start from a warm
accumulator (uniform in [0.5, 1.5] x 1e-4, as after some training): from
a zero accumulator AdaGrad's first update is ``lr * g / (|g| + eps)``,
about ``lr * sign(g)``, which turns ulp-level differences in a near-zero
gradient element into a whole update of either sign.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import forward as jforward
from repro.models.model import init_model as jinit_model
from repro.models.model import loss_fn as jloss_fn
from repro.optim import optimizers as jopt
from repro.pm.collectives import EmulatedBackend as JBackend
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.kernels import pm_forward
from repro_torch.models.model import (init_model, load_params, loss_fn,
                                      params_from_jax, params_to_jax)
from repro_torch.optim import optimizers as topt
from repro_torch.pm.embedding import make_state
from repro_torch.train.steps import make_opt_init, make_train_step

ARCHS = ["nemotron-4-15b", "smollm-135m"]   # untied fused arm, tied dense


def carried(arch: str, seed: int = 0):
    """The JAX smoke model's weights and the port's model holding them."""
    cfg = get_config(arch, smoke=True)
    jp = jinit_model(jget_config(arch, smoke=True), jax.random.PRNGKey(seed))
    model = init_model(cfg, torch.Generator().manual_seed(seed))
    load_params(model, params_from_jax(
        jax.tree_util.tree_map(np.array, jp)))
    return cfg, jp, model


def warm_accum(jp, seed: int = 1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, size=x.shape) * 1e-4)
        .astype(np.float32), jp)


def batch(cfg, seed: int, B: int = 2, S: int = 16):
    rng = np.random.default_rng(seed)
    tok = (rng.zipf(1.2, size=(B, S)) % cfg.vocab_size).astype(np.int32)
    tok[0, :2] = 0                               # row 0, duplicated
    return tok, np.roll(tok, -1, axis=1)


def leaves(tree):
    return {"/".join(str(getattr(e, "key", e)) for e in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def as_reference(cfg) -> dict:
    """``cfg`` by the reference's fields, after checking that the fields
    the port adds for its own families (falcon_h1's) hold their defaults:
    the same configuration as the reference's."""
    ref = {f.name for f in dataclasses.fields(type(jget_config("smollm-135m")))}
    own = [f for f in dataclasses.fields(cfg) if f.name not in ref]
    assert {f.name: getattr(cfg, f.name) for f in own} == \
        {f.name: f.default for f in own}, cfg.arch_id
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k in ref}


def test_registry_names_the_ported_archs():
    assert get_config("smollm-135m").n_layers == 30
    assert get_config("nemotron-4-15b").d_model == 6144
    assert get_config("granite-20b").n_kv_heads == 1
    assert get_config("llama3-405b").d_model == 16384
    assert get_config("mixtral-8x22b").sliding_window == 4096
    moe = get_config("qwen3-moe-30b-a3b")
    assert (moe.family, moe.n_experts, moe.top_k) == ("moe", 128, 8)
    vlm, encdec = get_config("qwen2-vl-7b"), get_config("whisper-medium")
    assert (vlm.family, vlm.mrope_sections) == ("vlm", (16, 24, 24))
    assert (encdec.family, encdec.encoder.n_frames) == ("encdec", 1500)
    ssm, hybrid = get_config("falcon-mamba-7b"), get_config("zamba2-1.2b")
    assert (ssm.family, ssm.dt_rank, ssm.d_inner) == ("ssm", 256, 8192)
    assert (hybrid.family, hybrid.attn_every) == ("hybrid", 6)
    for arch in ("granite-20b", "llama3-405b", "mixtral-8x22b",
                 "qwen3-moe-30b-a3b", "qwen2-vl-7b", "whisper-medium"):
        for smoke in (False, True):
            assert as_reference(get_config(arch, smoke)) == \
                dataclasses.asdict(jget_config(arch, smoke)), (arch, smoke)
    # the two recurrent families, ported last
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        for smoke in (False, True):
            assert as_reference(get_config(arch, smoke)) == \
                dataclasses.asdict(jget_config(arch, smoke)), (arch, smoke)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_carrier_round_trip(arch):
    cfg, jp, model = carried(arch)
    back = params_to_jax({k: v.detach() for k, v in
                          model.named_parameters()})
    want = leaves(jp)
    got = leaves(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    cfg, jp, model = carried(arch)
    tok, lab = batch(cfg, 1)
    jcfg = jget_config(arch, smoke=True)
    jl, _, _ = jforward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    jloss = jloss_fn(jl, jnp.asarray(lab))
    with torch.no_grad():
        tl, aux, _ = model({"tokens": torch.from_numpy(tok)})
        tloss = loss_fn(tl, torch.from_numpy(lab), aux)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_dense_optimizers_match_jax(opt, monkeypatch):
    monkeypatch.setattr(topt, "CHUNK", 7)        # chunking changes nothing
    rng = np.random.default_rng(2)
    p = {"a": rng.normal(size=(5, 6)).astype(np.float32),
         "b": rng.normal(size=(9,)).astype(np.float32)}
    gs = [{k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in p.items()} for _ in range(3)]
    jinit, jupd = (jopt.adagrad_init, jopt.adagrad_update) \
        if opt == "adagrad" else (jopt.adam_init, jopt.adam_update)
    tinit, tupd = (topt.adagrad_init, topt.adagrad_update) \
        if opt == "adagrad" else (topt.adam_init, topt.adam_update)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jinit(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = tinit(tp)
    for g in gs:
        jp, js = jupd({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                      lr=0.01)
        tupd({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, lr=0.01)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def managed_batch(cfg, jp, tok, lab, M):
    """A managed-lookup batch for both packages: the sorted, V-padded
    replica cache of the batch's most frequent ids and its rows."""
    ids, counts = np.unique(tok, return_counts=True)
    cache = np.full(16, cfg.vocab_size, np.int32)
    hot = np.sort(ids[np.argsort(-counts, kind="stable")[:8]])
    cache[:hot.size] = hot
    jcr = JBackend().refresh_rows(jp["embed"], jnp.asarray(cache))
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
          "pm_cache_ids": jnp.asarray(cache), "pm_cache_rows": jcr}
    n_miss = np.setdiff1d(tok, cache).size
    assert n_miss <= M
    return jb, cache, n_miss


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kernel", [False, True])
def test_one_step_matches_jax(arch, kernel):
    """The port's step (``kernel=True``: the fused sparse arm on the
    untied model, the segmented `scatter_rows` backward on the tied one;
    plain versions on the CPU) against JAX's plain dense step
    (``pm_kernel=False``).  Sparse AdaGrad on the touched rows equals
    dense AdaGrad: zero-gradient rows do not move."""
    cfg, jp, model = carried(arch)
    M = 64
    tok, lab = batch(cfg, 3)
    jacc = warm_accum(jp)
    jb, cache, n_miss = managed_batch(cfg, jp, tok, lab, M)
    jstep = jmake_train_step(jget_config(arch, smoke=True), lr=0.01,
                             pm_miss_capacity=M, pm_kernel=False)
    jl, jp2, js2 = jstep(jp, jopt.AdaGradState(jacc), jb)

    state = make_opt_init()(model)
    for k, v in params_from_jax(jacc).items():
        state.accum[k].copy_(torch.from_numpy(np.array(v)))
    tc = torch.from_numpy(cache)
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
          "pm_cache_ids": tc,
          "pm_cache_rows": make_state(model.embed.detach(), tc).cache_rows,
          "pm_n_miss": n_miss}
    step = make_train_step(cfg, lr=0.01, pm_miss_capacity=M,
                           pm_kernel=kernel)
    tl, model, state = step(model, state, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = leaves(params_to_jax({k: v.detach() for k, v in
                                model.named_parameters()}))
    got_acc = leaves(params_to_jax(state.accum))
    for want, have in ((leaves(jp2), got), (leaves(js2.accum), got_acc)):
        assert set(want) == set(have)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_sort_per_step(arch, monkeypatch):
    """Exactly one torch sort per managed kernel step (forward probe,
    backward pre-sum and sparse update all read the step residual)."""
    cfg, jp, model = carried(arch)
    tok, lab = batch(cfg, 4)
    _, cache, n_miss = managed_batch(cfg, jp, tok, lab, 64)
    tc = torch.from_numpy(cache)
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
          "pm_cache_ids": tc,
          "pm_cache_rows": make_state(model.embed.detach(), tc).cache_rows,
          "pm_n_miss": n_miss}
    calls = []
    for name in ("argsort", "sort"):
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, counted)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _f=counted, **kw:
                            _f(self, *a, **kw))
    step = make_train_step(cfg, lr=0.01, pm_miss_capacity=64,
                           pm_kernel=True)
    step(model, make_opt_init()(model), tb)
    assert calls == ["argsort"]
    # and the residual is what sorted
    calls.clear()
    pm_forward.step_residual(tc, torch.from_numpy(tok).reshape(-1), 64)
    assert calls == ["argsort"]
