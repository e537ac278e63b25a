"""The MoE family against the JAX package, with the JAX weights carried
across (`params_from_jax`) on the same numpy inputs.

Routing is held exactly: the top-k experts, every assignment's capacity
slot (the running count over the token-major (T*K) order) and which
assignments drop.  The block's output and aux loss within rtol 1e-5;
the model's gradients, one step of each arm and a 20-step loop trace
within rtol 1e-4 / atol 1e-5 (XLA and PyTorch sum matmuls in other
orders).  The steps and loops start from a warm accumulator, as in
`test_torch_model.py` and `test_torch_train.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.model import forward as jforward
from repro.models.model import loss_fn as jloss_fn
from repro.optim import optimizers as jopt
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train_loop as jtrain_loop
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import moe
from repro_torch.models.model import loss_fn, params_from_jax, params_to_jax
from repro_torch.pm.embedding import make_state
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import make_opt_init, make_train_step
from test_torch_model import batch, carried, leaves, managed_batch, warm_accum
from test_torch_train import PINNED, warm_start

ARCH = "qwen3-moe-30b-a3b"


def jax_slots(topk_idx, E, C):
    """The reference's capacity positions and slots (`moe_block`'s own
    jnp expressions) from its top-k experts."""
    e_flat = topk_idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos_in_e = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = pos_in_e < C
    return np.asarray(jnp.where(keep, e_flat * C + pos_in_e, E * C)), \
        np.asarray(keep)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_matches_jax(capacity_factor):
    """At the config's capacity factor nothing drops; at 0.5 the capacity
    is 8 of 16 mean assignments per expert and the same assignments drop
    in both packages."""
    cfg = get_config(ARCH, smoke=True)
    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    jp = jmoe.init_moe(jax.random.PRNGKey(3), D, E, cfg.moe_d_ff,
                       jnp.float32)
    x = np.random.default_rng(4).normal(size=(4, 16, D)).astype(np.float32)
    jout, jaux, jidx = jmoe.moe_block(jnp.asarray(x), jp, n_experts=E,
                                      top_k=K,
                                      capacity_factor=capacity_factor)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    routes = []
    out, aux, idx = moe.moe_block(torch.from_numpy(x), p, n_experts=E,
                                  top_k=K, capacity_factor=capacity_factor,
                                  routes=routes)
    r, = routes
    T = x.shape[0] * x.shape[1]
    assert r.capacity == jmoe.expert_capacity(T, E, K, capacity_factor) \
        == moe.expert_capacity(T, E, K, capacity_factor)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want_slot, want_keep = jax_slots(jidx, E, r.capacity)
    np.testing.assert_array_equal(r.slot.numpy(), want_slot)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    assert want_keep.all() == (capacity_factor == 1.25)
    # rtol 1e-5 of the output's scale: the experts' fp32 sums cancel
    # (the reference's (E, D, F) init draws with 1/sqrt(E), so outputs
    # reach ~100 and single elements sit near 0)
    jout = np.asarray(jout)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x22b"])
def test_moe_carrier_round_trip(arch):
    cfg, jp, model = carried(arch)
    named = {k: v.detach() for k, v in model.named_parameters()}
    assert tuple(named["layers.1.moe.w_down"].shape) == \
        (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    got = leaves(params_to_jax(named))
    want = leaves(jp)
    assert set(got) == set(want)
    assert want["layers/moe/w_gate"].shape == \
        (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_moe_loss_and_gradients_match_jax():
    """The loss (cross-entropy plus the layers' summed aux) and its
    gradient for every leaf: `jax.grad` against autograd."""
    cfg, jp, model = carried(ARCH)
    tok, lab = batch(cfg, 5, B=2, S=16)
    jcfg = jget_config(ARCH, smoke=True)

    def jloss(p):
        lg, aux, _ = jforward(p, jcfg, {"tokens": jnp.asarray(tok)},
                              remat=False)
        return jloss_fn(lg, jnp.asarray(lab), aux)

    jl, jg = jax.value_and_grad(jloss)(jp)
    lg, aux, _ = model({"tokens": torch.from_numpy(tok)})
    tl = loss_fn(lg, torch.from_numpy(lab), aux)
    tl.backward()
    assert float(aux.detach()) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got = leaves(params_to_jax({k: p.grad for k, p in
                                model.named_parameters()}))
    want = leaves(jg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kernel", [False, True])
def test_moe_one_step_matches_jax(kernel):
    """One step of the untied MoE model: ``kernel=True`` the fused sparse
    arm (`adagrad_rows`' plain version on the CPU), ``kernel=False`` the
    dense arm, both against JAX's plain dense step."""
    cfg, jp, model = carried(ARCH)
    M = 64
    tok, lab = batch(cfg, 3)
    jacc = warm_accum(jp)
    jb, cache, n_miss = managed_batch(cfg, jp, tok, lab, M)
    jstep = jmake_train_step(jget_config(ARCH, smoke=True), lr=0.01,
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


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    init = warm_start(ARCH, tmp_path_factory.mktemp("moe") / "init")
    kw = dict(PINNED, steps=20, init_from=init)
    return kw, jtrain_loop(jget_config(ARCH, smoke=True), JLoopConfig(**kw))


@pytest.mark.parametrize("kernel", [True, False])
def test_moe_loop_trace_matches_jax(jax_trace, kernel):
    kw, want = jax_trace
    ops.reset_launch_counts()
    got = train_loop(get_config(ARCH, smoke=True),
                     LoopConfig(kernel=kernel, **kw), device="cpu")
    assert len(got.losses) == len(want.losses) == 20
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                               atol=1e-5)
    assert got.overflows == want.overflows == 0
    assert got.plans == want.plans and got.refreshes == want.refreshes
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions


def test_launch_train_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--steps", "3", "--batch", "2",
                       "--seq", "16", "--kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "0 overflow" in out


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", ARCH, "--steps", "1"])


def test_moe_forward_without_experts_is_the_dense_stack():
    """With ``n_experts`` 0 a MoE config builds MLP layers and no aux."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), n_experts=0,
                              top_k=0)
    from repro_torch.models.model import init_model
    model = init_model(cfg, torch.Generator().manual_seed(0))
    names = {k for k, _ in model.named_parameters()}
    assert "layers.0.mlp.w_gate" in names
    assert not any(".moe." in k for k in names)
    _, aux, _ = model({"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert float(aux) == 0.0
