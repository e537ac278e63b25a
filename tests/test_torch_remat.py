"""Rematerialisation in training (`DenseLM.forward`'s ``remat`` /
``remat_policy``, `make_train_step`'s defaults), on the CPU at the smoke
configs.

Recomputing a layer runs the same ops on the same inputs, so the
gradients with ``remat=False``, "full" and "dots" are held equal bit for
bit, for one model of each family.  The bytes autograd saves outside the
rematerialised units (counted with `saved_tensors_hooks`, parameters
left out) fall under "full", and the scan's ``a`` and ``h`` are no
longer among them.  "dots" keeps exactly the outputs of ``aten.mm`` /
``aten.addmm`` and recomputes every batched product.  One step of each
arm with "dots" is held against JAX's ``make_train_step(remat=True,
remat_policy="dots")`` within the families' parity tolerances
(`test_torch_families.check_one_step`: loss rtol 1e-5, parameters and
accumulators rtol 1e-4 / atol 1e-5); with "full", the default of both
steps, every family's one-step parity test holds it.
"""

import numpy as np
import pytest
import torch

from test_torch_families import check_one_step, extras, torch_of
from repro_torch.configs.registry import get_config
from repro_torch.models import model as model_mod
from repro_torch.models.model import init_cache, init_model, loss_fn
from repro_torch.train import steps as steps_mod
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import (make_opt_init, make_prefill_decode_step,
                                     make_serve_step, make_train_step)

#: one model of each family
FAMILIES = {"dense": "nemotron-4-15b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-medium", "vlm": "qwen2-vl-7b"}
SETTINGS = ((False, "full"), (True, "full"), (True, "dots"))
B, S = 2, 16


def setup(arch: str, seed: int = 0):
    cfg = get_config(arch, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    tb = {"tokens": torch.from_numpy(rng.integers(
              0, cfg.vocab_size, size=(B, S)).astype(np.int32)),
          "labels": torch.from_numpy(rng.integers(
              0, cfg.vocab_size, size=(B, S)).astype(np.int32)),
          **torch_of(extras(cfg, B, S, seed=1))}
    return cfg, model, tb


def backward(model, tb, remat: bool, policy: str, routes=None):
    model.zero_grad(set_to_none=True)
    logits, aux, _ = model(tb, remat=remat, remat_policy=policy,
                           routes=routes)
    loss = loss_fn(logits, tb["labels"], aux)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gradients_equal_bit_for_bit(family):
    cfg, model, tb = setup(FAMILIES[family])
    runs = [backward(model, tb, *s) for s in SETTINGS]
    loss0, g0 = runs[0]
    assert len(g0) == len(list(model.parameters()))
    for (loss, g), s in zip(runs[1:], SETTINGS[1:]):
        assert torch.equal(loss, loss0), s
        assert set(g) == set(g0)
        for k in g0:
            assert torch.equal(g[k], g0[k]), (s, k)


def saved(model, tb, remat: bool, policy: str = "full"):
    """The shapes and the bytes of the distinct non-parameter storages
    autograd saves for the backward (outside checkpoint's own hooks)."""
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    store = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params:
            store.setdefault(ptr, []).append(tuple(t.shape))
            store[ptr + 0.5] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, aux, _ = model(tb, remat=remat, remat_policy=policy)
        loss = loss_fn(logits, tb["labels"], aux)
    loss.backward()
    shapes = {s for k, v in store.items() if isinstance(k, int) for s in v}
    nbytes = sum(v for k, v in store.items() if not isinstance(k, int))
    return shapes, nbytes


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "encdec"])
def test_full_saves_fewer_bytes_and_no_scan_state(family):
    cfg, model, tb = setup(FAMILIES[family])
    plain_shapes, plain = saved(model, tb, False)
    full_shapes, full = saved(model, tb, True)
    # the encoder is not rematerialised: its activations stay saved
    assert full < (plain if family == "encdec" else plain / 2), (full, plain)
    scan = {"ssm": [(B, S, cfg.d_inner, cfg.ssm_state)],
            "hybrid": [(B, S, cfg.d_inner // cfg.ssm_head_dim,
                        cfg.ssm_head_dim, cfg.ssm_state),
                       (B, S, cfg.d_inner // cfg.ssm_head_dim, 1, 1)]}
    for shape in scan.get(family, []):
        assert shape in plain_shapes          # a, h without remat
        assert shape not in full_shapes


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_dots_keeps_only_products_without_batch_dims(family, monkeypatch):
    """The policy sees every op of a unit: it keeps every ``mm`` /
    ``addmm`` and nothing else, and the batched products (the experts'
    ``bmm``, attention's tiles, the scan readout's einsum) are
    recomputed."""
    seen = []
    policy = model_mod.save_dots

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        seen.append((op, decision, ctx.is_recompute))
        return decision

    monkeypatch.setattr(model_mod, "save_dots", recording)
    cfg, model, tb = setup(FAMILIES[family])
    backward(model, tb, True, "dots")
    kept = {op for op, d, rec in seen if not rec
            and d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert kept and kept <= set(model_mod.DOTS)
    forward_ops = {op for op, d, rec in seen if not rec}
    assert torch.ops.aten.bmm.default in forward_ops
    assert all(d != torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
               for op, d, _ in seen if op == torch.ops.aten.bmm.default)


def test_moe_routes_once_per_layer():
    cfg, model, tb = setup(FAMILIES["moe"])
    for remat, policy in SETTINGS:
        routes = []
        backward(model, tb, remat, policy, routes=routes)
        assert len(routes) == cfg.n_layers, (remat, policy)


def count_units(monkeypatch):
    """Counts the rematerialised units entered (each call of
    `torch.utils.checkpoint.checkpoint` from the model)."""
    calls = []
    real = model_mod.checkpoint

    def counting(*args, **kwargs):
        calls.append(None)
        return real(*args, **kwargs)

    monkeypatch.setattr(model_mod, "checkpoint", counting)
    return calls


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_unit_per_layer_the_encoder_outside(family, monkeypatch):
    calls = count_units(monkeypatch)
    cfg, model, tb = setup(FAMILIES[family])
    backward(model, tb, True, "full")
    assert len(calls) == cfg.n_layers         # no encoder layer among them


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_decoding_never_rematerialises(arch, monkeypatch):
    calls = count_units(monkeypatch)
    cfg, model, tb = setup(arch)
    cache = init_cache(cfg, B, S + 2, device="cpu")
    if cfg.family == "encdec":
        with torch.no_grad():
            cache["enc_out"] = model.encode(tb["frames"])
    logits, cache = make_prefill_decode_step(cfg)(model, cache,
                                                  tb["tokens"][:, :S])
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    make_serve_step(cfg)(model, cache, tok)
    model(tb | {"tokens": tok}, {**cache, "len": cache["len"] + 1},
          remat=True)
    assert calls == []


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "smollm-135m"])
def test_the_loop_trains_with_remat_and_one_lookup_a_step(arch,
                                                          monkeypatch):
    """The loop's steps rematerialise each layer (the step's default), and
    the managed lookup runs once a step: in the model (the tied dense
    arm) or in the step (the fused arm), outside the units."""
    calls = count_units(monkeypatch)
    lookups = []
    for mod in (model_mod, steps_mod):
        real = mod.pm_lookup
        monkeypatch.setattr(mod, "pm_lookup",
                            lambda *a, _real=real, **k:
                            lookups.append(None) or _real(*a, **k))
    cfg = get_config(arch, smoke=True)
    res = train_loop(cfg, LoopConfig(steps=3, batch=2, seq=16,
                                     kernel=True, pipeline_depth=1,
                                     refresh_every=2), device="cpu")
    assert len(res.losses) == 3
    assert len(calls) == 3 * cfg.n_layers
    assert len(lookups) == 3


def test_unknown_policy_raises():
    cfg, model, tb = setup(FAMILIES["dense"])
    step = make_train_step(cfg, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        step(model, make_opt_init()(model), tb)
    with pytest.raises(ValueError, match="remat_policy"):
        model(tb, remat=True, remat_policy="dot")


def test_step_defaults_rematerialise(monkeypatch):
    calls = count_units(monkeypatch)
    cfg, model, tb = setup(FAMILIES["dense"])
    state = make_opt_init()(model)
    make_train_step(cfg, lr=0.01)(model, state, tb)
    assert len(calls) == cfg.n_layers
    make_train_step(cfg, lr=0.01, remat=False)(model, state, tb)
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("arch,kernel", [
    ("smollm-135m", False),            # tied: the dense arm
    ("qwen3-moe-30b-a3b", True),       # untied: the fused arm
    ("zamba2-1.2b", False),            # the dense arm, the scan in a unit
])
def test_one_step_matches_jax_with_dots(arch, kernel):
    """"dots" on both sides; "full", both steps' default, is what every
    family's one-step parity test (`check_one_step`) now runs."""
    check_one_step(arch, kernel, remat=True, remat_policy="dots")
