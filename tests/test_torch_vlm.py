"""The vlm family (qwen2-vl-7b's smoke config: M-RoPE, image-patch
embeddings scattered over the token rows) against the JAX package, with
the JAX weights carried across on the same numpy inputs
(`test_torch_families`): the forward and loss within rtol 1e-5, one step of
each arm (qwen2-vl is untied: ``kernel=True`` is the fused sparse arm)
and a 12-step managed loop's loss trace within rtol 1e-4 / atol 1e-5,
the fused prefill and serve steps within rtol 1e-4 / atol 1e-5, and the
weight carrier bit for bit.
"""

import pytest
import torch

from test_torch_families import (check_decode, check_forward, check_loop,
                             check_one_step, check_prefill_step,
                             check_round_trip, extras, jax_loop, torch_of)
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models.model import init_model
from repro_torch.pm.embedding import make_state
from repro_torch.train.steps import make_opt_init, make_train_step

ARCH = "qwen2-vl-7b"


def test_carrier_round_trip():
    want = check_round_trip(ARCH)
    cfg = get_config(ARCH, smoke=True)
    assert want["layers/attn/wq"].shape == \
        (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)


def test_forward_with_images_matches_jax():
    check_forward(ARCH)


def test_images_replace_their_token_rows():
    """Image rows overwrite the token rows at ``img_pos`` out of place:
    the logits do not depend on the tokens there, and those tokens' rows
    get zero gradient through the fused arm's gathered rows."""
    cfg = get_config(ARCH, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    ex = torch_of(extras(cfg, 2, 16, seed=2))
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    other = tok.clone()
    rows = torch.arange(2)[:, None]
    other[rows, ex["img_pos"].long()] = (tok[rows, ex["img_pos"].long()]
                                         + 1) % cfg.vocab_size
    with torch.no_grad():
        a, _, _ = model(dict(ex, tokens=tok))
        b, _, _ = model(dict(ex, tokens=other))
    assert torch.equal(a, b)
    h0 = model.embed.detach()[tok.long()].requires_grad_(True)
    lg, _, _ = model(dict(ex, tokens=tok), embed_rows=h0)
    lg.sum().backward()
    g = h0.grad
    assert not g[rows, ex["img_pos"].long()].any()
    keep = torch.ones((2, 16), dtype=torch.bool)
    keep[rows, ex["img_pos"].long()] = False
    assert g[keep].abs().sum(dim=-1).gt(0).all()


def test_default_positions_repeat_the_chunk_position():
    """Without ``positions`` the three M-RoPE coordinates are the chunk's
    position, which is plain RoPE."""
    cfg = get_config(ARCH, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    pos3 = torch.arange(8).expand(2, 8)[..., None].expand(2, 8, 3)
    with torch.no_grad():
        a, _, _ = model({"tokens": tok})
        b, _, _ = model({"tokens": tok, "positions": pos3})
    assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", [False, True])
def test_one_step_matches_jax(kernel):
    check_one_step(ARCH, kernel)


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    return jax_loop(ARCH, tmp_path_factory.mktemp("vlm") / "init", 12)


@pytest.mark.parametrize("kernel", [True, False])
def test_loop_trace_matches_jax(jax_trace, kernel):
    check_loop(ARCH, *jax_trace, kernel)


def test_prefill_and_serve_steps_match_jax():
    check_decode(ARCH)


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_matches_jax(last_only):
    check_prefill_step(ARCH, last_only)


def test_the_fused_arm_differentiates_the_gathered_rows():
    """qwen2-vl is untied: its kernel step never builds a table
    gradient."""
    cfg = get_config(ARCH, smoke=True)
    assert not cfg.tie_embeddings
    model = init_model(cfg, torch.Generator().manual_seed(0))
    state = make_opt_init()(model)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(3))
    cache = torch.full((16,), cfg.vocab_size, dtype=torch.int32)
    cache[:4] = torch.unique(tok)[:4].to(torch.int32)
    b = dict(torch_of(extras(cfg, 2, 16, seed=5)), tokens=tok,
             labels=torch.roll(tok, -1, 1), pm_cache_ids=cache,
             pm_cache_rows=make_state(model.embed.detach(),
                                      cache).cache_rows)
    make_train_step(cfg, lr=0.01, pm_miss_capacity=64,
                    pm_kernel=True)(model, state, b)
    assert model.embed.grad is None


def test_launch_train_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--steps", "3", "--batch", "2",
                       "--seq", "16", "--kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "0 overflow" in out
