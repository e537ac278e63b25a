"""The ssm family (falcon-mamba-7b's smoke config: a Mamba-1 trunk, no
attention) and the scan and conv under both recurrent families, against
the JAX package, with the JAX weights carried across on the same numpy
inputs (`test_torch_families`).

Tolerances: `linear_scan` (values and the gradients of a scalar loss
with respect to ``a``, ``b`` and ``h0``) within rtol 1e-5 / atol 1e-6;
`mamba1_block`'s output and gradients within rtol 1e-5; the model's
forward within rtol 1e-5, one step of each arm and the loop's loss trace
within rtol 1e-4 / atol 1e-5; the fused prefill and serve steps against
the reference's ``prefill_scan`` and serve steps, and against the port's
own token loop, within rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import (check_decode, check_forward, check_loop,
                                 check_one_step, check_prefill_step,
                                 check_round_trip, jax_loop)
from test_torch_model import carried
from repro.configs.registry import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.model import init_cache as jinit_cache
from repro.models.model import init_model as jinit_model
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.models.model import init_cache, init_model, params_to_jax
from repro_torch.train.steps import make_prefill_decode_step, make_serve_step

ARCH = "falcon-mamba-7b"


def scan_inputs(a_shape, b_shape, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, size=a_shape).astype(np.float32)
    b = rng.normal(size=b_shape).astype(np.float32)
    h0 = rng.normal(size=(b_shape[0],) + b_shape[2:]).astype(np.float32)
    w = rng.normal(size=b_shape).astype(np.float32)
    w_last = rng.normal(size=h0.shape).astype(np.float32)
    return a, b, h0, w, w_last


@pytest.mark.parametrize("a_shape,b_shape,chunk", [
    ((2, 10, 3, 1, 1), (2, 10, 3, 4, 5), 4),   # broadcast a, ragged chunk
    ((2, 10, 6, 4), (2, 10, 6, 4), 4),         # full a, ragged chunk
    ((2, 7, 6, 4), (2, 7, 6, 4), 16),          # one chunk shorter than 16
    ((1, 9, 3, 2), (1, 9, 3, 2), 1),           # chunks of one position
])
def test_linear_scan_matches_jax(a_shape, b_shape, chunk):
    """Outputs, and the gradients of sum(h * w) + sum(h_final * w_last)
    with respect to a, b and h0 (`jax.grad` against autograd), against
    `_chunked_linear_scan` (given the broadcast ``a`` materialised, as
    the reference's `mamba2_block` does)."""
    a, b, h0, w, w_last = scan_inputs(a_shape, b_shape)

    def jloss(a, b, h0):
        h, hf = jssm._chunked_linear_scan(jnp.broadcast_to(a, b.shape), b,
                                          h0, chunk)
        return jnp.sum(h * w) + jnp.sum(hf * w_last), (h, hf)

    (_, (jh, jhf)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(a, b, h0)
    ta, tb, th0 = (torch.tensor(x, requires_grad=True) for x in (a, b, h0))
    h, hf = ssm.linear_scan(ta, tb, th0, chunk)
    ((h * torch.from_numpy(w)).sum()
     + (hf * torch.from_numpy(w_last)).sum()).backward()
    for got, want in ((h, jh), (hf, jhf), (ta.grad, jgrads[0]),
                      (tb.grad, jgrads[1]), (th0.grad, jgrads[2])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    # the inputs are read, not written
    assert np.array_equal(ta.detach().numpy(), a)
    assert np.array_equal(tb.detach().numpy(), b)


@pytest.mark.parametrize("broadcast", [False, True])
def test_linear_scan_saves_a_and_h_only(broadcast):
    """What autograd keeps for the scan's backward is ``a``, ``h`` and
    ``h0``: no tensor of the doubling levels.  A chain of torch ops doing
    the same scan would keep about 2 log2(chunk) tensors of ``b``'s
    size."""
    b_shape = (2, 16, 3, 4, 5)
    a_shape = (2, 16, 3, 1, 1) if broadcast else b_shape
    a, b, h0, _, _ = scan_inputs(a_shape, b_shape)
    ta, tb, th0 = (torch.tensor(x, requires_grad=True) for x in (a, b, h0))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        h, _ = ssm.linear_scan(ta, tb, th0, chunk=8)
    assert sorted(saved) == sorted([a_shape, tuple(h.shape), th0.shape])


def test_causal_conv_with_a_state():
    """With a state and S > 1 the conv equals the stateless conv over the
    state's sequence followed by the chunk, bit for bit, and its new
    state is the last K-1 inputs; at S = 1 it equals the reference's
    decode path."""
    rng = np.random.default_rng(3)
    B, C, K = 2, 6, 4
    seq = torch.from_numpy(rng.normal(size=(B, 9, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(C, K)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    whole, none = ssm._causal_conv(seq, w, bias)
    assert none is None
    y, state = ssm._causal_conv(seq[:, 4:], w, bias, seq[:, 1:4])
    assert torch.equal(y, whole[:, 4:])
    assert torch.equal(state, seq[:, -3:])
    # a chunk shorter than the ring keeps part of the old state
    y, state = ssm._causal_conv(seq[:, 4:6], w, bias, seq[:, 1:4])
    assert torch.equal(state, seq[:, 3:6])
    for t in (3, 8):
        got, got_state = ssm._causal_conv(seq[:, t:t + 1], w, bias,
                                          seq[:, t - 3:t])
        want, want_state = jssm._causal_conv(
            jnp.asarray(seq[:, t:t + 1].numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(bias.numpy()), jnp.asarray(seq[:, t - 3:t].numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        assert np.array_equal(got_state.numpy(), np.asarray(want_state))


def block_check(jinit, jblock, tblock, kw, S: int = 10, chunk: int = 4):
    """One block's output and the gradients of a weighted sum of it with
    respect to x and every parameter, JAX against the port, on the smoke
    config's widths (S = 10 over chunks of 4: the last one ragged; the
    port's Mamba-1 block takes no chunk, its scan walks time in order on
    the card and its plain version scans in chunks of 256)."""
    cfg = get_config(ARCH if jblock is jssm.mamba1_block else "zamba2-1.2b",
                     smoke=True)
    jp = jinit(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, _ = jblock(x, p, scan_chunk=chunk, **kw(cfg))
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, x)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    chunked = {} if tblock is ssm.mamba1_block else {"scan_chunk": chunk}
    out, state = tblock(tx, tp, **chunked, **kw(cfg))
    assert state is None
    (out * torch.from_numpy(w)).sum().backward()

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    close(out, jout, "out")
    close(tx.grad, jgx, "x")
    for k in jp:
        close(tp[k].grad, jgp[k], k)


def test_mamba1_block_matches_jax():
    block_check(
        lambda key, c: jssm.init_mamba1(key, c.d_model, c.d_inner,
                                        c.ssm_state, c.ssm_conv, c.dt_rank,
                                        jnp.float32),
        jssm.mamba1_block, ssm.mamba1_block,
        lambda c: dict(ssm_state=c.ssm_state, dt_rank=c.dt_rank))


def test_deterministic_inits_equal_the_reference():
    """``A_log`` = log(1..N), ``dt_bias`` -4.6, ``D_skip`` ones,
    ``conv_b`` zeros: drawn by neither generator, so the port's own init
    gives the reference's."""
    cfg = get_config(ARCH, smoke=True)
    want = jinit_model(jget_config(ARCH, smoke=True), jax.random.PRNGKey(0))
    got = params_to_jax({k: v.detach() for k, v in init_model(
        cfg, torch.Generator().manual_seed(0)).named_parameters()})
    for name in ("A_log", "dt_bias", "D_skip", "conv_b"):
        np.testing.assert_array_equal(
            got["layers"]["mamba"][name].numpy(),
            np.asarray(want["layers"]["mamba"][name]), err_msg=name)


def test_carrier_round_trip():
    want = check_round_trip(ARCH)
    cfg = get_config(ARCH, smoke=True)
    assert want["layers/mamba/A_log"].shape == \
        (cfg.n_layers, cfg.d_inner, cfg.ssm_state)
    assert want["layers/mamba/x_proj"].shape == \
        (cfg.n_layers, cfg.d_inner, cfg.dt_rank + 2 * cfg.ssm_state)


def test_forward_matches_jax():
    check_forward(ARCH)


@pytest.mark.parametrize("kernel", [False, True])
def test_one_step_matches_jax(kernel):
    check_one_step(ARCH, kernel)


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    return jax_loop(ARCH, tmp_path_factory.mktemp("ssm") / "init", 12)


@pytest.mark.parametrize("kernel", [True, False])
def test_loop_trace_matches_jax(jax_trace, kernel):
    check_loop(ARCH, *jax_trace, kernel)


def test_prefill_and_serve_steps_match_jax():
    """The fused prefill (one chunk through the scan) against the
    reference's ``prefill_scan`` (a loop over the prompt's positions),
    then serve steps, logits and the final state."""
    check_decode(ARCH)


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_matches_jax(last_only):
    check_prefill_step(ARCH, last_only)


def check_chunked_prefill(arch: str) -> None:
    """A 12-token prompt prefilled in chunks of 5, 1 and 6 against 12
    one-token serve steps: logits of each chunk's last position and every
    cache tensor within rtol 1e-4 / atol 1e-5."""
    cfg, _, model = carried(arch)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32))
    prefill, serve = make_prefill_decode_step(cfg), make_serve_step(cfg)
    loop = init_cache(cfg, 2, 12, device="cpu")
    per_pos = []
    for t in range(12):
        lg, loop = serve(model, loop, tok[:, t:t + 1])
        per_pos.append(lg)
    chunked = init_cache(cfg, 2, 12, device="cpu")
    for t0, t1 in ((0, 5), (5, 6), (6, 12)):
        lg, chunked = prefill(model, chunked, tok[:, t0:t1])
        np.testing.assert_allclose(lg.numpy(), per_pos[t1 - 1].numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert chunked["len"] == loop["len"] == 12
    for name in set(loop) - {"len"}:
        np.testing.assert_allclose(chunked[name].numpy(), loop[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_fused_prefill_equals_a_token_loop():
    check_chunked_prefill(ARCH)


def test_decode_state_does_not_grow_with_max_seq():
    cfg = get_config(ARCH, smoke=True)
    jcfg = jget_config(ARCH, smoke=True)
    for max_seq in (4, 100, 500_000):
        got = init_cache(cfg, 2, max_seq, device="cpu")
        want = jinit_cache(jcfg, 2, 4)
        assert set(got) == set(want) == {"len", "conv", "h"}
        for name in ("conv", "h"):
            assert tuple(got[name].shape) == tuple(want[name].shape)
        assert got["h"].dtype == torch.float32
    assert tuple(got["h"].shape) == (cfg.n_layers, 2, cfg.d_inner,
                                     cfg.ssm_state)


def test_launch_train_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch",
                       "2", "--seq", "16", "--kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "0 overflow" in out
