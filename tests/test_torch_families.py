"""Checks shared by the vlm, encdec, ssm and hybrid parity files
(`test_torch_vlm.py`, `test_torch_encdec.py`, `test_torch_ssm.py`,
`test_torch_hybrid.py`; this module holds no test of its own, as
`test_torch_model.py` lends its helpers to the MoE file): the same
numpy inputs, made from a seed, go
through the JAX reference (its plain paths) and through the port, with the
JAX weights carried across (`params_from_jax`).

Batches carry each family's extra inputs: the vlm family's image-patch
embeddings written at ``img_pos`` and M-RoPE positions whose t, h and w
coordinates differ over the image rows (a 2 x 2 patch grid per image,
text positions continuing after it, as Qwen2-VL numbers them); the
encdec family's frame embeddings; the ssm and hybrid families need
none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import _encoder as jencoder
from repro.models.model import forward as jforward
from repro.models.model import init_cache as jinit_cache
from repro.models.model import loss_fn as jloss_fn
from repro.optim import optimizers as jopt
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train_loop as jtrain_loop
from repro.train.steps import make_prefill_decode_step as jmake_prefill
from repro.train.steps import make_prefill_step as jmake_prefill_step
from repro.train.steps import make_serve_step as jmake_serve_step
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models.model import (init_cache, loss_fn, params_from_jax,
                                      params_to_jax)
from repro_torch.pm.embedding import make_state
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import (make_opt_init, make_prefill_decode_step,
                                     make_prefill_step, make_serve_step,
                                     make_train_step)
from test_torch_model import batch, carried, leaves, managed_batch, warm_accum
from test_torch_train import PINNED, warm_start


def extras(cfg, B: int, S: int, seed: int) -> dict:
    """The family's extra batch fields as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        n = 4                                  # one 2 x 2 image per row
        out["img_embeds"] = (rng.normal(size=(B, n, cfg.d_model)) * 0.02) \
            .astype(np.float32)
        out["img_pos"] = np.stack([np.arange(1, 1 + n) + b
                                   for b in range(B)]).astype(np.int32)
        pos = np.zeros((B, S, 3), np.int32)
        for b in range(B):
            p0 = int(out["img_pos"][b, 0])
            pos[b, :p0] = np.arange(p0)[:, None]
            for i in range(n):                 # t fixed, h row, w column
                pos[b, p0 + i] = (p0, p0 + i // 2, p0 + i % 2)
            rest = np.arange(S - p0 - n)
            pos[b, p0 + n:] = (p0 + 2 + rest)[:, None]
        out["positions"] = pos
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return out


def jax_of(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


def torch_of(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in d.items()}


def check_round_trip(arch: str) -> dict:
    cfg, jp, model = carried(arch)
    back = leaves(params_to_jax({k: v.detach() for k, v in
                                 model.named_parameters()}))
    want = leaves(jp)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    return want


def check_forward(arch: str) -> None:
    """Logits and loss of one batch with the family's extra inputs."""
    cfg, jp, model = carried(arch)
    tok, lab = batch(cfg, 1)
    ex = extras(cfg, *tok.shape, seed=2)
    jl, _, _ = jforward(jp, jget_config(arch, smoke=True),
                        dict(jax_of(ex), tokens=jnp.asarray(tok)))
    with torch.no_grad():
        tl, aux, _ = model(dict(torch_of(ex), tokens=torch.from_numpy(tok)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        float(loss_fn(tl, torch.from_numpy(lab), aux)),
        float(jloss_fn(jl, jnp.asarray(lab))), rtol=1e-5)


def check_one_step(arch: str, kernel: bool) -> None:
    """One managed step of the port (``kernel``: the hand-written
    kernels' arm, their plain versions on the CPU) against JAX's plain
    dense step, from a warm accumulator, with the family's extra
    inputs."""
    cfg, jp, model = carried(arch)
    M = 64
    tok, lab = batch(cfg, 3)
    ex = extras(cfg, *tok.shape, seed=4)
    jacc = warm_accum(jp)
    jb, cache, n_miss = managed_batch(cfg, jp, tok, lab, M)
    jstep = jmake_train_step(jget_config(arch, smoke=True), lr=0.01,
                             pm_miss_capacity=M, pm_kernel=False)
    jl, jp2, js2 = jstep(jp, jopt.AdaGradState(jacc),
                         dict(jb, **jax_of(ex)))

    state = make_opt_init()(model)
    for k, v in params_from_jax(jacc).items():
        state.accum[k].copy_(torch.from_numpy(np.array(v)))
    tc = torch.from_numpy(cache)
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab),
          "pm_cache_ids": tc,
          "pm_cache_rows": make_state(model.embed.detach(), tc).cache_rows,
          "pm_n_miss": n_miss, **torch_of(ex)}
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


def jax_loop(arch: str, path, steps: int):
    """The reference loop's run from a warm start; returns the loop
    arguments and its result."""
    kw = dict(PINNED, steps=steps, init_from=warm_start(arch, path))
    return kw, jtrain_loop(jget_config(arch, smoke=True), JLoopConfig(**kw))


def check_loop(arch: str, kw: dict, want, kernel: bool) -> None:
    ops.reset_launch_counts()
    got = train_loop(get_config(arch, smoke=True),
                     LoopConfig(kernel=kernel, **kw), device="cpu")
    assert len(got.losses) == len(want.losses) == kw["steps"]
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                               atol=1e-5)
    assert got.overflows == want.overflows == 0
    assert got.plans == want.plans and got.refreshes == want.refreshes
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions


def check_decode(arch: str, P: int = 6, N: int = 5, B: int = 2) -> None:
    """The fused prefill, then N one-token serve steps fed the JAX run's
    greedy tokens; an encoder-decoder cache first takes the encoder's
    output over the batch's frames (checked against the reference's
    `_encoder`).  Logits within rtol 1e-4 / atol 1e-5 at every step, and
    every cache tensor at the end."""
    cfg, jp, model = carried(arch)
    jcfg = jget_config(arch, smoke=True)
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, P)).astype(np.int32)
    jcache = jinit_cache(jcfg, B, P + N)
    cache = init_cache(cfg, B, P + N, device="cpu")
    assert set(cache) == set(jcache)
    for name in set(cache) - {"len"}:
        assert tuple(cache[name].shape) == tuple(jcache[name].shape), name
    if cfg.family == "encdec":
        frames = extras(cfg, B, P, seed=6)["frames"]
        jcache["enc_out"] = jencoder(jp, jcfg, jnp.asarray(frames))
        with torch.no_grad():
            cache["enc_out"] = model.encode(torch.from_numpy(frames))
        np.testing.assert_allclose(cache["enc_out"].numpy(),
                                   np.asarray(jcache["enc_out"]), rtol=1e-5,
                                   atol=1e-5)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)

    jl, jcache = jax.jit(jmake_prefill(jcfg))(jp, jcache, jnp.asarray(tok))
    tl, cache = make_prefill_decode_step(cfg)(model, cache,
                                              torch.from_numpy(tok))
    close(tl, jl)
    jserve, serve = jax.jit(jmake_serve_step(jcfg)), make_serve_step(cfg)
    for _ in range(N):
        nxt = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
        jl, jcache = jserve(jp, jcache, jnp.asarray(nxt))
        tl, cache = serve(model, cache, torch.from_numpy(nxt))
        close(tl, jl)
    assert cache["len"] == int(jcache["len"]) == P + N
    for name in set(cache) - {"len"}:
        close(cache[name], jcache[name])


def check_prefill_step(arch: str, last_only: bool) -> None:
    """The forward-only prefill over a batch with the family's extra
    inputs."""
    cfg, jp, model = carried(arch)
    tok, _ = batch(cfg, 5)
    ex = extras(cfg, *tok.shape, seed=7)
    want = jmake_prefill_step(jget_config(arch, smoke=True),
                              last_only=last_only)(
        jp, dict(jax_of(ex), tokens=jnp.asarray(tok)))
    got = make_prefill_step(cfg, last_only=last_only)(
        model, dict(torch_of(ex), tokens=torch.from_numpy(tok)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
