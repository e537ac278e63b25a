"""The encdec family (whisper-medium's smoke config: a non-causal
encoder over frame embeddings, decoder layers with cross-attention,
tied embeddings) against the JAX package, with the JAX weights carried
across on the same numpy inputs (`test_torch_families`): the forward and
loss within rtol 1e-5, one step of each arm (whisper is tied: both take
the dense arm, ``kernel=True`` with the segmented scatter in the
lookup's backward) and a 12-step managed loop's loss trace within rtol
1e-4 / atol 1e-5, the encoder's output and the fused prefill and serve
steps (the cache's ``enc_out`` filled by `DenseLM.encode`) within rtol
1e-4 / atol 1e-5, and the weight carrier bit for bit, ``enc_layers``,
``cross`` and ``norm_x`` included.
"""

import numpy as np
import pytest
import torch

from test_torch_families import (check_decode, check_forward, check_loop,
                             check_one_step, check_prefill_step,
                             check_round_trip, extras, jax_loop)
from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models.model import (init_cache, init_model, load_params,
                                      params_from_jax, params_to_jax)
from test_torch_model import carried, leaves

ARCH = "whisper-medium"


def test_carrier_round_trip():
    want = check_round_trip(ARCH)
    cfg = get_config(ARCH, smoke=True)
    e = cfg.encoder
    assert want["enc_layers/attn/wq"].shape == \
        (e.n_layers, cfg.d_model, cfg.d_model)
    assert want["layers/cross/wk"].shape == \
        (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert want["layers/norm_x/bias"].shape == (cfg.n_layers, cfg.d_model)
    assert want["enc_norm/scale"].shape == (cfg.d_model,)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A tree the JAX package writes loads into the port, and the tree
    the port writes loads into the JAX package, leaf for leaf."""
    cfg, jp, model = carried(ARCH)
    jckpt.save(str(tmp_path / "jax"), jp, 3)
    other = init_model(cfg, torch.Generator().manual_seed(5))
    like = params_to_jax({k: v.detach() for k, v in
                          other.named_parameters()})
    tree, step = checkpoint.load(str(tmp_path / "jax"), like)
    assert step == 3
    load_params(other, params_from_jax(tree))
    for (k, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), k
    checkpoint.save(str(tmp_path / "port"), params_to_jax(
        {k: v.detach() for k, v in other.named_parameters()}), 4)
    back, step = jckpt.load(str(tmp_path / "port"), jp)
    assert step == 4
    want, got = leaves(jp), leaves(back)
    assert set(got) == set(want) and any(k.startswith("enc_layers/")
                                         for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_forward_with_frames_matches_jax():
    check_forward(ARCH)


def test_the_decoder_reads_the_frames():
    cfg = get_config(ARCH, smoke=True)
    model = init_model(cfg, torch.Generator().manual_seed(0))
    tok = torch.zeros((2, 4), dtype=torch.int32)
    fr = torch.from_numpy(extras(cfg, 2, 4, seed=1)["frames"])
    with torch.no_grad():
        a, _, _ = model({"tokens": tok, "frames": fr})
        b, _, _ = model({"tokens": tok, "frames": fr.flip(1)})
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("kernel", [False, True])
def test_one_step_matches_jax(kernel):
    check_one_step(ARCH, kernel)


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    return jax_loop(ARCH, tmp_path_factory.mktemp("encdec") / "init", 12)


@pytest.mark.parametrize("kernel", [True, False])
def test_loop_trace_matches_jax(jax_trace, kernel):
    check_loop(ARCH, *jax_trace, kernel)


def test_prefill_and_serve_steps_match_jax():
    check_decode(ARCH)


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_step_matches_jax(last_only):
    check_prefill_step(ARCH, last_only)


def test_cache_holds_the_encoder_output():
    cfg = get_config(ARCH, smoke=True)
    cache = init_cache(cfg, 3, 10, device="cpu")
    assert tuple(cache["enc_out"].shape) == \
        (3, cfg.encoder.n_frames, cfg.d_model)
    assert not cache["enc_out"].any()
    assert tuple(cache["k"].shape) == \
        (cfg.n_layers, 3, 10, cfg.n_kv_heads, cfg.head_dim)


def test_launch_train_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--steps", "3", "--batch", "2",
                       "--seq", "16", "--kernel", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "0 overflow" in out
