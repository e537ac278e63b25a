"""The port's `train_loop` against `repro.train.loop.train_loop`, and its
own invariants.

Both loops start from one checkpoint in the JAX on-disk format: the JAX
smoke model's init (``init_model(cfg, PRNGKey(0))``) with a warm
AdaGrad accumulator (uniform in [0.5, 1.5] x 1e-4).  From a zero
accumulator AdaGrad's first step is about ``lr * sign(g)``, and ulp-level
differences between XLA's and PyTorch's matmul sums flip the update of
near-zero gradient elements; the trace then drifts chaotically (measured
2e-4 relative at step 34 on the smollm smoke config).  From the warm
start the 50-step traces agree to about 3e-7; the tolerance is rtol 1e-4
/ atol 1e-5.  ``refresh_every`` and ``pipeline_depth`` are pinned: left
automatic, the controller hill-climbs on wall-clock reward and two runs
need not take the same knob path.  ``cache_capacity`` stays automatic (it
is driven by intent, not by the clock).
"""

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.registry import get_config as jget_config
from repro.models.model import init_model as jinit_model
from repro.optim.optimizers import AdaGradState
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import train_loop as jtrain_loop
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.train.loop import LoopConfig, train_loop

ARCHS = ["nemotron-4-15b", "smollm-135m"]
PINNED = dict(batch=2, seq=16, refresh_every=2, pipeline_depth=1,
              log_every=0)
COUNTERS = ("plans", "refreshes", "overflows", "capacity_resizes",
            "recompiles")


def warm_start(arch: str, path) -> str:
    jp = jinit_model(jget_config(arch, smoke=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    acc = jax.tree_util.tree_map(
        lambda x: (rng.uniform(0.5, 1.5, size=x.shape) * 1e-4)
        .astype(np.float32), jp)
    jckpt.save(str(path), {"params": jp, "opt": AdaGradState(acc)}, 0)
    return str(path)


@pytest.mark.parametrize("arch", ARCHS)
def test_loop_trace_matches_jax(arch, tmp_path):
    init = warm_start(arch, tmp_path / "init")
    kw = dict(PINNED, steps=50, init_from=init)
    want = jtrain_loop(jget_config(arch, smoke=True), JLoopConfig(**kw))
    got = train_loop(get_config(arch, smoke=True),
                     LoopConfig(kernel=True, **kw), device="cpu")
    assert len(got.losses) == len(want.losses) == 50
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                               atol=1e-5)
    assert want.losses[-1] < want.losses[0]
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.knobs == want.knobs


def test_no_overflow_over_200_steps():
    ops.reset_launch_counts()
    res = train_loop(get_config("nemotron-4-15b", smoke=True),
                     LoopConfig(steps=200, batch=4, seq=32, kernel=True,
                                log_every=0), device="cpu")
    assert res.overflows == 0 and len(res.losses) == 200
    assert np.all(np.isfinite(res.losses))
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_depth_does_not_change_the_trace(arch):
    """Deferred loss blocking, plan-ahead and the delta refresh are exact:
    depth 0 and depth 2 give the same losses bit for bit."""
    cfg = get_config(arch, smoke=True)
    runs = [train_loop(cfg, LoopConfig(steps=40, batch=2, seq=16,
                                       cache_capacity=64, refresh_every=2,
                                       pipeline_depth=d, kernel=True,
                                       log_every=0), device="cpu")
            for d in (0, 2)]
    assert runs[0].losses == runs[1].losses
    assert runs[0].refreshes == runs[1].refreshes


def test_checkpoints_cross_both_ways(tmp_path):
    """A checkpoint the port's loop writes restores into the JAX loop and
    the other way round; from either, the two loops then train alike."""
    arch = "nemotron-4-15b"
    init = warm_start(arch, tmp_path / "init")
    kw = dict(PINNED, steps=7, init_from=init, ckpt_every=6)
    train_loop(get_config(arch, smoke=True),
               LoopConfig(kernel=True, ckpt_dir=str(tmp_path / "port"),
                          **kw), device="cpu")
    jtrain_loop(jget_config(arch, smoke=True),
                JLoopConfig(ckpt_dir=str(tmp_path / "jax"), **kw))
    for src in ("port", "jax"):
        kw2 = dict(PINNED, steps=6, init_from=str(tmp_path / src))
        want = jtrain_loop(jget_config(arch, smoke=True), JLoopConfig(**kw2))
        got = train_loop(get_config(arch, smoke=True),
                         LoopConfig(kernel=True, **kw2), device="cpu")
        assert got.start_step == want.start_step == 6
        np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4,
                                   atol=1e-5)


def test_train_loop_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(get_config("smollm-135m", smoke=True),
                   LoopConfig(steps=1, log_every=0))
