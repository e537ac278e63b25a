"""The dry run's memory record (`repro_torch.launch.dryrun.StepCounter`'s
live bytes) and the layout of the gradients the dense AdaGrad takes.

* The counter on plain fake tensors against torch's own tracker,
  `MemTracker`, on real CPU tensors running the same step (smollm-135m's
  smoke config, a training step and a decode step, bf16 weights as the
  dry run's): the same peak, exactly, and the counter run on those real
  tensors gives it too.
* The counter on DTensors against `MemTracker` on the same step's real
  shards on 2 gloo ranks: the same peak in each part of the step,
  exactly, on fake shards as on real ones.
* Each gradient laid out as its parameter before the update
  (`models.layouts.as_param`): on the fake 2 x 2 mesh, the update's
  collectives are one reduction of each gradient that held partial sums
  for each mesh dimension it was partial over, at the gradient's own
  dtype (bf16), and nothing else; on plain tensors the training step's
  parameters and accumulators are bit for bit those of the update on the
  backward's own gradients, in both arms.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._pytree import tree_leaves

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.data.batches import make_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh, run_ranks
from repro_torch.models.model import DenseLM, init_cache
from repro_torch.optim.optimizers import AdaGradState
from repro_torch.pm.embedding import make_state
from repro_torch.train import steps
import _mesh_ranks as R

B, S = 4, 32


@pytest.fixture(scope="module")
def mesh():
    yield fake_mesh((2, 2), ("data", "model"))
    if dist.is_initialized():
        dist.destroy_process_group()


def real_call(cfg, kind: str):
    """The step `dryrun.trace_step` traces for ``kind`` with its default
    knobs, on real CPU tensors: seeded bf16 weights, fp32 accumulators
    and a `make_batch` batch (training), or a zero cache at its last
    position and one token a sequence (decoding)."""
    gen = torch.Generator()
    gen.manual_seed(0)
    model = DenseLM(cfg, gen, dryrun.PARAM_DTYPE)
    if kind == "train":
        opt = AdaGradState({n: torch.zeros(p.shape)
                            for n, p in model.named_parameters()})
        batch = make_batch(cfg, B, S, np.random.default_rng(0))
        return steps.make_train_step(cfg), (model, opt, batch)
    cache = init_cache(cfg, B, S, dtype=dryrun.PARAM_DTYPE, device="cpu")
    cache["len"] = S - 1
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                           dtype=torch.int32)
    return steps.make_serve_step(cfg), (model, cache, tokens)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_counter_against_memtracker_on_real_tensors(kind):
    cfg = get_config("smollm-135m", smoke=True)
    fake = dryrun.trace_step(cfg, InputShape("s", S, B, kind), None,
                             distributed=False)
    step, args = real_call(cfg, kind)
    tracker = MemTracker()
    tracker.track_external(*[t for a in args for t in dryrun._tensors(a)])
    with tracker:
        step(*args)
    want = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]
    step, args = real_call(cfg, kind)
    real = dryrun.StepCounter("forward" if kind == "train" else kind)
    real.hold([dryrun._tensors(a) for a in args])
    with real:
        step(*args)
    assert max(fake.peak_per_phase.values()) == want["Total"] \
        == max(real.peak_per_phase.values())
    assert fake.peak_per_phase == real.peak_per_phase


def test_sharded_peak_on_two_gloo_ranks():
    """The counter's rules for DTensors (which fake tensors and which real
    ones a device holds, a collective's result held once) against
    `MemTracker` on real shards: one training step of qwen3-moe-30b-a3b
    and zamba2-1.2b (smoke configs) on 2 gloo ranks, on a
    (1, 2) mesh (tensor parallel) and a (2, 1) mesh (ZeRO over "data"),
    parameters, accumulators and batch placed by the specs
    (`_mesh_ranks.dtensor_peaks`): on each rank the counter's peak of
    every part of the step on fake shards equals its peak on the real
    shards, exactly, and the highest equals `MemTracker`'s total peak."""
    archs = ("qwen3-moe-30b-a3b", "zamba2-1.2b")
    shapes = ((1, 2), (2, 1))
    outs = run_ranks(R.dtensor_peaks, 2, archs, shapes, timeout_s=300)
    for rank in outs:
        assert len(rank) == len(archs) * len(shapes)
        for key, (fake, real, tracked) in rank.items():
            assert set(fake) == {"forward", "backward", "update",
                                 "update/adagrad"}, key
            assert fake == real, key
            assert max(real.values()) == tracked, key


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b"])
def test_one_reduction_of_each_gradient(mesh, monkeypatch, arch):
    """smollm-135m (tied) and zamba2-1.2b (its shared block's gradient
    summed over two applications): every collective of the update phase
    falls inside a gradient's `as_param`, whose collectives are one for
    each mesh dimension the gradient was partial over, each on the
    tensor as the previous one left it, from the gradient cut to the
    parameter's shards where it was whole (an all-reduce counts twice
    its bytes, a reduce-scatter its result's, which halves it on this
    mesh), in bf16."""
    calls, grads = [], []
    count, lay_out = dryrun.StepCounter.collective, steps.as_param

    def collective(self, func, out):
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and func._overloadpacket.__name__ in dryrun._FUNCOL:
            t, = tree_leaves(out)
            calls.append((self.phase, func._overloadpacket.__name__,
                          t.numel() * t.element_size(), t.dtype))
        count(self, func, out)

    def as_param(g, p):
        first = len(calls)
        out = lay_out(g, p)
        grads.append((g, calls[first:], p))
        return out

    monkeypatch.setattr(dryrun.StepCounter, "collective", collective)
    monkeypatch.setattr(steps, "as_param", as_param)
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=3)
    t = dryrun.trace_step(cfg, InputShape("t", S, B, "train"), mesh)
    update = [c for c in calls if c[0] == "update"]
    assert update and sum(len(c) for _, c, _ in grads) == len(update)
    partial = 0
    for g, made, p in grads:
        # the reductions start from g cut to p's shards where g is whole
        n = g._local_tensor.numel() * g.element_size()
        for i, (pl, q) in enumerate(zip(g.placements, p.placements)):
            if pl.is_replicate() and q.is_shard():
                n //= mesh.size(i)
        assert len(made) == sum(pl.is_partial() for pl in g.placements)
        partial += bool(made)
        for _, op, nbytes, dtype in made:
            assert dtype == torch.bfloat16 == g.dtype
            if op.startswith("all_reduce"):
                assert nbytes == n
            else:
                assert op.startswith("reduce_scatter") and nbytes == n // 2
                n //= 2
    assert partial > 0
    per_op = t.collective_bytes_per_phase["update"]
    assert sum(per_op.values()) == sum(
        (2 if op.startswith("all_reduce") else 1) * n
        for _, op, n, _ in update)


@pytest.mark.parametrize("arch, managed", [("smollm-135m", False),
                                           ("qwen3-moe-30b-a3b", True)])
def test_plain_update_is_bit_for_bit(monkeypatch, arch, managed):
    """The training step on plain tensors (smollm-135m's dense arm;
    qwen3-moe-30b-a3b's fused arm, whose dense AdaGrad updates every
    parameter but the table) against the same step updating from the
    backward's own gradients, as before they were laid out: parameters
    and accumulators equal bit for bit, and the laid-out gradients are
    the backward's tensors themselves."""
    cfg = get_config(arch, smoke=True)
    T = B * S
    kw = dict(pm_miss_capacity=T, pm_kernel=True) if managed else {}

    def run(laid_out):
        monkeypatch.setattr(steps, "laid_out_grads", laid_out)
        gen = torch.Generator()
        gen.manual_seed(0)
        model = DenseLM(cfg, gen)
        opt = steps.make_opt_init()(model)
        batch = make_batch(cfg, B, S, np.random.default_rng(0))
        if managed:
            ids = torch.arange(0, cfg.vocab_size, 8, dtype=torch.int32)
            batch.update(pm_cache_ids=ids, pm_cache_rows=make_state(
                model.embed.detach(), ids).cache_rows)
        step = steps.make_train_step(cfg, lr=0.01, **kw)
        for _ in range(2):
            step(model, opt, batch)
        return dict(model.named_parameters()), opt.accum

    new = steps.laid_out_grads
    seen = []

    def checked(params):
        before = {k: p.grad for k, p in params.items()}
        out = new(params)
        seen.append(all(out[k] is before[k] for k in out))
        return out

    p_new, a_new = run(checked)
    p_old, a_old = run(lambda params: {k: p.grad for k, p in params.items()
                                       if p.grad is not None})
    assert seen == [True, True]
    for k in p_old:
        assert torch.equal(p_new[k], p_old[k]), k
        assert torch.equal(a_new[k], a_old[k]), k
