"""The port's dry run (`repro_torch.launch.dryrun`): each family's smoke
config, deepened past its cut depths (`deep`), through its train,
prefill and serve steps on a fake 2 x 2 ("data", "model") mesh of
DTensors, nothing allocated.

* ``status`` ok, and the argument bytes equal the per-device shard sizes
  computed from the reference's specs (`repro.launch.sharding`, over the
  reference's parameter and input structs, on a stand-in mesh);
* the unit-scaled counts (`depth_variants`) equal a trace at the full
  depth, FLOPs and every collective's bytes, in each part of the step;
* the memory record: the output bytes equal those of the reference's
  specs (parameters, accumulators and the loss; the logits and the
  cache), the peak in each part equals the full trace's and is at least
  the argument bytes, which the counter holds at the step's entry;
* the global FLOPs equal `FlopCounterMode`'s count of the same step on
  plain fake tensors (no DTensor);
* no collective on a 1 x 1 mesh, and some on 2 x 2.

The FSDP gather runs for real on 2 gloo ranks (`launch.mesh.run_ranks`):
the training step's losses with DTensor parameters placed by the specs
equal the plain step's within rtol 1e-6, on a (1, 2) mesh (tensor
parallel) and a (2, 1) mesh (ZeRO over "data", gathered by
``fsdp_spec``).  The CLI runs once in a subprocess on the production
mesh, as the reference's slow test does.
"""

import dataclasses
import functools
import json
from collections import Counter
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

# the reference's dry-run module sets a host-device flag for the
# processes that run it; a test process keeps its own
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
import _mesh_ranks as R  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_mesh, run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"train": InputShape("train_smoke", 32, 4, "train"),
          "prefill": InputShape("prefill_smoke", 32, 4, "prefill"),
          "decode": InputShape("decode_smoke", 32, 4, "decode")}
FAMILIES = ("smollm-135m", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
            "whisper-medium", "falcon-mamba-7b", "zamba2-1.2b")


def deep(cfg):
    """A smoke config (the port's or the reference's) deeper than its
    cut depths (`dryrun.depth_variants`), so that the dry run's scaled
    counts are not a trace of the whole: stacks of 5 layers (traced at
    2 and 3), zamba2 with 7 and its shared block before every second (4
    applications: training traced at 3 and 5 layers, forward at 2 and 3
    layers applying it twice, and 3 thrice), whisper's 4 decoder and 4
    encoder layers (traced at 2 + 2, 3 + 2 and 2 + 3)."""
    if cfg.encoder is not None:
        return dataclasses.replace(cfg, n_layers=4, encoder=dataclasses
                                   .replace(cfg.encoder, n_layers=4))
    return dataclasses.replace(cfg, n_layers=7 if cfg.family == "hybrid"
                               else 5)


@functools.lru_cache(maxsize=None)
def traced(cfg, kind: str, mesh) -> "dryrun.StepCounter":
    """`dryrun.trace_step` of ``kind``'s smoke shape at ``cfg``'s depth
    with the default knobs (once for the tests that share it)."""
    return dryrun.trace_step(cfg, SHAPES[kind], mesh)


def counts(cfg, kind: str, mesh) -> list:
    """The counts of `depth_variants` of ``cfg`` for `dryrun_one`."""
    return [dryrun._counts(traced(c, kind, mesh), 0.0)
            for c, _ in dryrun.depth_variants(cfg, kind == "train")]


@pytest.fixture(scope="module")
def mesh():
    """A fake 2 x 2 mesh; the fake process group is gone after the
    module."""
    yield fake_mesh((2, 2), ("data", "model"))
    if dist.is_initialized():
        dist.destroy_process_group()


def reference_bytes(arch: str, shape: InputShape, *,
                    pm_miss_capacity: int = 0,
                    zero_embed_head: bool = True) -> dict:
    """One device's bytes of the step's arguments from the reference's
    specs (its `deep` smoke config) on a stand-in 2 x 2 mesh, by part: ``params`` in bf16,
    ``accum`` (fp32 AdaGrad accumulators, when training) and ``inputs``
    (the batch; or the cache, the cache's ``len``, a host integer in the
    port, left out, and the tokens; with ``pm_miss_capacity``, the
    replica cache's ids and rows that the reference's dry run adds to
    the batch), and the decode cache's share of them, ``cache``."""
    jcfg = deep(jget_config(arch, smoke=True))
    jmesh = SimpleNamespace(axis_names=("data", "model"),
                            shape={"data": 2, "model": 2})

    def nbytes(sds, spec):
        n = np.dtype(sds.dtype).itemsize
        for d, ax in zip(sds.shape, tuple(spec) + (None,) * len(sds.shape)):
            for a in (() if ax is None else ax if isinstance(ax, tuple)
                      else (ax,)):
                assert d % jmesh.shape[a] == 0
                d //= jmesh.shape[a]
            n *= d
        return n

    def total(tree, specs):
        return sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            nbytes, tree, specs,
            is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))))

    p = jdryrun.params_specs(jcfg)
    pspec = jsharding.param_pspecs(p, jcfg, jmesh, zero_layers=True,
                                   zero_embed_head=zero_embed_head)
    out = {"params": total(p, pspec), "accum": 0, "cache": 0}
    if shape.kind == "train":
        out["accum"] = total(jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), p), pspec)
    inputs = jdryrun.input_specs(jcfg, shape)
    if pm_miss_capacity:
        C = 4096
        inputs = dict(inputs,
                      pm_cache_ids=jax.ShapeDtypeStruct((C,), np.int32),
                      pm_cache_rows=jax.ShapeDtypeStruct(
                          (C, jcfg.d_model), jdryrun.PARAM_DTYPE))
    if shape.kind != "decode":
        out["inputs"] = total(inputs, jsharding.batch_pspecs(jcfg, jmesh,
                                                             inputs))
        return out
    cache = {k: v for k, v in inputs["cache"].items() if k != "len"}
    cspec = jsharding.cache_pspecs(jcfg, jmesh, inputs["cache"])
    out["cache"] = total(cache, {k: cspec[k] for k in cache})
    tok = inputs["tokens"]
    out["inputs"] = out["cache"] + nbytes(
        tok, ("data" if shape.global_batch % 2 == 0 else None, None))
    return out


def reference_argument_bytes(arch: str, shape: InputShape, **kw) -> int:
    b = reference_bytes(arch, shape, **kw)
    return b["params"] + b["accum"] + b["inputs"]


def reference_output_bytes(arch: str, shape: InputShape) -> int:
    """One device's bytes of what the step returns, by the reference's
    specs: when training, the parameters and the accumulators (updated
    in place) and the fp32 loss; otherwise the last position's bf16
    logits (B, V), vocab-sharded over "model" with their partial sums
    over "data" pending (the head's ZeRO-sharded contraction), so whole
    over the batch, and when decoding the cache (written in place)."""
    b = reference_bytes(arch, shape)
    if shape.kind == "train":
        return b["params"] + b["accum"] + 4
    V = get_config(arch, smoke=True).vocab_size
    return b["cache"] + shape.global_batch * (V // 2) * 2


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_one_on_a_fake_mesh(mesh, arch, kind):
    """Each family's `deep` smoke config through each step, its record
    made from its cut depths' traces."""
    shape = SHAPES[kind]
    cfg = deep(get_config(arch, smoke=True))
    assert cfg not in [c for c, _ in dryrun.depth_variants(
        cfg, kind == "train")]
    rec = dryrun.dryrun_one(cfg, shape, mesh=mesh, verbose=False,
                            traced=counts(cfg, kind, mesh))
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    assert rec["arch"] == arch and rec["mesh"] == "2x2"
    assert rec["zero_layers_effective"] is True
    assert rec["memory"]["argument_bytes"] == \
        reference_argument_bytes(arch, shape)
    assert rec["collective_bytes"] == \
        sum(rec["collective_bytes_per_op"].values()) > 0
    assert set(rec["collective_bytes_per_op"]) == set(dryrun.COLLECTIVES)
    # the unit-scaled counts against the step at its full depth
    full = traced(cfg, kind, mesh)
    assert rec["flops"] == full.flops > 0
    assert rec["collective_bytes_per_op"] == full.collective_bytes
    assert rec["collective_bytes_per_phase"] == \
        full.collective_bytes_per_phase
    mem = rec["memory"]
    assert set(mem["peak_per_phase"]) == (
        {"forward", "backward", "update"} if kind == "train" else {kind})
    assert mem["peak_per_phase"] == full.peak_per_phase
    assert mem["peak_bytes"] == max(full.peak_per_phase.values()) \
        >= mem["argument_bytes"] == full.entry_bytes
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert mem["output_bytes"] == full.output_bytes == \
        reference_output_bytes(arch, shape)
    # the global FLOPs against torch's counter on plain fake tensors
    with FlopCounterMode(display=False) as fc:
        plain = dryrun.trace_step(cfg, shape, mesh, distributed=False)
    assert rec["flops"] == plain.flops == fc.get_total_flops()
    assert set(plain.collective_bytes.values()) == {0}


@pytest.mark.parametrize("arch, kind, layers", [
    ("zamba2-1.2b", "train", 7), ("whisper-medium", "train", 4),
    ("zamba2-1.2b", "decode", 7), ("qwen3-moe-30b-a3b", "train", 5),
    ("falcon-mamba-7b", "decode", 5), ("whisper-medium", "prefill", 4)])
def test_unit_scaling_at_a_deeper_stack(mesh, arch, kind, layers):
    """Deeper than the smoke configs and than the cut depths, so that
    the scaling is not the identity: zamba2 with 7 layers and the shared
    block before every second (4 applications; traced at 3 and 5 layers
    in training, and decoding at 2 and 3 layers applying it twice, and 3
    thrice), whisper with 4 decoder and 4 encoder layers (traced at 2 +
    2, 3 + 2 and 2 + 3), plain stacks of 5 (traced at 2 and 3); the
    scaled counts, the peak of each part of the step (`StepCounter`'s
    ``peak_per_part``) and the output bytes equal the full trace's.
    These are `deep` configs of `test_dryrun_one_on_a_fake_mesh`, whose
    traces are shared (`traced`), held here part by part where that test
    holds the record's phases."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=layers))
    full = traced(cfg, kind, mesh)
    variants = dryrun.depth_variants(cfg, kind == "train")
    assert cfg not in [c for c, _ in variants]
    flops = out = 0
    coll = dict.fromkeys(dryrun.COLLECTIVES, 0)
    peaks = dict.fromkeys(full.peak_per_part, 0)
    for c, coef in variants:
        t = traced(c, kind, mesh)
        flops += coef * t.flops
        out += coef * t.output_bytes
        for k, v in t.collective_bytes.items():
            coll[k] += coef * v
        for k, v in t.peak_per_part.items():
            peaks[k] += coef * v
    assert flops == full.flops and coll == full.collective_bytes
    assert peaks == full.peak_per_part and out == full.output_bytes


@pytest.mark.parametrize("knobs", [
    dict(vp_loss=True), dict(fsdp_gather=True), dict(zero_embed_head=False),
    dict(zero_layers=None), dict(remat_policy="dots"), dict(pad_vocab=True)])
def test_knobs(mesh, knobs):
    """The reference's knobs through smollm-135m's training step: the
    vocab-parallel loss, the FSDP gather and the layouts leave the FLOPs
    as they are; "dots" recomputes fewer products, a padded vocabulary
    adds head work."""
    base = dryrun.dryrun_one("smollm-135m", SHAPES["train"], smoke=True,
                             mesh=mesh, verbose=False,
                             traced=counts(get_config("smollm-135m",
                                                      smoke=True),
                                           "train", mesh))
    rec = dryrun.dryrun_one("smollm-135m", SHAPES["train"], smoke=True,
                            mesh=mesh, verbose=False, **knobs)
    assert rec["status"] == "ok" and rec["collective_bytes"] > 0
    for k, v in knobs.items():
        assert rec[k] == ("auto" if v is None else v)
    if "remat_policy" in knobs:
        assert 0 < rec["flops"] < base["flops"]
    elif "pad_vocab" in knobs:
        assert rec["flops"] > base["flops"]
    else:
        assert rec["flops"] == base["flops"]


@pytest.mark.parametrize("zero_embed_head", [True, False])
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b",
                                  "falcon-mamba-7b"])
def test_managed_step_on_a_fake_mesh(mesh, monkeypatch, arch,
                                     zero_embed_head):
    """The intent-managed embedding (``pm_miss_capacity``, strict, as the
    reference's dry run passes it) through the training step: the
    argument bytes with the replica cache in the batch, the scaled counts
    and memory of the `deep` config equal to its full trace, the FLOPs as
    for the unmanaged step, and no all-gather of the table's rows (the
    buffer comes from a masked lookup and the backward stays in each
    device's vocab block): of the all-gathers the managed step adds to
    the unmanaged step's at the smoke depth, none gives V rows."""
    shape = SHAPES["train"]
    knobs = dict(pm_miss_capacity=16, zero_embed_head=zero_embed_head)
    k = dryrun.Knobs(**knobs)
    cfg = deep(get_config(arch, smoke=True))
    gathered = []
    count = dryrun.StepCounter.collective

    def collective(self, func, out):
        if "all_gather" in func._overloadpacket.__name__:
            gathered.append(tuple(out.shape))
        count(self, func, out)

    monkeypatch.setattr(dryrun.StepCounter, "collective", collective)
    # the all-gathers at the smoke depth, the first cut depth
    (smoke, _), (c3, _) = dryrun.depth_variants(cfg, True)
    assert smoke == get_config(arch, smoke=True)
    at2 = dryrun.trace_step(smoke, shape, mesh, k)
    managed, gathered[:] = Counter(gathered), []
    dryrun.trace_step(smoke, shape, mesh,
                      dryrun.Knobs(zero_embed_head=zero_embed_head))
    added = managed - Counter(gathered)
    assert added and not [s for s in added if s[0] == cfg.vocab_size]
    rec = dryrun.dryrun_one(cfg, shape, mesh=mesh, verbose=False, traced=[
        dryrun._counts(t, 0.0) for t in (at2, dryrun.trace_step(
            c3, shape, mesh, k))], **knobs)
    assert rec["status"] == "ok" and rec["pm_miss_capacity"] == 16
    assert rec["memory"]["argument_bytes"] == \
        reference_argument_bytes(arch, shape, **knobs)
    full = dryrun.trace_step(cfg, shape, mesh, k)
    assert rec["flops"] == full.flops > 0
    assert rec["collective_bytes_per_op"] == full.collective_bytes
    assert rec["collective_bytes_per_phase"] == \
        full.collective_bytes_per_phase
    mem = rec["memory"]
    assert mem["peak_per_phase"] == full.peak_per_phase
    assert mem["argument_bytes"] == full.entry_bytes
    assert mem["output_bytes"] == full.output_bytes
    with FlopCounterMode(display=False) as fc:
        plain = dryrun.trace_step(cfg, shape, mesh, dryrun.Knobs(**knobs),
                                  distributed=False)
    assert rec["flops"] == plain.flops == fc.get_total_flops()


def test_auto_zero_is_decided_at_the_full_depth(mesh, monkeypatch):
    """``zero_layers=None`` (auto): the full config's decision holds in
    the traces at cut depth, whose own parameter counts would decide
    otherwise."""
    from repro_torch.launch import sharding
    deep = lambda cfg, mesh: cfg.n_layers >= 2       # noqa: E731
    monkeypatch.setattr(dryrun, "needs_zero", deep)
    monkeypatch.setattr(sharding, "needs_zero", deep)
    kw = dict(smoke=True, mesh=mesh, verbose=False)
    auto = dryrun.dryrun_one("qwen3-moe-30b-a3b", SHAPES["train"],
                             zero_layers=None, **kw)
    on = dryrun.dryrun_one("qwen3-moe-30b-a3b", SHAPES["train"],
                           zero_layers=True, **kw)
    assert auto["zero_layers"] == "auto" and auto["zero_layers_effective"]
    for k in ("flops", "collective_bytes_per_op", "memory"):
        assert auto[k] == on[k], k


def test_counter_sees_the_collectives_inside_an_op(mesh):
    """A collective DTensor makes inside an op (here the all-gather of a
    weight ZeRO-sharded along the contraction, which the product's rule
    cannot take) is counted as an explicit redistribution's is, once, as
    `CommDebugMode` counts it."""
    import torch
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    fakes = dryrun._Fakes(mesh)
    x = fakes.dtensor((8, 16, 64), torch.bfloat16, ("data", None, None))
    for spec, n in ((("data", "model"), 1), ((None, "model"), 0)):
        w = fakes.dtensor((64, 128), torch.bfloat16, spec)
        counter, comm = dryrun.StepCounter(), CommDebugMode()
        with implicit_replication(), counter:
            y = x @ w
        with implicit_replication(), comm:
            x @ w
        assert comm.get_total_counts() == n
        # the (64, 64) bf16 block of w whole over "data"
        assert counter.collective_bytes["all-gather"] == n * 64 * 64 * 2
        assert counter.flops == 2 * 8 * 16 * 64 * 128
        with implicit_replication(), counter:
            y.redistribute(mesh, [Replicate(), Replicate()])
        assert counter.collective_bytes["all-gather"] == \
            n * 64 * 64 * 2 + 8 * 16 * 64 * 2 + 8 * 16 * 128 * 2


def test_no_collective_on_one_device():
    one = fake_mesh((1, 1), ("data", "model"))
    try:
        rec = dryrun.dryrun_one("smollm-135m", SHAPES["train"], smoke=True,
                                mesh=one, verbose=False)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["collective_bytes"] == 0 and rec["flops"] > 0


def test_host_mesh_matches_reference():
    """`launch.mesh.make_host_mesh`: the reference's degenerate mesh, a
    1 x 1 ("data", "model") `DeviceMesh`, on which the training step's
    DTensors stay whole."""
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes
    try:
        host = make_host_mesh()
        assert mesh_axes(host) == dict(jmake_host_mesh().shape) \
            == {"data": 1, "model": 1}
        rec = dryrun.dryrun_one("falcon-mamba-7b", SHAPES["train"],
                                smoke=True, mesh=host, verbose=False,
                                pm_miss_capacity=16)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert rec["collective_bytes"] == 0


def test_a_real_process_group_is_not_replaced(tmp_path):
    """The production mesh runs in a process of its own: it raises where
    the process already has a real group."""
    from repro_torch.launch.mesh import init_group
    if dist.is_initialized():
        dist.destroy_process_group()
    init_group(0, 1, str(tmp_path / "init"), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="fake"):
            dryrun.make_production_mesh()
    finally:
        dist.destroy_process_group()


def test_fsdp_gather_on_two_gloo_ranks():
    """Also the vocab-parallel loss (`vp_loss_mesh`, DTensor's
    `loss_parallel`) where the vocabulary divides the "model" axis."""
    archs = ("smollm-135m", "falcon-mamba-7b")
    shapes = ((1, 2), (2, 1))
    outs = run_ranks(R.dtensor_train, 2, archs, shapes, timeout_s=300)
    assert outs[0] == outs[1]                    # every rank the same
    assert len(outs[0]) == len(archs) * len(shapes) * 2
    for (arch, shape, vp), (plain, dt) in outs[0].items():
        assert len(plain) == len(dt) == 2
        np.testing.assert_allclose(dt, plain, rtol=1e-6,
                                   err_msg=f"{arch} on {shape}, vp {vp}")


def test_managed_step_on_two_gloo_ranks():
    """The managed embedding with DTensor parameters and batches
    (`_mesh_ranks.dtensor_pm_train`), strict and not, on a (1, 2) mesh
    (the table's vocab over "model") and a (2, 1) mesh (the tokens over
    "data", the table's width ZeRO-sharded there): the index stage, the
    lookup's rows and the table's gradient (for an integer-valued
    upstream gradient) equal to the plain ones exactly; the losses of
    two managed training steps and the updated table within rtol 1e-6 of
    the plain managed step's, a table entry near zero held at the
    table's scale (atol 1e-6 of its largest entry: the sharded matmuls'
    sums round apart by an ulp of that scale).  The plain managed step is
    held to JAX's by the loop tests."""
    archs = ("smollm-135m", "falcon-mamba-7b")
    shapes = ((1, 2), (2, 1))
    outs = run_ranks(R.dtensor_pm_train, 2, archs, shapes, timeout_s=300)
    assert len(outs[0]) == len(archs) * len(shapes) * 2
    for key, r in outs[0].items():
        for o in outs[1:]:                       # every rank the same
            np.testing.assert_array_equal(o[key]["embed"][1],
                                          r["embed"][1])
        plain, dt = r["stage"]
        assert len(plain) == len(dt) == 10
        for a, b in zip(plain, dt):
            assert a.dtype == b.dtype and a.equal(b), key
        for name in ("rows", "grad"):
            np.testing.assert_array_equal(r[name][1], r[name][0],
                                          err_msg=f"{key} {name}")
        (p_loss, loss), (p_embed, embed) = r["losses"], r["embed"]
        assert len(loss) == 2
        np.testing.assert_allclose(loss, p_loss, rtol=1e-6, err_msg=key)
        np.testing.assert_allclose(embed, p_embed, rtol=1e-6,
                                   atol=1e-6 * p_embed.abs().max().item(),
                                   err_msg=key)


def test_cli_on_the_production_mesh(tmp_path):
    out = tmp_path / "dr.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "done: 1 ok, 0 skipped (documented), 0 failed" in proc.stdout
    rec = json.loads(out.read_text())[0]
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["collective_bytes"] > 0
