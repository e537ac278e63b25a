"""The port's dry run (`repro_torch.launch.dryrun`): each family's smoke
config through its train, prefill and serve steps on a fake 2 x 2
("data", "model") mesh of DTensors, nothing allocated.

* ``status`` ok, and the argument bytes equal the per-device shard sizes
  computed from the reference's specs (`repro.launch.sharding`, over the
  reference's parameter and input structs, on a stand-in mesh);
* the unit-scaled counts (`depth_variants`) equal a trace at the full
  smoke depth, FLOPs and every collective's bytes;
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
import json
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


@pytest.fixture(scope="module")
def mesh():
    """A fake 2 x 2 mesh; the fake process group is gone after the
    module."""
    yield fake_mesh((2, 2), ("data", "model"))
    if dist.is_initialized():
        dist.destroy_process_group()


def reference_argument_bytes(arch: str, shape: InputShape) -> int:
    """One device's bytes of the step's arguments from the reference's
    specs on a stand-in 2 x 2 mesh: parameters in bf16 (and fp32
    AdaGrad accumulators when training) and the inputs (the cache's
    ``len``, a host integer in the port, left out)."""
    jcfg = jget_config(arch, smoke=True)
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
    pspec = jsharding.param_pspecs(p, jcfg, jmesh, zero_layers=True)
    n = total(p, pspec)
    if shape.kind == "train":
        n += total(jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, np.float32), p), pspec)
    inputs = jdryrun.input_specs(jcfg, shape)
    if shape.kind != "decode":
        return n + total(inputs, jsharding.batch_pspecs(jcfg, jmesh, inputs))
    cache = {k: v for k, v in inputs["cache"].items() if k != "len"}
    cspec = jsharding.cache_pspecs(jcfg, jmesh, inputs["cache"])
    n += total(cache, {k: cspec[k] for k in cache})
    tok = inputs["tokens"]
    return n + nbytes(tok, ("data" if shape.global_batch % 2 == 0 else None,
                            None))


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_dryrun_one_on_a_fake_mesh(mesh, arch, kind):
    shape = SHAPES[kind]
    rec = dryrun.dryrun_one(arch, shape, smoke=True, mesh=mesh,
                            verbose=False)
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    assert rec["mesh"] == "2x2" and rec["zero_layers_effective"] is True
    assert rec["memory"]["argument_bytes"] == \
        reference_argument_bytes(arch, shape)
    assert rec["collective_bytes"] == \
        sum(rec["collective_bytes_per_op"].values()) > 0
    assert set(rec["collective_bytes_per_op"]) == set(dryrun.COLLECTIVES)
    # the unit-scaled counts against the step at its full smoke depth
    cfg = get_config(arch, smoke=True)
    full = dryrun.trace_step(cfg, shape, mesh)
    assert rec["flops"] == full.flops > 0
    assert rec["collective_bytes_per_op"] == full.collective_bytes
    # the global FLOPs against torch's counter on plain fake tensors
    with FlopCounterMode(display=False) as fc:
        plain = dryrun.trace_step(cfg, shape, mesh, distributed=False)
    assert rec["flops"] == plain.flops == fc.get_total_flops()
    assert set(plain.collective_bytes.values()) == {0}


@pytest.mark.parametrize("arch, kind", [("zamba2-1.2b", "train"),
                                        ("whisper-medium", "train"),
                                        ("zamba2-1.2b", "decode")])
def test_unit_scaling_at_a_deeper_stack(mesh, arch, kind):
    """Deeper than the smoke configs: zamba2 with 5 layers and the shared
    block before every second (3 applications), whisper with 3 decoder
    and 2 encoder layers; the scaled counts equal the full trace's."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=5 if cfg.attn_every else 3)
    shape = SHAPES[kind]
    full = dryrun.trace_step(cfg, shape, mesh)
    flops, coll = 0, dict.fromkeys(dryrun.COLLECTIVES, 0)
    for c, coef in dryrun.depth_variants(cfg, kind == "train"):
        t = dryrun.trace_step(c, shape, mesh)
        flops += coef * t.flops
        for k, v in t.collective_bytes.items():
            coll[k] += coef * v
    assert flops == full.flops and coll == full.collective_bytes


@pytest.mark.parametrize("knobs", [
    dict(vp_loss=True), dict(fsdp_gather=True), dict(zero_embed_head=False),
    dict(zero_layers=None), dict(remat_policy="dots"), dict(pad_vocab=True)])
def test_knobs(mesh, knobs):
    """The reference's knobs through smollm-135m's training step: the
    vocab-parallel loss, the FSDP gather and the layouts leave the FLOPs
    as they are; "dots" recomputes fewer products, a padded vocabulary
    adds head work."""
    base = dryrun.dryrun_one("smollm-135m", SHAPES["train"], smoke=True,
                             mesh=mesh, verbose=False)
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


def test_no_collective_on_one_device():
    one = fake_mesh((1, 1), ("data", "model"))
    try:
        rec = dryrun.dryrun_one("smollm-135m", SHAPES["train"], smoke=True,
                                mesh=one, verbose=False)
    finally:
        dist.destroy_process_group()
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["collective_bytes"] == 0 and rec["flops"] > 0


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
