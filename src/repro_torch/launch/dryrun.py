"""Dry run on the production meshes: one call of every (architecture x
input shape) step on DTensors over a fake process group, with no
allocation (the twin of `repro/launch/dryrun.py`).

Per combination it records:

* that the sharding propagates through the whole step: the train,
  prefill or serve step is called once on DTensor parameters, optimizer
  state and inputs placed by `launch.sharding`'s specs on the production
  mesh (`launch.mesh.make_production_mesh`), every tensor a fake one;
* the exact per-device bytes of the step's arguments, from the specs at
  full depth;
* the step's global FLOPs and its per-device collective bytes, from the
  ops the DTensor call issues.

Where the reference lowers and compiles one jitted step, the port makes
one eager call under DTensor, and where XLA's partitioner inserts the
collectives, DTensor's redistributions do: the counts are those of the
port's own ops.  There is no HLO, so the reference's HLO parser
(`_tuple_shapes`, `_split_computations`, `collective_bytes`) has no
counterpart.  The port's layer and tile loops are eager Python where the
reference's layers are one `lax.scan` body, so a full-depth trace would
take hours: each step is traced at the cut depths of `depth_variants`
(no layer and one, as a rule) and the counts are scaled to the full
depth by a linear combination of them, the counterpart of the
reference's trip-count scaling.  It is exact because every layer meets
the same layouts (`models.layouts.between_layers`) and issues the same
ops.  The CLI runs the combinations in worker processes, a fresh one
for each (``--jobs`` of them at a time).

On a CPU mesh DTensor turns an all-to-all into an all-gather and a
chunk (its CPU groups lack all-to-all), so such a redistribution counts
as an all-gather.

The tensors are fake (`FakeTensorMode`): they carry shapes and dtypes
and nothing is computed.  The mode is not entered around the call:
DTensor's own bookkeeping builds small index tensors that it reads back,
which a fake tensor cannot give.  Each op on the fake shards dispatches
to the fake mode by itself, and the model builds every tensor whose size
grows with the inputs from an input (``new_zeros``), so only
position-sized constants (ranges and masks) are real.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.data.batches import batch_struct
from repro_torch.models.model import (DenseLM, cache_seq_len, init_cache,
                                      n_attn_apps)
from repro_torch.optim.optimizers import AdaGradState
from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                     make_train_step)
from .mesh import axis_size, make_production_mesh, mesh_axes
from .sharding import (batch_entry, batch_pspecs, cache_pspecs, local_shape,
                       needs_zero, param_pspecs, placements)

PARAM_DTYPE = torch.bfloat16

# Documented skips (DESIGN.md §5): long_500k needs sub-quadratic context.
LONG_OK = {"falcon-mamba-7b", "zamba2-1.2b", "mixtral-8x22b"}

#: the reference's collective names, and the functional collectives
#: DTensor issues for each (all-reduce counts twice its result bytes, as
#: a ring moves them; the others once)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all"}

#: the managed embedding's replica cache rows in a dry run's batch, as the
#: reference's
PM_CACHE_ROWS = 4096


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and cfg.arch_id not in LONG_OK:
        return ("full-attention family: 500k decode requires sub-quadratic "
                "attention (DESIGN.md §5)")
    return None


def _np_dtype(d) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=d)).dtype


def input_specs(cfg: ModelConfig, shape: InputShape,
                fake: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """Fake tensors of every model input of this shape: `batch_struct`'s
    fields for train and prefill; for decode one new token per sequence,
    ``tokens`` (B, 1), and ``cache``, `init_cache`'s tensors for
    ``seq_len`` positions in `PARAM_DTYPE` (``len`` 0)."""
    fake = fake or FakeTensorMode()
    with fake:
        if shape.kind in ("train", "prefill"):
            return {k: torch.empty(s, dtype=_np_dtype(d)) for k, (s, d) in
                    batch_struct(cfg, shape.global_batch,
                                 shape.seq_len).items()}
        return {"tokens": torch.empty((shape.global_batch, 1),
                                      dtype=torch.int32),
                "cache": init_cache(cfg, shape.global_batch, shape.seq_len,
                                    dtype=PARAM_DTYPE, device="cpu")}


def _fake_model(cfg: ModelConfig, fake: FakeTensorMode) -> DenseLM:
    with fake:
        return DenseLM(cfg, torch.Generator(), PARAM_DTYPE)


def params_specs(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The model's named parameters in `PARAM_DTYPE` on the meta device
    (the reference's ``jax.eval_shape`` of ``init_model``)."""
    model = _fake_model(cfg, FakeTensorMode())
    return {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for n, p in model.named_parameters()}


def _bytes(shape, dtype, spec, mesh) -> int:
    return int(np.prod(local_shape(shape, spec, mesh), dtype=np.int64)) \
        * torch.empty((), dtype=dtype).element_size()


class StepCounter(TorchDispatchMode):
    """Counts a step's global FLOPs and its per-device collective bytes.

    FLOPs are counted at the level of whole tensors, from the global
    shapes (`torch.utils.flop_counter`'s formulas): an op on DTensors, or
    an op on plain tensors outside any DTensor op; the shards' own ops
    are not counted again.  Collective bytes are the result sizes of the
    functional collectives DTensor issues on one device's shards, under
    the reference's names (all-reduce twice): those of an explicit
    redistribution, and those DTensor makes inside an op to bring its
    inputs to a layout its rule takes (`_ShardOps`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collective_bytes = {name: 0 for name in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            with _ShardOps(self):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        self.collective(func, out)
        return out

    def collective(self, func, out) -> None:
        """Counts ``out`` if ``func`` is a functional collective."""
        op = _FUNCOL.get(func._overloadpacket.__name__) \
            if func.namespace in ("_c10d_functional", "c10d_functional") \
            else None
        if op is not None:
            n = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            self.collective_bytes[op] += (2 if op == "all-reduce" else 1) * n


class _ShardOps(TorchDispatchMode):
    """The mode of `StepCounter` while DTensor runs one of its ops (a mode
    is off while its own handler runs): it lets every DTensor op through
    to DTensor, whose dispatch comes after the modes' (as
    `torch.distributed.tensor.debug.CommDebugMode` does), runs the
    shards' ops, and hands the collectives among them to the counter."""

    def __init__(self, counter: StepCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not isinstance(func, torch._ops.HigherOrderOperator):
            self.counter.collective(func, out)
        return out


def depth_variants(cfg: ModelConfig, backward: bool = False
                   ) -> List[Tuple[ModelConfig, int]]:
    """The configs a step is traced at, each with its coefficient: the
    full-depth count is the sum of coefficient x count.  Every layer of a
    stack meets the same layouts (`models.layouts.between_layers`) and
    issues the same ops, ``a``, beside ``c`` outside the stack, so L
    layers count c + L a = (1 - L) T(0) + L T(1).  The hybrid's shared
    block adds ``b`` for each of its A applications: T(0) + L [T(1 layer
    without it) - T(0)] + A [T(1 layer after one application) - T(1
    layer without it)]; in training, where its gradients are summed and
    its update made once a step, from one application and two.  The
    encoder-decoder's two stacks scale each by
    its own count; with a ``backward`` (training), from one layer of each
    stack and two, since the encoder's backward runs only where a decoder
    layer reads its output, and the gradients of that output from the
    decoder layers are summed once."""
    L = cfg.n_layers
    zero = dataclasses.replace(cfg, n_layers=0)
    one = dataclasses.replace(cfg, n_layers=1)
    if cfg.family == "encdec":
        E = cfg.encoder.n_layers

        def enc(c, n):
            return dataclasses.replace(
                c, encoder=dataclasses.replace(c.encoder, n_layers=n))
        if backward:
            two = dataclasses.replace(cfg, n_layers=2)
            return [(enc(one, 1), 3 - L - E), (enc(two, 1), L - 1),
                    (enc(one, 2), E - 1)]
        return [(enc(zero, 0), 1 - L - E), (enc(one, 0), L),
                (enc(zero, 1), E)]
    if cfg.family == "hybrid":
        A = n_attn_apps(cfg)
        bare = dataclasses.replace(one, attn_every=0)
        if backward and A > 1:
            # the shared block's gradients from its applications are
            # summed, and its parameters updated, once a step: c + L a +
            # A b + u, from one application and from two (two layers)
            two = dataclasses.replace(cfg, n_layers=2, attn_every=1)
            return [(zero, A - L), (bare, L - A), (one, 2 - A), (two, A - 1)]
        return [(zero, 1 - L), (bare, L - A), (one, A)]
    return [(zero, 1 - L), (one, L)]


class _Fakes:
    """DTensors of fake shards on ``mesh`` (nothing allocated)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.mode = FakeTensorMode(allow_non_fake_inputs=True)

    def dtensor(self, shape, dtype, spec) -> DTensor:
        shape = torch.Size(shape)
        with self.mode:
            local = torch.empty(local_shape(shape, spec, self.mesh),
                                dtype=dtype)
            stride = torch.empty(shape, device="meta").stride()
            return DTensor.from_local(local, self.mesh,
                                      placements(spec, self.mesh),
                                      run_check=False, shape=shape,
                                      stride=stride)

    def distribute(self, model: nn.Module, specs) -> nn.Module:
        """``model``'s parameters replaced by DTensors placed by ``specs``."""
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            setattr(mod, leaf, nn.Parameter(
                self.dtensor(p.shape, p.dtype, specs[name])))
        return model


@dataclasses.dataclass(frozen=True)
class Knobs:
    """What a dry run varies besides the architecture, shape and mesh."""
    pm_miss_capacity: int = 0
    zero_embed_head: bool = True
    prefill_last_only: bool = False
    vp_loss: bool = False
    remat_policy: str = "full"
    zero_layers: Optional[bool] = True
    fsdp_gather: bool = False


def _layer_fsdp_spec(cfg: ModelConfig, mesh, fake: FakeTensorMode):
    """The tensor-parallel spec of one layer of ``layers`` (named relative
    to the layer), the reference's ``param_pspecs(layer_sds, ...,
    zero_layers=False)``."""
    one = _fake_model(dataclasses.replace(cfg, n_layers=1), fake)
    return param_pspecs(dict(one.layers[0].named_parameters()), cfg, mesh,
                        zero_layers=False)


def _token_spec(B: int, mesh):
    """The decode tokens' spec: over the batch axes where they divide the
    batch (the reference's rule)."""
    entry, bsize = batch_entry(mesh)
    return (entry if B % bsize == 0 else None, None)


def _batch_shapes(cfg: ModelConfig, shape: InputShape,
                  knobs: Knobs) -> Dict[str, Tuple[tuple, torch.dtype]]:
    out = {k: (s, _np_dtype(d)) for k, (s, d) in
           batch_struct(cfg, shape.global_batch, shape.seq_len).items()}
    if knobs.pm_miss_capacity:
        out["pm_cache_ids"] = ((PM_CACHE_ROWS,), torch.int32)
        out["pm_cache_rows"] = ((PM_CACHE_ROWS, cfg.d_model), PARAM_DTYPE)
    return out


def _zero_layers(cfg, mesh, knobs: Knobs) -> bool:
    return needs_zero(cfg, mesh) if knobs.zero_layers is None \
        else knobs.zero_layers


def argument_bytes(cfg: ModelConfig, shape: InputShape, mesh,
                   knobs: Knobs) -> int:
    """One device's bytes of the step's arguments at full depth, from the
    specs: parameters, the AdaGrad accumulators (fp32) when training,
    and the inputs (the batch; or the cache and the tokens)."""
    p = params_specs(cfg)
    specs = param_pspecs(p, cfg, mesh, zero_embed_head=knobs.zero_embed_head,
                         zero_layers=knobs.zero_layers)
    n = sum(_bytes(t.shape, t.dtype, specs[k], mesh) for k, t in p.items())
    if shape.kind == "train":
        n += sum(_bytes(t.shape, torch.float32, specs[k], mesh)
                 for k, t in p.items())
    if shape.kind in ("train", "prefill"):
        b = _batch_shapes(cfg, shape, knobs)
        bspec = batch_pspecs(cfg, mesh, {k: s for k, (s, _) in b.items()})
        return n + sum(_bytes(s, d, bspec[k], mesh)
                       for k, (s, d) in b.items())
    inputs = input_specs(cfg, shape)
    cache = {k: v for k, v in inputs["cache"].items() if k != "len"}
    cspec = cache_pspecs(cfg, mesh, cache)
    n += sum(_bytes(t.shape, t.dtype, cspec[k], mesh)
             for k, t in cache.items())
    tok = inputs["tokens"]
    return n + _bytes(tok.shape, tok.dtype,
                      _token_spec(shape.global_batch, mesh), mesh)


def trace_step(cfg: ModelConfig, shape: InputShape, mesh,
               knobs: Knobs = Knobs(), distributed: bool = True
               ) -> StepCounter:
    """One call of ``shape``'s step at ``cfg``'s depth on fake tensors:
    with ``distributed``, DTensors placed by the specs on ``mesh`` (under
    `implicit_replication`: a plain constant joins a DTensor op
    replicated); without, plain fake tensors of the global shapes.
    Returns the counts."""
    fakes = _Fakes(mesh)
    model = _fake_model(cfg, fakes.mode)
    zl = _zero_layers(cfg, mesh, knobs)
    fsdp_spec = None
    if distributed:
        specs = param_pspecs(dict(model.named_parameters()), cfg, mesh,
                             zero_embed_head=knobs.zero_embed_head,
                             zero_layers=zl)
        if knobs.fsdp_gather and zl:
            fsdp_spec = _layer_fsdp_spec(cfg, mesh, fakes.mode)
        fakes.distribute(model, specs)

    def place(shp, dtype, spec):
        if distributed:
            return fakes.dtensor(shp, dtype, spec)
        with fakes.mode:
            return torch.empty(shp, dtype=dtype)

    B = shape.global_batch
    counter = StepCounter()
    if shape.kind in ("train", "prefill"):
        b = _batch_shapes(cfg, shape, knobs)
        bspec = batch_pspecs(cfg, mesh, {k: s for k, (s, _) in b.items()})
        batch = {k: place(s, d, bspec[k]) for k, (s, d) in b.items()}
    if shape.kind == "train":
        opt = AdaGradState({n: place(p.shape, torch.float32, specs[n]
                                     if distributed else None)
                            for n, p in model.named_parameters()})
        vp_ok = (distributed and knobs.vp_loss
                 and cfg.vocab_size % axis_size(mesh, "model") == 0)
        step = make_train_step(cfg, pm_miss_capacity=knobs.pm_miss_capacity,
                               pm_strict=bool(knobs.pm_miss_capacity),
                               remat_policy=knobs.remat_policy,
                               vp_loss_mesh=mesh if vp_ok else None,
                               fsdp_spec=fsdp_spec)
        call = (step, model, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, last_only=knobs.prefill_last_only,
                                 fsdp_spec=fsdp_spec)
        call = (step, model, batch)
    else:
        inputs = input_specs(cfg, shape, fakes.mode)
        cache = {k: v for k, v in inputs["cache"].items() if k != "len"}
        cspec = cache_pspecs(cfg, mesh, cache)
        cache = {k: place(t.shape, t.dtype, cspec[k])
                 for k, t in cache.items()}
        # the new token at the cache's last position: it attends to the
        # whole cache, as the reference's step does (its cache length is
        # a traced scalar, and it masks the full-size cache)
        cache["len"] = cache_seq_len(cfg, shape.seq_len) - 1
        tokens = place((B, 1), torch.int32, _token_spec(B, mesh))
        call = (make_serve_step(cfg, fsdp_spec=fsdp_spec), model, cache,
                tokens)
    with implicit_replication(), counter:
        call[0](*call[1:])
    return counter


def dryrun_one(arch: str, shape_name, *, multi_pod: bool = False,
               pm_miss_capacity: int = 0, zero_embed_head: bool = True,
               prefill_last_only: bool = False, vp_loss: bool = False,
               remat_policy: str = "full", pad_vocab: bool = False,
               zero_layers=True, fsdp_gather: bool = False,
               verbose: bool = True, smoke: bool = False,
               mesh=None) -> Dict[str, Any]:
    """The dry run of ``arch`` at ``shape_name`` (a name of `SHAPES`, or
    an `InputShape`) on the production mesh, with the reference's knobs
    and record keys.  ``smoke``: the architecture's smoke config;
    ``mesh``: a `DeviceMesh` of a fake group in place of the production
    mesh (both for tests)."""
    cfg = get_config(arch, smoke=smoke)
    if pad_vocab:
        pad_to = 16 * 128
        v = -(-cfg.vocab_size // pad_to) * pad_to
        cfg = dataclasses.replace(cfg, vocab_size=v)
    shape = shape_name if isinstance(shape_name, InputShape) \
        else SHAPES[shape_name]
    knobs = Knobs(pm_miss_capacity=pm_miss_capacity,
                  zero_embed_head=zero_embed_head,
                  prefill_last_only=prefill_last_only, vp_loss=vp_loss,
                  remat_policy=remat_policy, zero_layers=zero_layers,
                  fsdp_gather=fsdp_gather)
    if mesh is None:
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        mesh_name = "x".join(str(n) for n in mesh_axes(mesh).values())
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "pm_miss_capacity": pm_miss_capacity,
        "zero_embed_head": zero_embed_head,
        "prefill_last_only": prefill_last_only,
        "vp_loss": vp_loss, "remat_policy": remat_policy,
        "pad_vocab": pad_vocab,
        "zero_layers": "auto" if zero_layers is None else zero_layers,
        "fsdp_gather": fsdp_gather,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rec["zero_layers_effective"] = _zero_layers(cfg, mesh, knobs)
    # the full depth's ZeRO decision holds at the cut depths too
    traced = dataclasses.replace(knobs,
                                 zero_layers=rec["zero_layers_effective"])
    flops = 0
    coll = {name: 0 for name in COLLECTIVES}
    depths = []
    for c, coef in depth_variants(cfg, shape.kind == "train"):
        counts = trace_step(c, shape, mesh, traced)
        flops += coef * counts.flops
        for k, v in counts.collective_bytes.items():
            coll[k] += coef * v
        depths.append({"n_layers": c.n_layers, "coefficient": coef,
                       **({"attn_apps": n_attn_apps(c)}
                          if c.family == "hybrid" else {}),
                       **({"enc_layers": c.encoder.n_layers}
                          if c.encoder is not None else {})})
    trace_s = time.time() - t0
    n_dev = 1
    for n in mesh_axes(mesh).values():
        n_dev *= n
    rec.update({
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "trace_depth": depths,
        "flops": flops,
        "collective_bytes_per_op": coll,
        "collective_bytes": sum(coll.values()),
        "memory": {
            "argument_bytes": argument_bytes(cfg, shape, mesh, knobs),
            "output_bytes": None, "peak_bytes": None,
            "reason": "not measured: the traces run one or two layers, "
                      "whose outputs and peak are not the full depth's"},
        "n_devices": n_dev,
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}: OK "
              f"(trace {trace_s:.1f}s, GFLOPs {flops / 1e9:.1f}, "
              f"coll {rec['collective_bytes'] / 1e6:.1f}MB, args/device "
              f"{rec['memory']['argument_bytes'] / 1e9:.2f}GB)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, nargs="+",
                    help="one architecture or more (default: all)")
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--pm-miss-capacity", type=int, default=0)
    ap.add_argument("--no-zero-embed-head", dest="zero_embed_head",
                    action="store_false",
                    help="keep embed/head vocab-sharded only")
    ap.add_argument("--prefill-last-only", action="store_true",
                    help="head matmul on the final position only")
    ap.add_argument("--vp-loss", action="store_true",
                    help="vocab-parallel CE (DTensor's loss_parallel)")
    ap.add_argument("--remat-policy", choices=("full", "dots"),
                    default="full")
    ap.add_argument("--auto-zero-layers", action="store_true",
                    help="ZeRO layer weights only when TP-only weights and "
                         "optimizer state would not fit a device")
    ap.add_argument("--fsdp-gather", action="store_true",
                    help="gather layer weights to their TP layout inside "
                         "the layer loop when ZeRO is active")
    ap.add_argument("--pad-vocab", action="store_true",
                    help="pad vocab to a multiple of 16*128")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, one combination each at a time")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else tuple(args.arch)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    knobs = dict(pm_miss_capacity=args.pm_miss_capacity,
                 zero_embed_head=args.zero_embed_head,
                 prefill_last_only=args.prefill_last_only,
                 vp_loss=args.vp_loss, remat_policy=args.remat_policy,
                 pad_vocab=args.pad_vocab,
                 zero_layers=None if args.auto_zero_layers else True,
                 fsdp_gather=args.fsdp_gather)
    combos = [(a, s, mp, knobs) for a in archs for s in shapes
              for mp in meshes]
    results = []

    def keep(rec):
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    # one fresh worker process a combination: a process keeps one fake
    # group (DTensor's caches hold on to a replaced group's subgroups)
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                             max_tasks_per_child=1) as pool:
        for rec in pool.map(_run_combo, combos):
            keep(rec)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    err = sum(1 for r in results if r["status"] == "error")
    print(f"[dryrun] done: {ok} ok, {sk} skipped (documented), {err} failed")
    return 1 if err else 0


def _run_combo(combo) -> Dict[str, Any]:
    """`dryrun_one` of one (arch, shape name, multi_pod, knobs), or its
    error record: the op DTensor refused and the traceback's end."""
    a, s, mp, knobs = combo
    try:
        return dryrun_one(a, s, multi_pod=mp, **knobs)
    except Exception as e:
        tb = traceback.format_exc()
        print(f"[dryrun] {a} x {s}: FAILED {e!r}", file=sys.stderr,
              flush=True)
        return {"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                "status": "error", "error": repr(e), "op": _failed_op(tb),
                "trace": tb[-6000:]}


def _failed_op(tb: str) -> Optional[str]:
    """The aten op named in a DTensor propagation error, if any."""
    for line in reversed(tb.splitlines()):
        if "aten." in line:
            i = line.index("aten.")
            return line[i:].split("(")[0].split()[0]
    return None


if __name__ == "__main__":
    sys.exit(main())
