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
  ops the DTensor call issues, in total and by part of the step
  (``forward``, ``backward``, ``update`` for training);
* one device's memory, under the reference's keys (``memory``):
  ``argument_bytes`` (as above), ``output_bytes`` (the local shards of
  what the step returns: the parameters and accumulators, updated in
  place, and the loss; the logits; the logits and the updated cache),
  ``peak_bytes`` (the most one device holds at once during the step,
  its arguments included: the live bytes of `StepCounter`, counted on
  the fake shards as a caching allocator would count the real ones),
  ``temp_bytes`` = ``peak_bytes - argument_bytes`` (the most the step
  holds beyond its arguments; not XLA's temp buffer size, which counts
  every buffer of the compiled program whether or not they are alive
  together) and ``peak_per_phase`` (the peak in each part of the step).

Where the reference lowers and compiles one jitted step, the port makes
one eager call under DTensor, and where XLA's partitioner inserts the
collectives, DTensor's redistributions do: the counts are those of the
port's own ops.  There is no HLO, so the reference's HLO parser
(`_tuple_shapes`, `_split_computations`, `collective_bytes`) has no
counterpart, and the memory figures are the live bytes of the eager
call, not `compiled.memory_analysis()`'s.  The port's layer and tile
loops are eager Python where the reference's layers are one `lax.scan`
body, so a full-depth trace would take hours: each step is traced at the
cut depths of `depth_variants` and the counts, the peaks and the output
bytes are scaled to the full depth by a linear combination of them, the
counterpart of the reference's trip-count scaling.  It is exact because
every layer meets the same layouts (`models.layouts.between_layers`)
and issues the same ops, and the cut depths keep each peak at the same
point of its part of the step.  The CLI runs the combinations in worker
processes, a fresh one for each (``--jobs`` of them at a time).

On a CPU mesh DTensor turns an all-to-all into an all-gather and a
chunk (its CPU groups lack all-to-all), so such a redistribution counts
as an all-gather.

The tensors are fake (`FakeTensorMode`): they carry shapes and dtypes
and nothing is computed.  The mode is not entered around the call:
DTensor's own bookkeeping builds small index tensors that it reads back,
which a fake tensor cannot give.  Each op on the fake shards dispatches
to the fake mode by itself, and the model builds every tensor whose size
grows with the inputs from an input (``new_zeros``), so only
position-sized constants (ranges and masks) are real; they count as
live bytes, since on a device they would live there too.

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
import weakref
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, as_completed
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed._functional_collectives import AsyncCollectiveTensor
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
from repro_torch.train.steps import (PHASE_LISTENERS, make_prefill_step,
                                     make_serve_step, make_train_step)
from .mesh import (axis_size, make_production_mesh, mesh_axes,
                   production_shape)
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
#: functional-collective ops whose result is their input on a device (a
#: wrapper of it, or it once the collective is done), and that make a new
#: tensor of its size on fake tensors
_ALIASES = ("wait_tensor", "_wrap_tensor_autograd")

#: the managed embedding's replica cache rows in a dry run's batch, as the
#: reference's
PM_CACHE_ROWS = 4096

#: the order the CLI traces the shapes' steps in, the most work a call
#: first: a prefill runs 32k tokens' attention and scan tiles forward, a
#: training step 4k tokens forward and backward, a decode step one token
_KIND_ORDER = {"prefill": 0, "train": 1, "decode": 2}


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and cfg.arch_id not in LONG_OK:
        return ("full-attention family: 500k decode requires sub-quadratic "
                "attention (DESIGN.md §5)")
    return None


def _np_dtype(d) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=d)).dtype


def input_specs(cfg: ModelConfig, shape: InputShape,
                fake: Optional[FakeTensorMode] = None,
                dtype: torch.dtype = PARAM_DTYPE) -> Dict[str, Any]:
    """Fake tensors of every model input of this shape: `batch_struct`'s
    fields for train and prefill; for decode one new token per sequence,
    ``tokens`` (B, 1), and ``cache``, `init_cache`'s tensors for
    ``seq_len`` positions in ``dtype`` (``len`` 0)."""
    fake = fake or FakeTensorMode()
    with fake:
        if shape.kind in ("train", "prefill"):
            return {k: torch.empty(s, dtype=_np_dtype(d)) for k, (s, d) in
                    batch_struct(cfg, shape.global_batch,
                                 shape.seq_len).items()}
        return {"tokens": torch.empty((shape.global_batch, 1),
                                      dtype=torch.int32),
                "cache": init_cache(cfg, shape.global_batch, shape.seq_len,
                                    dtype=dtype, device="cpu")}


def _fake_model(cfg: ModelConfig, fake: FakeTensorMode,
                dtype: torch.dtype = PARAM_DTYPE) -> DenseLM:
    with fake:
        return DenseLM(cfg, torch.Generator(), dtype)


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
    """Counts a step's global FLOPs, its per-device collective bytes and
    one device's live bytes, each in the step's part (``phase``) where it
    falls.

    FLOPs are counted at the level of whole tensors, from the global
    shapes (`torch.utils.flop_counter`'s formulas): an op on DTensors, or
    an op on plain tensors outside any DTensor op; the shards' own ops
    are not counted again.  Collective bytes are the result sizes of the
    functional collectives DTensor issues on one device's shards, under
    the reference's names (all-reduce twice): those of an explicit
    redistribution, and those DTensor makes inside an op to bring its
    inputs to a layout its rule takes (`_ShardOps`).

    Live bytes are counted at the level of one device's shards: the
    storages of the tensors `hold` is given (the step's arguments) and of
    every op's outputs on plain tensors or shards, each storage once
    (a view or an in-place op adds nothing), until it dies.  Of fake
    tensors only those of ``fake_mode`` (the step's) count: DTensor's
    sharding propagation runs each new op once more on fake tensors of
    its own of the global shapes, which no device would hold.  A real
    tensor made inside a DTensor op counts where the op read a tensor
    the counter holds (a plain tensor of the step, such as autograd's
    zero gradient of an unused output, cut to a shard), and not
    otherwise: DTensor's host bookkeeping (the index tensors of the
    device mesh it builds to propagate a layout) reads none.  A
    collective's result is its output buffer: the wrapper DTensor puts
    around it, and the wait, hold nothing more (`_ALIASES`).  The
    highest total in each part is ``peak_per_part``, and in each phase
    ``peak_per_phase``.  A training step names its parts through
    `train.steps.PHASE_LISTENERS`: a phase (``forward``, ``backward``,
    ``update``), or ``phase/sub``, a part of one whose peak is kept
    apart (``update/adagrad`` after the gradients are laid out: each
    part's peak sits at one point of it whatever the depth, where the
    phase's may move from one part to another); other steps stay in the
    part named at construction."""

    def __init__(self, phase: str = "step",
                 fake_mode: Optional[FakeTensorMode] = None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.collective_bytes = {name: 0 for name in COLLECTIVES}
        self.collective_bytes_per_phase: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak_per_part: Dict[str, int] = {}
        self._storages: Dict[int, weakref.ref] = {}
        self.enter_phase(phase)

    def enter_phase(self, name: str) -> None:
        """Enters the step's part ``name`` (``phase`` or ``phase/sub``)."""
        self.part, self.phase = name, name.split("/")[0]
        self.collective_bytes_per_phase.setdefault(
            self.phase, {op: 0 for op in COLLECTIVES})
        self._note_peak()

    @property
    def peak_per_phase(self) -> Dict[str, int]:
        return by_phase(self.peak_per_part)

    def __enter__(self):
        PHASE_LISTENERS.append(self.enter_phase)
        return super().__enter__()

    def __exit__(self, *exc):
        PHASE_LISTENERS.remove(self.enter_phase)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            with _ShardOps(self):
                out = func(*args, **kwargs)
        else:
            out = _call(func, args, kwargs)
            self.hold(out)
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
            n *= 2 if op == "all-reduce" else 1
            self.collective_bytes[op] += n
            self.collective_bytes_per_phase[self.phase][op] += n

    def hold(self, tree, inputs=None) -> None:
        """Counts the storages of the tensors in ``tree`` (of a DTensor,
        its local shard) as live from now until each dies; of fake
        tensors, only those of ``fake_mode``; with ``inputs`` (an op's),
        a real tensor only where the op read one the counter holds."""
        real = None
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            elif isinstance(t, AsyncCollectiveTensor):
                t = t.elem
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            if isinstance(t, FakeTensor):
                if t.fake_mode is not self.fake_mode:
                    continue
            elif inputs is not None:
                if real is None:
                    real = any(self.holds(x) for x in tree_leaves(inputs))
                if not real:
                    continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = weakref.ref(st, partial(self._free, key, n))
            self.live += n
        self._note_peak()

    def holds(self, t) -> bool:
        """Whether ``t``'s storage is counted live."""
        return isinstance(t, torch.Tensor) and t.device.type != "meta" \
            and id(t.untyped_storage()) in self._storages

    def _free(self, key: int, n: int, _ref) -> None:
        del self._storages[key]
        self.live -= n

    def _note_peak(self) -> None:
        if self.live > self.peak_per_part.get(self.part, -1):
            self.peak_per_part[self.part] = self.live


def by_phase(peak_per_part: Dict[str, int]) -> Dict[str, int]:
    """The peak of each phase: the highest of its parts'."""
    out: Dict[str, int] = {}
    for part, v in peak_per_part.items():
        phase = part.split("/")[0]
        out[phase] = max(out.get(phase, v), v)
    return out


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
        out = _call(func, args, kwargs or {})
        if not isinstance(func, torch._ops.HigherOrderOperator):
            self.counter.hold(out, (args, kwargs))
            self.counter.collective(func, out)
        return out


def _call(func, args, kwargs):
    """``func`` on ``args``; of `_ALIASES` on a fake tensor, a view of it,
    as on a device."""
    if func.namespace == "_c10d_functional" \
            and func._overloadpacket.__name__ in _ALIASES \
            and isinstance(args[0], FakeTensor):
        return args[0].view(args[0].shape)
    return func(*args, **kwargs)


def _cut(n: int, first: int, period: int = 1
         ) -> Optional[Tuple[int, int]]:
    """The two depths a stack of ``n`` layers is traced at, ``n1`` (at
    least ``first``, and ``n`` modulo ``period``) and ``n1 + period``;
    None where ``n`` is no deeper than the second (it is traced whole)."""
    n1 = first + (n - first) % period
    return None if n <= n1 + period else (n1, n1 + period)


def depth_variants(cfg: ModelConfig, backward: bool = False
                   ) -> List[Tuple[ModelConfig, int]]:
    """The configs a step is traced at, each with its coefficient: the
    full depth's counts, peaks and output bytes are the sum of
    coefficient x the variant's.

    Every layer of a stack meets the same layouts
    (`models.layouts.between_layers`) and issues the same ops, so the
    counts and the bytes held at any fixed point of a part of the step
    are affine in the depth, and a part's peak is too wherever it sits
    at the same point at the cut depths and the full one.  The first
    layer differs from the others (its input is the embedding's output,
    which the model holds through the stack, and no layout is made for
    it; in training, with one layer the top layer is the bottom one), so
    a stack is traced at two layers and three, and L layers give
    (3 - L) T(2) + (L - 2) T(3).  The hybrid applies its shared block
    before every ``attn_every``-th layer (period e) and holds A
    applications' KV caches.  Forward only (prefill, decode), its peak
    sits in a layer applying the block past the first (or in the head)
    whatever the period, and is affine in L and A: it is traced at two
    layers applying the block twice, and three applying it twice and
    thrice.  In training its peaks follow the period: it is traced at
    two depths one period apart with the full depth's remainder modulo
    e, from two applications of the block on (the second adds its
    gradient into the first's, which holds one more temporary).  The
    encoder-decoder scales each stack by its own depth, the other held
    at two layers.  A stack no deeper than its second cut depth is
    traced whole."""
    if cfg.family == "encdec":
        def at(n, m):
            return dataclasses.replace(cfg, n_layers=n, encoder=dataclasses
                                       .replace(cfg.encoder, n_layers=m))
        L, E = cfg.n_layers, cfg.encoder.n_layers
        d, e = _cut(L, 2), _cut(E, 2)
        d1 = d[0] if d else L
        e1 = e[0] if e else E
        kd, ke = L - d1, E - e1
        return [(at(d1, e1), 1 - kd - ke)] \
            + ([(at(d[1], e1), kd)] if d else []) \
            + ([(at(d1, e[1]), ke)] if e else [])
    period = cfg.attn_every if cfg.family == "hybrid" and cfg.attn_every \
        else 1
    if period > 1 and not backward and cfg.n_layers > 3:
        # c + L a + A b, from (L, A) = (2, 2), (3, 2) and (3, 3)
        L, A = cfg.n_layers, n_attn_apps(cfg)
        return [(dataclasses.replace(cfg, n_layers=n, attn_every=e), coef)
                for n, e, coef in ((2, 1, 3 - L), (3, 2, L - A),
                                   (3, 1, A - 2))]
    cut = _cut(cfg.n_layers, period + 1, period)
    if cut is None:
        return [(cfg, 1)]
    k = (cfg.n_layers - cut[0]) // period
    return [(dataclasses.replace(cfg, n_layers=cut[0]), 1 - k),
            (dataclasses.replace(cfg, n_layers=cut[1]), k)]


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
    # besides the reference's: the training step as a caller on the card
    # may build it (`chip_smoke.py` predicts its peaks with these)
    remat: bool = True
    pm_kernel: bool = False
    pm_cache_rows: int = PM_CACHE_ROWS


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


def _batch_shapes(cfg: ModelConfig, shape: InputShape, knobs: Knobs,
                  dtype: torch.dtype = PARAM_DTYPE
                  ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    out = {k: (s, _np_dtype(d)) for k, (s, d) in
           batch_struct(cfg, shape.global_batch, shape.seq_len).items()}
    if knobs.pm_miss_capacity:
        C = knobs.pm_cache_rows
        out["pm_cache_ids"] = ((C,), torch.int32)
        out["pm_cache_rows"] = ((C, cfg.d_model), dtype)
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
               knobs: Knobs = Knobs(), distributed: bool = True,
               dtype: torch.dtype = PARAM_DTYPE) -> StepCounter:
    """One call of ``shape``'s step at ``cfg``'s depth on fake tensors:
    with ``distributed``, DTensors placed by the specs on ``mesh`` (under
    `implicit_replication`: a plain constant joins a DTensor op
    replicated); without, plain fake tensors of the global shapes (and
    ``mesh`` may be None).  ``dtype``: the parameters' and the decode
    cache's.  Returns the counts, with ``entry_bytes``, one device's
    bytes of the step's arguments as the counter holds them, and
    ``output_bytes``, of what the step returns: the parameters and the
    accumulators (updated in place) and the loss when training; the
    logits, and the cache when decoding."""
    fakes = _Fakes(mesh)
    model = _fake_model(cfg, fakes.mode, dtype)
    fsdp_spec, specs = None, {}
    if distributed:
        zl = _zero_layers(cfg, mesh, knobs)
        specs = param_pspecs(dict(model.named_parameters()), cfg, mesh,
                             zero_embed_head=knobs.zero_embed_head,
                             zero_layers=zl)
        if knobs.fsdp_gather and zl:
            fsdp_spec = _layer_fsdp_spec(cfg, mesh, fakes.mode)
        fakes.distribute(model, specs)

    def spec_of(specs_fn, *args):
        return specs_fn(cfg, mesh, *args) if distributed else {}

    def place(shp, dt, spec):
        if distributed:
            return fakes.dtensor(shp, dt, spec)
        with fakes.mode:
            return torch.empty(shp, dtype=dt)

    B = shape.global_batch
    if shape.kind in ("train", "prefill"):
        b = _batch_shapes(cfg, shape, knobs, dtype)
        bspec = spec_of(batch_pspecs, {k: s for k, (s, _) in b.items()})
        batch = {k: place(s, d, bspec.get(k)) for k, (s, d) in b.items()}
    if shape.kind == "train":
        opt = AdaGradState({n: place(p.shape, torch.float32, specs.get(n))
                            for n, p in model.named_parameters()})
        vp_ok = (distributed and knobs.vp_loss
                 and cfg.vocab_size % axis_size(mesh, "model") == 0)
        step = make_train_step(cfg, pm_miss_capacity=knobs.pm_miss_capacity,
                               pm_strict=bool(knobs.pm_miss_capacity),
                               pm_kernel=knobs.pm_kernel, remat=knobs.remat,
                               remat_policy=knobs.remat_policy,
                               vp_loss_mesh=mesh if vp_ok else None,
                               fsdp_spec=fsdp_spec)
        call = (step, model, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, last_only=knobs.prefill_last_only,
                                 fsdp_spec=fsdp_spec)
        call = (step, model, batch)
    else:
        inputs = input_specs(cfg, shape, fakes.mode, dtype)
        cache = {k: v for k, v in inputs["cache"].items() if k != "len"}
        cspec = spec_of(cache_pspecs, cache)
        cache = {k: place(t.shape, t.dtype, cspec.get(k))
                 for k, t in cache.items()}
        # the new token at the cache's last position: it attends to the
        # whole cache, as the reference's step does (its cache length is
        # a traced scalar, and it masks the full-size cache)
        cache["len"] = cache_seq_len(cfg, shape.seq_len) - 1
        tokens = place((B, 1), torch.int32,
                       _token_spec(B, mesh) if distributed else None)
        call = (make_serve_step(cfg, fsdp_spec=fsdp_spec), model, cache,
                tokens)
    counter = StepCounter("forward" if shape.kind == "train" else shape.kind,
                          fakes.mode)
    counter.hold([_tensors(a) for a in call[1:]])
    counter.entry_bytes = counter.live
    with implicit_replication(), counter:
        out = call[0](*call[1:])
    counter.output_bytes = _local_bytes(_tensors(out))
    return counter


def _tensors(x) -> list:
    """The tensors of a step's argument or result (a module's are its
    parameters)."""
    if isinstance(x, nn.Module):
        return list(x.parameters())
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _local_bytes(tensors) -> int:
    """One device's bytes of ``tensors`` (of a DTensor, its local shard),
    each tensor once."""
    seen = {id(t): t for t in tensors}
    return sum((t._local_tensor if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in seen.values())


def _config(arch, shape_name, pad_vocab: bool = False,
            smoke: bool = False) -> Tuple[ModelConfig, InputShape]:
    cfg = arch if isinstance(arch, ModelConfig) \
        else get_config(arch, smoke=smoke)
    if pad_vocab:
        pad_to = 16 * 128
        v = -(-cfg.vocab_size // pad_to) * pad_to
        cfg = dataclasses.replace(cfg, vocab_size=v)
    shape = shape_name if isinstance(shape_name, InputShape) \
        else SHAPES[shape_name]
    return cfg, shape


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh_axes(mesh).values())


def _counts(t: StepCounter, seconds: float) -> Dict[str, Any]:
    """A trace's counts as plain numbers (what a worker sends back)."""
    return {"flops": t.flops, "output_bytes": t.output_bytes,
            "collective_bytes": t.collective_bytes,
            "collective_bytes_per_phase": t.collective_bytes_per_phase,
            "peak_per_part": t.peak_per_part, "seconds": seconds}


def trace_variant(arch, shape_name, j: int, *, multi_pod: bool = False,
                  pad_vocab: bool = False, smoke: bool = False, mesh=None,
                  **knobs) -> Dict[str, Any]:
    """The counts of the ``j``-th of `depth_variants` of ``arch`` (a name,
    or a `ModelConfig`) at ``shape_name`` (with the fields of `Knobs`),
    traced on ``mesh`` (None: the production mesh, whose fake group this
    process starts)."""
    cfg, shape = _config(arch, shape_name, pad_vocab, smoke)
    k = Knobs(**knobs)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    k = dataclasses.replace(k, zero_layers=_zero_layers(cfg, mesh, k))
    c, _ = depth_variants(cfg, shape.kind == "train")[j]
    t0 = time.time()
    return _counts(trace_step(c, shape, mesh, k), time.time() - t0)


def dryrun_one(arch, shape_name, *, multi_pod: bool = False,
               pm_miss_capacity: int = 0, zero_embed_head: bool = True,
               prefill_last_only: bool = False, vp_loss: bool = False,
               remat_policy: str = "full", pad_vocab: bool = False,
               zero_layers=True, fsdp_gather: bool = False,
               verbose: bool = True, smoke: bool = False,
               mesh=None, traced: Optional[list] = None) -> Dict[str, Any]:
    """The dry run of ``arch`` (a name of `ARCH_IDS`, or a `ModelConfig`)
    at ``shape_name`` (a name of `SHAPES`, or an `InputShape`) on the
    production mesh, with the reference's knobs and record keys.
    ``smoke``: the architecture's smoke config; ``mesh``: a `DeviceMesh`
    of a fake group in place of the production mesh (both for tests).
    ``traced``: the counts of `depth_variants` traced elsewhere
    (`trace_variant`, in the CLI's workers), in order; None: traced
    here."""
    cfg, shape = _config(arch, shape_name, pad_vocab, smoke)
    knobs = Knobs(pm_miss_capacity=pm_miss_capacity,
                  zero_embed_head=zero_embed_head,
                  prefill_last_only=prefill_last_only, vp_loss=vp_loss,
                  remat_policy=remat_policy, zero_layers=zero_layers,
                  fsdp_gather=fsdp_gather)
    rec: Dict[str, Any] = {
        "arch": cfg.arch_id, "shape": shape.name,
        "mesh": _mesh_name(production_shape(multi_pod) if mesh is None
                           else mesh),
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

    variants = depth_variants(cfg, shape.kind == "train")
    if traced is None:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        traced = [trace_variant(cfg, shape, j, mesh=mesh,
                                **dataclasses.asdict(knobs))
                  for j in range(len(variants))]
    elif mesh is None:
        mesh = production_shape(multi_pod)
    rec["zero_layers_effective"] = _zero_layers(cfg, mesh, knobs)
    flops = out_b = 0
    coll = {name: 0 for name in COLLECTIVES}
    coll_phase: Dict[str, Dict[str, int]] = {}
    peaks: Dict[str, int] = {}
    depths = []
    for (c, coef), counts in zip(variants, traced):
        flops += coef * counts["flops"]
        out_b += coef * counts["output_bytes"]
        for k, v in counts["collective_bytes"].items():
            coll[k] += coef * v
        for ph, per_op in counts["collective_bytes_per_phase"].items():
            acc = coll_phase.setdefault(ph, dict.fromkeys(COLLECTIVES, 0))
            for k, v in per_op.items():
                acc[k] += coef * v
        for part, v in counts["peak_per_part"].items():
            peaks[part] = peaks.get(part, 0) + coef * v
        depths.append({"n_layers": c.n_layers, "coefficient": coef,
                       **({"attn_apps": n_attn_apps(c)}
                          if c.family == "hybrid" else {}),
                       **({"enc_layers": c.encoder.n_layers}
                          if c.encoder is not None else {})})
    trace_s = sum(t["seconds"] for t in traced)
    n_dev = 1
    for n in mesh_axes(mesh).values():
        n_dev *= n
    args_b = argument_bytes(cfg, shape, mesh, knobs)
    peaks = by_phase(peaks)
    peak = max(peaks.values())
    rec.update({
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "trace_depth": depths,
        "flops": flops,
        "collective_bytes_per_op": coll,
        "collective_bytes_per_phase": coll_phase,
        "collective_bytes": sum(coll.values()),
        "memory": {"argument_bytes": args_b, "output_bytes": out_b,
                   "temp_bytes": peak - args_b, "peak_bytes": peak,
                   "peak_per_phase": peaks},
        "n_devices": n_dev,
    })
    if verbose:
        print(f"[dryrun] {rec['arch']} x {shape.name} x {rec['mesh']}: OK "
              f"(trace {trace_s:.1f}s, GFLOPs {flops / 1e9:.1f}, "
              f"coll {rec['collective_bytes'] / 1e6:.1f}MB, args/device "
              f"{args_b / 1e9:.2f}GB, peak/device {peak / 1e9:.2f}GB)",
              flush=True)
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
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    results: Dict[int, Dict[str, Any]] = {}

    def keep(i, rec):
        results[i] = rec
        if args.out:
            with open(args.out, "w") as f:
                json.dump([results[k] for k in sorted(results)], f,
                          indent=1)

    # every traced depth of every combination is a task of its own, by
    # the work of a call (`_KIND_ORDER`), the deepest first; a worker
    # keeps its fake group from task to task, and with both meshes is a
    # fresh process for each task (DTensor's caches hold on to a
    # replaced group's subgroups)
    tasks = []
    for i, (a, s, mp) in enumerate(combos):
        cfg, shape = _config(a, s, args.pad_vocab)
        if skip_reason(cfg, shape):
            keep(i, _run_combo(a, s, mp, knobs, []))
            continue
        for j, (c, _) in enumerate(depth_variants(cfg,
                                                  shape.kind == "train")):
            depth = c.n_layers + (c.encoder.n_layers if c.encoder else 0)
            tasks.append((_KIND_ORDER[shape.kind], -depth, i, j))
    traced: Dict[int, list] = {i: [] for i in range(len(combos))}
    errors: Dict[int, tuple] = {}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                             max_tasks_per_child=1 if args.both_meshes
                             else None) as pool:
        futures = {pool.submit(trace_variant, combos[i][0], combos[i][1],
                               j, multi_pod=combos[i][2], **knobs): (i, j)
                   for *_, i, j in sorted(tasks)}
        left = Counter(i for *_, i, _ in tasks)
        for fut in as_completed(futures):
            i, j = futures[fut]
            try:
                traced[i].append((j, fut.result()))
            except Exception as e:
                errors.setdefault(i, (e, "".join(traceback.format_exception(
                    e))))
            left[i] -= 1
            if left[i] == 0:
                a, s, mp = combos[i]
                keep(i, _run_combo(a, s, mp, knobs,
                                   [t for _, t in sorted(traced[i])],
                                   errors.get(i)))
    ok = sum(1 for r in results.values() if r["status"] == "ok")
    sk = sum(1 for r in results.values() if r["status"] == "skipped")
    err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"[dryrun] done: {ok} ok, {sk} skipped (documented), {err} failed")
    return 1 if err else 0


def _run_combo(a: str, s: str, mp: bool, knobs: dict, traced: list,
               error: Optional[tuple] = None) -> Dict[str, Any]:
    """`dryrun_one` of one (arch, shape name, multi_pod) from its traced
    variants, or its error record: the op DTensor refused and the
    traceback's end."""
    try:
        if error is not None:
            raise error[0]
        return dryrun_one(a, s, multi_pod=mp, traced=traced, **knobs)
    except Exception as e:
        tb = error[1] if error is not None else traceback.format_exc()
        print(f"[dryrun] {a} x {s}: FAILED {e!r}", file=sys.stderr,
              flush=True)
        return {"arch": a, "shape": s,
                "mesh": _mesh_name(production_shape(mp)),
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
