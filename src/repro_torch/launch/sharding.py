"""Sharding rules: parameter, batch and cache dimensions -> mesh axes (the
twin of `repro/launch/sharding.py`).

Scheme, as the reference's:

* "model" axis: tensor parallelism — vocab, attention heads, FFN hidden,
  MoE experts (expert-parallel when E divides), Mamba d_inner;
* "data" (x "pod") axis: batch; parameters and optimizer state also
  ZeRO-shard their d_model-sized dimension over "data" (FSDP-style; the
  model gathers a layer's weights to their tensor-parallel layout inside
  the layer loop when given ``fsdp_spec``);
* a rule whose dimension does not divide its mesh axis falls back to
  replication for that dimension (e.g. smollm's 9 heads on a 16-way
  model axis).

A spec is a tuple with one entry per dimension: a mesh axis name, a tuple
of names (the dimension sharded over each of them), or None — the
reference's ``PartitionSpec``.  The rules work on the port's own names:
its layers are unstacked (``layers.<i>.<rest>``), so no spec has the
reference's leading layer entry, and the decode cache is the port's dict
(``len`` a host integer).  They read only a mesh's axis names and sizes
(`launch.mesh.mesh_axes`), so a `DeviceMesh`, a `ModelGroup` or a
`MeshShape` will do; `placements` turns a spec into a `DeviceMesh`'s
DTensor placements.

`block_rows` and `place_table` place the intent-managed table on the
vocab-parallel mesh (the reference's `managed_table_sharding`): every row
has one owner, rank k of n holding rows ``[k·V/n, (k+1)·V/n)`` of the
table and of each optimizer state of the table's shape, with the feature
dimension whole.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .mesh import axis_size, batch_axes, mesh_axes

Spec = Tuple[Any, ...]


def block_rows(vocab: int, rank: int, n: int) -> slice:
    """The rows rank ``rank`` of ``n`` owns; ``vocab`` must divide by n."""
    if vocab % n:
        raise ValueError(f"vocab {vocab} must divide the 'model' axis ({n})")
    b = vocab // n
    return slice(rank * b, (rank + 1) * b)


def place_table(x, mesh) -> torch.Tensor:
    """This rank's block of a table or accumulator ``x`` ((V, ...), numpy
    or tensor), contiguous on the mesh's device.  A tensor already on the
    device is not copied when the mesh has one rank; otherwise the block
    is its own storage (it neither aliases a numpy source nor keeps a
    full table alive)."""
    sl = block_rows(x.shape[0], mesh.rank, mesh.size)
    if isinstance(x, np.ndarray):
        blk = torch.from_numpy(np.ascontiguousarray(x[sl]))
        return blk.clone() if mesh.device.type == "cpu" \
            else blk.to(mesh.device)
    blk = x[sl]
    if mesh.size > 1 and x.device == mesh.device:
        return blk.clone(memory_format=torch.contiguous_format)
    return blk.to(mesh.device).contiguous()


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _roles_for(name: str, shape, in_moe: bool, cfg: ModelConfig):
    """Role per dimension of one (unstacked) parameter, by its leaf name."""
    nd = len(shape)
    if name == "embed":
        return ("vocab", "zero")
    if name == "head":
        return ("zero", "vocab")
    if in_moe:
        if name == "router":
            return ("zero", None)
        if name in ("w_gate", "w_up"):
            return ("expert", "zero", "tp_sub")
        if name == "w_down":
            return ("expert", "tp_sub", "zero")
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "in_proj"):
        return ("zero", "tp")
    if name in ("wo", "w_down", "w_out", "out_proj"):
        return ("tp", "zero")
    if name in ("conv_w", "x_proj"):
        return ("tp", None)
    if name in ("conv_b", "dt_bias", "D_skip"):
        return ("tp",)
    if name == "dt_proj":
        # mamba1: (dt_rank, d_inner); mamba2: (d_model, n_heads)
        return (None, "tp") if nd == 2 else ("tp",)
    if name == "A_log":
        return ("tp", None) if nd == 2 else ("tp",)
    if name in ("B_proj", "C_proj"):
        return ("zero", None)
    return tuple(None for _ in range(nd))


def needs_zero(cfg: ModelConfig, mesh, budget_bytes: float = 10e9) -> bool:
    """Auto-ZeRO heuristic: shard layer weights over "data" (FSDP) only
    when tensor-parallel weights and AdaGrad state would not fit the
    per-device budget (bf16 parameters + fp32 accumulator = 6 bytes a
    parameter)."""
    per_dev = cfg.param_count() / axis_size(mesh, "model") * 6.0
    return per_dev > budget_bytes


def param_pspecs(shapes: Mapping[str, Any], cfg: ModelConfig, mesh, *,
                 zero_embed_head: bool = True,
                 zero_layers: Optional[bool] = None) -> Dict[str, Spec]:
    """A spec per named parameter of ``shapes`` (name -> anything with a
    ``.shape``: the model's named parameters, its optimizer state, or one
    layer's parameters named relative to the layer).

    ``zero_embed_head``: also ZeRO-shard the d_model dimension of the
    embedding table and the head over "data" (the naive FSDP baseline,
    which shards the head's contraction dimension); False keeps them
    vocab-sharded over "model" only.  ``zero_layers``: ZeRO-shard layer
    weights over "data"; None: `needs_zero`."""
    dsize = axis_size(mesh, "data")
    msize = axis_size(mesh, "model")
    if zero_layers is None:
        zero_layers = needs_zero(cfg, mesh)
    expert_parallel = cfg.n_experts > 0 and _fits(cfg.n_experts, msize)

    def resolve(role, dim: int, expert_used: bool):
        if role in ("vocab", "tp"):
            return "model" if _fits(dim, msize) else None
        if role == "expert":
            return "model" if expert_parallel else None
        if role == "tp_sub":
            # the experts' hidden dimension takes "model" only when the
            # experts do not (a dimension cannot use an axis twice)
            if expert_used:
                return None
            return "model" if _fits(dim, msize) else None
        if role == "zero":
            if not zero_layers:
                return None
            return "data" if _fits(dim, dsize) else None
        return None

    def spec(name: str, shape) -> Spec:
        parts = name.split(".")
        leaf = parts[-1]
        roles = _roles_for(leaf, shape, "moe" in parts, cfg)
        if not zero_embed_head:
            if leaf == "embed":
                roles = ("vocab", None)
            elif leaf == "head":
                roles = (None, "vocab")
        expert_used = expert_parallel and "expert" in roles
        return tuple(resolve(r, d, expert_used and r == "tp_sub")
                     for r, d in zip(roles, shape))

    return {name: spec(name, tuple(t.shape)) for name, t in shapes.items()}


def batch_entry(mesh):
    """The spec entry of a batch dimension (the batch axes: one name, or
    a tuple of them) and the number of devices it spans."""
    baxes = batch_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= axis_size(mesh, a)
    return (baxes[0] if len(baxes) == 1 else baxes), bsize


def batch_pspecs(cfg: ModelConfig, mesh,
                 batch_shapes: Mapping[str, Any]) -> Dict[str, Spec]:
    """A spec per field of a training or prefill batch (dimension 0 the
    global batch; the managed embedding's replica cache replicated).
    ``batch_shapes``: name -> a shape tuple or anything with a
    ``.shape``."""
    baxes, bsize = batch_entry(mesh)

    def spec(name: str, shape) -> Spec:
        if name.startswith("pm_cache"):
            return (None,) * len(shape)
        first = baxes if _fits(shape[0], bsize) or shape[0] == bsize \
            else None
        return (first,) + (None,) * (len(shape) - 1)

    return {name: spec(name, _shape(s)) for name, s in batch_shapes.items()}


def cache_pspecs(cfg: ModelConfig, mesh,
                 cache: Mapping[str, Any]) -> Dict[str, Spec]:
    """A spec per tensor of a decode cache (`models.model.init_cache`);
    ``len``, a host integer, has none."""
    baxes, bsize = batch_entry(mesh)
    dsize = axis_size(mesh, "data")
    msize = axis_size(mesh, "model")

    def b_ax(B: int):
        return baxes if _fits(B, bsize) else None

    def spec(name: str, shape) -> Spec:
        if name in ("k", "v", "attn_k", "attn_v"):
            L, B, S, KvH, hd = shape
            kv_ax = "model" if _fits(KvH, msize) else None
            hd_ax = "model" if kv_ax is None and _fits(hd, msize) else None
            s_ax = "data" if b_ax(B) is None and _fits(S, dsize) else None
            return (None, b_ax(B), s_ax, kv_ax, hd_ax)
        if name == "conv":
            L, B, K1, di = shape
            return (None, b_ax(B), None,
                    "model" if _fits(di, msize) else None)
        if name == "h":
            if len(shape) == 4:      # mamba1 (L, B, di, N)
                L, B, di, N = shape
                return (None, b_ax(B),
                        "model" if _fits(di, msize) else None, None)
            L, B, nh, hd, N = shape  # mamba2
            return (None, b_ax(B), "model" if _fits(nh, msize) else None,
                    None, None)
        if name == "enc_out":
            return (b_ax(shape[0]), None, None)
        return (None,) * len(shape)

    return {name: spec(name, _shape(s)) for name, s in cache.items()
            if name != "len"}


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on the `DeviceMesh` ``mesh``:
    ``Shard(dim)`` on each mesh dimension a tensor dimension names (a
    tuple of axes shards that dimension over each of them, in order),
    ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            out[names.index(a)] = Shard(dim)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard shape of a tensor of ``shape`` under ``spec``
    (every named axis divides its dimension, as the rules ensure)."""
    sizes = mesh_axes(mesh)
    out = []
    for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            if d % sizes[a]:
                raise ValueError(f"dimension {d} does not divide axis {a!r} "
                                 f"({sizes[a]})")
            d //= sizes[a]
        out.append(d)
    return tuple(out)


def _shape(s) -> Tuple[int, ...]:
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)
