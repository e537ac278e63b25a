"""Layouts of DTensor activations and their gradients (the dry run,
`launch.dryrun`, runs the model on DTensors over a fake process group).

Where the reference constrains a layout with `with_sharding_constraint`
and lets XLA's partitioner do the rest, the port redistributes a DTensor
only where DTensor has no rule for an op of the model, or where a layer
boundary fixes the layout (`between_layers`).  Each helper returns a
plain tensor as it is, so runs without DTensors are unchanged.  A
gradient's layout is fixed by `laid_out_grad`: the identity, whose
backward redistributes the gradient (DTensor's own backward of a
redistribution returns the forward's input layout, which some ops of the
backward cannot take).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def whole_along(t: DTensor, dim: int, parts: int) -> DTensor:
    """``t`` gathered along ``dim`` over every mesh dimension that shards
    it, unless ``parts`` (the number of pieces a following split makes
    of it) divides among them: DTensor cannot split an unevenly sharded
    dimension."""
    ways = 1
    for i, pl in enumerate(t.placements):
        if pl.is_shard(dim):
            ways *= t.device_mesh.size(i)
    if parts % ways == 0:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_shard(dim) else pl for pl in t.placements])


def reduce_partials(t):
    """A DTensor's pending partial sums reduced (its other placements
    kept); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in t.placements])


def as_param(g, p):
    """A parameter's gradient ``g`` laid out as the parameter ``p``: a
    DTensor's pending partial sums reduced once, into ``p``'s placements
    (an all-reduce where ``p`` is replicated, a reduce-scatter where it
    is sharded), in ``g``'s own dtype; a plain tensor as it is.  Left
    partial, every op of the optimizer that needs it whole would reduce
    it again.  The smaller tensor moves: first the mesh dimensions where
    ``g`` is whole and ``p`` sharded are cut (a local chunk, nothing
    moves), then the reduce-scatters, then the all-reduces."""
    if not isinstance(g, DTensor):
        return g
    for move in (lambda pl, q: pl.is_replicate() and q.is_shard(),
                 lambda pl, q: pl.is_partial() and q.is_shard()):
        lay = [q if move(pl, q) else pl
               for pl, q in zip(g.placements, p.placements)]
        if lay != list(g.placements):
            g = g.redistribute(g.device_mesh, lay)
    return g.redistribute(p.device_mesh, p.placements)


class _GradLaidOut(torch.autograd.Function):
    """The identity, whose backward lays the gradient out by ``fn``."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def laid_out_grad(t, fn):
    """``t``, whose gradient a DTensor's backward lays out by ``fn``; a
    plain tensor as it is."""
    return _GradLaidOut.apply(t, fn) if isinstance(t, DTensor) else t


def reduce_partials_both_ways(t):
    """`reduce_partials` of ``t``, and of its gradient in the backward
    (DTensor cannot turn a gradient of plain partial sums into the masked
    ones a vocab-sharded lookup leaves)."""
    return laid_out_grad(reduce_partials(t), reduce_partials)


def between_layers(h):
    """The residual stream where one layer hands it to the next.  A
    DTensor is laid out with its batch over the mesh's batch axes (where
    they divide it) and whole over "model", and so is its gradient in the
    backward: every layer then meets the same layouts, forward and
    backward (the reference constrains its scan's carry likewise with
    ``act_spec``).  A plain tensor is returned as it is."""
    if not isinstance(h, DTensor):
        return h
    mesh = h.device_mesh
    names = mesh.mesh_dim_names
    batch = [i for i, n in enumerate(names) if n in ("pod", "data")]
    ways = 1
    for i in batch:
        ways *= mesh.size(i)
    lay = [Shard(0) if i in batch and h.shape[0] % ways == 0
           else Replicate() for i in range(len(names))]
    return laid_out_grad(h.redistribute(mesh, lay),
                         lambda g: g.redistribute(mesh, lay))


def replicated(t):
    """A DTensor whole on every device (partial sums reduced, shards
    gathered); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def whole_heads(t):
    """A DTensor (B, S, heads, hd) gathered along its heads and head
    dimension, its batch and positions kept; a plain tensor as it is.
    The attention's batched products flatten (batch, heads) into one
    dimension, which DTensor cannot do where both are sharded, so under
    DTensor the attention runs with whole heads on each device's batch."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_shard() and pl.dim % t.ndim >= 2 else pl
        for pl in t.placements])
