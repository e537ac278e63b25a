"""Dispatch to the hand-written kernels (the twin of
`repro/kernels/ops.py`).

``use_kernel=True`` goes to the kernel's wrapper, which launches the CUDA
kernel on CUDA tensors and runs the plain version on CPU tensors;
``use_kernel=False`` runs the plain version wherever the tensors are.
Each wrapper counts its launches, so a run can show that its path went
through the kernels (`launch_counts`).

Index-side helpers: `sorted_slots` is the shared residual *producer* (one
stable argsort -> a reusable `SortResidual`), and `segment_rows` /
`unique_rows` are its consumers — pass them a precomputed residual (the
managed step's `pm_forward.step_residual`) and they do no sorting at all,
which keeps the whole train step at a single sort.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .adagrad_rows import adagrad_row_update as _adagrad_kernel
from .embed_gather import embed_gather as _gather_kernel
from .pm_forward import SortResidual
from .pm_forward import pm_combine as _combine_kernel
from .scatter_rows import scatter_rows as _scatter_kernel
from .scatter_rows import segment_scatter_rows as _segment_scatter_kernel
from .selective_scan import selective_scan as _scan_kernel

KERNELS = {"embed_gather": _gather_kernel, "pm_combine": _combine_kernel,
           "adagrad_rows": _adagrad_kernel, "scatter_rows": _scatter_kernel,
           "segment_scatter_rows": _segment_scatter_kernel,
           "selective_scan": _scan_kernel}
#: kernels whose backward is a launch of its own, counted as
#: ``<name>_backward``
BACKWARDS = ("selective_scan",)


def embed_gather(table, ids, *, use_kernel: bool = True):
    """``table[ids]`` (zero rows for ids outside ``[0, V)``)."""
    if not use_kernel:
        return ref.embed_gather_ref(table, ids)
    return _gather_kernel(table, ids)


def masked_embed_gather(table, ids, valid, *, use_kernel: bool = True):
    """Gather with a validity mask: rows for ``ids`` where ``valid``,
    zeros elsewhere (the replica refresh, where invalid ids are pad
    slots)."""
    rows = embed_gather(table, ids.to(torch.int32), use_kernel=use_kernel)
    return torch.where(valid[:, None], rows, 0.0)


def adagrad_row_update(table, accum, ids, grads, *, lr=0.1, eps=1e-8,
                       use_kernel: bool = True):
    """Fused sparse AdaGrad row update, in place; ids must be unique
    apart from skipped pads outside ``[0, V)`` (see `segment_rows`)."""
    if not use_kernel:
        return ref.adagrad_row_update_ref(table, accum, ids, grads, lr=lr,
                                          eps=eps)
    return _adagrad_kernel(table, accum, ids, grads, lr=lr, eps=eps)


def pm_combine(hit, cache_slot, buf_slot, cache_rows, buf_rows, *,
               use_kernel: bool = True):
    """Managed-lookup select: hits read the replica cache, misses read
    the compact deduped buffer (trash row last)."""
    if not use_kernel:
        return ref.pm_combine_ref(hit, cache_slot, buf_slot, cache_rows,
                                  buf_rows)
    return _combine_kernel(hit, cache_slot, buf_slot, cache_rows, buf_rows)


def scatter_rows(base, ids, rows, *, use_kernel: bool = True):
    """Row scatter into ``base`` in place (the managed-lookup backward);
    ids must be unique apart from zero-row pad collisions."""
    if not use_kernel:
        return ref.scatter_rows_ref(base, ids, rows)
    return _scatter_kernel(base, ids, rows)


def segment_scatter_rows(base, residual: SortResidual, grads, *,
                         use_kernel: bool = True):
    """The lookup backward's gradient write in one step: ``base[id] =``
    the sum of the token gradients of each run of equal sorted ids (the
    forward's `SortResidual`), in place; ids outside ``[0, R)`` are
    skipped."""
    if not use_kernel:
        return ref.segment_scatter_rows_ref(base, residual, grads)
    return _segment_scatter_kernel(base, residual, grads)


def sorted_slots(ids, n_slots: int,
                 residual: Optional[SortResidual] = None) -> SortResidual:
    """Shared id-compaction residual: stable sort, flag first-of-group,
    cumsum to dense slot indices (clipped into n_slots).  A caller that
    already holds a step residual passes it through, and no sort runs."""
    if residual is not None:
        return SortResidual(residual.order, residual.sorted_ids,
                            residual.slot.clamp(max=n_slots - 1))
    ids = ids.to(torch.int32)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    s_ids = ids[order]
    is_new = torch.cat([torch.ones(1, dtype=torch.int32, device=ids.device),
                        (s_ids[1:] != s_ids[:-1]).to(torch.int32)])
    slot = (torch.cumsum(is_new, 0) - 1).clamp(max=n_slots - 1)
    return SortResidual(order, s_ids, slot.to(torch.int32))


def segment_rows(ids, grads, n_slots: int, pad_id: int = 0,
                 residual: Optional[SortResidual] = None):
    """Aggregate duplicate row ids: returns (slot ids (n_slots,) int32,
    summed grads (n_slots, D) fp32).  Unused slots get id ``pad_id`` with
    an all-zero gradient; a sentinel ``pad_id`` (the vocab size) lets the
    scatter and the row update skip them.  Sums are taken in fp32
    (`ref.segment_sum`).  ``residual``: a precomputed `SortResidual` for
    these ids (the managed step's single sort) — aggregation then runs
    sort-free."""
    order, s_ids, slot = sorted_slots(ids, n_slots, residual)
    return ref.segment_sum(order, s_ids, slot, grads, n_slots, pad_id)


def owner_segments(sorted_ids, n_valid, n_owners: int, block: int):
    """Per-owner segment boundaries of an ascending id list: the index
    stage of the mesh's destination-compacted routing.

    ``sorted_ids`` must be ascending on its first ``n_valid`` entries (an
    int or a 0-dim tensor; the probe/compact and segment contracts: unique
    ids claim slots in ascending-id order, so grouping by owner falls out
    of the step's one sort); entries past ``n_valid`` may hold anything.
    Returns ``(view, seg)``: ``view[i] = sorted_ids[i]`` for ``i <
    n_valid`` and the out-of-vocab sentinel ``n_owners * block`` after,
    and ``seg`` (``n_owners + 1`` int32 entries) with ``seg[k]`` the first
    position owned by shard k — per-owner counts are ``seg[1:] -
    seg[:-1]``.  Pure `searchsorted` over the ascending view: no sort."""
    dev = sorted_ids.device
    pos = torch.arange(sorted_ids.shape[0], dtype=torch.int32, device=dev)
    view = torch.where(pos < n_valid, sorted_ids.to(torch.int32),
                       n_owners * block).to(torch.int32)
    bounds = torch.arange(n_owners + 1, dtype=torch.int32,
                          device=dev) * block
    seg = torch.searchsorted(view, bounds).to(torch.int32)
    return view, seg


def unique_rows(ids, n_slots: int, pad_id: int = 0,
                residual: Optional[SortResidual] = None):
    """Unique ids compacted into ``n_slots`` slots (unused slots keep
    ``pad_id``) — the id-only fast path of `segment_rows`."""
    _, s_ids, slot = sorted_slots(ids, n_slots, residual)
    out = torch.full((n_slots,), pad_id, dtype=torch.int32,
                     device=ids.device)
    out[slot.long()] = s_ids
    return out


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last `reset_launch_counts`."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts.update({f"{name}_backward": KERNELS[name].backward_launches
                   for name in BACKWARDS})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for name in BACKWARDS:
        KERNELS[name].backward_launches = 0
