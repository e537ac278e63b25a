"""Index stage of the managed lookup and the `pm_combine` kernel's
wrapper.

`_compact_math` is the probe/compact/segment arithmetic of
`repro/kernels/pm_forward.py`, written once against a small array shim so
the training step's device probe (`step_residual`, torch) and the serving
runtime's admission probe (`host_compact`, numpy) are the same code:
binary-search every token against the sorted replica-cache ids, sort the
token ids once, deduplicate the missed ids and compact them into the
planner's intent-sized buffer of M slots (slot M is the all-zero trash row
that overflow tokens read), and keep the sort (`SortResidual`) for the
backward pre-sum and the sparse optimizer, which then never sort again.

`pm_combine` replaces the Pallas TPU kernel `repro/kernels/pm_forward.py::
_combine_kernel`: per token, the winning row — the cache row on a hit, the
miss-buffer row otherwise — and only that row is read.  Like the gather it
is bound by memory traffic (``T * D * elt`` bytes read and as many
written); one warp copies one token's row as raw words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build
from .embed_gather import check_rows, index_operand
from .ref import pm_combine_ref


class ProbeCompact(NamedTuple):
    """Index-stage outputs of the managed lookup (all static shapes)."""

    hit: torch.Tensor         # (T,) bool, token served by the replica cache
    cache_slot: torch.Tensor  # (T,) int32 cache row (clipped; valid on hit)
    buf_ids: torch.Tensor     # (M,) int32 UNIQUE missed ids (pad: 0)
    buf_slot: torch.Tensor    # (T,) int32 buffer slot per token (M = trash)
    n_miss: torch.Tensor      # () int32 count of unique missed ids
    overflow: torch.Tensor    # (T,) bool, unique misses beyond capacity M


class SortResidual(NamedTuple):
    """The reusable product of one token-id argsort: enough to aggregate
    duplicate rows (`ops.segment_rows`) or compact unique ids
    (`ops.unique_rows`) without sorting again."""

    order: torch.Tensor       # (T,) int32 argsort permutation of the ids
    sorted_ids: torch.Tensor  # (T,) int32 ids[order]
    slot: torch.Tensor        # (T,) int32 unique-group index per sorted pos


class StepResidual(NamedTuple):
    """Everything a managed step derives from its token ids, computed from
    a single argsort: the probe/compact index stage (forward) plus the
    full-token sort residual (backward pre-sum + sparse optimizer)."""

    probe: ProbeCompact
    sort: SortResidual
    n_uniq: torch.Tensor      # () int32 unique token ids in the step


class _NumpyOps:
    """The array operations `_compact_math` uses, on numpy."""

    int32 = np.int32
    bool = np.bool_
    searchsorted = staticmethod(np.searchsorted)
    clip = staticmethod(np.clip)
    argsort = staticmethod(np.argsort)
    concatenate = staticmethod(np.concatenate)
    cumsum = staticmethod(np.cumsum)
    sum = staticmethod(np.sum)
    where = staticmethod(np.where)

    @staticmethod
    def astype(x, dtype):
        return x.astype(dtype)

    @staticmethod
    def zeros(shape, dtype, like):
        return np.zeros(shape, dtype)

    @staticmethod
    def ones(shape, dtype, like):
        return np.ones(shape, dtype)

    @staticmethod
    def scatter_set(dst, idx, val):
        dst[idx] = val
        return dst


class _TorchOps:
    """The same operations on torch tensors (on the tensors' device).  The
    sort is stable, as ``jnp.argsort`` is."""

    int32 = torch.int32
    bool = torch.bool

    @staticmethod
    def searchsorted(a, v):
        return torch.searchsorted(a, v)

    @staticmethod
    def clip(x, lo, hi):
        return x.clamp(lo, hi)

    @staticmethod
    def argsort(x):
        return torch.argsort(x, stable=True)

    @staticmethod
    def concatenate(xs):
        return torch.cat(xs)

    @staticmethod
    def cumsum(x):
        return torch.cumsum(x, 0)

    @staticmethod
    def sum(x):
        return x.sum()

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)

    @staticmethod
    def zeros(shape, dtype, like):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    @staticmethod
    def ones(shape, dtype, like):
        return torch.ones(shape, dtype=dtype, device=like.device)

    @staticmethod
    def scatter_set(dst, idx, val):
        dst[idx.long()] = val
        return dst


def _compact_math(xp, cache_ids, tok, miss_capacity: int) -> dict:
    """The probe/compact/segment arithmetic, once, for numpy and torch.

    One argsort of the raw token ids orders every duplicate group; hits
    are identified independently by binary search, so the same sorted
    view yields (a) the unique *missed* ids in ascending order — each
    claims one dense buffer slot, duplicates share it, overflow beyond
    ``miss_capacity`` routes to the trash slot M — and (b) the unique-id
    compaction over ALL tokens that the backward/optimizer reuse.

    Deduplication is load-bearing: the planner's `intent_miss_bound`
    counts unique ids per step, so duplicate missed tokens must share one
    slot for the static capacity to be exact."""
    M = miss_capacity
    T = tok.shape[0]
    C = cache_ids.shape[0]
    int32 = xp.int32
    if C:
        cache_slot = xp.astype(xp.clip(xp.searchsorted(cache_ids, tok),
                                       0, C - 1), int32)
        hit = cache_ids[cache_slot] == tok
    else:
        cache_slot = xp.zeros((T,), int32, tok)
        hit = xp.zeros((T,), xp.bool, tok)

    order = xp.astype(xp.argsort(tok), int32)    # THE step's one sort
    s = tok[order]
    hs = hit[order]
    first = xp.concatenate([xp.ones((1,), xp.bool, tok), s[1:] != s[:-1]])
    # unique-id compaction over all tokens (backward/optimizer residual)
    seg_slot = xp.astype(xp.cumsum(xp.astype(first, int32)) - 1, int32)
    n_uniq = xp.sum(xp.astype(first, int32))
    # unique MISSED ids claim dense buffer slots in ascending-id order
    # (hit status is constant within a duplicate group)
    miss_first = first & ~hs
    mgrp = xp.astype(xp.cumsum(xp.astype(miss_first, int32)) - 1, int32)
    n_miss = xp.sum(xp.astype(miss_first, int32))
    in_buf = miss_first & (mgrp < M)
    buf_ids = xp.scatter_set(xp.zeros((M + 1,), int32, tok),
                             xp.where(in_buf, mgrp, M),
                             xp.astype(xp.where(in_buf, s, 0), int32))[:M]
    slot_sorted = xp.astype(xp.where(~hs & (mgrp < M), mgrp, M), int32)
    buf_slot = xp.scatter_set(xp.zeros((T,), int32, tok), order,
                              slot_sorted)
    over_sorted = ~hs & (mgrp >= M)
    overflow = xp.scatter_set(xp.zeros((T,), xp.bool, tok), order,
                              over_sorted)
    return dict(hit=hit, cache_slot=cache_slot, buf_ids=buf_ids,
                buf_slot=buf_slot, n_miss=n_miss, overflow=overflow,
                order=order, sorted_ids=xp.astype(s, int32),
                seg_slot=seg_slot, n_uniq=n_uniq)


def step_residual(cache_ids: torch.Tensor, tok: torch.Tensor,
                  miss_capacity: int) -> StepResidual:
    """Probe (T,) tokens against the sorted cache and derive the FULL step
    residual — probe/compact index stage plus the reusable sort — from a
    single stable argsort, on the tokens' device with no host sync.
    Compute once per managed step; every other consumer (backward
    pre-sum, sparse row optimizer) reads these tensors instead of
    re-sorting."""
    r = _compact_math(_TorchOps, cache_ids.to(torch.int32),
                      tok.to(torch.int32), miss_capacity)
    return StepResidual(
        probe=ProbeCompact(r["hit"], r["cache_slot"], r["buf_ids"],
                           r["buf_slot"], r["n_miss"], r["overflow"]),
        sort=SortResidual(r["order"], r["sorted_ids"], r["seg_slot"]),
        n_uniq=r["n_uniq"])


def probe_and_compact(cache_ids: torch.Tensor, tok: torch.Tensor,
                      miss_capacity: int) -> ProbeCompact:
    """Index-stage-only view of `step_residual`."""
    return step_residual(cache_ids, tok, miss_capacity).probe


def host_compact(cache_ids: np.ndarray, tok: np.ndarray,
                 miss_capacity: int) -> dict:
    """Probe (T,) tokens against the sorted cache ids on the host (numpy):
    the same `_compact_math` as `step_residual`."""
    return _compact_math(_NumpyOps, np.asarray(cache_ids),
                         np.asarray(tok, dtype=np.int32), miss_capacity)


def pm_combine(hit: torch.Tensor, cache_slot: torch.Tensor,
               buf_slot: torch.Tensor, cache_rows: torch.Tensor,
               buf_rows: torch.Tensor) -> torch.Tensor:
    """Per-token select: ``out[t] = cache_rows[cache_slot[t]]`` on hit
    else ``buf_rows[buf_slot[t]]``.  cache_rows (C, D); buf_rows (M+1, D)
    with the trash row last; returns (T, D).

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and raises if the build or the launch fails).  The slots
    come from the host probe: ``cache_slot`` in ``[0, C)`` on hits and
    ``buf_slot`` in ``[0, M]`` on misses."""
    if cache_rows.device.type == "cpu":
        return pm_combine_ref(hit, cache_slot, buf_slot, cache_rows,
                              buf_rows)
    dev = cache_rows.device
    check_rows("pm_combine", dev, cache_rows, buf_rows)
    hit, cache_slot, buf_slot = (index_operand("pm_combine", dev, x)
                                 for x in (hit, cache_slot, buf_slot))
    T, D = hit.shape[0], cache_rows.shape[1]
    if cache_slot.shape[0] != T or buf_slot.shape[0] != T:
        raise ValueError("pm_combine: hit and slot lengths differ")
    out = torch.empty((T, D), dtype=cache_rows.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = build.library().pm_combine_launch(
            hit.data_ptr(), cache_slot.data_ptr(), buf_slot.data_ptr(),
            cache_rows.data_ptr(), buf_rows.data_ptr(), out.data_ptr(), T,
            D * cache_rows.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "pm_combine")
    pm_combine.launches += 1
    return out


pm_combine.launches = 0
