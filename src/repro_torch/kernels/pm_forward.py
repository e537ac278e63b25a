"""Index stage of the managed lookup (numpy, on the host) and the
`pm_combine` kernel's wrapper.

The serving runtime probes each batch at admission: `host_compact` is the
probe/compact arithmetic of `repro/kernels/pm_forward.py::_compact_math`
on numpy — binary-search every token against the sorted replica-cache
ids, deduplicate the missed ids and compact them into the planner's
intent-sized buffer of M slots (slot M is the all-zero trash row that
overflow tokens read).

`pm_combine` replaces the Pallas TPU kernel `repro/kernels/pm_forward.py::
_combine_kernel`: per token, the winning row — the cache row on a hit, the
miss-buffer row otherwise — and only that row is read.  Like the gather it
is bound by memory traffic (``T * D * elt`` bytes read and as many
written); one warp copies one token's row as raw words.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .embed_gather import check_rows, index_operand
from .ref import pm_combine_ref


def _compact_math(cache_ids: np.ndarray, tok: np.ndarray,
                  miss_capacity: int) -> dict:
    """The probe/compact/segment arithmetic.

    One argsort of the raw token ids orders every duplicate group; hits
    are identified independently by binary search, so the same sorted
    view yields (a) the unique *missed* ids in ascending order — each
    claims one dense buffer slot, duplicates share it, overflow beyond
    ``miss_capacity`` routes to the trash slot M — and (b) the unique-id
    compaction over ALL tokens.

    Deduplication is load-bearing: the planner's `intent_miss_bound`
    counts unique ids per step, so duplicate missed tokens must share one
    slot for the static capacity to be exact."""
    M = miss_capacity
    T = tok.shape[0]
    C = cache_ids.shape[0]
    int32 = np.int32
    if C:
        cache_slot = np.clip(np.searchsorted(cache_ids, tok),
                             0, C - 1).astype(int32)
        hit = cache_ids[cache_slot] == tok
    else:
        cache_slot = np.zeros((T,), int32)
        hit = np.zeros((T,), bool)

    order = np.argsort(tok).astype(int32)
    s = tok[order]
    hs = hit[order]
    first = np.concatenate([np.ones((1,), bool), s[1:] != s[:-1]])
    seg_slot = (np.cumsum(first.astype(int32)) - 1).astype(int32)
    n_uniq = np.sum(first.astype(int32))
    # unique MISSED ids claim dense buffer slots in ascending-id order
    # (hit status is constant within a duplicate group)
    miss_first = first & ~hs
    mgrp = (np.cumsum(miss_first.astype(int32)) - 1).astype(int32)
    n_miss = np.sum(miss_first.astype(int32))
    in_buf = miss_first & (mgrp < M)
    buf_ids = np.zeros((M + 1,), int32)
    buf_ids[np.where(in_buf, mgrp, M)] = np.where(in_buf, s, 0)
    buf_ids = buf_ids[:M]
    buf_slot = np.zeros((T,), int32)
    buf_slot[order] = np.where(~hs & (mgrp < M), mgrp, M)
    overflow = np.zeros((T,), bool)
    overflow[order] = ~hs & (mgrp >= M)
    return dict(hit=hit, cache_slot=cache_slot, buf_ids=buf_ids,
                buf_slot=buf_slot, n_miss=n_miss, overflow=overflow,
                order=order, sorted_ids=s.astype(int32), seg_slot=seg_slot,
                n_uniq=n_uniq)


def host_compact(cache_ids: np.ndarray, tok: np.ndarray,
                 miss_capacity: int) -> dict:
    """Probe (T,) tokens against the sorted cache ids on the host."""
    return _compact_math(np.asarray(cache_ids),
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
