"""Plain PyTorch versions of the hand-written kernels (the twins of
`repro/kernels/ref.py`).  The CPU path and the tests run these; on the
card, `chip_smoke.py` holds each kernel against them bit for bit."""

from __future__ import annotations

import torch


def embed_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, with a zero row for every id outside ``[0, V)`` (the
    runtime pads id buckets with V; `index_select` alone would raise)."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table.index_select(0, torch.where(valid, ids, 0))
    return rows.masked_fill(~valid[:, None], 0)


def pm_combine_ref(hit, cache_slot, buf_slot, cache_rows, buf_rows):
    """Per-token select between cache row and compact miss-buffer row."""
    hit_rows = cache_rows.index_select(0, cache_slot.long())
    miss_rows = buf_rows.index_select(0, buf_slot.long())
    return torch.where(hit.bool()[:, None], hit_rows, miss_rows)
