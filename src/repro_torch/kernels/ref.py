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


def adagrad_row_update_ref(table, accum, ids, grads, *, lr=0.1, eps=1e-8):
    """Summed-gradient AdaGrad on unique rows ``ids``, in place; ids outside
    ``[0, V)`` (segment pads) are skipped.  fp32 math in the kernel's
    order, each operation rounded on its own: ``acc = acc + g * g``, then
    ``p = p - (lr * g) / (sqrt(acc) + eps)``, cast back to the table's
    type.  Returns ``(table, accum)``."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < table.shape[0])
    ids = ids[valid]
    g = grads[valid].float()
    acc = accum.index_select(0, ids).float() + g * g
    p = table.index_select(0, ids).float() - lr * g / (torch.sqrt(acc) + eps)
    accum.index_copy_(0, ids, acc.to(accum.dtype))
    table.index_copy_(0, ids, p.to(table.dtype))
    return table, accum


def adagrad_row_add_ref(table, accum, ids, grads, *, lr=0.1, eps=1e-8):
    """Scatter-ADD form of the row update, in place: exact for unique
    ``ids`` plus any number of duplicate slots carrying all-zero gradients
    (a zero-grad duplicate adds 0 to the accumulator and to the row).
    Ids must lie in ``[0, V)``.  Returns ``(table, accum)``."""
    ids = ids.long()
    g = grads.float()
    accum.index_add_(0, ids, (g * g).to(accum.dtype))
    denom = torch.sqrt(accum.index_select(0, ids).float()) + eps
    table.index_add_(0, ids, (-lr * g / denom).to(table.dtype))
    return table, accum


def scatter_rows_ref(base, ids, rows):
    """``base[ids[i]] = rows[i]`` in place, rows cast to ``base``'s type;
    ids outside ``[0, R)`` are skipped.  Ids must be unique apart from pad
    collisions, which must carry equal rows.  Returns ``base``."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < base.shape[0])
    return base.index_put_((ids[valid],), rows[valid].to(base.dtype))
