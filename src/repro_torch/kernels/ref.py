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


def segment_rows_ref(ids, grads, n_unique: int):
    """Duplicate row gradients summed: ``(unique ids, sums)``, the unique
    ids ascending and padded with -1 to ``n_unique``, and their summed
    gradients (n_unique, D) in fp32, each row's added in token order
    (`index_add_in_order`).  The reference for `ops.segment_rows`."""
    uniq, inv = torch.unique(ids, return_inverse=True)
    out = torch.zeros((n_unique, grads.shape[1]), dtype=torch.float32,
                      device=grads.device)
    index_add_in_order(out, inv, grads.float())
    pad = uniq.new_full((n_unique - uniq.shape[0],), -1)
    return torch.cat([uniq, pad])[:n_unique], out


def index_add_in_order(out, index, src):
    """``out[index[i]] += src[i]`` for i in order, in place: the same bits
    on the CPU and on a card, in every run.  `index_add_` adds in that
    order on the CPU, but on a card its atomics add in no fixed order; an
    accumulating `index_put_` on a card sorts the index stably and adds
    each run in order (on the CPU it does not keep the order).  The last
    bit matters: it decides MoE routing near-ties, which then train two
    runs apart.  Returns ``out``."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


def segment_sum(order, sorted_ids, slot, grads, n_slots: int, pad_id: int):
    """Duplicate rows pre-summed from a sort (order, sorted_ids, slot):
    returns (slot ids (n_slots,) int32, sums (n_slots, D) fp32).  Unused
    slots get id ``pad_id`` and a zero row.  Each slot's rows are added
    one after another in sorted order, from 0 (`index_add_in_order`)."""
    s_g = grads.index_select(0, order.long()).float()
    out_g = torch.zeros((n_slots, grads.shape[1]), dtype=torch.float32,
                        device=grads.device)
    index_add_in_order(out_g, slot.long(), s_g)
    out_ids = torch.full((n_slots,), pad_id, dtype=torch.int32,
                         device=sorted_ids.device)
    out_ids[slot.long()] = sorted_ids.to(torch.int32)
    return out_ids, out_g


def segment_scatter_rows_ref(base, residual, grads):
    """``base[id] = sum of grads[order[k]]`` over each run of equal
    ``residual.sorted_ids``, in place: `segment_sum` with its pads at R
    (outside ``[0, R)``, so skipped) followed by `scatter_rows_ref`.
    Returns ``base``."""
    order, sorted_ids, slot = residual[:3]
    ids, sums = segment_sum(order, sorted_ids, slot, grads,
                            order.shape[0], base.shape[0])
    return scatter_rows_ref(base, ids, sums)
