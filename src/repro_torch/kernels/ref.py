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


def selective_scan_ref(u, delta, A, Bm, Cm, D, h0=None, *, chunk: int = 256):
    """The Mamba-1 selective scan as plain torch ops, the composition
    `models/ssm.py::mamba1_block` ran before the kernel (and runs on CPU
    tensors and DTensors): ``a = exp(delta A)`` and ``b = delta u B``
    materialised (B, S, di, N), `ssm.linear_scan` over them in chunks of
    ``chunk`` from ``h0`` (zeros when None), ``y = sum_n h C + D u``.
    u, delta (B, S, di); A (di, N); Bm, Cm (B, S, N); D (di,); h0 (B,
    di, N).  Returns ``(y, h_last)``."""
    from ..models.ssm import linear_scan
    a = torch.exp(delta[..., None] * A)                       # (B,S,di,N)
    b = (delta * u)[..., None] * Bm[:, :, None, :]
    if h0 is None:
        h0 = b.new_zeros((b.shape[0],) + b.shape[2:], dtype=torch.float32)
    h, h_last = linear_scan(a, b, h0, chunk)
    y = torch.einsum("bsdn,bsn->bsd", h, Cm)
    return y + D * u, h_last


def selective_scan_backward_ref(u, delta, A, Bm, Cm, D, h0, dy, dh_last):
    """The selective scan's gradients by the kernel's reverse pass, one
    position at a time: the states h_t forward from ``h0`` (zeros when
    None), then from the last position ``g_t = dy_t C_t + a_{t+1}
    g_{t+1}`` (seeded with ``dh_last``, zeros when None) and

        ddelta_t = sum_n g_t (h_{t-1} a_t A + u_t B_t)
        du_t = sum_n g_t delta_t B_t + D dy_t
        dB_t = sum_d g_t delta_t u_t,   dC_t = sum_d dy_t h_t
        dA = sum_{b,t} g_t h_{t-1} a_t delta_t,   dD = sum_{b,t} dy u
        dh0 = a_0 g_0.

    Returns ``(du, ddelta, dA, dB, dC, dD, dh0)``."""
    a = torch.exp(delta[..., None] * A)                       # (B,S,di,N)
    h = [u.new_zeros(a[:, 0].shape) if h0 is None else h0]
    for t in range(u.shape[1]):
        h.append(a[:, t] * h[-1]
                 + (delta[:, t] * u[:, t])[..., None] * Bm[:, t, None, :])
    g_next = torch.zeros_like(h[0]) if dh_last is None else dh_last
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    for t in reversed(range(u.shape[1])):
        g = dy[:, t, :, None] * Cm[:, t, None, :] + g_next     # (B,di,N)
        at, hp = a[:, t], h[t]
        ddelta[:, t] = (g * (hp * at * A
                             + u[:, t, :, None] * Bm[:, t, None, :])).sum(-1)
        du[:, t] = (g * delta[:, t, :, None]
                    * Bm[:, t, None, :]).sum(-1) + D * dy[:, t]
        dB[:, t] = (g * (delta[:, t] * u[:, t])[..., None]).sum(1)
        dC[:, t] = (dy[:, t, :, None] * h[t + 1]).sum(1)
        dA += (g * hp * at * delta[:, t, :, None]).sum(0)
        g_next = at * g
    return du, ddelta, dA, dB, dC, (dy * u).sum((0, 1)), g_next
