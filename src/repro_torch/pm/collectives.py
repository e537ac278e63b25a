"""Collective backends: the vocab-parallel communication layer of the
intent-managed embedding (the twin of `repro/pm/collectives.py`).

The managed lookup's cost is what moves through the network: only the
compact ``(M+1, D)`` miss buffer instead of every token's row.  Of the
reference's backends this package has `EmulatedBackend`, the single-device
stand-in: with ``n_shards > 1`` every gather materializes one owner-masked
``(n, D)`` partial per shard and sums them, the cost model for the
all-reduce's wire bytes on a one-device host.  ``n_shards == 1``
degenerates to a plain (optionally kernel) gather, which is the training
default.  The training step's backward scatter (`scatter_row_grads`), its
fused sparse AdaGrad (`update_rows`) and the delta refresh
(`refresh_rows_delta`) run here too.  The mesh backend over
several cards is not ported yet (`make_backend` raises for it).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.kernels import ops, ref


@dataclass(frozen=True)
class EmulatedBackend:
    """Single-host stand-in for the vocab-parallel collectives."""

    n_shards: int = 1
    mesh_real: bool = field(default=False, init=False)

    def gather_rows(self, table, ids, *, kernel: bool = False):
        """Rows for ``ids`` through the emulated collective: ``kernel``
        gathers with the `embed_gather` kernel.  Ids outside ``[0, V)``
        (bucket pads) come back as zero rows.  With ``n_shards > 1`` the
        result is the sum of one owner-masked partial per shard, added in
        shard order as the reference adds them."""
        rows = ops.embed_gather(table, ids, use_kernel=kernel)
        if self.n_shards <= 1:
            return rows
        V = table.shape[0]
        block = -(-V // self.n_shards)
        owner = ids.long() // block
        partial = torch.zeros_like(rows)
        for s in range(self.n_shards):
            partial = partial + torch.where((owner == s)[:, None], rows, 0.0)
        return partial

    def scatter_row_grads(self, tok, g, vocab_size: int, *,
                          kernel: bool = False, segmented: bool = False):
        """Route all row gradients to the table: a dense scatter-add, or —
        ``kernel`` — compact unique slots written by the `scatter_rows`
        kernel into a zero ``(V + 1, D)`` buffer whose trash row V takes
        the pad slots and is sliced off.  ``segmented`` marks (tok, g) as
        already duplicate-pre-summed slots (the lookup backward feeds the
        forward's sort residual through `ops.segment_rows`), so no index
        work happens here."""
        V = vocab_size
        base = torch.zeros((V + 1, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        if not kernel:
            # pad ids (== V, only on segmented inputs) add into the trash
            # row, which is dropped
            return base.index_add_(0, tok.long().clamp(max=V), g)[:V]
        if segmented:
            slot_ids, slot_g = tok, g
        else:
            slot_ids, slot_g = ops.segment_rows(tok, g, n_slots=tok.shape[0],
                                                pad_id=V)
        return ops.scatter_rows(base, slot_ids, slot_g)[:V]

    def refresh_rows(self, table, cache_ids):
        """Replica sync: gather the hot rows (pad ids >= V read zeros)."""
        return ref.embed_gather_ref(table, cache_ids)

    def refresh_rows_delta(self, table, cache_rows, ids, slots):
        """Incremental replica sync, in place: re-gather only ``ids``
        (ascending, V-padded) and write them into ``cache_rows`` at
        ``slots``; pad slots (== C) are dropped.  Rows the optimizer did
        not touch since the last refresh are bitwise unchanged in the
        table, so skipping them is exact — the loop takes this path only
        when that holds (sparse AdaGrad, untied embeddings).  The training
        loop hands the index tensors over on the host, so dropping the
        pads costs no device sync.  Returns ``cache_rows``."""
        keep = slots < cache_rows.shape[0]
        ids = ids[keep].to(table.device, non_blocking=True)
        slots = slots[keep].to(cache_rows.device, non_blocking=True)
        rows = ref.embed_gather_ref(table, ids)
        return cache_rows.index_copy_(0, slots.long(), rows)

    def update_rows(self, table, accum, seg_ids, seg_g, *, lr: float,
                    eps: float = 1e-8, kernel: bool = False):
        """Fused sparse AdaGrad over segment slots, in place on the table
        and its accumulator: ``seg_ids`` are the ascending unique batch ids
        followed by pad slots (== V) with zero gradients
        (`ops.segment_rows(pad_id=V)`).  Both the `adagrad_rows` kernel
        and its plain version skip every id outside ``[0, V)``, so the
        pads stay V and never touch a live row.  (The reference instead
        aliases pads to row 0 and reverses the slot order so that its
        sequential TPU grid writes row 0's real update last; blocks on a
        GPU run in no order, where that trick would let a pad write the
        stale row back.)  Returns ``(table, accum)``."""
        return ops.adagrad_row_update(table, accum, seg_ids, seg_g, lr=lr,
                                      eps=eps, use_kernel=kernel)


#: module-level default: the single-device reference.
EMULATED = EmulatedBackend(1)


def resolve(backend, n_shards: int = 1):
    """``backend`` if given, else the emulated backend at ``n_shards`` —
    the rule every `pm.embedding` entry point applies to its arguments."""
    if backend is not None:
        return backend
    return EMULATED if n_shards <= 1 else EmulatedBackend(n_shards)


def make_backend(collective: str):
    """Config-string entry point: ``"emulated"`` -> None (the per-call
    `resolve` default)."""
    if collective == "emulated":
        return None
    if collective == "mesh":
        raise NotImplementedError("the mesh collective backend is not "
                                  "ported to PyTorch yet")
    raise ValueError(f"unknown collective {collective!r}")
