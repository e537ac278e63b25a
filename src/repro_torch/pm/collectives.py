"""Collective backends: the vocab-parallel communication layer of the
intent-managed embedding (the twin of `repro/pm/collectives.py`).

The managed lookup's cost is what moves through the network: only the
compact ``(M+1, D)`` miss buffer instead of every token's row.  Of the
reference's backends this package has `EmulatedBackend`, the single-device
stand-in: with ``n_shards > 1`` every gather materializes one owner-masked
``(n, D)`` partial per shard and sums them, the cost model for the
all-reduce's wire bytes on a one-device host.  ``n_shards == 1``
degenerates to a plain (optionally kernel) gather.  The mesh backend over
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

    def refresh_rows(self, table, cache_ids):
        """Replica sync: gather the hot rows (pad ids >= V read zeros)."""
        return ref.embed_gather_ref(table, cache_ids)


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
