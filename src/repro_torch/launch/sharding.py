"""Placement of the intent-managed table on the vocab-parallel mesh (the
twin of `repro/launch/sharding.py::managed_table_sharding`).

Every row has one owner: rank k of n holds rows ``[k·V/n, (k+1)·V/n)``
of the table and of each optimizer state of the table's shape, with the
feature dimension whole.  Only this rule is ported; the reference's
per-parameter sharding rules (FSDP, tensor parallelism) are not.
"""

from __future__ import annotations

import numpy as np
import torch


def block_rows(vocab: int, rank: int, n: int) -> slice:
    """The rows rank ``rank`` of ``n`` owns; ``vocab`` must divide by n."""
    if vocab % n:
        raise ValueError(f"vocab {vocab} must divide the 'model' axis ({n})")
    b = vocab // n
    return slice(rank * b, (rank + 1) * b)


def place_table(x, mesh) -> torch.Tensor:
    """This rank's block of a table or accumulator ``x`` ((V, ...), numpy
    or tensor), contiguous on the mesh's device.  A tensor already on the
    device is not copied when the mesh has one rank; otherwise the block
    is its own storage (it neither aliases a numpy source nor keeps a
    full table alive)."""
    sl = block_rows(x.shape[0], mesh.rank, mesh.size)
    if isinstance(x, np.ndarray):
        blk = torch.from_numpy(np.ascontiguousarray(x[sl]))
        return blk.clone() if mesh.device.type == "cpu" \
            else blk.to(mesh.device)
    blk = x[sl]
    if mesh.size > 1 and x.device == mesh.device:
        return blk.clone(memory_format=torch.contiguous_format)
    return blk.to(mesh.device).contiguous()
