"""Row gather from an embedding table: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel `repro/kernels/embed_gather.py::
_gather_kernel`.  It is bound by memory traffic: ``n * D * elt`` bytes read
and as many written.  Where the row's byte width and both base pointers
are multiples of 16 and the gather writes at most 32 MiB
(`embed_gather_path` says "tma"), the kernel (``csrc/row_kernels.cu``)
copies rows with Hopper's bulk copies: a persistent grid of one-warp
blocks, each streaming row chunks through a ring of shared-memory stages,
global to shared and shared to global, without the data passing through
registers.  Larger gathers and other rows (odd widths, unaligned views)
take the word path: one warp per (row, column chunk), the widest aligned
word.  Ids outside ``[0, V)`` write a zero row and read nothing.
"""

from __future__ import annotations

import torch

from . import build
from .launch import as_int32, launcher, reject
from .ref import embed_gather_ref

_launch = launcher("embed_gather_launch",
                   "table ids out n V row_bytes path")
_PATHS = {"auto": 0, "tma": 1, "word": 2}


def embed_gather_path(table: torch.Tensor, out: torch.Tensor) -> str:
    """The path the kernel takes, left to choose, to gather ``out``'s rows
    from ``table``: ``"tma"`` or ``"word"`` (decided in the library from
    the gather's size, the row width and alignment)."""
    row_bytes = table.shape[1] * table.element_size()
    tma = build.library().embed_gather_path(table.data_ptr(), out.data_ptr(),
                                            out.shape[0], row_bytes)
    return "tma" if tma else "word"


def embed_gather(table: torch.Tensor, ids: torch.Tensor, *,
                 path: str = "auto") -> torch.Tensor:
    """``table[ids]`` -> (n, D), with zero rows for ids outside ``[0, V)``.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and raises if the build or the launch fails).
    ``path`` "tma" or "word" takes that path whatever the size, to time
    and check one against the other ("tma" raises on rows or pointers that
    are not 16-byte aligned); "auto" lets the kernel choose."""
    if table.is_cpu:
        return embed_gather_ref(table, ids)
    dev = table.get_device()
    if not (ids.get_device() == dev and ids.ndim == 1 and table.ndim == 2
            and table.is_contiguous() and table.itemsize in (2, 4)):
        reject("embed_gather", table.device, (table,), (ids,))
    ids = as_int32(ids)
    V, D = table.shape
    n = ids.shape[0]
    out = torch.empty((n, D), dtype=table.dtype, device=table.device)
    if n and D:
        _launch(dev, table.data_ptr(), ids.data_ptr(), out.data_ptr(), n,
                V, D * table.itemsize, _PATHS[path])
        embed_gather.launches += 1
    return out


embed_gather.launches = 0
