"""Row gather from an embedding table: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel `repro/kernels/embed_gather.py::
_gather_kernel`.  The kernel (``csrc/row_kernels.cu``) gives each warp one
output row (and, for long rows, one column chunk of it) and copies the row
as raw 16-byte words where the row width and pointers allow, narrower words
otherwise.  It is bound by memory traffic: ``n * D * elt`` bytes read and
as many written.  Ids outside ``[0, V)`` write a zero row and read nothing.
"""

from __future__ import annotations

import torch

from . import build
from .ref import embed_gather_ref


def check_rows(name: str, device: torch.device, *rows: torch.Tensor) -> None:
    """Raise unless every row operand is a contiguous 2-D tensor of one
    2- or 4-byte dtype and width on ``device``."""
    for t in rows:
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous 2-D tensors")
        if t.dtype != rows[0].dtype or t.shape[1] != rows[0].shape[1]:
            raise ValueError(f"{name}: row operands differ in dtype or width")
    if rows[0].element_size() not in (2, 4):
        raise ValueError(f"{name}: unsupported dtype {rows[0].dtype}")


def index_operand(name: str, device: torch.device,
                  x: torch.Tensor) -> torch.Tensor:
    """A contiguous int32 1-D copy (or view) of an index operand."""
    if x.device != device or x.dim() != 1:
        raise ValueError(f"{name}: index operands must be 1-D on {device}")
    return x.to(torch.int32).contiguous()


def embed_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` -> (n, D), with zero rows for ids outside ``[0, V)``.

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and raises if the build or the launch fails)."""
    if table.device.type == "cpu":
        return embed_gather_ref(table, ids)
    dev = table.device
    check_rows("embed_gather", dev, table)
    ids = index_operand("embed_gather", dev, ids)
    V, D = table.shape
    out = torch.empty((ids.shape[0], D), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = build.library().embed_gather_launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
            V, D * table.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "embed_gather")
    embed_gather.launches += 1
    return out


embed_gather.launches = 0
