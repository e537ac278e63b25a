"""Row scatter into a gradient buffer: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel `repro/kernels/scatter_rows.py::
_scatter_kernel`.  The managed lookup's backward pre-sums duplicate token
gradients into compact slots (`ops.segment_rows`, fed by the step's sort
residual) and writes each slot's row into a zero ``(V + 1, D)`` buffer in
place; pad slots carry id V and zero rows and land on the trash row V,
which the caller slices off.  The kernel (``csrc/row_kernels.cu``) copies
each row as raw words, one warp per (row, column chunk): bound by memory
traffic, one row read and one row written per slot.  Ids outside
``[0, R)`` write nothing.
"""

from __future__ import annotations

import torch

from . import build
from .embed_gather import check_rows, index_operand
from .ref import scatter_rows_ref


def scatter_rows(base: torch.Tensor, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``base[ids[i]] = rows[i]`` in place (rows cast to ``base``'s type);
    returns ``base``.  base (R, D); ids (n,) unique apart from pad
    collisions carrying equal rows; rows (n, D).

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and raises if the build or the launch fails)."""
    if base.device.type == "cpu":
        return scatter_rows_ref(base, ids, rows)
    dev = base.device
    rows = rows.to(base.dtype).contiguous()
    check_rows("scatter_rows", dev, base, rows)
    ids = index_operand("scatter_rows", dev, ids)
    if rows.shape[0] != ids.shape[0]:
        raise ValueError("scatter_rows: ids and rows lengths differ")
    R, D = base.shape
    if rows.numel() == 0:
        return base
    with torch.cuda.device(dev):
        err = build.library().scatter_rows_launch(
            base.data_ptr(), ids.data_ptr(), rows.data_ptr(), ids.shape[0],
            R, D * base.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "scatter_rows")
    scatter_rows.launches += 1
    return base


scatter_rows.launches = 0
