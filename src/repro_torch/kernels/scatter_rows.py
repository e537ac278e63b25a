"""Row scatter into a gradient buffer: the CUDA kernels' wrappers.

Both replace the Pallas TPU kernel `repro/kernels/scatter_rows.py::
_scatter_kernel` and share one CUDA source (``csrc/row_kernels.cu``).

`scatter_rows` is the port of that kernel as it is: ``base[ids[i]] =
rows[i]`` in place, one warp per (row, column chunk) copying raw words;
ids outside ``[0, R)`` write nothing.

`segment_scatter_rows` is the form the managed lookup's backward runs: it
takes the forward's sort residual and the token gradients and writes, for
each run of equal sorted ids, the run's sum into ``base[id]``, in one
launch.  It replaces the duplicate pre-sum (`ops.segment_rows`: an
`index_select`, a `zeros`, an in-order add that sorts the slots again
on a card, a `full`, an index-put and a cast) followed by the scatter.  Each run is summed in sorted order in fp32, so the result is
the same in every run and equals the plain version on the CPU bit for
bit.  At the backward's sizes both kernels move a few MB, well under
10 us of memory time, so what they cost is launches and host work.
"""

from __future__ import annotations

import torch

from .launch import as_int32, index_operand, launcher, reject
from .ref import scatter_rows_ref, segment_scatter_rows_ref

_FLOATS = (torch.float32, torch.bfloat16)
_scatter = launcher("scatter_rows_launch", "base ids rows n R row_bytes")
_segment = launcher("segment_scatter_rows_launch",
                    "base order sorted_ids grads T R D base_bf16 grads_bf16")


def scatter_rows(base: torch.Tensor, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``base[ids[i]] = rows[i]`` in place (rows cast to ``base``'s type);
    returns ``base``.  base (R, D); ids (n,) unique apart from pad
    collisions carrying equal rows; rows (n, D).

    On CPU tensors this is the plain version; on CUDA tensors it launches
    the kernel (and raises if the build or the launch fails)."""
    if base.is_cpu:
        return scatter_rows_ref(base, ids, rows)
    if rows.dtype != base.dtype or not rows.is_contiguous():
        rows = rows.to(base.dtype).contiguous()
    dev = base.get_device()
    n = ids.shape[0]
    if not (rows.get_device() == ids.get_device() == dev
            and base.ndim == rows.ndim == 2 and ids.ndim == 1
            and base.is_contiguous() and base.itemsize in (2, 4)
            and rows.shape[1] == base.shape[1]):
        reject("scatter_rows", base.device, (base, rows), (ids,))
    if rows.shape[0] != n:
        raise ValueError("scatter_rows: ids and rows lengths differ")
    ids = as_int32(ids)
    R, D = base.shape
    if n and D:
        _scatter(dev, base.data_ptr(), ids.data_ptr(), rows.data_ptr(), n,
                 R, D * base.itemsize)
        scatter_rows.launches += 1
    return base


scatter_rows.launches = 0


def check_segment_operands(device: torch.device, base: torch.Tensor,
                           order: torch.Tensor, sorted_ids: torch.Tensor,
                           grads: torch.Tensor):
    """Raise unless base (R, D) and grads (T, D) are contiguous fp32 or
    bf16 rows on ``device`` and order / sorted_ids are (T,) there; returns
    the two index operands as int32."""
    name = "segment_scatter_rows"
    for t in (base, grads):
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous 2-D tensors")
        if t.dtype not in _FLOATS:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if grads.shape[1] != base.shape[1]:
        raise ValueError(f"{name}: base and grads differ in width")
    order = index_operand(name, device, order)
    sorted_ids = index_operand(name, device, sorted_ids)
    T = grads.shape[0]
    if order.shape[0] != T or sorted_ids.shape[0] != T:
        raise ValueError(f"{name}: order, sorted_ids and grads lengths "
                         f"differ")
    return order, sorted_ids


def segment_scatter_rows(base: torch.Tensor, residual,
                         grads: torch.Tensor) -> torch.Tensor:
    """For each run of equal ids in ``residual.sorted_ids``: ``base[id] =
    sum of grads[order[k]]`` over the run, in place; returns ``base``.

    base (R, D) fp32 or bf16; ``residual`` a `SortResidual` of the (T,)
    token ids (``order`` a stable argsort, ``sorted_ids = ids[order]``);
    grads (T, D) fp32 or bf16, of any layout.  Sums are fp32, added in
    sorted order and rounded once to base's type.  Rows of ids outside
    ``[0, R)``, and every row no id names, are left as they are.  On CPU
    tensors this is the plain version; on CUDA tensors it launches the
    kernel (and raises if the build or the launch fails)."""
    if base.is_cpu:
        return segment_scatter_rows_ref(base, residual, grads)
    order, sorted_ids = residual.order, residual.sorted_ids
    if not grads.is_contiguous():   # e.g. the expanded gradient of a sum
        grads = grads.contiguous()
    dev = base.get_device()
    T = grads.shape[0]
    if not (grads.get_device() == order.get_device()
            == sorted_ids.get_device() == dev
            and base.ndim == grads.ndim == 2
            and order.ndim == sorted_ids.ndim == 1
            and base.is_contiguous() and base.dtype in _FLOATS
            and grads.dtype in _FLOATS
            and grads.shape[1] == base.shape[1]
            and order.numel() == sorted_ids.numel() == T):
        check_segment_operands(base.device, base, order, sorted_ids, grads)
    order, sorted_ids = as_int32(order), as_int32(sorted_ids)
    R, D = base.shape
    if T and D:
        _segment(dev, base.data_ptr(), order.data_ptr(),
                 sorted_ids.data_ptr(), grads.data_ptr(), T, R, D,
                 base.dtype is torch.bfloat16, grads.dtype is torch.bfloat16)
        segment_scatter_rows.launches += 1
    return base


segment_scatter_rows.launches = 0
