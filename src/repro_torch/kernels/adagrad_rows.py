"""Fused sparse AdaGrad row update: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel `repro/kernels/adagrad_rows.py::
_make_kernel`.  For every id in ``[0, V)``, in place on the table and its
fp32 accumulator: ``acc[id] += g * g``, then ``table[id] -= lr * g /
(sqrt(acc[id]) + eps)``, fp32 math cast back to the table's type (fp32 or
bf16).  The kernel (``csrc/adagrad_rows.cu``) gives each warp one (row,
column chunk) pair and moves 4-element vectors where width and alignment
allow; it is bound by memory traffic (five row transfers per updated row).
Ids outside ``[0, V)`` are skipped: the training step pads its segment
slots with V, and no pad ever reads or writes a live row.
"""

from __future__ import annotations

import torch

from . import build
from .embed_gather import index_operand
from .ref import adagrad_row_update_ref


def adagrad_row_update(table: torch.Tensor, accum: torch.Tensor,
                       ids: torch.Tensor, grads: torch.Tensor, *,
                       lr: float = 0.1, eps: float = 1e-8):
    """Apply AdaGrad to rows ``ids`` of (table, accum) with ``grads``, in
    place; returns ``(table, accum)``.

    table (V, D) fp32 or bf16, accum (V, D) fp32, ids (n,) unique within
    ``[0, V)`` apart from skipped pads, grads (n, D).  On CPU tensors this
    is the plain version; on CUDA tensors it launches the kernel (and
    raises if the build or the launch fails)."""
    if table.device.type == "cpu":
        return adagrad_row_update_ref(table, accum, ids, grads, lr=lr,
                                      eps=eps)
    dev = table.device
    name = "adagrad_rows"
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported table dtype {table.dtype}")
    if accum.dtype != torch.float32 or accum.shape != table.shape:
        raise ValueError(f"{name}: accum must be fp32 of the table's shape")
    for t in (table, accum):
        if t.device != dev or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: table and accum must be contiguous "
                             f"2-D tensors on {dev}")
    ids = index_operand(name, dev, ids)
    V, D = table.shape
    if grads.device != dev or grads.shape != (ids.shape[0], D):
        raise ValueError(f"{name}: grads must be (n, D) on {dev}")
    grads = grads.float().contiguous()
    with torch.cuda.device(dev):
        err = build.library().adagrad_rows_launch(
            table.data_ptr(), accum.data_ptr(), grads.data_ptr(),
            ids.data_ptr(), ids.shape[0], V, D, lr, eps,
            int(table.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, name)
    adagrad_row_update.launches += 1
    return table, accum


adagrad_row_update.launches = 0
