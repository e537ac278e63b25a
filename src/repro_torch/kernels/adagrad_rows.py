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

from .launch import as_int32, index_operand, launcher
from .ref import adagrad_row_update_ref

_launch = launcher("adagrad_rows_launch",
                   "table accum grads ids n V D lr eps table_bf16")


def adagrad_row_update(table: torch.Tensor, accum: torch.Tensor,
                       ids: torch.Tensor, grads: torch.Tensor, *,
                       lr: float = 0.1, eps: float = 1e-8):
    """Apply AdaGrad to rows ``ids`` of (table, accum) with ``grads``, in
    place; returns ``(table, accum)``.

    table (V, D) fp32 or bf16, accum (V, D) fp32, ids (n,) unique within
    ``[0, V)`` apart from skipped pads, grads (n, D).  On CPU tensors this
    is the plain version; on CUDA tensors it launches the kernel (and
    raises if the build or the launch fails)."""
    if table.is_cpu:
        return adagrad_row_update_ref(table, accum, ids, grads, lr=lr,
                                      eps=eps)
    dev = table.get_device()
    n = ids.shape[0]
    if not (accum.get_device() == ids.get_device() == grads.get_device()
            == dev and table.ndim == accum.ndim == grads.ndim == 2
            and ids.ndim == 1 and table.is_contiguous()
            and accum.is_contiguous() and accum.dtype == torch.float32
            and table.dtype in (torch.float32, torch.bfloat16)
            and accum.shape == table.shape
            and grads.shape == (n, table.shape[1])):
        _reject(table, accum, ids, grads)
    ids = as_int32(ids)
    if grads.dtype != torch.float32 or not grads.is_contiguous():
        grads = grads.float().contiguous()
    V, D = table.shape
    if n and D:
        _launch(dev, table.data_ptr(), accum.data_ptr(), grads.data_ptr(),
                ids.data_ptr(), n, V, D, lr, eps,
                table.dtype is torch.bfloat16)
        adagrad_row_update.launches += 1
    return table, accum


def _reject(table, accum, ids, grads) -> None:
    """Raise the precise error for operands the kernel does not take."""
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
    index_operand(name, dev, ids)
    raise ValueError(f"{name}: grads must be (n, D) on {dev}")


adagrad_row_update.launches = 0
