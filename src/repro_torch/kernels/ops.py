"""Dispatch to the hand-written kernels (the twin of
`repro/kernels/ops.py`).

``use_kernel=True`` goes to the kernel's wrapper, which launches the CUDA
kernel on CUDA tensors and runs the plain version on CPU tensors;
``use_kernel=False`` runs the plain version wherever the tensors are.
Each wrapper counts its launches, so a run can show that its path went
through the kernels (`launch_counts`).
"""

from __future__ import annotations

from typing import Dict

from . import ref
from .embed_gather import embed_gather as _gather_kernel
from .pm_forward import pm_combine as _combine_kernel

KERNELS = {"embed_gather": _gather_kernel, "pm_combine": _combine_kernel}


def embed_gather(table, ids, *, use_kernel: bool = True):
    """``table[ids]`` (zero rows for ids outside ``[0, V)``)."""
    if not use_kernel:
        return ref.embed_gather_ref(table, ids)
    return _gather_kernel(table, ids)


def pm_combine(hit, cache_slot, buf_slot, cache_rows, buf_rows, *,
               use_kernel: bool = True):
    """Managed-lookup select: hits read the replica cache, misses read
    the compact deduped buffer (trash row last)."""
    if not use_kernel:
        return ref.pm_combine_ref(hit, cache_slot, buf_slot, cache_rows,
                                  buf_rows)
    return _combine_kernel(hit, cache_slot, buf_slot, cache_rows, buf_rows)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
