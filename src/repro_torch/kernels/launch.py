"""The kernel wrappers' shared launch path.

Every wrapper checks its operands, hands raw pointers to a launcher of the
kernel library (`build.library`) and raises on the CUDA error the launcher
returns.  At the training step's sizes a kernel runs for about a
microsecond, so this host work is what a wrapper costs, and it is kept
small:

- each launcher is looked up in the library once, and takes its
  arguments as one block of 8-byte fields that the wrapper packs with
  `struct`: ctypes then converts one bytes object and the stream instead
  of every pointer and count.  The block is declared once, in C
  (``csrc/launch_args.h``); the library describes it, and `launcher`
  builds the packing format from that description after checking that
  the wrapper names the same fields in the same order;
- the stream is read as a raw handle with
  ``torch._C._cuda_getCurrentRawStream(device_index)``, the accessor that
  PyTorch's own generated kernels use (``torch/_inductor/codegen/
  wrapper.py``), instead of building a `torch.cuda.Stream` object per call
  as ``torch.cuda.current_stream(dev).cuda_stream`` does;
- the device guard is entered only when the operands' card is not the
  current one;
- a wrapper first tests its operands with one cheap expression (integer
  device indices, ``ndim``, ``is_contiguous``, ``itemsize``) and runs the
  detailed checks below only when that test fails, to raise the precise
  error; an index operand that is already contiguous int32 is passed as
  it is.

Every check stays: a wrong device, dtype, rank, width or layout raises
`ValueError` before anything is launched.
"""

from __future__ import annotations

import struct
from typing import Callable, Sequence

import torch

from . import build

_KIND_FORMAT = {"p": "Q", "i": "q", "d": "d"}


def check_rows(name: str, device: torch.device, *rows: torch.Tensor) -> None:
    """Raise unless every row operand is a contiguous 2-D tensor of one
    2- or 4-byte dtype and width on ``device``."""
    first = rows[0]
    for t in rows:
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: rows must be contiguous 2-D tensors")
        if t.dtype != first.dtype or t.shape[1] != first.shape[1]:
            raise ValueError(f"{name}: row operands differ in dtype or width")
    if first.element_size() not in (2, 4):
        raise ValueError(f"{name}: unsupported dtype {first.dtype}")


def index_operand(name: str, device: torch.device,
                  x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it is a contiguous int32 1-D tensor on ``device``,
    else a contiguous int32 copy; raises for another rank or device."""
    if x.device != device or x.dim() != 1:
        raise ValueError(f"{name}: index operands must be 1-D on {device}")
    return as_int32(x)


def as_int32(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous int32 copy of it (checked by the caller)."""
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def reject(name: str, device: torch.device, rows=(), indices=()) -> None:
    """Raise the precise error for operands that failed a wrapper's cheap
    test: the detailed row and index checks, else a shape error."""
    if rows:
        check_rows(name, device, *rows)
    for x in indices:
        index_operand(name, device, x)
    raise ValueError(f"{name}: operand shapes do not fit together")


def block_format(cname: str, described: str,
                 fields: Sequence[str]) -> str:
    """The `struct` format of launcher ``cname``'s argument block, from
    the library's description ``described`` ("name:kind ..."); raises
    unless it names ``fields``, in that order."""
    pairs = [f.split(":") for f in described.split()]
    names = tuple(name for name, _ in pairs)
    if names != tuple(fields) or any(k not in _KIND_FORMAT
                                     for _, k in pairs):
        raise RuntimeError(f"{cname}: the library's argument block is "
                           f"{described!r}, its wrapper packs {fields}")
    return "<" + "".join(_KIND_FORMAT[k] for _, k in pairs)


def launcher(cname: str, fields: str) -> Callable:
    """``launch(index, *values)``: call the library's launcher ``cname``
    with ``values`` (the argument block's ``fields``, in order) on card
    ``index``'s current stream; raise if it reports a CUDA error.  The
    library is loaded, and the block's layout checked, at the first
    launch."""
    names = tuple(fields.split())
    bound = []

    def bind():
        lib = build.library()
        described = getattr(lib, cname + "_args")().decode()
        pack = struct.Struct(block_format(cname, described, names)).pack
        bound.extend((getattr(lib, cname), pack,
                      torch._C._cuda_getCurrentRawStream,
                      torch._C._cuda_getDevice))

    def launch(index: int, *values) -> None:
        if not bound:
            bind()
        fn, pack, raw_stream, current_device = bound
        if index == current_device():
            err = fn(pack(*values), raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(pack(*values), raw_stream(index))
        if err:
            build.check(err, cname[:-len("_launch")])

    launch.cname, launch.fields = cname, names
    return launch
