"""Build and load the hand-written CUDA kernels of `kernels/csrc`.

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all
of them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, loaded with `ctypes`: no PyTorch
headers and no ``ninja``, so a build takes seconds.  The library lands in
``kernels/_build/<hash>/`` (listed in ``.gitignore``), the hash taken over
the sources and headers: a change to any of them rebuilds on first use.

Nothing here runs at import: `library()` builds on its first call, which
only a launch on a CUDA tensor makes.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]


LAUNCHERS = ("embed_gather_launch", "pm_combine_launch",
             "scatter_rows_launch", "segment_scatter_rows_launch",
             "adagrad_rows_launch")

_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.h")) + sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)"
                       ": the CUDA kernels cannot be built")


def _run(cmds: list) -> None:
    """Run the commands in parallel; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the sources into ``_build/<hash>/librow_kernels.so`` unless
    that file exists; returns its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librow_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc = nvcc_path()
    objs = [tmp_dir / f"{src.stem}.o" for src in sources()]
    _run([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
          for src, obj in zip(sources(), objs)])
    tmp = tmp_dir / lib.name
    _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib)
    shutil.rmtree(tmp_dir)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # each launcher takes one packed block of 8-byte arguments and the
        # stream; <launcher>_args describes the block (see
        # `launch.launcher`)
        for name in LAUNCHERS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            getattr(lib, name + "_args").restype = ctypes.c_char_p
        lib.embed_gather_path.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_longlong,
                                          ctypes.c_longlong]
        lib.embed_gather_path.restype = ctypes.c_int
        lib.row_kernels_error_string.argtypes = [ctypes.c_int]
        lib.row_kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if err != 0:
        msg = library().row_kernels_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
