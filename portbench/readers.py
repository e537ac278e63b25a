"""What the per-layer metric files share: each ``metrics/<name>.py`` is a
`read(window)` that calls one of these with its own parameters and
returns None where its window holds nothing to read."""

from __future__ import annotations

import re
from typing import Iterable, Optional

import numpy as np

from portbench.devtrace import busy_ns
from portbench.peaks import peaks_of
from portbench.work import lookup_bytes

#: the managed lookup's and the row update's kernels
#: (`src/repro_torch/kernels/csrc/*.cu`)
LOOKUP_KERNELS = re.compile(
    r"\b(gather_tma_kernel|gather_kernel|combine_kernel)\b")
UPDATE_KERNELS = re.compile(
    r"\b(adagrad_(scalar|vec4)_kernel|scatter_kernel|"
    r"segment_scatter_kernel)\b")


def span_ms(w, names: Iterable[str], per: float) -> Optional[float]:
    """Host ms in the program's spans ``names`` inside the window, over
    ``per`` (steps, rounds); None where there are none."""
    names = set(names)
    ns = [e - s for n, s, e in w.spans if n in names]
    if not ns or not per:
        return None
    return sum(ns) / 1e6 / per


def span_mean_ms(w, name: str) -> Optional[float]:
    ns = [e - s for n, s, e in w.spans if n == name]
    return float(np.mean(ns)) / 1e6 if ns else None


def idle_pct(w) -> Optional[float]:
    if not w.ops or w.t1 <= w.t0:
        return None
    return 100.0 * (1.0 - busy_ns(w.ops) / (w.t1 - w.t0))


def kernel_s(w, *patterns) -> float:
    return sum(e - s for n, s, e in w.ops
               if any(p.search(n) for p in patterns)) / 1e9


def roofline_pct(w, token_arrays, update: bool) -> Optional[float]:
    """The least time of the lookup's (and with ``update`` the row
    update's) bytes at the chip's HBM bandwidth, over the device time of
    its kernels in the window, in %."""
    pats = (LOOKUP_KERNELS, UPDATE_KERNELS) if update else (LOOKUP_KERNELS,)
    t = kernel_s(w, *pats)
    if not t or not token_arrays:
        return None
    cfg = w.cell.config
    nbytes = sum(lookup_bytes(cfg, tk, update) for tk in token_arrays)
    bw = peaks_of(w.values["device_kind"])["hbm_bytes_per_s"]
    return 100.0 * nbytes / bw / t


def mfu_pct(w) -> Optional[float]:
    """Model FLOPs of the window's steps over its seconds and the peak of
    the configuration's precision, in %."""
    if not w.values.get("steps"):
        return None
    prec = "tf32" if w.cell.config.get("tf32") else w.cell.config["dtype"]
    peak = peaks_of(w.values["device_kind"])["flops"][prec]
    return 100.0 * w.values["model_flops"] * w.values["steps"] \
        / w.seconds / peak


def mean_pct(values) -> Optional[float]:
    return 100.0 * float(np.mean(values)) if len(values) else None
