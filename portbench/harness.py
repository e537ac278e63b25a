"""What every cell's run shares: the command line, finding the cell's
configuration, traffic, driver, limits and metric readers by name, the
look for the chip, and the result's last line.

A run prints, as the last lines of standard error, each number its check
compared beside its limit, and as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
#: top-level module names the process that prints a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library of the port loads JAX by itself."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with what its name finds."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def find_cell(name: str, sp: dict, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in sp["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in sp["configs"]}[w["config"]]
    config = dict(load_json(root / conf["file"]), name=conf["name"])
    traffic = dict(load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    limits = load_json(HERE / "limits" / f"{name}.json")

    def here(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m["name"] for m in sp["end_to_end"] if here(m)]
    # a per-layer metric names the cells where its reader finds something
    unnamed = [m["name"] for m in sp["per_layer"] if "workloads" not in m]
    if unnamed:
        raise ValueError(f"per-layer metrics {unnamed} name no workloads")
    layer = [m["name"] for m in sp["per_layer"] if name in m["workloads"]]
    units = {m["name"]: m["unit"] for m in sp["end_to_end"] + sp["per_layer"]}
    return Cell(name, w["chips"], config, traffic, limits, e2e, layer,
                units)


@dataclass
class Window:
    """What a traced run saw in its window, for the per-layer readers:
    device operations and program spans (name, start ns, end ns) on the
    host's `time.perf_counter_ns` clock, clipped to ``[t0, t1]``, and the
    driver's own numbers of the window in ``values``."""

    cell: Cell
    t0: int
    t1: int
    ops: List[Tuple[str, int, int]]
    spans: List[Tuple[str, int, int]]
    values: Dict[str, object] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


@dataclass
class Outcome:
    """A driver's run: end-to-end metrics, what was attempted and failed,
    each number compared with its limit, the device's peak memory, and
    with a trace the window for the per-layer readers."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    window: Optional[Window] = None
    #: the driver's further numbers, for the tools (not in the result)
    detail: Dict[str, float] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim
                                        in self.checks.values())


@dataclass
class Run:
    """One run as a driver sees it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec_ = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def execute(run: Run) -> Tuple[Outcome, dict]:
    """Drive the cell and assemble its result line (a dict)."""
    from portbench import devtrace
    driver = importlib.import_module(
        f"portbench.drivers.{run.cell.traffic['kind']}")
    out = driver.run(run)
    cell = run.cell
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed}
    dev = device_info(run.device, cell.chips, out.memory_peak_bytes)
    if run.trace:
        w = out.window
        metrics = {}
        for name in cell.per_layer:
            v = reader(name)(w)
            if v is not None:
                metrics[name] = v
        busy = devtrace.busy_ns(w.ops) / 1e9
        dev.update(busy_s=busy, window_s=w.seconds)
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(w.ops),
            "idle_gaps": devtrace.idle_gaps(w.ops, w.spans, w.t0, w.t1)}
    else:
        missing = [m for m in cell.end_to_end if m not in out.metrics]
        if missing:
            raise RuntimeError(f"the driver gave no {missing}")
        result["metrics"] = {m: out.metrics[m] for m in cell.end_to_end}
        result["device"] = dev
    result["metrics"] = {k: {"value": v, "unit": cell.units[k]}
                         for k, v in result["metrics"].items()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return out, result


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    kind = torch.cuda.get_device_name(device) \
        if getattr(device, "type", device) == "cuda" else "cpu"
    return {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def forbidden_modules() -> List[str]:
    return sorted(k for k in list(sys.modules)
                  if k.split(".")[0] in FORBIDDEN)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    set_environment()
    cell = find_cell(args.workload, spec())
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)          # the device's context, up front
    run = Run(cell, args.seed, args.seconds, bool(args.trace), dev,
              t_start)
    out, result = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    print(f"detail: {json.dumps(out.detail)}", file=sys.stderr)
    for k, (v, lim) in out.checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
