#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs CUDA and the CUDA toolkit (``nvcc``) and fails without them.  In
order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
3. holds each kernel against its plain PyTorch version, bit for bit, in
   fp32 and bf16 at D in {1, 8, 576, 6144} over a 256000-row table (the
   nemotron-4-15b embedding, 6.29 GB in fp32), with bucket pads (id == V)
   and row 0 among the ids; then times kernel, plain version and the
   PyTorch library call with CUDA events at the serving path's shapes;
4. serves a drifting Zipf request stream through
   `repro_torch.serve.ServingRuntime` at full width (vocab 256000, D 6144,
   64 requests of 64 keys per batch, 64 emulated shards) twice — with the
   runtime's automatic knobs, and with a 512-row cache and a 2-deep
   pipeline — and checks every served row against ``table[keys]`` bit for
   bit, that no request was served a zero row, and that both kernels were
   launched during each run; then serves each configuration twice more
   without collecting outputs, untraced and under `torch.profiler`, to
   show where its time goes;
5. prints the kernel table as one JSON line, the card line and, last, the
   device line.

Any failure raises, so the script exits non-zero before those last lines.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM peak HBM bandwidth (data sheet)
VOCAB, WIDTH = 256000, 6144   # nemotron-4-15b embedding
DIMS = (1, 8, 576, 6144)
N_IDS = 4096                  # ids per gather check
T_TOK, C_ROWS, M_ROWS = 4096, 8192, 512   # pm_combine check shapes
B_REQ = K_KEYS = 64           # serving batch: requests x keys
N_SHARDS = 64
ROUNDS = 32
TIMING_SAMPLES, TIMING_REPS = 21, 10
SEED = 0


def bits(x):
    """The raw words of a 2- or 4-byte tensor, for bitwise comparison."""
    import torch
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_table(dev, seed: int = SEED):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    table = torch.empty((VOCAB, WIDTH), dtype=torch.float32, device=dev)
    return table.normal_(generator=g)


def check_kernels(table, dims=DIMS, n=N_IDS, T=T_TOK, C=C_ROWS, M=M_ROWS,
                  seed: int = SEED) -> dict:
    """Each kernel's wrapper against its plain version on the same inputs,
    bitwise, for fp32 and bf16 and every width in ``dims``.  Returns the
    largest absolute difference seen per kernel (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels.embed_gather import embed_gather
    from repro_torch.kernels.pm_forward import pm_combine
    from repro_torch.kernels.ref import embed_gather_ref, pm_combine_ref
    dev = table.device
    V = table.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    err = {"embed_gather": 0.0, "pm_combine": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for D in dims:
            src = table[:, :D].to(dtype).contiguous() if D != WIDTH \
                else table.to(dtype)
            ids = torch.randint(0, V, (n,), generator=g, device=dev,
                                dtype=torch.int32)
            ids[0] = 0
            ids[1::97] = V                      # bucket pads: zero rows
            got, want = embed_gather(src, ids), embed_gather_ref(src, ids)
            torch.cuda.synchronize(dev)
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"embed_gather != plain ({dtype}, D={D})")
            err["embed_gather"] = max(err["embed_gather"],
                                      max_abs_err(got, want))
            del src
            cache = torch.randn((C, D), generator=g, device=dev).to(dtype)
            buf = torch.randn((M + 1, D), generator=g, device=dev).to(dtype)
            buf[M] = 0                          # the trash row
            hit = torch.randint(0, 2, (T,), generator=g, device=dev,
                                dtype=torch.int32)
            cslot = torch.randint(0, C, (T,), generator=g, device=dev,
                                  dtype=torch.int32)
            bslot = torch.randint(0, M, (T,), generator=g, device=dev,
                                  dtype=torch.int32)
            bslot[(hit == 0).nonzero().squeeze(1)[::7]] = M  # overflow
            got = pm_combine(hit, cslot, bslot, cache, buf)
            want = pm_combine_ref(hit, cslot, bslot, cache, buf)
            torch.cuda.synchronize(dev)
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"pm_combine != plain ({dtype}, D={D})")
            err["pm_combine"] = max(err["pm_combine"],
                                    max_abs_err(got, want))
    return err


def median_ms(fn, samples: int = TIMING_SAMPLES,
              reps: int = TIMING_REPS) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls between two CUDA events (back to back, so the host's launch
    overhead overlaps the device's work as it does on the serving path)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def time_kernels(table, n=N_IDS, T=T_TOK, C=C_ROWS, M=M_ROWS,
                 seed: int = SEED) -> dict:
    """Kernel, plain version and library call on the same inputs, at the
    serving path's shapes: a gather of ``n`` rows from the full table
    (the miss buffer is at most the batch's T = 4096 tokens) and the
    combine of one batch's T tokens.  The gather's ids hold no pads so
    that ``index_select`` takes them too."""
    import torch
    from repro_torch.kernels.embed_gather import embed_gather
    from repro_torch.kernels.pm_forward import pm_combine
    from repro_torch.kernels.ref import embed_gather_ref, pm_combine_ref
    dev = table.device
    V, D = table.shape
    elt = table.element_size()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    ids = torch.randint(0, V, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    cache = torch.randn((C, D), generator=g, device=dev)
    buf = torch.randn((M + 1, D), generator=g, device=dev)
    buf[M] = 0
    hit = torch.randint(0, 2, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    cslot = torch.randint(0, C, (T,), generator=g, device=dev,
                          dtype=torch.int32)
    bslot = torch.randint(0, M + 1, (T,), generator=g, device=dev,
                          dtype=torch.int32)
    hit_b = hit.bool()
    gather_bytes = 2 * n * D * elt + 4 * n
    combine_bytes = 2 * T * D * elt + 12 * T
    return {
        "embed_gather": {
            "shape": f"table ({V}, {D}) {table.dtype}, n={n}",
            "ms": median_ms(lambda: embed_gather(table, ids)),
            "plain_ms": median_ms(lambda: embed_gather_ref(table, ids)),
            "library_ms": median_ms(
                lambda: torch.index_select(table, 0, ids)),
            "bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
        },
        "pm_combine": {
            "shape": f"T={T}, cache ({C}, {D}), buf ({M + 1}, {D}) "
                     f"{table.dtype}",
            "ms": median_ms(lambda: pm_combine(hit, cslot, bslot, cache,
                                               buf)),
            "plain_ms": median_ms(lambda: pm_combine_ref(
                hit, cslot, bslot, cache, buf)),
            "library_ms": median_ms(lambda: torch.where(
                hit_b[:, None], cache.index_select(0, cslot),
                buf.index_select(0, bslot))),
            "bound_ms": combine_bytes / HBM_BYTES_PER_S * 1e3,
        },
    }


def runtime(table, rounds: int = ROUNDS, B: int = B_REQ, K: int = K_KEYS,
            n_shards: int = N_SHARDS, seed: int = SEED, **knobs):
    """A serving runtime over ``table`` and a recorded drifting Zipf
    stream (serve_bench's geometry); returns (runtime, stream, keys by
    request id)."""
    from repro_torch.serve import (DriftingZipfStream, ReplayStream,
                                   ServeConfig, ServingRuntime)
    V = table.shape[0]
    live = DriftingZipfStream(V, K, zipf_a=1.1, arrival_rate=B,
                              scenario="rotate", rotate_every=12, seed=seed)
    replay = ReplayStream.record(live, rounds + 40)
    keys = {r.rid: r.keys for wave in replay.per_round for r in wave}
    cfg = ServeConfig(vocab=V, batch_requests=B, keys_per_request=K,
                      n_shards=n_shards, kernel=True, summary=False,
                      seed=seed, **knobs)
    return ServingRuntime(table, cfg, device=table.device), replay, keys


def serve(table, rounds: int = ROUNDS, **knobs) -> dict:
    """One run of the serving runtime; checks every served row against
    ``table[keys]`` bitwise.  Returns the run's numbers and the kernels'
    launches during it."""
    import torch
    from repro_torch.kernels import ops
    dev = table.device
    rt, replay, keys = runtime(table, rounds, **knobs)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.run(replay, rounds, collect_outputs=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if res.served <= 0 or res.zero_served != 0:
        raise AssertionError(f"served={res.served} "
                             f"zero_served={res.zero_served}")
    if len(res.outputs) != res.served:
        raise AssertionError("outputs do not cover the served requests")
    rids = sorted(res.outputs)
    for i in range(0, len(rids), 64):
        chunk = rids[i:i + 64]
        got = torch.from_numpy(np.stack([res.outputs[r] for r in chunk]))
        idx = torch.from_numpy(np.stack([keys[r] for r in chunk]))
        want = table.index_select(0, idx.to(dev).reshape(-1))
        if not torch.equal(bits(got.to(dev).reshape(want.shape)),
                           bits(want)):
            raise AssertionError(f"served rows != table[keys] for "
                                 f"requests {chunk[0]}..{chunk[-1]}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the run")
    return {"knobs": {k: str(v) for k, v in knobs.items()} or "auto",
            "served": res.served, "rounds": res.rounds,
            "replans": res.replans, "requeues": res.requeues,
            "zero_served": res.zero_served,
            "final_knobs": res.knobs, "launches": launches,
            "wall_s": wall, "throughput_rps": res.throughput_rps,
            "p50_ms": res.p50_ms, "p99_ms": res.p99_ms,
            "mean_miss_rate": float(np.mean([m for _, m in res.miss_trace])),
            "plan_miss_capacities": res.plan_miss_capacities}


def profile(table, rounds: int = ROUNDS, **knobs) -> dict:
    """Where one serving run's time goes.  The run (outputs not collected)
    is made twice on fresh runtimes: untraced, for host wall time per
    round and served requests per second, then under `torch.profiler`,
    for the device's busy time (the sum of its kernels' times; one stream,
    so they do not overlap), the device time per kernel name and the host
    time per runtime phase (the runtime's own spans: ``serve.round``
    encloses the phases, ``serve.plan`` the staging gather)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    dev = table.device
    rt, replay, _ = runtime(table, rounds, **knobs)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = rt.run(replay, rounds)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rt, replay, _ = runtime(table, rounds, trace=True, **knobs)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.run(replay, rounds)
        torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            name = ev.key[:72]
            by_kernel[name] = by_kernel.get(name, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    host_ms = {}
    for ev in rt.tracer.events():
        if ev["name"] != "serve.request":
            host_ms[ev["name"]] = host_ms.get(ev["name"], 0.0) + \
                (ev["t1_ns"] - ev["t0_ns"]) / 1e6
    return {"knobs": {k: str(v) for k, v in knobs.items()} or "auto",
            "served": res.served, "rounds": res.rounds,
            "requeues": res.requeues, "zero_served": res.zero_served,
            "wall_s": wall,
            "ms_per_round": wall * 1e3 / rounds,
            "throughput_rps": res.throughput_rps,
            "peak_alloc_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "traced_wall_s": traced, "device_busy_ms": busy_ms,
            "device_busy_share_traced": busy_ms / (traced * 1e3),
            "top_device_ms": dict(top), "host_span_ms": host_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    print(f"[1/5] device: {card} ({torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"[2/5] built {lib.relative_to(Path(__file__).resolve().parent)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    table = make_table(dev)
    err = check_kernels(table)
    times = time_kernels(table)
    print("[3/5] kernels == plain versions, bitwise: "
          + json.dumps({k: {"max_abs_err": err[k], **times[k]}
                        for k in err}), flush=True)

    runs = [serve(table),
            serve(table, cache_capacity=512, pipeline_depth=2)]
    for r in runs:
        print("[4/5] serve " + json.dumps(r), flush=True)
    for knobs in ({}, {"cache_capacity": 512, "pipeline_depth": 2}):
        print("[4/5] profile " + json.dumps(profile(table, **knobs)),
              flush=True)

    source = "src/repro_torch/kernels/csrc/row_kernels.cu"
    replaces = {"embed_gather": "src/repro/kernels/embed_gather.py:30",
                "pm_combine": "src/repro/kernels/pm_forward.py:178"}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces[name],
                "launches": sum(r["launches"][name] for r in runs),
                "max_abs_err": err[name], "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": times[name]["library_ms"]}
               for name in replaces]
    print("[5/5] done")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
