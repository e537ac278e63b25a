#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs CUDA and the CUDA toolkit (``nvcc``) and fails without them.  In
order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. holds each kernel against its plain PyTorch version, bit for bit, in
   fp32 and bf16 at D in {1, 8, 576, 6144} over a 256000-row table (the
   nemotron-4-15b embedding, 6.29 GB in fp32; `adagrad_rows` updates it in
   place with an fp32 accumulator of the same size), with pads (id == V)
   and row 0 among the ids; then times kernel, plain version and the
   PyTorch library call with CUDA events at the serving and training
   paths' shapes;
4. serves a drifting Zipf request stream through
   `repro_torch.serve.ServingRuntime` at full width (vocab 256000, D 6144,
   64 requests of 64 keys per batch, 64 emulated shards) twice — with the
   runtime's automatic knobs, and with a 512-row cache and a 2-deep
   pipeline — and checks every served row against ``table[keys]`` bit for
   bit, that no request was served a zero row, and that both kernels were
   launched during each run; then serves each configuration twice more
   without collecting outputs, untraced and under `torch.profiler`, to
   show where its time goes;
5. frees the serving table and trains through
   `repro_torch.train.loop.train_loop` (intent-managed embedding, AdaGrad,
   seeded random init): nemotron-4-15b at its published widths with 4 of
   its 32 layers (untied: the fused sparse arm, `adagrad_rows`) and
   smollm-135m at its full published config (tied: the lookup's backward,
   `scatter_rows`), 16 steps of 8 x 64 tokens each through the kernels
   (AdaGrad at lr 1e-4 on nemotron, where the reference's 0.01 diverges,
   and 0.01 on smollm),
   checks finite losses, no overflow and which kernels ran, then the same
   run through the plain versions, whose loss trace must agree within
   rtol 1e-4 / atol 1e-5; then trains each again, untraced and under
   `torch.profiler`, to show where a step's time goes;
6. prints the kernel table as one JSON line, the card line and, last, the
   device line.

Any failure raises, so the script exits non-zero before those last lines.
"""

from __future__ import annotations

import dataclasses
import gc
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
N_ROWS = 512                  # training step: 8 x 64 tokens, one slot each
SMOLLM = (49152, 576)         # smollm-135m (tied) embedding: scatter shape
TRAIN_STEPS, TRAIN_B, TRAIN_S = 16, 8, 64
PROFILE_STEPS = 12
NEMOTRON_LAYERS = 4           # of 32: fp32 AdaGrad state of 32 layers
#                               does not fit 80 GB
TRAIN_KNOBS = dict(cache_capacity=1024, refresh_every=2, pipeline_depth=1,
                   n_shards=4, plan_every=8)
# nemotron at its full width diverges under the reference's default lr
# 0.01 (AdaGrad's first step moves every weight by about +-lr, large
# against a 1/sqrt(6144) init: loss 13.2 -> 70 in four steps), and a
# diverging run amplifies rounding into a different trace; 1e-4 trains
TRAIN_LR = {"nemotron-4-15b": 1e-4, "smollm-135m": 1e-2}
TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-5
SERVE_KERNELS = ("embed_gather", "pm_combine")


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
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
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


def check_training_kernels(table, dims=DIMS, n=N_ROWS,
                           seed: int = SEED) -> dict:
    """`adagrad_rows` and `scatter_rows` against their plain versions on
    the same inputs, bitwise, in fp32 and bf16 at every width in ``dims``
    over the full table's rows; ``n`` unique ids with row 0 and pads
    (id == V, skipped by both) among them.  Returns the largest absolute
    difference per kernel (0.0 when bitwise)."""
    import torch
    from repro_torch.kernels.adagrad_rows import adagrad_row_update
    from repro_torch.kernels.ref import (adagrad_row_update_ref,
                                         scatter_rows_ref)
    from repro_torch.kernels.scatter_rows import scatter_rows
    dev = table.device
    V = table.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    err = {"adagrad_rows": 0.0, "scatter_rows": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for D in dims:
            # unique ids (the kernels' contract): 1..V-1 drawn, then row 0
            ids = (torch.randperm(V - 1, generator=g, device=dev)[:n] + 1) \
                .to(torch.int32)
            ids[0] = 0
            ids[1::97] = V                      # pads: skipped
            grads = torch.randn((n, D), generator=g, device=dev)
            src = table[:, :D].to(dtype).contiguous() if D != WIDTH \
                else table.to(dtype)
            acc = torch.rand((V, D), generator=g, device=dev)
            t_k, a_k = adagrad_row_update(src.clone(), acc.clone(), ids,
                                          grads, lr=0.01)
            t_p, a_p = adagrad_row_update_ref(src.clone(), acc.clone(), ids,
                                              grads, lr=0.01)
            torch.cuda.synchronize(dev)
            if not (torch.equal(bits(t_k), bits(t_p))
                    and torch.equal(bits(a_k), bits(a_p))):
                raise AssertionError(f"adagrad_rows != plain ({dtype}, "
                                     f"D={D})")
            if torch.equal(bits(t_k[0]), bits(src[0])):
                raise AssertionError("adagrad_rows did not update row 0")
            err["adagrad_rows"] = max(err["adagrad_rows"],
                                      max_abs_err(t_k, t_p),
                                      max_abs_err(a_k, a_p))
            del src, acc, t_k, a_k, t_p, a_p
            base = torch.zeros((V + 1, D), dtype=dtype, device=dev)
            rows = torch.randn((n, D), generator=g, device=dev).to(dtype)
            rows[ids == V] = 0                  # pads hit the trash row
            got = scatter_rows(base.clone(), ids, rows)
            want = scatter_rows_ref(base, ids, rows)
            torch.cuda.synchronize(dev)
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"scatter_rows != plain ({dtype}, "
                                     f"D={D})")
            err["scatter_rows"] = max(err["scatter_rows"],
                                      max_abs_err(got, want))
            del base, got, want
    return err


def time_training_kernels(table, n=N_ROWS, seed: int = SEED) -> dict:
    """Kernel, plain version and library composition at the training
    step's shapes: the AdaGrad update of n = 512 unique rows of the full
    table (in place, with an fp32 accumulator of the table's size) and
    the scatter of 512 rows into smollm-135m's (49153, 576) gradient
    buffer.  Ids hold no pads, so the library calls take them too."""
    import torch
    from repro_torch.kernels.adagrad_rows import adagrad_row_update
    from repro_torch.kernels.ref import (adagrad_row_update_ref,
                                         scatter_rows_ref)
    from repro_torch.kernels.scatter_rows import scatter_rows
    dev = table.device
    V, D = table.shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    ids = torch.randperm(V, generator=g, device=dev)[:n].to(torch.int32)
    idl = ids.long()
    grads = torch.randn((n, D), generator=g, device=dev)
    accum = torch.rand((V, D), generator=g, device=dev)
    lr, eps = 0.01, 1e-8

    def library_adagrad():
        a = accum.index_select(0, idl) + grads * grads
        p = table.index_select(0, idl) - lr * grads / (torch.sqrt(a) + eps)
        accum.index_copy_(0, idl, a)
        table.index_copy_(0, idl, p)

    Vs, Ds = SMOLLM
    s_ids = torch.randperm(Vs, generator=g, device=dev)[:n].to(torch.int32)
    s_idl = s_ids.long()
    s_rows = torch.randn((n, Ds), generator=g, device=dev)
    base = torch.zeros((Vs + 1, Ds), device=dev)
    out = {
        "adagrad_rows": {
            "shape": f"table ({V}, {D}) {table.dtype}, accum fp32, n={n}",
            "ms": median_ms(lambda: adagrad_row_update(
                table, accum, ids, grads, lr=lr, eps=eps)),
            "plain_ms": median_ms(lambda: adagrad_row_update_ref(
                table, accum, ids, grads, lr=lr, eps=eps)),
            "library_ms": median_ms(library_adagrad),
            "bound_ms": (5 * n * D * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3,
        },
        "scatter_rows": {
            "shape": f"base ({Vs + 1}, {Ds}) fp32, n={n}",
            "ms": median_ms(lambda: scatter_rows(base, s_ids, s_rows)),
            "plain_ms": median_ms(lambda: scatter_rows_ref(base, s_ids,
                                                           s_rows)),
            "library_ms": median_ms(lambda: base.index_copy_(0, s_idl,
                                                             s_rows)),
            "bound_ms": (2 * n * Ds * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3,
        },
    }
    del accum
    return out


def train_config(arch: str):
    """The published config; nemotron-4-15b cut to NEMOTRON_LAYERS."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if arch == "nemotron-4-15b":
        cfg = dataclasses.replace(cfg, n_layers=NEMOTRON_LAYERS)
    return cfg


def loop_config(arch: str, kernel: bool, steps: int = TRAIN_STEPS):
    from repro_torch.train.loop import LoopConfig
    return LoopConfig(steps=steps, batch=TRAIN_B, seq=TRAIN_S,
                      lr=TRAIN_LR[arch], kernel=kernel, log_every=0,
                      seed=SEED, **TRAIN_KNOBS)


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train(arch: str, kernel: bool) -> dict:
    """One training run (seeded random init on the card); checks finite
    losses and no overflow, and with ``kernel`` which kernels ran: the
    fused arm (untied) updates rows with `adagrad_rows` and never
    scatters, the tied arm scatters with `scatter_rows` and never runs
    the row update; both gather and combine through the forward
    kernels."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train_loop
    free_card()
    cfg = train_config(arch)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_loop(cfg, loop_config(arch, kernel))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if len(res.losses) != TRAIN_STEPS or not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"{arch}: losses {res.losses}")
    if res.overflows != 0:
        raise AssertionError(f"{arch}: {res.overflows} overflow steps")
    if kernel:
        want = ("scatter_rows",) if cfg.tie_embeddings else ("adagrad_rows",)
        never = ("adagrad_rows",) if cfg.tie_embeddings else ("scatter_rows",)
        for name in SERVE_KERNELS + want:
            if launches[name] <= 0:
                raise AssertionError(f"{arch}: {name} was not launched")
        for name in never:
            if launches[name] != 0:
                raise AssertionError(f"{arch}: {name} ran on the wrong arm")
    elif any(launches.values()):
        raise AssertionError(f"{arch}: plain run launched {launches}")
    return {"arch": arch, "n_layers": cfg.n_layers,
            "tied": cfg.tie_embeddings, "kernel": kernel,
            "steps": len(res.losses), "losses": res.losses,
            "plans": res.plans, "refreshes": res.refreshes,
            "overflows": res.overflows, "recompiles": res.recompiles,
            "launches": launches, "wall_s": wall,
            "peak_alloc_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def loss_clock():
    """A telemetry bus that also notes the host clock at every loss read
    (the loop publishes ``train.loss`` as it reads each step's loss)."""
    from repro_torch.obs.telemetry import Telemetry

    class LossClock(Telemetry):
        def __init__(self):
            super().__init__()
            self.loss_t = []

        def set(self, name, v, **labels):
            if name == "train.loss":
                self.loss_t.append(time.perf_counter())
            super().set(name, v, **labels)

    return LossClock()


def train_profile(arch: str, steps: int = PROFILE_STEPS) -> dict:
    """Where a training step's time goes: an untraced run for the steady
    step time (host clock between the first and the last loss read, over
    the steps between) and tokens per second, beside the loop's own
    per-step latency (a step's start to its loss being read, which at
    pipeline depth 1 spans the next step's dispatch too), then a run under
    `torch.profiler` with the loop's span tracer on, for the device's
    busy time (the sum of its kernels' times), the device time per kernel
    name, the host time per loop phase and peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.obs.trace import make_tracer
    from repro_torch.train.loop import train_loop
    cfg = train_config(arch)
    dev = torch.device("cuda")
    free_card()
    bus = loss_clock()
    t0 = time.perf_counter()
    res = train_loop(cfg, loop_config(arch, True, steps), telemetry=bus)
    wall = time.perf_counter() - t0
    ms = (bus.loss_t[-1] - bus.loss_t[0]) * 1e3 / (len(bus.loss_t) - 1)
    latency_ms = statistics.median(bus.latency("train.step_ms").values())
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    tracer = make_tracer(True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_loop(cfg, loop_config(arch, True, steps), tracer=tracer)
        torch.cuda.synchronize(dev)
        traced = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            name = ev.key[:72]
            by_kernel[name] = by_kernel.get(name, 0.0) + \
                ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    host_ms = {}
    for ev in tracer.events():
        host_ms[ev["name"]] = host_ms.get(ev["name"], 0.0) + \
            (ev["t1_ns"] - ev["t0_ns"]) / 1e6
    return {"arch": arch, "n_layers": cfg.n_layers, "steps": steps,
            "tokens_per_step": TRAIN_B * TRAIN_S,
            "untraced_wall_s": wall, "step_ms": ms,
            "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3),
            "median_step_latency_ms": latency_ms,
            "final_loss": res.losses[-1],
            "traced_wall_s": traced, "device_busy_ms": busy_ms,
            "device_busy_share_traced": busy_ms / (traced * 1e3),
            "top_device_ms": dict(sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:8]),
            "host_span_ms": host_ms,
            "peak_alloc_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    print(f"[1/6] device: {card} ({torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"[2/6] built {lib.relative_to(Path(__file__).resolve().parent)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    table = make_table(dev)
    err = check_kernels(table)
    err.update(check_training_kernels(table))
    times = time_kernels(table)
    times.update(time_training_kernels(table))
    print("[3/6] kernels == plain versions, bitwise: "
          + json.dumps({k: {"max_abs_err": err[k], **times[k]}
                        for k in err}), flush=True)

    runs = [serve(table),
            serve(table, cache_capacity=512, pipeline_depth=2)]
    for r in runs:
        print("[4/6] serve " + json.dumps(r), flush=True)
    for knobs in ({}, {"cache_capacity": 512, "pipeline_depth": 2}):
        print("[4/6] profile " + json.dumps(profile(table, **knobs)),
              flush=True)
    del table

    trains = []
    for arch in ("nemotron-4-15b", "smollm-135m"):
        ker, plain = train(arch, True), train(arch, False)
        np.testing.assert_allclose(ker["losses"], plain["losses"],
                                   rtol=TRACE_RTOL, atol=TRACE_ATOL,
                                   err_msg=f"{arch}: kernel vs plain trace")
        diff = float(np.max(np.abs(np.subtract(ker["losses"],
                                               plain["losses"]))))
        for r in (ker, plain):
            print("[5/6] train " + json.dumps(r), flush=True)
        print(f"[5/6] {arch}: kernel vs plain loss trace, max abs diff "
              f"{diff!r} (rtol {TRACE_RTOL}, atol {TRACE_ATOL})", flush=True)
        trains.append(ker)
    for arch in ("nemotron-4-15b", "smollm-135m"):
        print("[5/6] train profile " + json.dumps(train_profile(arch)),
              flush=True)

    source = {"embed_gather": "src/repro_torch/kernels/csrc/row_kernels.cu",
              "pm_combine": "src/repro_torch/kernels/csrc/row_kernels.cu",
              "adagrad_rows": "src/repro_torch/kernels/csrc/adagrad_rows.cu",
              "scatter_rows": "src/repro_torch/kernels/csrc/row_kernels.cu"}
    replaces = {"embed_gather": "src/repro/kernels/embed_gather.py:30",
                "pm_combine": "src/repro/kernels/pm_forward.py:178",
                "adagrad_rows": "src/repro/kernels/adagrad_rows.py:38",
                "scatter_rows": "src/repro/kernels/scatter_rows.py:30"}
    kernels = [{"name": name, "route": "cuda", "source": source[name],
                "replaces": replaces[name],
                "launches": sum(r["launches"][name] for r in runs + trains),
                "max_abs_err": err[name], "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": times[name]["library_ms"]}
               for name in replaces]
    print("[6/6] done")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
