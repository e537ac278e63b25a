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
   and row 0 among the ids; `embed_gather` on both its paths (TMA bulk
   copies for rows of a multiple of 16 bytes, and its word path, forced
   onto those rows and taken by odd widths and an unaligned copy of the
   table), printing the path each check took; the segmented scatter over
   the smollm-135m loader's tokens against its plain version on CPU
   copies (bit for bit) and on the card (within the bound of a reordered
   fp32 sum); then times kernel, plain version and the PyTorch library
   call with CUDA events at the serving and training paths' shapes (the
   gather on both its paths), and each wrapper's and library call's host
   time per call (1000 calls, no synchronise between them);
4. serves a drifting Zipf request stream through
   `repro_torch.serve.ServingRuntime` at full width (vocab 256000, D 6144,
   64 requests of 64 keys per batch, 64 emulated shards) twice — with the
   runtime's automatic knobs, and with a 512-row cache and a 2-deep
   pipeline — and checks every served row against ``table[keys]`` bit for
   bit, that no request was served a zero row, and that both kernels were
   launched during each run; records the id-bucket sizes the runs hand to
   `embed_gather` and times the gather at those sizes (id sets rotated so
   that the 50 MB L2 does not serve repeated rows); then serves each
   configuration twice more without collecting outputs, untraced and
   under `torch.profiler`, to show where its time goes;
5. frees the serving table, counts the device launches of the dense
   arm's lookup backward (nodes of a CUDA graph captured from one call),
   and trains through
   `repro_torch.train.loop.train_loop` (intent-managed embedding, AdaGrad,
   seeded random init): nemotron-4-15b at its published widths with 4 of
   its 32 layers (untied: the fused sparse arm, `adagrad_rows`, and the
   delta refresh, `embed_gather` and `scatter_rows`) and smollm-135m at
   its full published config (tied: the lookup's backward,
   `segment_scatter_rows`), 16 steps of 8 x 64 tokens each through the
   kernels (AdaGrad at lr 1e-4 on nemotron, where the reference's 0.01
   diverges, and 0.01 on smollm),
   checks finite losses, no overflow and which kernels ran, then the same
   run through the plain versions, whose loss trace must agree within
   rtol 1e-4 / atol 1e-5; then trains each again, untraced and under
   `torch.profiler`, to show where a step's time goes;
6. prints the kernel table as one JSON line, the card line and, last, the
   device line.

Any failure raises, so the script exits non-zero before those last lines.

Two more modes compare this tree with another checkout on one card:

    python3 chip_smoke.py --ab DIR     # DIR: a checkout of another commit

records the serving runs' gather sizes as above, then runs ``python3
chip_smoke.py --measure`` four times in turns — DIR's package, this one,
this one, DIR's — each printing one JSON line of kernel times (the gather
at n = 4096 and at the recorded sizes, the scatters, pm_combine,
adagrad_rows), each wrapper's host time per call, and the end-to-end
times: ms per round of both serving runs and ms per smollm-135m step.
"""

from __future__ import annotations

import ctypes
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
HOST_CALLS = 1000             # calls per host-time measurement
WORD_ROWS = 32768             # rows of the unaligned table copy (word path)
L2_BYTES = 50 * 2 ** 20       # H100 L2 cache


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


def unaligned(x):
    """A copy of ``x`` whose first element sits one element past a 16-byte
    boundary (rows keep their width): the gather's word path."""
    import torch
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def loader_tokens(dev, seed: int = SEED):
    """One training batch of smollm-135m's loader corpus (8 x 64 tokens,
    Zipf 1.1 over 49152 ids), flattened to (512,) int32, with row 0 and
    id V - 1 among them."""
    import torch
    from repro_torch.data.pipeline import SyntheticCorpus
    tok = SyntheticCorpus(SMOLLM[0], seed=seed).tokens((TRAIN_B, TRAIN_S))
    tok = tok.reshape(-1).astype(np.int32)
    tok[:2] = [0, SMOLLM[0] - 1]
    return torch.from_numpy(tok).to(dev)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host time per call to enqueue ``fn``: a host clock over ``calls``
    calls with no synchronise between them (the one synchronise after
    them is outside the clock).  Where the device is slower than the host
    the launch queue fills and this reads the device's pace instead."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def check_kernels(table, dims=DIMS, n=N_IDS, T=T_TOK, C=C_ROWS, M=M_ROWS,
                  seed: int = SEED):
    """Each kernel's wrapper against its plain version on the same inputs,
    bitwise, for fp32 and bf16 and every width in ``dims``; the gather
    held to each path on aligned rows, and from an unaligned copy of the
    table's first rows (the word path).  Returns the largest
    absolute difference seen per kernel (0.0 when bitwise) and the
    gather's path per check."""
    import torch
    from repro_torch.kernels.embed_gather import (embed_gather,
                                                  embed_gather_path)
    from repro_torch.kernels.pm_forward import pm_combine
    from repro_torch.kernels.ref import embed_gather_ref, pm_combine_ref
    dev = table.device
    V = table.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    err = {"embed_gather": 0.0, "pm_combine": 0.0}
    paths = {}
    for dtype in (torch.float32, torch.bfloat16):
        for D in dims:
            src = table[:, :D].to(dtype).contiguous() if D != WIDTH \
                else table.to(dtype)
            ids = torch.randint(0, V, (n,), generator=g, device=dev,
                                dtype=torch.int32)
            ids[0] = 0
            ids[1::97] = V                      # bucket pads: zero rows
            word = unaligned(src[:WORD_ROWS])
            word_ids = torch.where(ids < V, ids % WORD_ROWS, WORD_ROWS)
            aligned = (D * src.element_size()) % 16 == 0
            for name, tab, idx, path in (
                    ("aligned", src, ids, "auto"),
                    ("aligned, held to tma", src, ids, "tma"),
                    ("aligned, held to word", src, ids, "word"),
                    ("unaligned", word, word_ids, "auto")):
                if path == "tma" and not aligned:
                    continue
                got = embed_gather(tab, idx, path=path)
                want = embed_gather_ref(tab, idx)
                torch.cuda.synchronize(dev)
                key = f"{str(dtype)[6:]} D={D} {name}"
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(f"embed_gather != plain ({key})")
                paths[key] = path if path != "auto" else \
                    embed_gather_path(tab, got)
                err["embed_gather"] = max(err["embed_gather"],
                                          max_abs_err(got, want))
            del src, word
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
    chosen = [p for key, p in paths.items() if "held" not in key]
    for p in ("tma", "word"):
        if p not in chosen:
            raise AssertionError(f"no gather check chose the {p} path")
    return err, paths


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


def path_gather(path: str):
    """The gather held to one path ("tma" or "word"), where the tree under
    test has that option; else None."""
    import functools
    import inspect
    from repro_torch.kernels.embed_gather import embed_gather
    if "path" not in inspect.signature(embed_gather).parameters:
        return None
    return functools.partial(embed_gather, path=path)


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

    def gather():
        return embed_gather(table, ids)

    def gather_lib():
        return torch.index_select(table, 0, ids)

    def combine():
        return pm_combine(hit, cslot, bslot, cache, buf)

    def combine_lib():
        return torch.where(hit_b[:, None], cache.index_select(0, cslot),
                           buf.index_select(0, bslot))

    return {
        "embed_gather": {
            "shape": f"table ({V}, {D}) {table.dtype}, n={n}",
            "ms": median_ms(gather),
            "plain_ms": median_ms(lambda: embed_gather_ref(table, ids)),
            "library_ms": median_ms(gather_lib),
            "bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
            "host_us": host_us(gather),
            "library_host_us": host_us(gather_lib),
        },
        "pm_combine": {
            "shape": f"T={T}, cache ({C}, {D}), buf ({M + 1}, {D}) "
                     f"{table.dtype}",
            "ms": median_ms(combine),
            "plain_ms": median_ms(lambda: pm_combine_ref(
                hit, cslot, bslot, cache, buf)),
            "library_ms": median_ms(combine_lib),
            "bound_ms": combine_bytes / HBM_BYTES_PER_S * 1e3,
            "host_us": host_us(combine),
            "library_host_us": host_us(combine_lib),
        },
    }


def gather_at_sizes(table, sizes, seed: int = SEED) -> dict:
    """`embed_gather` and `index_select` at each id-bucket size in
    ``sizes`` (the serving runs' gathers), full-width rows of ``table``.
    Each size cycles through enough distinct id sets that their rows
    exceed twice the L2 cache, so repeated calls read HBM as the serving
    path's fresh misses do.  Returns ms per call and the bound per size;
    where the tree has the option, also each path's ms, the two timed in
    turns (TMA, word, word, TMA), so "tma_ms" and "word_ms" list two turns
    each, and the path the gather takes left to choose."""
    import itertools
    import torch
    from repro_torch.kernels.embed_gather import embed_gather
    dev = table.device
    V, D = table.shape
    row_bytes = D * table.element_size()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    tma, word = path_gather("tma"), path_gather("word")
    out = {}
    for n in sizes:
        k = min(1024, max(2, -(-2 * L2_BYTES // (n * row_bytes))))
        sets = [torch.randint(0, V, (n,), generator=g, device=dev,
                              dtype=torch.int32) for _ in range(k)]
        cyc = itertools.cycle(sets)

        def timed(fn):
            return median_ms(lambda: fn(table, next(cyc)))

        row = {"ms": timed(embed_gather)}
        if tma is not None:
            from repro_torch.kernels.embed_gather import embed_gather_path
            t0, w0, w1, t1 = timed(tma), timed(word), timed(word), timed(tma)
            row.update(tma_ms=[t0, t1], word_ms=[w0, w1],
                       path=embed_gather_path(table, embed_gather(
                           table, sets[0])))
        row.update(
            library_ms=timed(lambda t, i: torch.index_select(t, 0, i)),
            bound_ms=(2 * n * row_bytes + 4 * n) / HBM_BYTES_PER_S * 1e3,
            id_sets=k)
        out[n] = row
    return out


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
    ``table[keys]`` bitwise.  Returns the run's numbers, the kernels'
    launches during it and how many gathers it made at each id-bucket
    size (recorded between `ops.embed_gather` and the kernel's
    wrapper)."""
    import torch
    from repro_torch.kernels import ops
    dev = table.device
    rt, replay, keys = runtime(table, rounds, **knobs)
    gather = ops._gather_kernel
    sizes = {}

    def recording_gather(tab, ids):
        sizes[ids.shape[0]] = sizes.get(ids.shape[0], 0) + 1
        return gather(tab, ids)

    ops.reset_launch_counts()
    ops._gather_kernel = recording_gather
    try:
        t0 = time.perf_counter()
        res = rt.run(replay, rounds, collect_outputs=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        ops._gather_kernel = gather
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
            "gather_sizes": dict(sorted(sizes.items())),
            "wall_s": wall, "throughput_rps": res.throughput_rps,
            "p50_ms": res.p50_ms, "p99_ms": res.p99_ms,
            "mean_miss_rate": float(np.mean([m for _, m in res.miss_trace])),
            "plan_miss_capacities": res.plan_miss_capacities}


def serve_untraced(table, rounds: int = ROUNDS, **knobs):
    """One serving run on a fresh runtime, outputs not collected; returns
    the run's result and its host wall time in seconds."""
    import torch
    rt, replay, _ = runtime(table, rounds, **knobs)
    t0 = time.perf_counter()
    res = rt.run(replay, rounds)
    torch.cuda.synchronize(table.device)
    return res, time.perf_counter() - t0


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
    torch.cuda.reset_peak_memory_stats(dev)
    res, wall = serve_untraced(table, rounds, **knobs)
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


def reorder_tolerance(base, residual, grads):
    """Per element, the forward-error bound of an fp32 sum of a run taken
    in another order: 2 * (T - 1) * 2^-24 * sum |g| (T bounds any run's
    length), plus one rounding to bf16 where base is bf16."""
    import torch
    from repro_torch.kernels.ref import segment_scatter_rows_ref
    T = grads.shape[0]
    mag = segment_scatter_rows_ref(
        torch.zeros(base.shape, dtype=torch.float32, device=base.device),
        residual, grads.float().abs())
    tol = 2.0 * max(T - 1, 1) * 2.0 ** -24 * mag
    if base.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * mag
    return tol


def check_segment_scatter(dev, dims=DIMS, seed: int = SEED) -> dict:
    """`segment_scatter_rows` over one smollm-135m loader batch (512
    tokens with the corpus's duplicates, row 0 and id V - 1) into a zero
    (49153, D) buffer, fp32 and bf16 at every width in ``dims``: bit for
    bit against the plain version run on CPU copies (both add each run in
    sorted order), and within `reorder_tolerance` of the plain version on
    the card (whose `index_add_` adds with atomics).  Returns the largest
    absolute difference from the CPU copies (0.0 when bitwise) and the
    largest ratio of the card difference to its tolerance."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_scatter_rows_ref
    from repro_torch.kernels.scatter_rows import segment_scatter_rows
    R = SMOLLM[0] + 1
    tok = loader_tokens(dev, seed)
    T = tok.shape[0]
    res = ops.sorted_slots(tok, T)
    res_cpu = type(res)(*(x.cpu() for x in res))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 6)
    err, ratio = 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for D in dims:
            grads = torch.randn((T, D), generator=g, device=dev).to(dtype)
            base = torch.zeros((R, D), dtype=dtype, device=dev)
            got = segment_scatter_rows(base.clone(), res, grads)
            torch.cuda.synchronize(dev)
            got_cpu = got.cpu()
            want = segment_scatter_rows_ref(base.cpu(), res_cpu, grads.cpu())
            if not torch.equal(bits(got_cpu), bits(want)):
                raise AssertionError(f"segment_scatter_rows != plain on CPU "
                                     f"copies ({dtype}, D={D})")
            err = max(err, max_abs_err(got_cpu, want))
            card = segment_scatter_rows_ref(base, res, grads)
            diff = (got.float() - card.float()).abs()
            tol = reorder_tolerance(base, res, grads)
            if bool((diff > tol).any()):
                raise AssertionError(f"segment_scatter_rows beyond the "
                                     f"reorder bound on the card ({dtype}, "
                                     f"D={D})")
            over = diff[tol > 0] / tol[tol > 0]
            ratio = max(ratio, float(over.max()) if over.numel() else 0.0)
            del base, got, card, diff, tol, got_cpu, want
    return {"max_abs_err": err, "card_diff_over_tolerance": ratio}


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

    def adagrad():
        return adagrad_row_update(table, accum, ids, grads, lr=lr, eps=eps)

    Vs, Ds = SMOLLM
    s_ids = torch.randperm(Vs, generator=g, device=dev)[:n].to(torch.int32)
    s_idl = s_ids.long()
    s_rows = torch.randn((n, Ds), generator=g, device=dev)
    base = torch.zeros((Vs + 1, Ds), device=dev)

    def scatter():
        return scatter_rows(base, s_ids, s_rows)

    def scatter_lib():
        return base.index_copy_(0, s_idl, s_rows)

    out = {
        "adagrad_rows": {
            "shape": f"table ({V}, {D}) {table.dtype}, accum fp32, n={n}",
            "ms": median_ms(adagrad),
            "plain_ms": median_ms(lambda: adagrad_row_update_ref(
                table, accum, ids, grads, lr=lr, eps=eps)),
            "library_ms": median_ms(library_adagrad),
            "bound_ms": (5 * n * D * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3,
            "host_us": host_us(adagrad),
            "library_host_us": host_us(library_adagrad),
        },
        "scatter_rows": {
            "shape": f"base ({Vs + 1}, {Ds}) fp32, n={n}",
            "ms": median_ms(scatter),
            "plain_ms": median_ms(lambda: scatter_rows_ref(base, s_ids,
                                                           s_rows)),
            "library_ms": median_ms(scatter_lib),
            "bound_ms": (2 * n * Ds * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3,
            "host_us": host_us(scatter),
            "library_host_us": host_us(scatter_lib),
        },
    }
    del accum
    return out


def time_segment_scatter(dev, seed: int = SEED) -> dict:
    """The segmented scatter at smollm-135m's step: one loader batch (512
    tokens of 576, fp32, with the corpus's duplicates) into the zero
    (49153, 576) buffer, against its plain version on the card and the
    one PyTorch call computing the same function, ``base.index_add_(0,
    tok, gt)``.  Bound: the token rows read once, the run sums written
    once and the two (T,) index operands read, over the HBM rate."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import segment_scatter_rows_ref
    from repro_torch.kernels.scatter_rows import segment_scatter_rows
    Vs, Ds = SMOLLM
    tok = loader_tokens(dev, seed)
    T = tok.shape[0]
    U = int(torch.unique(tok).numel())
    res = ops.sorted_slots(tok, T)
    tokl = tok.long()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    gt = torch.randn((T, Ds), generator=g, device=dev)
    base = torch.zeros((Vs + 1, Ds), device=dev)

    def seg():
        return segment_scatter_rows(base, res, gt)

    def seg_lib():
        return base.index_add_(0, tokl, gt)

    return {
        "shape": f"base ({Vs + 1}, {Ds}) fp32, T={T} loader tokens "
                 f"({U} unique)",
        "ms": median_ms(seg),
        "plain_ms": median_ms(lambda: segment_scatter_rows_ref(base, res,
                                                               gt)),
        "library_ms": median_ms(seg_lib),
        "bound_ms": ((T + U) * Ds * 4 + 8 * T) / HBM_BYTES_PER_S * 1e3,
        "host_us": host_us(seg),
        "library_host_us": host_us(seg_lib),
    }


# CUgraphNodeType values (cuda.h) of the nodes that run work on the card
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_launches(fn, stream) -> dict:
    """The device work that one call of ``fn`` enqueues, read from a CUDA
    graph captured from that call on ``stream``: its kernel, memcpy and
    memset nodes, and their sum (``launches``).  A capture records every
    launch exactly, where a profiler's short windows can drop events."""
    import torch
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    counts = dict.fromkeys(GRAPH_NODE_KINDS.values(), 0)
    kind = ctypes.c_int(0)
    for i in range(n.value):
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                   ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in GRAPH_NODE_KINDS:
            counts[GRAPH_NODE_KINDS[kind.value]] += 1
    graph.reset()
    counts["launches"] = sum(counts.values())
    return counts


def backward_launches(dev, seed: int = SEED) -> dict:
    """Device launches of the dense arm's lookup backward at smollm-135m's
    step (one loader batch of 8 x 64 tokens, D 576, fp32, every token a
    miss), counted in a CUDA graph captured from one call
    (`graph_launches`): the composition the backward ran before the
    segmented kernel (`ops.segment_rows` on the forward's sort residual,
    then the `scatter_rows` kernel into a zero (V + 1, D) buffer), the
    segmented form (zero buffer, one `segment_scatter_rows`), and
    `pm_lookup`'s whole autograd backward.  Everything runs on one side
    stream, the forward too, so that the backward runs on the stream
    being captured."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.pm_forward import step_residual
    from repro_torch.pm.embedding import make_state, pm_lookup
    V, D = SMOLLM
    tok = loader_tokens(dev, seed)
    T = tok.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 8)
    table = torch.randn((V, D), generator=g, device=dev)
    gout = torch.randn((TRAIN_B, TRAIN_S, D), generator=g, device=dev)
    cache_ids = torch.full((64,), V, dtype=torch.int32, device=dev)
    n_miss = int(torch.unique(tok).numel())
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        state = make_state(table, cache_ids)
        res = step_residual(cache_ids, tok, T).sort
        table.requires_grad_(True)
        out = pm_lookup(table, cache_ids, state.cache_rows,
                        tok.view(TRAIN_B, TRAIN_S), T, kernel=True,
                        n_miss=n_miss)
    gt = gout.reshape(T, D)

    def composition():
        ids, sums = ops.segment_rows(tok, gt, n_slots=T, pad_id=V,
                                     residual=res)
        base = torch.zeros((V + 1, D), device=dev)
        return ops.scatter_rows(base, ids, sums.to(gt.dtype))[:V]

    def segmented():
        base = torch.zeros((V + 1, D), device=dev)
        return ops.segment_scatter_rows(base, res, gt)[:V]

    def backward():
        return torch.autograd.grad(out, table, gout, retain_graph=True)[0]

    counts = {}
    for name, fn in (("composition", composition),
                     ("segment_scatter_rows", segmented),
                     ("pm_lookup_backward", backward)):
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize(dev)
        counts[name] = graph_launches(fn, side)
    if not (0 < counts["pm_lookup_backward"]["launches"]
            < counts["composition"]["launches"]):
        raise AssertionError(f"the backward launches no fewer kernels than "
                             f"the composition: {counts}")
    with torch.cuda.stream(side):
        diff = (composition() - backward()).abs().max()
    torch.cuda.synchronize(dev)
    counts["max_abs_diff_vs_composition"] = float(diff)
    return counts


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
    fused arm (untied) updates rows with `adagrad_rows`, its delta
    refresh writes the cache with `scatter_rows`, and it never runs the
    lookup's backward; the tied arm writes the lookup's gradient with
    `segment_scatter_rows` and runs neither the row update nor the delta
    refresh; both gather and combine through the forward kernels."""
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
        if cfg.tie_embeddings:
            want = ("segment_scatter_rows",)
            never = ("adagrad_rows", "scatter_rows")
        else:
            want = ("adagrad_rows", "scatter_rows")
            never = ("segment_scatter_rows",)
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


def train_untraced(arch: str, steps: int = PROFILE_STEPS):
    """One training run through the kernels, untraced, with a `loss_clock`
    bus; returns the result, the bus and the run's host wall seconds."""
    from repro_torch.train.loop import train_loop
    free_card()
    bus = loss_clock()
    t0 = time.perf_counter()
    res = train_loop(train_config(arch), loop_config(arch, True, steps),
                     telemetry=bus)
    return res, bus, time.perf_counter() - t0


def step_ms(bus) -> float:
    """Steady step time: the host clock between the first and the last
    loss read, over the steps between."""
    return (bus.loss_t[-1] - bus.loss_t[0]) * 1e3 / (len(bus.loss_t) - 1)


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
    res, bus, wall = train_untraced(arch, steps)
    ms = step_ms(bus)
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


SOURCE = {"embed_gather": "src/repro_torch/kernels/csrc/row_kernels.cu",
          "pm_combine": "src/repro_torch/kernels/csrc/row_kernels.cu",
          "adagrad_rows": "src/repro_torch/kernels/csrc/adagrad_rows.cu",
          "scatter_rows": "src/repro_torch/kernels/csrc/row_kernels.cu",
          "segment_scatter_rows":
              "src/repro_torch/kernels/csrc/row_kernels.cu"}
REPLACES = {"embed_gather": "src/repro/kernels/embed_gather.py:30",
            "pm_combine": "src/repro/kernels/pm_forward.py:178",
            "adagrad_rows": "src/repro/kernels/adagrad_rows.py:38",
            "scatter_rows": "src/repro/kernels/scatter_rows.py:30",
            "segment_scatter_rows": "src/repro/kernels/scatter_rows.py:30"}


def serve_sizes(runs) -> list:
    """The id-bucket sizes the serving runs handed to the gather."""
    return sorted({int(n) for r in runs for n in r["gather_sizes"]})


def end_to_end(table) -> dict:
    """Host ms per round of both serving runs (as `profile` makes them,
    untraced) and ms per step of smollm-135m through the kernels (as
    `train_profile` makes it, untraced): the end-to-end numbers that
    `--ab` compares."""
    out = {}
    for name, knobs in (("serve_auto", {}),
                        ("serve_constrained", {"cache_capacity": 512,
                                               "pipeline_depth": 2})):
        _, wall = serve_untraced(table, ROUNDS, **knobs)
        out[f"{name}_ms_per_round"] = wall * 1e3 / ROUNDS
    _, bus, _ = train_untraced("smollm-135m")
    out["smollm_step_ms"] = step_ms(bus)
    return out


def measure(sizes) -> dict:
    """The kernel times, host times and end-to-end times that `--ab`
    compares between two trees: whatever `repro_torch` is on the path."""
    import torch
    import repro_torch
    from repro_torch.kernels import scatter_rows
    dev = torch.device("cuda")
    table = make_table(dev)
    times = time_kernels(table)
    times.update(time_training_kernels(table))
    if hasattr(scatter_rows, "segment_scatter_rows"):   # not in older trees
        times["segment_scatter_rows"] = time_segment_scatter(dev)
    at = gather_at_sizes(table, sorted(set(sizes) | {N_IDS}))
    e2e = end_to_end(table)
    return {"package": str(Path(repro_torch.__file__).resolve().parent),
            "times": times, "gather_at_sizes": at, "end_to_end": e2e}


def ab(other: Path) -> int:
    """Old/new in turns on this card: ``other``'s package, this tree's,
    this tree's, ``other``'s, each in its own process (so each builds and
    loads its own kernels), at the serving runs' gather sizes."""
    import torch
    here = Path(__file__).resolve().parent
    card = card_line()
    print(f"[ab] device: {card}", flush=True)
    table = make_table(torch.device("cuda"))
    runs = [serve(table), serve(table, cache_capacity=512, pipeline_depth=2)]
    sizes = serve_sizes(runs)
    print("[ab] serve gather sizes " + json.dumps(
        [r["gather_sizes"] for r in runs]), flush=True)
    del table, runs
    free_card()
    for label, root in (("old", other), ("new", here), ("new", here),
                        ("old", other)):
        out = subprocess.run(
            [sys.executable, str(here / "chip_smoke.py"), "--measure",
             "--src", str(root / "src"), "--sizes",
             ",".join(map(str, sizes))],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"--measure of {root} failed:\n"
                               f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        print(f"[ab] {label} " + out.stdout.strip().splitlines()[-1],
              flush=True)
    print(card)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--ab"]:
        return ab(Path(args[1]).resolve())
    if args[:1] == ["--measure"]:
        sizes = [int(x) for x in args[args.index("--sizes") + 1].split(",")]
        print(json.dumps(measure(sizes)))
        return 0
    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
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
    err, paths = check_kernels(table)
    err.update(check_training_kernels(table))
    seg = check_segment_scatter(dev)
    err["segment_scatter_rows"] = seg["max_abs_err"]
    print("[3/6] embed_gather paths " + json.dumps(paths), flush=True)
    print("[3/6] segment_scatter_rows " + json.dumps(seg), flush=True)
    times = time_kernels(table)
    times.update(time_training_kernels(table))
    times["segment_scatter_rows"] = time_segment_scatter(dev)
    print("[3/6] kernels == plain versions, bitwise: "
          + json.dumps({k: {"max_abs_err": err[k], **times[k]}
                        for k in err}), flush=True)

    runs = [serve(table),
            serve(table, cache_capacity=512, pipeline_depth=2)]
    for r in runs:
        print("[4/6] serve " + json.dumps(r), flush=True)
    sizes = sorted(set(serve_sizes(runs)) | {N_IDS})
    print("[4/6] embed_gather at the serving runs' sizes and n=4096, both "
          "paths " + json.dumps(gather_at_sizes(table, sizes)), flush=True)
    for knobs in ({}, {"cache_capacity": 512, "pipeline_depth": 2}):
        print("[4/6] profile " + json.dumps(profile(table, **knobs)),
              flush=True)
    del table
    free_card()

    print("[5/6] lookup backward launches " + json.dumps(
        backward_launches(dev)), flush=True)
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

    kernels = []
    for name in REPLACES:
        launches = sum(r["launches"][name] for r in runs + trains)
        if launches <= 0:
            raise AssertionError(f"{name} was not launched on a main path")
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "host_us": t["host_us"], "library_host_us": t["library_host_us"]})
    print("[6/6] done")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--src" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--src") + 1])
    sys.exit(main())
