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
   time per call (1000 calls, no synchronise between them); then times
   the four kernels of qwen3-moe-30b-a3b's training path the same way at
   its shapes (its 151936 x 2048 embedding, 512-token steps, the
   1024-row cache); then holds the selective scan's kernels against
   their plain version at falcon-mamba-7b's training shape (1, 2048,
   8192, 16) and times the forward and the backward beside their bounds
   (bytes at the HBM rate, ``expf`` at the SFU rate, fp32 operations);
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
   delta refresh, `embed_gather` and `scatter_rows`), smollm-135m at
   its full published config (tied: the lookup's backward,
   `segment_scatter_rows`), qwen3-moe-30b-a3b at its published widths
   with 4 of its 48 layers (the MoE family, untied: the fused arm),
   qwen2-vl-7b at its published widths with 4 of its 28 layers (the vlm
   family, untied: the fused arm; 16 image rows a sequence, at M-RoPE
   positions whose t, h and w coordinates differ over the image),
   whisper-medium at its full config (the encdec family, 24 + 24 layers
   over 1500 frames, tied: the dense arm), falcon-mamba-7b at its
   published widths with 8 of its 64 layers (the ssm family: Mamba-1,
   D 4096, d_inner 8192, N 16, untied: the fused arm) and zamba2-1.2b at
   its full config (the hybrid family: 38 Mamba-2 layers and 7
   applications of one shared attention block, untied: the fused arm),
   16 steps of 8 x 64 tokens each (whisper: 4 x 64) through the kernels,
   each layer rematerialised as the step does by default (AdaGrad at
   lr 1e-4, where
   the reference's 0.01 diverges at these widths, and 0.01 on smollm),
   checks finite losses, no overflow and which kernels ran, then the same
   run through the plain versions, whose loss trace must agree within
   rtol 1e-4 / atol 1e-5 (the selective scan has no plain switch on the
   card: falcon-mamba's plain run launches it too, so its comparison
   holds the row kernels alone); then trains each again, untraced and under
   `torch.profiler`, to show where a step's time goes;
6. decodes smollm-135m (full config), qwen3-moe-30b-a3b (4 of 48
   layers), mixtral-8x22b (2 of 56 layers, its sliding window, at
   D 6144), qwen2-vl-7b (4 of 28 layers, text only), whisper-medium
   (full, against the encoder's output over the batch's frames),
   falcon-mamba-7b (all 64 layers) and zamba2-1.2b (full): a batch of 8
   with a 64-token prompt, a fused prefill into a KV cache (the ssm
   family: its O(1) conv and scan state; the hybrid: both), then 32
   greedy one-token steps; holds the fused prefill's last logits against
   a token-by-token prefill and the decoded logits against one
   teacher-forced forward over the consumed tokens, within 2e-3 (the MoE
   models at the positions where, there and before, both paths routed
   alike and dropped nothing; the count left out is printed), then times
   prefill and steps, and prints the decode state's bytes for a cache of
   96 and of 524288 positions (falcon-mamba's must not change);
7. holds the blocked `flash_attention` against `decode_attention` at
   4096 positions on nemotron-4-15b's heads, then prefills one
   32768-token prompt through nemotron-4-15b (4 of 32 layers) without a
   cache (timed, with its peak memory) and holds its last logits within
   2e-3 of the same prompt prefilled into a KV cache in chunks of 1024;
8. starts a one-rank NCCL process group on the card and runs the
   vocab-parallel mesh (`repro_torch.pm.collectives.MeshBackend`) at
   world size 1: its routed gather, gradient scatter, AdaGrad update and
   delta refresh at nemotron-4-15b's width against `EmulatedBackend(1)`
   (both through the kernels; rows, gradients and updated tables bit for
   bit), serves the nemotron embedding over it with the automatic knobs
   and with the constrained run's pinned knobs (exact rows, no zero row
   served, misses routed in the constrained run; ms per round beside the
   emulated runtime's, in turns, and both profiled) and trains
   nemotron-4-15b (4 layers, the fused arm) and smollm-135m (tied:
   `vocab_parallel_ce`) over it, whose loss traces must agree with the
   emulated kernel runs within rtol 1e-4 / atol 1e-5 with no overflow
   step;
9. runs the simulator on the host: the five baselines on
   `tests/data/seed_metrics.json`'s workload (ints equal, floats within
   rel 1e-9), the quickstart's part 1 (KGE, 8 nodes, scale 0.5: AdaPM,
   full replication, static partitioning) and the 1e6-key ZIPF AdaPM
   row of `benchmarks/scale_sweep.py`, whose simulated metrics must
   equal that row of `BENCH_scale.json`; prints the simulated figures
   (the simulator's cost model's, not the card's) and the host seconds
   each took;
10. trains zamba2-1.2b (full, 8 x 64) and qwen3-moe-30b-a3b (4 of 48
   layers) through `make_train_step` (the fused arm with the kernels, 6
   steps) without remat, with "full" and with "dots": each loss trace
   within rtol 1e-6 of the first, the same kernel launches in all three
   (the lookup is outside the rematerialised layers), and zamba2's peak
   lower under "full"; prints step ms and peak memory, and holds each
   run's peak over its steps (`max_memory_allocated` since a reset after
   the model, state and batches exist) within 2 % of the peak the dry
   run's tracker predicts on the host beforehand (plain fake tensors of
   the same config, batch and knobs);
11. decodes `long_500k` on the card: the full falcon-mamba-7b and
   zamba2-1.2b, one sequence against a 524288-position cache of seeded
   normals (zamba2's KV caches: 60.13 GB), from len 524267 to the
   cache's end; falcon-mamba's step must equal itself bit for bit at
   len 524267 and 95, zamba2's first application's attention must hold
   4 heads within rtol 1e-4 / atol 1e-5 of float64 and its k and v at
   slot 524267; prints ms per token (median of 20 steps), the bytes a
   token reads over the HBM rate, and the peak memory, and holds the
   timed steps' peak within 2 % of the tracker's prediction, as phase
   10 does;
12. runs the dry run (`repro_torch.launch.dryrun`) on the card's host,
   in worker processes of their own: one architecture per family
   through every shape on the 16 x 16 mesh and one combination on the
   2 x 16 x 16 mesh, each a step called once on fake DTensors, then the
   reference's hill-climb rungs at train_4k; prints each record (with
   its argument, output and peak bytes a device) and the counts, and
   any combination in error fails;
13. prints the kernel table as one JSON line (the selective scan's
   forward and backward last, their launches those of phase 5's kernel
   run of falcon-mamba-7b), the card line and, last, the device line.

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

import contextlib
import ctypes
import dataclasses
import gc
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
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
# 8 profiled steps (12 before the training step rematerialised each
# layer, which made the training phases about 25 % longer) keep the smoke
# near its earlier length
PROFILE_STEPS = 8
# whisper-medium's step runs about 20k eager calls: 6 profiled steps keep
# the profiler's processing of the trace short
PROFILE_STEPS_OF = {"whisper-medium": 6}
# layers kept of the published depth: the fp32 AdaGrad state (parameters,
# gradients and accumulators) of every layer does not fit 80 GB —
# nemotron-4-15b's 32 layers, and qwen3-moe-30b-a3b's 48 (2.46 GB of
# parameters per layer, about 7.4 GB of state: 354 GB in all)
TRAIN_LAYERS = {"nemotron-4-15b": 4, "qwen3-moe-30b-a3b": 4,
                "qwen2-vl-7b": 4, "falcon-mamba-7b": 8}
MOE_ARCH = "qwen3-moe-30b-a3b"
# the vlm and encdec families: qwen2-vl-7b at its published widths with 4
# of its 28 layers (about 2.0 G parameters, 22 GB with the AdaGrad state;
# 28 layers would need about 90 GB), whisper-medium at its full config
# (24 + 24 layers, 1500 frames), at a batch of 4 x 64 tokens against 1500
# frames each: under autograd each encoder layer keeps its attention's
# (B, 16, 1500, 1500) fp32 probabilities, 0.58 GB a layer at B = 4
VLM_ARCH, ENCDEC_ARCH = "qwen2-vl-7b", "whisper-medium"
# the ssm and hybrid families: falcon-mamba-7b at its published widths
# with 8 of its 64 layers (1.375 G parameters, about 16.5 GB with the
# AdaGrad state; 64 layers would need about 87 GB for that state alone),
# zamba2-1.2b at its full config (38 Mamba-2 layers, 7 applications of
# the shared attention block; 1.17 G parameters, about 14 GB with state)
# at 8 x 64 tokens: under autograd each Mamba-2 layer keeps its states h,
# (8, 64, 64, 64, 64) fp32 or 0.54 GB, about 20 GB over 38 layers, and
# the scan's transients add about 2 GB: a peak near 40 GB, under 70
SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "zamba2-1.2b"
FAMILY_ARCHS = (VLM_ARCH, ENCDEC_ARCH, SSM_ARCH, HYBRID_ARCH)
TRAIN_BATCH = {ENCDEC_ARCH: 4, HYBRID_ARCH: 8}
IMG_GRID = 4                  # the image rows of a vlm batch: a 4 x 4 grid
TRAIN_KNOBS = dict(cache_capacity=1024, refresh_every=2, pipeline_depth=1,
                   n_shards=4, plan_every=8)
# nemotron at its full width diverges under the reference's default lr
# 0.01 (AdaGrad's first step moves every weight by about +-lr, large
# against a 1/sqrt(6144) init: loss 13.2 -> 70 in four steps), and a
# diverging run amplifies rounding into a different trace; 1e-4 trains
TRAIN_LR = {"nemotron-4-15b": 1e-4, "smollm-135m": 1e-2,
            MOE_ARCH: 1e-4, VLM_ARCH: 1e-4, ENCDEC_ARCH: 1e-4,
            SSM_ARCH: 1e-4, HYBRID_ARCH: 1e-4}
# decoding: a batch of 8 with a 64-token prompt, a fused prefill, then 32
# greedy one-token steps; (arch, layers kept) — mixtral-8x22b's 2 of 56
# layers hold about 21 GB of fp32 weights; whisper-medium decodes against
# the encoder's output over the batch's frames; falcon-mamba-7b at its
# full 64 layers (29.1 GB of fp32 weights) and zamba2-1.2b in full
# decode through the recurrent state
DECODE_B, DECODE_PROMPT, DECODE_STEPS = 8, 64, 32
DECODE = (("smollm-135m", None), (MOE_ARCH, 4), ("mixtral-8x22b", 2),
          (VLM_ARCH, 4), (ENCDEC_ARCH, None), (SSM_ARCH, None),
          (HYBRID_ARCH, None))
# the decode state's size is also reckoned for a cache of this many
# positions (`long_500k`'s context), on the meta device
LONG_CONTEXT = 524288
# the long prefill: nemotron-4-15b (4 of 32 layers, about 19 GB of fp32
# weights) over one 32768-token prompt (`configs/shapes.py`'s prefill_32k
# length), held against the same prompt prefilled into a KV cache in
# chunks; and `flash_attention` against `decode_attention` at 4096
LONG_ARCH, LONG_LAYERS, LONG_S, LONG_CHUNK = "nemotron-4-15b", 4, 32768, 1024
FLASH_CHECK_S = 4096
DECODE_TOL = 2e-3             # the reference's decode-vs-forward tolerance
MOE_TABLE = (151936, 2048)    # qwen3-moe-30b-a3b's embedding
TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-5
SERVE_KERNELS = ("embed_gather", "pm_combine")
HOST_CALLS = 1000             # calls per host-time measurement
WORD_ROWS = 32768             # rows of the unaligned table copy (word path)
L2_BYTES = 50 * 2 ** 20       # H100 L2 cache
# the selective scan (Mamba-1): falcon-mamba-7b's training shape (B, S,
# d_inner, N); the H100 SXM's SFU rate (16 exp2 a clock on each of 132
# SMs at 1.98 GHz) and fp32 rate (67 TFLOP/s: 33.5 T instructions a
# second, an FMA one); fp32 operations a state and position need: the
# forward's decay argument, the update's product and FMA and y's FMA
# (4); the backward's decay argument, g, a g, the state again (2), the
# delta, u and A terms (8) and dB, dC (2): 15
SCAN_SHAPE = (1, 2048, 8192, 16)
SCAN_CHUNK = 256
# the scan's counts in `ops.launch_counts`
SCAN_COUNTS = ("selective_scan", "selective_scan_backward")
SFU_PER_S = 132 * 16 * 1.98e9
FP32_INSTR_PER_S = 33.5e12
SCAN_FP32_OPS = (4, 15)
# kernel against the plain version: time order against a doubling scan,
# 2048 positions (the card test holds 1e-5 at 300)
SCAN_RTOL = 1e-4
# the simulator phase: `tests/data/seed_metrics.json`'s configuration (as
# `tests/test_engine.py` runs it), quickstart's part 1 (KGE, 8 nodes,
# scale 0.5) and `benchmarks/scale_sweep.py`'s 1e6-key ZIPF AdaPM row,
# held to that row of `BENCH_scale.json`
ROOT = Path(__file__).resolve().parent
SEED_METRICS = ROOT / "tests" / "data" / "seed_metrics.json"
SCALE_ROWS = ROOT / "BENCH_scale.json"
ZIPF_KEYS = 1_000_000
# the remat phase: zamba2-1.2b in full at 8 x 64 (the scan's autograd
# function and the shared attention inside one unit) and qwen3-moe-30b-a3b
# with 4 of 48 layers (the experts recomputed), fused arm, 6 steps each
# with remat off, "full" and "dots", built with `make_train_step`
REMAT_ARCHS = (HYBRID_ARCH, MOE_ARCH)
REMAT_SETTINGS = ((False, "full"), (True, "full"), (True, "dots"))
REMAT_STEPS, REMAT_CACHE, REMAT_RTOL = 6, 1024, 1e-6
# a step's peak device memory as the dry run's tracker predicts it (plain
# fake tensors, `launch.dryrun.trace_step`) against the card's allocator
# (`max_memory_allocated` over the steps alone): within this share of the
# measured peak (phases 10 and 11); the card's runs so far came within
# 0.5 % (PERF.md), the allocator's rounding and cuBLAS's workspace,
# there at the reset, making up the rest
PEAK_RTOL = 0.02
# the long_500k phase: configs/shapes.py's long_500k (one sequence, a
# cache of 524288 positions) decoded by the full falcon-mamba-7b (64
# layers, 29.1 GB of fp32 weights, an O(1) state) and zamba2-1.2b (38
# layers, 4.7 GB of weights, and 7 KV caches of 524288 x 32 x 64 fp32 for
# k and for v: 60.13 GB); the cache holds seeded normals (no prefill)
# with len LONG_CONTEXT - LONG_STEPS - 1: one checked step, then
# LONG_STEPS timed ones fill it to its end
LONG_DECODE = (SSM_ARCH, HYBRID_ARCH)
LONG_STEPS = 20
LONG_EARLY = 95               # the other position of the Mamba-1 check
LONG_HEADS = 4                # heads held to a float64 attention
LONG_RTOL, LONG_ATOL = 1e-4, 1e-5
# the dry-run phase (host only, in worker processes): one architecture per
# family through every shape on the 16 x 16 mesh (the full sweep of all
# ten takes longer than this phase may: PERF.md has its numbers, from
# the CLI), and one combination on the 2 x 16 x 16 mesh
DRYRUN_ARCHS = ("smollm-135m", "mixtral-8x22b", "qwen2-vl-7b",
                ENCDEC_ARCH, SSM_ARCH, HYBRID_ARCH)
DRYRUN_MULTI_POD = (SSM_ARCH, "long_500k")
# the reference's hill-climb rungs of the paper's technique
# (benchmarks/hillclimb.py), train_4k on the 16 x 16 mesh, beside the
# sweep: it3 (vocab-sharded embed/head, vocab-parallel loss), it4 (it3
# and the intent-managed embedding), it6 (it4 and auto ZeRO layers), it5
# (it6 and "dots" remat), each rung one CLI run of its architectures
_IT3 = ["--no-zero-embed-head", "--vp-loss"]
_IT4 = _IT3 + ["--pm-miss-capacity", "8192"]
_IT6 = _IT4 + ["--auto-zero-layers"]
DRYRUN_RUNGS = (
    ("it3", ("nemotron-4-15b", "qwen3-moe-30b-a3b"), _IT3),
    ("it4", ("nemotron-4-15b", "qwen3-moe-30b-a3b"), _IT4),
    ("it6", ("nemotron-4-15b", "qwen3-moe-30b-a3b"), _IT6),
    ("it5", ("nemotron-4-15b",), _IT6 + ["--remat-policy", "dots"]))


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
    the card (`ref.index_add_in_order`).  Returns the largest
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


def time_training_kernels(table, n=N_ROWS, scatter=SMOLLM,
                          seed: int = SEED) -> dict:
    """Kernel, plain version and library composition at the training
    step's shapes: the AdaGrad update of n = 512 unique rows of the full
    table (in place, with an fp32 accumulator of the table's size) and
    the scatter of 512 rows into a (rows + 1, D) buffer, ``scatter`` =
    (rows, D) (smollm-135m's (49153, 576) gradient buffer by default).  Ids hold no pads, so the library calls take them too.  The
    update cycles through enough id sets that the table and accumulator
    rows they touch exceed twice the L2 cache, so each call reads its
    rows from HBM as a training step's fresh ids do (the gradient rows,
    just written by the step, stay one set)."""
    import torch
    from repro_torch.kernels.adagrad_rows import adagrad_row_update
    from repro_torch.kernels.ref import (adagrad_row_update_ref,
                                         scatter_rows_ref)
    from repro_torch.kernels.scatter_rows import scatter_rows
    dev = table.device
    V, D = table.shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 4)
    row_bytes = 2 * D * table.element_size()         # table + accum row
    k = max(2, -(-2 * L2_BYTES // (n * row_bytes)))
    sets = [torch.randperm(V, generator=g, device=dev)[:n].to(torch.int32)
            for _ in range(k)]
    cyc = itertools.cycle([(i, i.long()) for i in sets])
    grads = torch.randn((n, D), generator=g, device=dev)
    accum = torch.rand((V, D), generator=g, device=dev)
    lr, eps = 0.01, 1e-8

    def library_adagrad():
        _, idl = next(cyc)
        a = accum.index_select(0, idl) + grads * grads
        p = table.index_select(0, idl) - lr * grads / (torch.sqrt(a) + eps)
        accum.index_copy_(0, idl, a)
        table.index_copy_(0, idl, p)

    def adagrad():
        return adagrad_row_update(table, accum, next(cyc)[0], grads, lr=lr,
                                  eps=eps)

    Vs, Ds = scatter
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
                table, accum, next(cyc)[0], grads, lr=lr, eps=eps)),
            "library_ms": median_ms(library_adagrad),
            "bound_ms": (5 * n * D * 4 + 4 * n) / HBM_BYTES_PER_S * 1e3,
            "id_sets": k,
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
def time_at_moe_shapes(dev, seed: int = SEED) -> dict:
    """The four kernels of qwen3-moe-30b-a3b's training path, timed as
    above, at its shapes: its untied (151936, 2048) fp32 embedding, one
    8 x 64 step's 512 tokens, the smoke's 1024-row replica cache.
    `embed_gather` reads 512 rows of the table (the miss buffer holds at
    most the batch's tokens; one id set, 4 MiB, so the L2 serves repeats;
    ``embed_gather_hbm`` rotates id sets past twice the L2 instead),
    `pm_combine` combines the 512 tokens from the cache and a 512-row
    miss buffer, `adagrad_rows` updates 512 rows of the table and its
    accumulator, and `scatter_rows` writes 512 rows into the (1025, 2048)
    cache, as the delta refresh does."""
    import torch
    V, D = MOE_TABLE
    C = TRAIN_KNOBS["cache_capacity"]
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 8)
    table = torch.empty((V, D), device=dev).normal_(generator=g)
    out = time_kernels(table, n=N_ROWS, T=N_ROWS, C=C, M=N_ROWS)
    out.update(time_training_kernels(table, scatter=(C, D)))
    out["embed_gather_hbm"] = gather_at_sizes(table, [N_ROWS])[N_ROWS]
    del table
    free_card()
    return out


def scan_work(shape=SCAN_SHAPE) -> dict:
    """What the selective scan's forward and backward need at ``shape``
    (B, S, d_inner, N), counted from the shapes: the bytes each reads and
    writes once (forward: u, delta, B, C, A, D in, y, h_last and the
    saved chunk states out; backward: those inputs, the chunk states, dy
    and dh_last in, every gradient out), one ``expf`` per state and
    position, and `SCAN_FP32_OPS` fp32 operations per state and position
    (an FMA counts one)."""
    B, S, di, N = shape
    states = B * di * N
    chunks = -(-S // SCAN_CHUNK)
    seq, rows, params = B * S * di, B * S * N, di * N + di
    fwd_bytes = 4 * (3 * seq + 2 * rows + params + states * (chunks + 1))
    bwd_bytes = 4 * (5 * seq + 4 * rows + 2 * params
                     + states * (chunks + 2))
    n = B * S * di * N
    return {"bytes": (fwd_bytes, bwd_bytes), "expf": n,
            "fp32_ops": tuple(k * n for k in SCAN_FP32_OPS)}


def scan_bound_ms(nbytes: int, expf: int, ops: int) -> dict:
    """The least time for that work: the larger of the bytes at the HBM
    rate, the ``expf`` at the SFU rate and the operations at the fp32
    rate, and which of them sets it."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "expf": expf / SFU_PER_S * 1e3,
             "fp32": ops / FP32_INSTR_PER_S * 1e3}
    by = max(parts, key=parts.get)
    return {"bound_ms": parts[by], "bound_by": by, "bound_parts_ms": parts}


def scan_operands(dev, shape=SCAN_SHAPE, seed: int = SEED):
    """Seeded operands of the scan at ``shape``, in the range the model
    gives them: delta = softplus(x - 4.6) (the init's dt bias), A = -(1 ..
    N) (the init's ``-exp(A_log)``), D = 1."""
    import torch
    import torch.nn.functional as F
    B, S, di, N = shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 9)
    u = torch.randn((B, S, di), generator=g, device=dev)
    delta = F.softplus(torch.randn((B, S, di), generator=g, device=dev)
                       - 4.6)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=dev).expand(di, N).contiguous()
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev)
              for _ in range(2))
    return u, delta, A, Bm, Cm, torch.ones((di,), device=dev)


def time_selective_scan(dev, shape=SCAN_SHAPE) -> dict:
    """The selective scan's forward and backward kernels against the plain
    version (`selective_scan_ref`) on the same operands at falcon-mamba-7b's
    training shape: the largest difference of y, h_last and the six
    gradients over the plain version's largest magnitude (raises past
    SCAN_RTOL), each kernel's time (median of CUDA-event runs; the
    backward as one `torch.autograd.grad` of y, which also runs its
    second pass) beside its bound (`scan_bound_ms`), and the plain
    version's times."""
    import torch
    from repro_torch.kernels.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan import selective_scan
    xs = [t.requires_grad_(True) for t in scan_operands(dev, shape)]
    dy = torch.randn(xs[0].shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    work = scan_work(shape)
    out, results = {"shape": list(shape)}, {}
    for name, fn, samples, reps in (
            ("kernel", selective_scan, TIMING_SAMPLES, TIMING_REPS),
            ("plain", selective_scan_ref, 5, 1)):
        y, h_last = fn(*xs)
        grads = torch.autograd.grad(y, xs, dy, retain_graph=True)
        results[name] = [y.detach(), h_last.detach(), *grads]
        with torch.no_grad():
            fwd = median_ms(lambda: fn(*xs), samples, reps)
        bwd = median_ms(lambda: torch.autograd.grad(
            y, xs, dy, retain_graph=True), samples, reps)
        del y, h_last, grads
        out[name] = {"forward_ms": fwd, "backward_ms": bwd}
    err = max(float((k - p).abs().max() / p.abs().max())
              for k, p in zip(results["kernel"], results["plain"]))
    if not err <= SCAN_RTOL:
        raise AssertionError(f"selective_scan: kernel against plain, "
                             f"relative error {err!r} > {SCAN_RTOL}")
    out["max_rel_err"] = err
    for i, part in enumerate(("forward", "backward")):
        out[part] = dict(ms=out["kernel"][f"{part}_ms"],
                         plain_ms=out["plain"][f"{part}_ms"],
                         **scan_bound_ms(work["bytes"][i], work["expf"],
                                         work["fp32_ops"][i]))
    del results, xs
    free_card()
    return out


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
    """The published config, cut to the depth in TRAIN_LAYERS."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[arch])
    return cfg


def train_batch(arch: str) -> int:
    return TRAIN_BATCH.get(arch, TRAIN_B)


def loop_config(arch: str, kernel: bool, steps: int = TRAIN_STEPS,
                collective: str = "emulated"):
    from repro_torch.train.loop import LoopConfig
    return LoopConfig(steps=steps, batch=train_batch(arch), seq=TRAIN_S,
                      lr=TRAIN_LR[arch], kernel=kernel, log_every=0,
                      seed=SEED, collective=collective, **TRAIN_KNOBS)


@contextlib.contextmanager
def image_positions():
    """The training loader's M-RoPE batches with distinct t, h and w
    coordinates, as Qwen2-VL numbers an image: `make_batch` places the
    image rows at 0 .. n - 1 and gives all three coordinates the token's
    index; here those rows are an IMG_GRID-wide grid (t 0, h the row, w
    the column) and the text after the image continues from the grid's
    largest coordinate plus one.  The loader's random draws are unchanged
    (the positions are not drawn)."""
    import torch
    from repro_torch.data import pipeline
    make = pipeline.make_batch

    def with_grid(cfg, B, S, rng, device=None):
        batch = make(cfg, B, S, rng, device)
        if cfg.mrope and "img_pos" in batch:
            n = batch["img_pos"].shape[1]
            if not torch.equal(batch["img_pos"].cpu(),
                               torch.arange(n).expand(B, n)):
                raise AssertionError("image rows are not at 0 .. n - 1")
            i = torch.arange(n)
            grid = torch.stack([torch.zeros_like(i), i // IMG_GRID,
                                i % IMG_GRID], dim=-1)
            text = (torch.arange(S - n) + int(grid.max()) + 1)[:, None]
            pos = torch.cat([grid, text.expand(S - n, 3)])
            batch["positions"] = pos.to(torch.int32).expand(B, S, 3) \
                .contiguous().to(batch["positions"].device)
        return batch

    pipeline.make_batch = with_grid
    try:
        yield
    finally:
        pipeline.make_batch = make


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train(arch: str, kernel: bool, collective: str = "emulated") -> dict:
    """One training run (seeded random init on the card); checks finite
    losses and no overflow, and with ``kernel`` which kernels ran: the
    fused arm (untied) updates rows with `adagrad_rows`, its delta
    refresh writes the cache with `scatter_rows`, and it never runs the
    lookup's backward; the tied arm writes the lookup's gradient with
    `segment_scatter_rows` and runs neither the row update nor the delta
    refresh; both gather and combine through the forward kernels.  On the
    mesh (``collective="mesh"``, in a started process group) the routing
    packs and writes rows with `scatter_rows` on both arms.  A Mamba-1
    model launches the selective scan's forward and backward on both
    arms (the scan has no plain switch on the card: ``kernel=False``
    takes the plain versions of the row kernels alone), every other
    model neither.  Also returns the steady step time (host clock between
    the first and the last loss read)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train_loop
    free_card()
    cfg = train_config(arch)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    bus = loss_clock()
    t0 = time.perf_counter()
    with image_positions():
        res = train_loop(cfg, loop_config(arch, kernel,
                                          collective=collective),
                         telemetry=bus)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if len(res.losses) != TRAIN_STEPS or not np.all(np.isfinite(res.losses)):
        raise AssertionError(f"{arch}: losses {res.losses}")
    if res.overflows != 0:
        raise AssertionError(f"{arch}: {res.overflows} overflow steps")
    rows = {n: c for n, c in launches.items() if n not in SCAN_COUNTS}
    for name in SCAN_COUNTS:
        if (launches[name] > 0) != is_mamba1(cfg):
            raise AssertionError(f"{arch}: {name} launched "
                                 f"{launches[name]} times")
    if kernel:
        if cfg.tie_embeddings and collective == "mesh":
            want = ("segment_scatter_rows", "scatter_rows")
            never = ("adagrad_rows",)
        elif cfg.tie_embeddings:
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
    elif any(rows.values()):
        raise AssertionError(f"{arch}: plain run launched {launches}")
    return {"arch": arch, "n_layers": cfg.n_layers,
            "batch": [train_batch(arch), TRAIN_S],
            "tied": cfg.tie_embeddings, "kernel": kernel,
            "collective": collective,
            "steps": len(res.losses), "losses": res.losses,
            "plans": res.plans, "refreshes": res.refreshes,
            "overflows": res.overflows, "recompiles": res.recompiles,
            "launches": launches, "wall_s": wall, "step_ms": step_ms(bus),
            "peak_alloc_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def is_mamba1(cfg) -> bool:
    return cfg.family == "ssm" and cfg.ssm_version == 1


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
    with image_positions():
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
    name, the host time per loop phase and peak memory.  The profiler
    records device activity only (the host's time comes from the spans),
    which keeps the processing of a trace of many eager calls short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.obs.trace import make_tracer
    from repro_torch.train.loop import train_loop
    cfg = train_config(arch)
    dev = torch.device("cuda")
    steps = PROFILE_STEPS_OF.get(arch, steps)
    res, bus, wall = train_untraced(arch, steps)
    ms = step_ms(bus)
    latency_ms = statistics.median(bus.latency("train.step_ms").values())
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    tracer = make_tracer(True)
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with image_positions():
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
    tokens = train_batch(arch) * TRAIN_S
    return {"arch": arch, "n_layers": cfg.n_layers, "steps": steps,
            "tokens_per_step": tokens,
            "untraced_wall_s": wall, "step_ms": ms,
            "tokens_per_s": tokens / (ms / 1e3),
            "median_step_latency_ms": latency_ms,
            "final_loss": res.losses[-1],
            "traced_wall_s": traced, "device_busy_ms": busy_ms,
            "device_busy_share_traced": busy_ms / (traced * 1e3),
            "top_device_ms": dict(sorted(by_kernel.items(),
                                         key=lambda kv: -kv[1])[:8]),
            "host_span_ms": host_ms,
            "peak_alloc_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def decode_model(arch: str, n_layers, dev):
    """The published config (cut to ``n_layers`` where given) and a model
    with seeded random weights on ``dev``."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import init_model
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return cfg, init_model(cfg, gen)


def fresh_cache(cfg, B: int, max_seq: int, dev, enc_out=None):
    """An empty decode cache on ``dev``; an encoder-decoder model's takes
    ``enc_out`` (the encoder's output over the batch's frames)."""
    from repro_torch.models.model import init_cache
    cache = init_cache(cfg, B, max_seq, device=dev)
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return cache


def greedy_decode(model, cfg, prompt, steps: int, routes=None,
                  enc_out=None):
    """A fused prefill of ``prompt`` (B, P) into a fresh cache (with
    ``enc_out`` for an encoder-decoder model), then ``steps`` greedy
    one-token steps (`make_prefill_decode_step`, `make_serve_step`).
    Returns the logits (steps + 1, B, V) — the prefill's last
    position's, then each step's — the (B, P + steps) tokens the model
    consumed, and the prefill's and the steps' host seconds (each ended
    by a synchronise).  ``routes``: a list that collects each MoE layer's
    `Routing`, chunk by chunk."""
    import torch
    from repro_torch.train.steps import (make_prefill_decode_step,
                                         make_serve_step)
    B, P = prompt.shape
    prefill, serve = make_prefill_decode_step(cfg), make_serve_step(cfg)
    cache = fresh_cache(cfg, B, P + steps, prompt.device, enc_out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(model, cache, prompt, routes=routes)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, toks = [lg], [prompt]
    for _ in range(steps):
        tok = lg.argmax(dim=-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        lg, cache = serve(model, cache, tok, routes=routes)
        logits.append(lg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.stack(logits), torch.cat(toks, dim=1), t1 - t0, t2 - t1


def route_table(routes, n_layers: int, B: int):
    """Per layer, the top-k experts (L, B, S, K) and whether every
    assignment was kept (L, B, S), at each position of each sequence,
    from `Routing` records collected chunk by chunk (L per forward; a
    chunk's tokens are batch-major)."""
    import torch
    chunks = [routes[i:i + n_layers]
              for i in range(0, len(routes), n_layers)]
    K = routes[0].topk_idx.shape[1]
    topk = torch.stack([torch.cat([c[l].topk_idx.reshape(B, -1, K)
                                   for c in chunks], dim=1)
                        for l in range(n_layers)])
    kept = torch.stack([torch.cat([c[l].keep.reshape(B, -1, K).all(dim=-1)
                                   for c in chunks], dim=1)
                        for l in range(n_layers)])
    return topk, kept


def comparable(a, b):
    """(B, S) bool: the positions whose logits two paths must agree on —
    where, at that position and every earlier one of its sequence (which
    its attention reads), no layer of either path dropped an assignment
    and both chose the same top-k experts.  ``a``, ``b``: `route_table`s
    (None for a model without experts)."""
    if a is None:
        return None
    ok = (a[1] & b[1] & (a[0] == b[0]).all(dim=-1)).all(dim=0)
    return ok.int().cumprod(dim=1).bool()


def decode_checks(model, cfg, prompt, frames=None, enc_out=None) -> dict:
    """The decode path against two others on the same weights, within
    DECODE_TOL: the fused prefill's last logits against a token-by-token
    prefill (P one-token steps), and the prefill's and the 32 steps'
    logits against one teacher-forced forward over the consumed tokens.
    With experts, a prompt chunk routes through expert capacity at once,
    unlike the token loop, so each comparison keeps the positions
    `comparable` finds and reports how many it left out.  An
    encoder-decoder model's caches take ``enc_out``, and its
    teacher-forced forward runs the encoder over ``frames`` itself."""
    import torch
    from repro_torch.train.steps import make_serve_step
    B, P = prompt.shape
    L = cfg.n_layers
    moe = bool(cfg.n_experts)
    r_dec = [] if moe else None
    logits, toks, _, _ = greedy_decode(model, cfg, prompt, DECODE_STEPS,
                                       r_dec, enc_out)
    if tuple(logits.shape) != (DECODE_STEPS + 1, B, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.arch_id}: decode logits "
                             f"{tuple(logits.shape)} not finite or misshapen")
    # token-by-token prefill
    r_loop = [] if moe else None
    serve = make_serve_step(cfg)
    cache = fresh_cache(cfg, B, P, prompt.device, enc_out)
    for t in range(P):
        lg_loop, cache = serve(model, cache, prompt[:, t:t + 1], r_loop)
    # teacher forcing over the consumed tokens
    r_tf = [] if moe else None
    forced = {"tokens": toks}
    if frames is not None:
        forced["frames"] = frames
    with torch.no_grad():
        tf, _, _ = model(forced, routes=r_tf)
    tf = tf[:, P - 1:].transpose(0, 1)               # (steps + 1, B, V)
    if moe:
        dec = route_table(r_dec, L, B)         # the prefill, then the steps
        loop, forced = route_table(r_loop, L, B), route_table(r_tf, L, B)
        keep_a = comparable((dec[0][:, :, :P], dec[1][:, :, :P]),
                            loop)[:, P - 1]
        keep_b = comparable(dec, forced)[:, P - 1:].T
    else:
        keep_a = torch.ones(B, dtype=torch.bool, device=prompt.device)
        keep_b = torch.ones((DECODE_STEPS + 1, B), dtype=torch.bool,
                            device=prompt.device)
    out = {}
    for name, got, want, keep in (
            ("prefill_vs_token_loop", logits[0], lg_loop, keep_a),
            ("decode_vs_teacher_forced", logits, tf, keep_b)):
        diff = (got - want).abs()
        bad = (diff > DECODE_TOL + DECODE_TOL * want.abs()).any(dim=-1) \
            & keep
        if bool(bad.any()) or not bool(keep.any()):
            raise AssertionError(
                f"{cfg.arch_id}: {name}: {int(bad.sum())} positions beyond "
                f"{DECODE_TOL}, {int(keep.sum())} compared")
        out[name] = {"positions_compared": int(keep.sum()),
                     "positions_left_out": int((~keep).sum()),
                     "max_abs_diff": float(diff[keep].max())}
    if moe:
        out["dropped_assignments"] = {
            "prefill": int((~dec[1][:, :, :P]).sum()),
            "steps": int((~dec[1][:, :, P:]).sum()),
            "token_loop": int((~loop[1]).sum()),
            "teacher_forced": int((~forced[1]).sum())}
        if out["dropped_assignments"]["steps"] or \
                out["dropped_assignments"]["token_loop"]:
            raise AssertionError(f"{cfg.arch_id}: a one-token step dropped")
    return out


def decode(arch: str, n_layers, dev) -> dict:
    """Decoding of one model (seeded random weights on the card, a seeded
    random prompt of DECODE_B x DECODE_PROMPT tokens; an encoder-decoder
    model's frames drawn as the training loader draws them, and its
    encoder run once over them first): `decode_checks`, then a timed run
    of the same prefill and DECODE_STEPS greedy steps, and the decode
    state's bytes for a cache of the run's length and of LONG_CONTEXT
    positions (the ssm family's must be the same).  The decode path
    launches none of the kernels (its embedding is a plain index, as the
    reference's ``jnp.take``) but Mamba-1's scan forward, in the fused
    prefill."""
    import torch
    from repro_torch.data.batches import make_batch
    from repro_torch.kernels import ops
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model = decode_model(arch, n_layers, dev)
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(DECODE_B, DECODE_PROMPT)).astype(np.int32)
    ).to(dev)
    ops.reset_launch_counts()
    frames = enc_out = None
    encode_ms = None
    if cfg.family == "encdec":
        frames = make_batch(cfg, DECODE_B, DECODE_PROMPT, rng,
                            dev)["frames"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            enc_out = model.encode(frames)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
    checks = decode_checks(model, cfg, prompt, frames, enc_out)
    _, _, prefill_s, steps_s = greedy_decode(model, cfg, prompt,
                                             DECODE_STEPS, enc_out=enc_out)
    launches = ops.launch_counts()
    scans = launches.pop("selective_scan")
    if any(launches.values()) or (scans > 0) != is_mamba1(cfg):
        raise AssertionError(f"{arch}: decoding launched {launches} and "
                             f"the scan {scans} times")
    state = {n: state_bytes(cfg, n)
             for n in (DECODE_PROMPT + DECODE_STEPS, LONG_CONTEXT)}
    if cfg.family == "ssm" and len(set(state.values())) != 1:
        raise AssertionError(f"{arch}: the recurrent state grows with the "
                             f"context: {state}")
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "batch": DECODE_B, "prompt": DECODE_PROMPT,
           "steps": DECODE_STEPS, "cache_positions":
               DECODE_PROMPT + DECODE_STEPS,
           "encode_ms": encode_ms, "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_token": steps_s * 1e3 / DECODE_STEPS,
           "decode_tokens_per_s": DECODE_B * DECODE_STEPS / steps_s,
           "prefill_tokens_per_s": DECODE_B * DECODE_PROMPT / prefill_s,
           "checks": checks, "state_bytes_by_max_seq": state,
           "peak_alloc_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del model
    free_card()
    return out


def state_bytes(cfg, max_seq: int) -> int:
    """The bytes of a DECODE_B-sequence decode cache for ``max_seq``
    positions (built on the meta device, so nothing is allocated)."""
    from repro_torch.models.model import init_cache
    cache = init_cache(cfg, DECODE_B, max_seq, device="meta")
    return sum(t.numel() * t.element_size() for name, t in cache.items()
               if name != "len")


def check_flash_attention(dev, S: int = FLASH_CHECK_S,
                          seed: int = SEED) -> dict:
    """`flash_attention` (causal, the default 512 x 1024 blocks) against
    `decode_attention` with ``cache_len = S`` (plain softmax over the
    whole prefix) on random q, k, v of nemotron-4-15b's heads (48 query
    heads, 8 KV heads of 128), within TRACE_RTOL / TRACE_ATOL."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import decode_attention, flash_attention
    cfg = get_config(LONG_ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 9)
    q = torch.randn((1, S, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev)
    k, v = (torch.randn((1, S, cfg.n_kv_heads, cfg.head_dim), generator=g,
                        device=dev) for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    want = decode_attention(q, k, v, S)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not torch.allclose(got, want, rtol=TRACE_RTOL, atol=TRACE_ATOL):
        raise AssertionError(f"flash_attention != decode_attention at S = "
                             f"{S}: max abs diff {err}")
    return {"S": S, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "max_abs_diff": err}


def long_prefill(dev) -> dict:
    """The 32k prefill: LONG_ARCH cut to LONG_LAYERS layers (seeded random
    weights) over one seeded random LONG_S-token prompt through
    `make_prefill_step(last_only=True)` (blocked attention, no cache),
    timed (host clock, synchronised) with its peak memory; then the same
    prompt prefilled into a KV cache in chunks of LONG_CHUNK
    (`make_prefill_decode_step`, `decode_attention` over the cached
    prefix), whose last logits must agree within DECODE_TOL."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.steps import (make_prefill_decode_step,
                                         make_prefill_step)
    free_card()
    cfg, model = decode_model(LONG_ARCH, LONG_LAYERS, dev)
    weights_gb = torch.cuda.memory_allocated(dev) / 1e9
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(1, LONG_S)).astype(np.int32)).to(dev)
    ops.reset_launch_counts()
    prefill = make_prefill_step(cfg, last_only=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = prefill(model, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    chunk = make_prefill_decode_step(cfg)
    cache = fresh_cache(cfg, 1, LONG_S, dev)
    t0 = time.perf_counter()
    for c0 in range(0, LONG_S, LONG_CHUNK):
        want, cache = chunk(model, cache, prompt[:, c0:c0 + LONG_CHUNK])
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    chunked_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the prefill launched {ops.launch_counts()}")
    if tuple(got.shape) != (1, cfg.vocab_size) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"32k prefill logits {tuple(got.shape)} not "
                             f"finite or misshapen")
    diff = (got - want).abs()
    if bool((diff > DECODE_TOL + DECODE_TOL * want.abs()).any()):
        raise AssertionError(f"32k prefill vs chunked cache prefill: max "
                             f"abs diff {float(diff.max())}")
    del model, cache
    free_card()
    return {"arch": LONG_ARCH, "n_layers": cfg.n_layers, "batch": 1,
            "tokens": LONG_S, "weights_gb": weights_gb,
            "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": LONG_S / prefill_s,
            "peak_alloc_gb": peak,
            "chunked": {"chunk": LONG_CHUNK, "ms": chunked_s * 1e3,
                        "peak_alloc_gb": chunked_peak},
            "last_logits_max_abs_diff": float(diff.max())}


@contextlib.contextmanager
def nccl_group(dev):
    """A one-rank NCCL process group on ``dev`` (NCCL takes one card per
    rank, and the smoke has one card); yields its mesh backend.  A failed
    NCCL start raises."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_group
    from repro_torch.pm.collectives import make_backend
    with tempfile.TemporaryDirectory() as tmp:
        init_group(0, 1, str(Path(tmp) / "init"), device=dev)
        try:
            yield make_backend("mesh", 1)
        finally:
            dist.destroy_process_group()


def nemotron_tokens(dev, seed: int = SEED):
    """One training batch of nemotron-4-15b's loader corpus (8 x 64
    tokens, Zipf over 256000 ids), flattened to (512,) int32."""
    import torch
    from repro_torch.data.pipeline import SyntheticCorpus
    tok = SyntheticCorpus(VOCAB, seed=seed).tokens((TRAIN_B, TRAIN_S))
    return torch.from_numpy(tok.reshape(-1).astype(np.int32)).to(dev)


def check_mesh_backend(be, table, seed: int = SEED) -> dict:
    """The mesh backend's routed methods against `EmulatedBackend(1)`,
    both through the kernels, on the full nemotron-4-15b table (256000 x
    6144 fp32): the routed gather of a 1024-slot miss buffer (1000
    ascending unique ids, pads zero), the table gradient of one loader
    batch (512 tokens; both sum each run of equal ids in sorted order, so
    the bits must agree), the AdaGrad update of its unique rows (table
    and accumulator, in place, bitwise) and the delta refresh of 200
    rows of a 1024-row cache.  Returns the largest differences (0.0) and
    the launches the mesh calls made."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.pm.collectives import EmulatedBackend, route_block
    dev = table.device
    V, D = table.shape
    emu = EmulatedBackend(1)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    err = {}
    launches = dict.fromkeys(ops.launch_counts(), 0)

    def mesh(fn, *a, **k):
        before = ops.launch_counts()
        out = fn(*a, **k)
        for name, c in ops.launch_counts().items():
            launches[name] += c - before[name]
        return out

    def same(name, got, want):
        torch.cuda.synchronize(dev)
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"mesh {name} != emulated")
        err[name] = max_abs_err(got, want)

    M, nv = 1024, 1000
    ids = torch.sort(torch.randperm(V, generator=g, device=dev)[:M])[0]
    ids = ids.to(torch.int32)
    cap = route_block(ids[:nv].cpu().numpy(), V, be.n_shards, M)
    got = mesh(be.gather_rows_routed, table, ids, nv, cap, kernel=True)
    want = emu.gather_rows(table, ids, kernel=True)
    want[nv:] = 0
    same("gather_rows_routed", got, want)
    tok = nemotron_tokens(dev, seed)
    T = tok.shape[0]
    grads = torch.randn((T, D), generator=g, device=dev)
    res = ops.sorted_slots(tok, T)
    got = mesh(be.scatter_row_grads, tok, grads, V, kernel=True,
               residual=res)
    want = emu.scatter_row_grads(tok, grads, V, kernel=True, residual=res)
    same("scatter_row_grads", got, want)
    del got, want
    free_card()
    seg_ids, seg_g = ops.segment_rows(tok, grads, n_slots=T, pad_id=V,
                                      residual=res)
    accum = torch.rand((V, D), generator=g, device=dev)
    t_m, a_m = table.clone(), accum.clone()
    mesh(be.update_rows, t_m, a_m, seg_ids, seg_g, lr=0.01, kernel=True)
    t_e = table.clone()
    emu.update_rows(t_e, accum, seg_ids, seg_g, lr=0.01, kernel=True)
    same("update_rows (table)", t_m, t_e)
    same("update_rows (accum)", a_m, accum)
    del a_m, accum
    free_card()
    C, n, k = 1024, 256, 200
    cache = torch.sort(torch.randperm(V, generator=g, device=dev)[:C])[0]
    cache = cache.to(torch.int32)
    pick = torch.sort(torch.randperm(C, generator=g, device=dev)[:k])[0]
    ids_h = torch.full((n,), V, dtype=torch.int32)
    ids_h[:k] = cache[pick].cpu()
    slots_h = torch.full((n,), C, dtype=torch.int32)
    slots_h[:k] = pick.cpu().to(torch.int32)
    stale = emu.refresh_rows(table, cache)
    got = mesh(be.refresh_rows_delta, t_m, stale.clone(), ids_h, slots_h,
               kernel=True)
    want = emu.refresh_rows_delta(t_e, stale.clone(), ids_h, slots_h,
                                  kernel=True)
    same("refresh_rows_delta", got, want)
    del t_m, t_e, got, want
    free_card()
    return {"max_abs_err": err, "launches": launches,
            "shapes": f"table ({V}, {D}) fp32; gather M={M} (n_valid "
                      f"{nv}); grads and update T={T}; delta {k} of {C}"}


MESH_SERVE = dict(n_shards=1, collective="mesh", model_shards=1)


@contextlib.contextmanager
def miss_routes():
    """Counts the serving lookups that moved misses through the mesh's
    routed gather (a block from the host) and through its replicated
    gather (wrapping `pm.embedding.combine_miss_buffer`)."""
    from repro_torch.pm import embedding
    combine = embedding.combine_miss_buffer
    counts = {"routed": 0, "replicated": 0}

    def counting(*a, n_miss=None, route_cap=0, **k):
        if n_miss:
            counts["routed" if route_cap > 0 else "replicated"] += 1
        return combine(*a, n_miss=n_miss, route_cap=route_cap, **k)

    embedding.combine_miss_buffer = counting
    try:
        yield counts
    finally:
        embedding.combine_miss_buffer = combine


def serve_mesh(table) -> tuple:
    """The serving runtime over the one-rank mesh, checked as `serve`
    checks (every served row bitwise ``table[keys]``, no zero row
    served), with the automatic knobs and with the constrained run's
    pinned knobs (a 512-row cache, depth 2: about a third of the tokens
    miss and take the routed gather, which the run must show); then ms
    per round of fresh untraced runs in turns, emulated (one shard),
    mesh, mesh, emulated, on both knob sets (the automatic knobs'
    wall-clock hill-climb may take the two runtimes down different knob
    paths); then profiles both on the pinned knobs (`profile`)."""
    runs = []
    for pinned in ({}, {"cache_capacity": 512, "pipeline_depth": 2}):
        with miss_routes() as routes:
            runs.append(dict(serve(table, **MESH_SERVE, **pinned),
                             miss_routes=routes))
    if runs[1]["miss_routes"]["routed"] <= 0:
        raise AssertionError("the constrained mesh run routed no miss")
    ms = {}
    for label, pinned in (("auto", {}),
                          ("constrained", {"cache_capacity": 512,
                                           "pipeline_depth": 2})):
        for name in ("emulated", "mesh", "mesh", "emulated"):
            knobs = MESH_SERVE if name == "mesh" else dict(n_shards=1)
            _, wall = serve_untraced(table, ROUNDS, **knobs, **pinned)
            ms.setdefault(f"{label} {name}", []).append(
                wall * 1e3 / ROUNDS)
    pinned = {"cache_capacity": 512, "pipeline_depth": 2}
    profiles = {name: profile(table, **knobs, **pinned)
                for name, knobs in (("emulated", dict(n_shards=1)),
                                    ("mesh", MESH_SERVE))}
    return runs, ms, profiles


# ------------------------------------------------------------ the simulator


def tiny_workload(n_nodes: int, wpn: int, n_batches: int, n_keys: int,
                  kpb: int, seed: int):
    """`tests/test_engine.py`'s seeded workload, on which
    `tests/data/seed_metrics.json` was recorded: per worker, batches of
    the distinct keys among ``kpb`` uniform draws."""
    from repro_torch.core.simulator import Workload
    rng = np.random.default_rng(seed)
    streams = [[[np.unique(rng.integers(0, n_keys, size=kpb))
                 for _ in range(n_batches)]
                for _ in range(wpn)]
               for _ in range(n_nodes)]
    return Workload("tiny", n_keys, streams)


def simulate_seed_metrics() -> dict:
    """The five baselines of `seed_metrics.json` through the port's
    simulator, held as `tests/test_engine.py` holds them: ints equal,
    floats within rel 1e-9."""
    from repro_torch.core.api import CostModel
    from repro_torch.core.baselines import (NuPSStatic,
                                            SelectiveReplicationSSP,
                                            StaticFullReplication,
                                            StaticPartitioning)
    from repro_torch.core.simulator import SimConfig, simulate
    want = json.loads(SEED_METRICS.read_text())
    wl = tiny_workload(n_nodes=4, wpn=2, n_batches=40, n_keys=800, kpb=8,
                       seed=7)
    cost = CostModel()
    policies = {
        "static_partitioning": lambda: StaticPartitioning(4, cost),
        "full_replication":
            lambda: StaticFullReplication(4, cost, wl.n_keys),
        "ssp20": lambda: SelectiveReplicationSSP(4, cost, 20),
        "essp": lambda: SelectiveReplicationSSP(4, cost, None),
        "nups": lambda: NuPSStatic(4, cost, wl.n_keys, wl.hot_keys(0.02),
                                   reloc_offset=32),
    }
    out = {}
    for name, mk in policies.items():
        m = simulate(mk(), wl, SimConfig(signal_offset=20))
        for key, ref in want[name].items():
            got = getattr(m, key)
            ok = got == ref if isinstance(ref, int) else \
                abs(got - ref) <= max(1e-9 * abs(ref), 1e-12)
            if not ok:
                raise AssertionError(f"seed metrics {name}.{key}: {got!r} "
                                     f"against {ref!r}")
        out[name] = {k: getattr(m, k) for k in want[name]}
    return out


def simulator() -> dict:
    """The seed metrics, then quickstart's part 1 and the 1e6-key ZIPF
    AdaPM row (its simulated metrics held to `BENCH_scale.json`'s), each
    with the host seconds it took.  The epoch times, speedups and bytes
    are `CostModel`'s outputs (simulated), not measurements."""
    from repro_torch.core.api import CostModel
    from repro_torch.core.manager import AdaPM
    from repro_torch.core.simulator import SimConfig, simulate
    from repro_torch.data.workloads import zipf_workload
    from repro_torch.examples import quickstart
    t0 = time.perf_counter()
    seed = simulate_seed_metrics()
    t1 = time.perf_counter()
    part1 = quickstart.part1_cluster_simulation()
    t2 = time.perf_counter()
    single = part1.pop("single_node")
    quick = {name: dict(m.as_dict(), speedup=single / m.epoch_time)
             for name, m in part1.items()}
    if not (quick["AdaPM"]["remote_frac"]
            < quick["Static partitioning"]["remote_frac"]):
        raise AssertionError(f"quickstart part 1: {quick}")
    wl = zipf_workload(n_nodes=4, wpn=2, n_batches=100, n_keys=ZIPF_KEYS,
                       batch_size=64)
    t3 = time.perf_counter()
    m = simulate(AdaPM(4, CostModel()), wl, SimConfig(signal_offset=100))
    t4 = time.perf_counter()
    want = next(r for r in json.loads(SCALE_ROWS.read_text())["results"]
                if r["n_keys"] == ZIPF_KEYS and r["variant"] == "AdaPM")
    got = m.as_dict()
    for key, v in got.items():
        if want[key] != v:
            raise AssertionError(f"ZIPF {ZIPF_KEYS} AdaPM {key}: {v!r} "
                                 f"against BENCH_scale.json's {want[key]!r}")
    return {"seed_metrics": seed, "seed_metrics_host_s": t1 - t0,
            "quickstart_part1_simulated": quick,
            "quickstart_part1_single_node_epoch_s_simulated": single,
            "quickstart_part1_host_s": t2 - t1,
            "zipf_1e6_adapm_simulated": got,
            "zipf_1e6_workload_host_s": t3 - t2,
            "zipf_1e6_simulate_host_s": t4 - t3}

# -------------------------------------------------------------- rematerialise


def remat_batches(cfg, dev, seed: int = SEED):
    """REMAT_STEPS batches of the training loader's Zipf corpus (8 x 64
    tokens, labels the next token), the REMAT_CACHE ids they hit most
    (sorted; the replica cache) and each batch's unique-miss count."""
    import torch
    from repro_torch.data.pipeline import SyntheticCorpus
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
    toks = [corpus.tokens((train_batch(cfg.arch_id), TRAIN_S + 1))
            for _ in range(REMAT_STEPS)]
    ids, counts = np.unique(np.concatenate(toks), return_counts=True)
    cache = np.sort(ids[np.argsort(-counts, kind="stable")[:REMAT_CACHE]])
    cache = np.pad(cache, (0, REMAT_CACHE - cache.size),
                   constant_values=cfg.vocab_size).astype(np.int32)
    batches = [{"tokens": torch.from_numpy(t[:, :-1].copy()).to(dev),
                "labels": torch.from_numpy(t[:, 1:].copy()).to(dev)}
               for t in toks]
    misses = [int(np.setdiff1d(t[:, :-1], cache).size) for t in toks]
    return batches, torch.from_numpy(cache).to(dev), misses


def predicted_peak(cfg, kind: str, B: int, S: int, **knobs) -> dict:
    """The dry run's tracker on plain fake tensors with fp32 weights
    (`launch.dryrun.trace_step`, host only): one device's bytes at the
    entry of ``kind``'s step (its arguments) and at its peak, for ``B``
    sequences of ``S`` tokens (decoding: one token each against an
    ``S``-position cache at its last position), with ``knobs`` (the
    fields of `launch.dryrun.Knobs`)."""
    import torch
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import Knobs, trace_step
    t = trace_step(cfg, InputShape(f"{kind}_{B}x{S}", S, B, kind), None,
                   Knobs(**knobs), distributed=False, dtype=torch.float32)
    return {"entry": t.entry_bytes, "peak": max(t.peak_per_phase.values()),
            "per_phase": t.peak_per_phase}


def held_peak(name: str, predicted: dict, resident: int,
              measured: int) -> dict:
    """The tracker's predicted peak against the card's measured one
    (``max_memory_allocated`` since a reset with the step's arguments,
    ``resident`` bytes, allocated): fails beyond PEAK_RTOL of the
    measured peak."""
    rel = (predicted["peak"] - measured) / measured
    out = {"predicted_peak_gb": predicted["peak"] / 1e9,
           "step_peak_gb": measured / 1e9, "rel_diff": rel,
           "predicted_entry_gb": predicted["entry"] / 1e9,
           "resident_gb": resident / 1e9,
           "predicted_per_phase_gb": {k: v / 1e9 for k, v in
                                      predicted["per_phase"].items()},
           "rtol": PEAK_RTOL}
    if abs(rel) > PEAK_RTOL:
        raise AssertionError(f"{name}: predicted peak {out}")
    return out


def remat_run(arch: str, remat: bool, policy: str, dev) -> dict:
    """REMAT_STEPS managed steps of ``arch`` (seeded random init, the
    fused arm through the kernels) from `make_train_step` with ``remat``
    and ``policy``; returns the losses, the steady step time (host clock
    between the first and the last loss read), the peak memory (of the
    run, and of the steps alone against the tracker's prediction,
    `held_peak`) and the kernel launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_model
    from repro_torch.pm.embedding import make_state
    from repro_torch.train.steps import make_opt_init, make_train_step
    free_card()
    cfg = train_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    batches, cache, misses = remat_batches(cfg, dev)
    T = batches[0]["tokens"].numel()
    # strict: with T miss slots no token overflows, as in the run
    predicted = predicted_peak(
        cfg, "train", train_batch(arch), TRAIN_S, pm_miss_capacity=T,
        pm_kernel=True, remat=remat, remat_policy=policy,
        pm_cache_rows=REMAT_CACHE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = init_model(cfg, gen)
    state = make_opt_init()(model)
    step = make_train_step(cfg, lr=TRAIN_LR[arch], pm_miss_capacity=T,
                           pm_kernel=True, remat=remat, remat_policy=policy)
    setup_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    ops.reset_launch_counts()
    losses, read_t = [], []
    for b, n_miss in zip(batches, misses):
        rows = make_state(model.embed.detach(), cache).cache_rows
        loss, model, state = step(model, state, dict(
            b, pm_cache_ids=cache, pm_cache_rows=rows, pm_n_miss=n_miss))
        losses.append(float(loss))
        read_t.append(time.perf_counter())
    launches = ops.launch_counts()
    step_peak = torch.cuda.max_memory_allocated(dev)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{arch} remat={remat} {policy}: {losses}")
    for name in ("embed_gather", "pm_combine", "adagrad_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"{arch}: {name} was not launched")
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "batch": [train_batch(arch), TRAIN_S], "remat": remat,
           "policy": policy if remat else None, "losses": losses,
           "step_ms": (read_t[-1] - read_t[0]) * 1e3 / (len(read_t) - 1),
           "peak_alloc_gb": max(setup_peak, step_peak) / 1e9,
           **held_peak(f"{arch} remat={remat} {policy}", predicted,
                       resident, step_peak),
           "launches": launches}
    del model, state
    return out


def rematerialise(arch: str, dev) -> list:
    """`remat_run` without remat, with "full" and with "dots": each
    trace within REMAT_RTOL of the first, the same kernel launches in
    all three, and (zamba2) a lower peak under "full"."""
    runs = [remat_run(arch, *s, dev) for s in REMAT_SETTINGS]
    base = runs[0]
    for r in runs:
        np.testing.assert_allclose(
            r["losses"], base["losses"], rtol=REMAT_RTOL, atol=0,
            err_msg=f"{arch}: remat {r['policy']} against none")
        r["max_abs_diff_vs_no_remat"] = float(np.max(np.abs(
            np.subtract(r["losses"], base["losses"]))))
        if r["launches"] != base["launches"]:
            raise AssertionError(f"{arch}: launches {r['launches']} under "
                                 f"remat {r['policy']}, {base['launches']} "
                                 f"without")
    if arch == HYBRID_ARCH and not \
            runs[1]["peak_alloc_gb"] < base["peak_alloc_gb"]:
        raise AssertionError(f"{arch}: peak {runs[1]['peak_alloc_gb']} GB "
                             f"under full remat, {base['peak_alloc_gb']} GB "
                             f"without")
    return runs


def long_cache(cfg, dev, length: int):
    """A one-sequence decode cache of LONG_CONTEXT positions on ``dev``,
    filled with seeded normals from a generator on the card (the conv
    ring and the KV caches at 0.5, ``h`` at 0.1), at ``len`` ``length``."""
    import torch
    from repro_torch.models.model import init_cache
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    cache = init_cache(cfg, 1, LONG_CONTEXT, device=dev)
    for name, t in cache.items():
        if name != "len":
            t.normal_(generator=gen).mul_(0.1 if name == "h" else 0.5)
    cache["len"] = length
    return cache


@contextlib.contextmanager
def first_attention():
    """Records the first application's decode attention of a step: the
    arguments and output of the first `layers.decode_attention` call, and
    the chunks the first two `layers.write_chunk` calls write (its k and
    its v)."""
    from repro_torch.models import layers
    seen = {"attention": [], "writes": []}
    attend, write = layers.decode_attention, layers.write_chunk

    def attend_(q, k, v, cache_len, **kw):
        out = attend(q, k, v, cache_len, **kw)
        if not seen["attention"]:
            seen["attention"].append((q, out, cache_len))
        return out

    def write_(cache, t, idx):
        write(cache, t, idx)
        if len(seen["writes"]) < 2:
            seen["writes"].append((cache, t.clone(), idx))

    layers.decode_attention, layers.write_chunk = attend_, write_
    try:
        yield seen
    finally:
        layers.decode_attention, layers.write_chunk = attend, write


def check_long_attention(cfg, seen) -> dict:
    """The hybrid's first application: its new k and v at their slot, bit
    for bit, and the new token's attention output for LONG_HEADS heads
    against a float64 recomputation over every cached position."""
    import torch
    (q, out, cache_len), = seen["attention"]
    (kc, k_new, idx), (vc, v_new, _) = seen["writes"]
    if idx != cache_len - 1 or not (torch.equal(kc[:, idx], k_new[:, 0])
                                    and torch.equal(vc[:, idx],
                                                    v_new[:, 0])):
        raise AssertionError(f"{cfg.arch_id}: slot {idx} does not hold the "
                             f"step's k and v")
    rep = cfg.n_heads // cfg.n_kv_heads
    heads = list(range(LONG_HEADS))
    kv = [h // rep for h in heads]
    k = kc[:, :cache_len, kv].double()
    v = vc[:, :cache_len, kv].double()
    s = torch.einsum("bqhd,bkhd->bhqk", q[:, :, heads].double(), k) \
        / float(cfg.head_dim) ** 0.5
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    got = out[:, :, heads].double()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LONG_RTOL, atol=LONG_ATOL):
        raise AssertionError(f"{cfg.arch_id}: attention over {cache_len} "
                             f"positions differs from float64 by {err}")
    return {"positions": int(cache_len), "heads": LONG_HEADS,
            "max_abs_diff_vs_float64": err, "rtol": LONG_RTOL,
            "atol": LONG_ATOL, "slot_holds_step_kv": idx}


def long_decode(arch: str, dev) -> dict:
    """`long_500k` on the card: the full ``arch`` (seeded fp32 weights)
    decoding one sequence against a LONG_CONTEXT-position cache of seeded
    normals (`long_cache`), from len LONG_CONTEXT - LONG_STEPS - 1: one
    checked step (falcon-mamba: the same step at len LONG_EARLY on the
    same state, bit for bit; zamba2: `check_long_attention`; both: finite
    logits), then LONG_STEPS greedy steps timed one by one (host clock,
    synchronised), which fill the cache to its end.  The bound is the
    bytes a token must read (every weight and the state, the KV caches
    included) over the HBM rate."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_serve_step
    free_card()
    predicted = predicted_peak(get_config(arch), "decode", 1, LONG_CONTEXT)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, model = decode_model(arch, None, dev)
    start = LONG_CONTEXT - LONG_STEPS - 1
    cache = long_cache(cfg, dev, start)
    serve = make_serve_step(cfg)
    ops.reset_launch_counts()
    tok = torch.tensor([[int(np.random.default_rng(SEED).integers(
        cfg.vocab_size))]], dtype=torch.int32, device=dev)
    checks = {}
    if cfg.family == "ssm":
        before = {n: cache[n].clone() for n in ("conv", "h")}
        lg, cache = serve(model, cache, tok)
        after = {n: cache[n].clone() for n in ("conv", "h")}
        for n in before:
            cache[n].copy_(before[n])
        cache["len"] = LONG_EARLY
        early, cache = serve(model, cache, tok)
        same = torch.equal(lg, early) and all(
            torch.equal(cache[n], after[n]) for n in after)
        if not same:
            raise AssertionError(f"{arch}: the step at len {start} differs "
                                 f"from the step at len {LONG_EARLY}: a "
                                 f"position enters the Mamba-1 step")
        for n in after:
            cache[n].copy_(after[n])
        cache["len"] = start + 1
        del before, after, early
        checks["positions_compared"] = [start, LONG_EARLY]
        checks["bitwise_equal"] = True
    else:
        with first_attention() as seen:
            lg, cache = serve(model, cache, tok)
        checks = check_long_attention(cfg, seen)
        del seen
    if not bool(torch.isfinite(lg).all()) or \
            tuple(lg.shape) != (1, cfg.vocab_size):
        raise AssertionError(f"{arch}: logits {tuple(lg.shape)} not finite")
    ms = []
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    for _ in range(LONG_STEPS):
        tok = lg.argmax(dim=-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = serve(model, cache, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_peak = torch.cuda.max_memory_allocated(dev)
    if cache["len"] != LONG_CONTEXT or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{arch}: len {cache['len']} after the steps")
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{arch}: decoding launched {launches}")
    weight_b = sum(p.numel() * p.element_size() for p in model.parameters())
    state_b = sum(t.numel() * t.element_size() for n, t in cache.items()
                  if n != "len")
    out = {"arch": arch, "n_layers": cfg.n_layers, "batch": 1,
           "cache_positions": LONG_CONTEXT, "first_len": start,
           "steps_timed": LONG_STEPS,
           "ms_per_token_median": statistics.median(ms),
           "ms_per_token_min": min(ms), "ms_per_token_max": max(ms),
           "weight_bytes": weight_b, "state_bytes": state_b,
           "bound_ms": (weight_b + state_b) / HBM_BYTES_PER_S * 1e3,
           "checks": checks,
           "peak_alloc_gb": max(setup_peak, step_peak) / 1e9,
           **held_peak(f"{arch} long_500k", predicted, resident, step_peak)}
    del model, cache, lg
    free_card()
    return out


def _dry_runs(runs: list, tmp: Path) -> list:
    """The dry-run CLI commands ``runs`` (each ending in ``--out FILE``),
    started together and awaited; the records of each.  A command that
    fails fails the phase with its log's end."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [tmp / f"dryrun_{i}.log" for i in range(len(runs))]
    procs = []
    try:
        for c, log in zip(runs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    c, env=env, cwd=ROOT, stdout=f,
                    stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for p, log, c in zip(procs, logs, runs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(c[2:])} exited {p.returncode}:\n"
                               f"{log.read_text()[-4000:]}")
        recs.append(json.loads(Path(c[-1]).read_text()))
    return recs


def dry_run(tmp: Path) -> dict:
    """The dry run (`repro_torch.launch.dryrun`) on the card's host, in
    worker processes of its own (its fake process group never meets the
    card's): DRYRUN_ARCHS through every shape on the 16 x 16 mesh,
    DRYRUN_MULTI_POD on the 2 x 16 x 16 mesh and the rungs of
    DRYRUN_RUNGS, all at the same time.  Any combination in error fails
    the phase.  Returns the records, the rungs' records (each with its
    ``rung``) and the counts."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    jobs = max(1, (os.cpu_count() or 2) - 1)
    arch, shape = DRYRUN_MULTI_POD
    runs = [cmd + ["--arch", arch, "--shape", shape, "--multi-pod",
                   "--out", str(tmp / "multi_pod.json")],
            cmd + ["--arch", *DRYRUN_ARCHS, "--jobs", str(jobs),
                   "--out", str(tmp / "single_pod.json")]]
    runs += [cmd + ["--arch", *archs, "--shape", "train_4k", *knobs,
                    "--jobs", str(len(archs)),
                    "--out", str(tmp / f"rung_{name}.json")]
             for name, archs, knobs in DRYRUN_RUNGS]
    out = _dry_runs(runs, tmp)
    recs = out[0] + out[1]
    rungs = [dict(r, rung=name) for (name, _, _), rs in
             zip(DRYRUN_RUNGS, out[2:]) for r in rs]
    counts = {k: sum(r["status"] == k for r in recs + rungs)
              for k in ("ok", "skipped", "error")}
    bad = [(r.get("rung"), r["arch"], r["shape"], r.get("error"))
           for r in recs + rungs if r["status"] == "error"
           or "rung" in r and r["status"] != "ok"]
    if bad:
        raise AssertionError(f"dry run: {counts}: {bad}")
    return {"records": recs, "rungs": rungs, "counts": counts}


def _memory_keys(rec) -> dict:
    """A dry-run record's per-device memory figures, for its line."""
    m = rec["memory"]
    return {"argument_bytes_per_device": m["argument_bytes"],
            "peak_bytes_per_device": m["peak_bytes"],
            "output_bytes_per_device": m["output_bytes"],
            "peak_per_phase": m["peak_per_phase"]}


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
    start = last = time.perf_counter()
    phase_s = {}

    def phase(name: str) -> None:
        """Notes the seconds since the last phase ended."""
        nonlocal last
        now = time.perf_counter()
        phase_s[name] = now - last
        last = now

    print(f"[1/13] device: {card} ({torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"[2/13] built {lib.relative_to(Path(__file__).resolve().parent)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    phase("build")

    table = make_table(dev)
    err, paths = check_kernels(table)
    err.update(check_training_kernels(table))
    seg = check_segment_scatter(dev)
    err["segment_scatter_rows"] = seg["max_abs_err"]
    print("[3/13] embed_gather paths " + json.dumps(paths), flush=True)
    print("[3/13] segment_scatter_rows " + json.dumps(seg), flush=True)
    times = time_kernels(table)
    times.update(time_training_kernels(table))
    times["segment_scatter_rows"] = time_segment_scatter(dev)
    print("[3/13] kernels == plain versions, bitwise: "
          + json.dumps({k: {"max_abs_err": err[k], **times[k]}
                        for k in err}), flush=True)
    print(f"[3/13] kernels at {MOE_ARCH}'s shapes " + json.dumps(
        dict(time_at_moe_shapes(dev), card=card)), flush=True)
    scan = time_selective_scan(dev)
    print("[3/13] selective_scan " + json.dumps(dict(scan, card=card)),
          flush=True)
    phase("kernels")

    runs = [serve(table),
            serve(table, cache_capacity=512, pipeline_depth=2)]
    for r in runs:
        print("[4/13] serve " + json.dumps(r), flush=True)
    sizes = sorted(set(serve_sizes(runs)) | {N_IDS})
    print("[4/13] embed_gather at the serving runs' sizes and n=4096, both "
          "paths " + json.dumps(gather_at_sizes(table, sizes)), flush=True)
    for knobs in ({}, {"cache_capacity": 512, "pipeline_depth": 2}):
        print("[4/13] profile " + json.dumps(profile(table, **knobs)),
              flush=True)
    del table
    free_card()
    phase("serve")

    print("[5/13] lookup backward launches " + json.dumps(
        backward_launches(dev)), flush=True)
    trains, other_trains = [], []
    for arch in ("nemotron-4-15b", "smollm-135m", MOE_ARCH) + FAMILY_ARCHS:
        ker, plain = train(arch, True), train(arch, False)
        np.testing.assert_allclose(ker["losses"], plain["losses"],
                                   rtol=TRACE_RTOL, atol=TRACE_ATOL,
                                   err_msg=f"{arch}: kernel vs plain trace")
        diff = float(np.max(np.abs(np.subtract(ker["losses"],
                                               plain["losses"]))))
        for r in (ker, plain):
            print("[5/13] train " + json.dumps(r), flush=True)
        print(f"[5/13] {arch}: kernel vs plain loss trace, max abs diff "
              f"{diff!r} (rtol {TRACE_RTOL}, atol {TRACE_ATOL})", flush=True)
        (trains if arch in ("nemotron-4-15b", "smollm-135m")
         else other_trains).append(ker)
        phase(f"train {arch}")
    for arch in ("nemotron-4-15b", "smollm-135m", MOE_ARCH) + FAMILY_ARCHS:
        print("[5/13] train profile " + json.dumps(
            dict(train_profile(arch), card=card)), flush=True)
        phase(f"train profile {arch}")

    for arch, layers in DECODE:
        print("[6/13] decode " + json.dumps(
            dict(decode(arch, layers, dev), card=card)), flush=True)
        phase(f"decode {arch}")

    print("[7/13] flash_attention == decode_attention " + json.dumps(
        dict(check_flash_attention(dev), card=card)), flush=True)
    print("[7/13] long prefill " + json.dumps(
        dict(long_prefill(dev), card=card)), flush=True)
    phase("long prefill")

    import torch.distributed as dist
    with nccl_group(dev) as be:
        print(f"[8/13] process group: backend {dist.get_backend()}, world "
              f"size {dist.get_world_size()}, {type(be).__name__} of "
              f"{be.n_shards} shard on {be.device} ({card})", flush=True)
        table = make_table(dev)
        mesh_err = check_mesh_backend(be, table)
        print("[8/13] mesh backend == emulated backend, bitwise: "
              + json.dumps(dict(mesh_err, card=card)), flush=True)
        serve_runs, serve_ms, serve_prof = serve_mesh(table)
        for r in serve_runs:
            print("[8/13] mesh serve " + json.dumps(dict(r, card=card)),
                  flush=True)
        print("[8/13] mesh serve ms per round in turns (emulated, mesh, mesh,"
              " emulated; 32 rounds, one shard) "
              + json.dumps(dict(serve_ms, card=card)), flush=True)
        for name, prof in serve_prof.items():
            print(f"[8/13] profile, {name}, one shard " + json.dumps(
                dict(prof, card=card)), flush=True)
        del table
        free_card()
        mesh_runs = list(serve_runs)
        for emu in trains:
            r = train(emu["arch"], True, collective="mesh")
            np.testing.assert_allclose(
                r["losses"], emu["losses"], rtol=TRACE_RTOL, atol=TRACE_ATOL,
                err_msg=f"{r['arch']}: mesh vs emulated trace")
            diff = float(np.max(np.abs(np.subtract(r["losses"],
                                                   emu["losses"]))))
            print("[8/13] mesh train " + json.dumps(dict(r, card=card)),
                  flush=True)
            print(f"[8/13] {r['arch']}: mesh vs emulated kernel loss trace, "
                  f"max abs diff {diff!r} (rtol {TRACE_RTOL}, atol "
                  f"{TRACE_ATOL}) ({card})", flush=True)
            mesh_runs.append(r)
    print("[8/13] mesh runs' launches " + json.dumps(
        {name: sum(r["launches"][name] for r in mesh_runs)
         for name in REPLACES}), flush=True)
    phase("mesh")

    print("[9/13] simulator (host; epoch times, speedups and bytes "
          "simulated by CostModel) " + json.dumps(
              dict(simulator(), card=card)), flush=True)
    phase("simulator")

    remat_runs = []
    for arch in REMAT_ARCHS:
        for r in rematerialise(arch, dev):
            print("[10/13] remat " + json.dumps(dict(r, card=card)),
                  flush=True)
            remat_runs.append(r)
        phase(f"remat {arch}")

    for arch in LONG_DECODE:
        print("[11/13] long_500k decode " + json.dumps(
            dict(long_decode(arch, dev), card=card)), flush=True)
        phase(f"long_500k {arch}")

    with tempfile.TemporaryDirectory() as tmp:
        dr = dry_run(Path(tmp))
    for r in dr["records"]:
        keep = {k: r.get(k) for k in ("arch", "shape", "mesh", "status",
                                      "reason", "n_devices", "flops",
                                      "collective_bytes", "trace_s")}
        if r["status"] == "ok":
            keep.update(_memory_keys(r))
            keep["collective_bytes_per_op"] = r["collective_bytes_per_op"]
        print("[12/13] dry run " + json.dumps(keep), flush=True)
    for r in dr["rungs"]:
        keep = {k: r.get(k) for k in (
            "rung", "arch", "shape", "mesh", "status", "pm_miss_capacity",
            "zero_embed_head", "vp_loss", "zero_layers",
            "zero_layers_effective", "remat_policy", "n_devices", "flops",
            "collective_bytes", "collective_bytes_per_op",
            "collective_bytes_per_phase", "trace_s")}
        keep.update(_memory_keys(r))
        print("[12/13] dry run rung " + json.dumps(keep), flush=True)
    print("[12/13] dry run (host, fake process groups of 256 and 512 ranks): "
          + json.dumps(dict(dr["counts"], archs=list(DRYRUN_ARCHS),
                            multi_pod=list(DRYRUN_MULTI_POD),
                            rungs=[[n, list(a)] for n, a, _ in
                                   DRYRUN_RUNGS])), flush=True)
    phase("dry run")

    kernels = []
    for name in REPLACES:
        launches = sum(r["launches"][name] for r in
                       runs + trains + other_trains + mesh_runs + remat_runs)
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
    # the selective scan replaces no TPU kernel: its rows name the
    # reference's plain scan; launches in the kernel training runs
    for part, name in zip(("forward", "backward"), SCAN_COUNTS):
        launches = sum(r["launches"][name] for r in trains + other_trains)
        if launches <= 0:
            raise AssertionError(f"selective_scan's {part} was not "
                                 f"launched on a main path")
        t = scan[part]
        kernels.append({
            "name": f"selective_scan.{part}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
            "replaces": None, "added_for": "src/repro/models/ssm.py:"
            "mamba1_block's plain scan", "launches": launches,
            "max_rel_err": scan["max_rel_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(f"[13/13] done in {time.perf_counter() - start:.1f} s; seconds per "
          f"phase " + json.dumps(phase_s))
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
