"""Cells at a size a CPU test holds: the configurations' and traffic's
own files with the sizes cut, the driver run on the CPU (the harness's
look for a chip skipped)."""

from __future__ import annotations

import time

import torch

from portbench import harness

SMALL = {
    "nemotron-4-15b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab_size=512),
    "falcon-mamba-7b": dict(n_layers=2, d_model=64, vocab_size=512),
}
TRAFFIC = {
    "train-zipf": dict(seq=32),
    "serve-zipf-open": dict(rate=400.0, warm_s=0.5, tail_s=0.5,
                            grace_s=10.0, check_requests=64),
    "serve-uniform-closed": dict(backlog=64, warm_s=0.5, grace_s=10.0,
                                 check_stride=7),
}
BATCH = {"nemotron-4-15b": 2, "falcon-mamba-7b": 1}
#: the training checks' limits at this size, set from CPU readings over
#: 12 seeds (sound runs at most loss 5.5e-7 over all 10 steps, grad
#: 3.7e-7, change 5.0e-5, rows_replan 5.8e-3: one element of one rare
#: row whose gradient lies near AdaGrad's eps, over 64 token rows) and 3
#: of the emulated TF32 control (at least 2.5e-5, 1.4e-4, 7.7e-4) and of
#: half a batch left out (rows_replan at least 0.62): small leaves move
#: under AdaGrad's first step by round-off more than the cells' do, so
#: the cells' own limits do not carry over
TRAIN_LIMITS = {"loss": 3e-6, "loss_late": 3e-6, "grad": 3e-5,
                "change": 2.5e-4, "rows_wrong": 0, "rows_replan": 0.05}


def cell(name: str) -> harness.Cell:
    c = harness.find_cell(name, harness.spec())
    c.config = dict(c.config, **SMALL[c.config["name"]])
    c.config["train"] = dict(c.config["train"],
                             batch=BATCH[c.config["name"]])
    c.traffic = dict(c.traffic, **TRAFFIC[c.traffic["name"]])
    c.limits = dict(c.limits)
    if c.traffic["kind"] == "train":
        c.limits = dict(TRAIN_LIMITS)
    if "rows_checked_min" in c.limits:      # fewer requests at this size
        c.limits["rows_checked_min"] = 32
    return c


def run(name: str, seed: int = 5, seconds: float = 0.5,
        trace: bool = False):
    """The cell's run on the CPU: (outcome, result line)."""
    r = harness.Run(cell(name), seed, seconds, trace, torch.device("cpu"),
                    time.perf_counter())
    return harness.execute(r)
