"""Training cells: `repro_torch.train.loop.train_loop` with the managed
embedding through the hand-written kernels, as users run it (the loop's
"auto" knobs), on the traffic's token stream.

The window opens at the loss read of step ``warm_steps - 1`` and closes
at the last loss read: the loop is told to stop dispatching once
``seconds`` have passed (and no sooner than the check's last step), and
the steps already dispatched are read in full.  ``train_tokens_per_s``
is the tokens of the steps read inside the window over its length.

The check follows the loop's first ``plan_every + 2`` steps, through its
first replan (at step ``plan_every``, counting from 0, where the cache
capacity is steered, the plan and the replica cache are made anew, and
the step may run at a new miss capacity) and one step past it: the same
call and feed as the window's, in set-up and on into the window.  The
loop's step functions are observed (not changed) to read each leaf's
first gradient from the AdaGrad state after step 0 (``a = g * g`` from
zeros) and each leaf's change after step ``CHANGE_AFTER - 1``, in set-up;
the step's managed lookup is observed to copy the rows it gathers at
step 0 and at the two steps from the replan on to the host.  Once the
window has closed, the peak memory read and the program's state freed,
the plain reference (`reference.steps.train`) runs the same steps from
the same seed, and `compare` holds the two.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.devtrace import DeviceTrace, clip
from portbench.generator import TokenStream
from portbench.harness import Outcome, Run, Window
from portbench.reference import steps as ref_steps
from portbench.work import model_flops

#: the step after which each leaf's change is compared (in set-up)
CHANGE_AFTER = 3


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in names})


def checked_steps(plan_every: int):
    """The steps the reference follows, and those whose lookup rows are
    compared: the first, the first replan's and the one after it."""
    return plan_every + 2, (0, plan_every, plan_every + 1)


class StepWatch:
    """Wraps the step functions the loop builds: counts the steps it
    dispatches and, after steps 0 and ``CHANGE_AFTER - 1``, reads the
    state the check compares; copies the rows the step's lookup gathers
    at the steps ``rows_at`` to the host (the state itself is left as the
    step made it)."""

    def __init__(self, config: dict, seed: int, rows_at, shape, device):
        self.config, self.seed = config, seed
        self.calls = 0
        self.first_grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        # host buffers made up front: a copy inside the window waits for
        # nothing but its own transfer
        pin = device.type == "cuda"
        self.rows = {k: torch.empty(shape + (config["d_model"],),
                                    pin_memory=pin) for k in rows_at}
        self.kept = set()

    def watch_lookup(self, lookup):
        """The step's managed lookup, its rows at ``rows_at`` kept."""
        def lookup_watched(*args, **kwargs):
            h = lookup(*args, **kwargs)
            k = self.calls
            if k in self.rows and k not in self.kept:
                self.rows[k].copy_(h.detach().reshape(self.rows[k].shape),
                                   non_blocking=True)
                self.kept.add(k)
            return h
        return lookup_watched

    def wrap(self, make):
        def make_watched(*args, **kwargs):
            fn = make(*args, **kwargs)

            def step(model, opt_state, batch):
                out = fn(model, opt_state, batch)
                self.calls += 1
                if self.calls == 1:
                    self.first_grad = {
                        k: math.sqrt(max(ref_steps.sum64(a), 0.0))
                        for k, a in opt_state.accum.items()}
                if self.calls == CHANGE_AFTER:
                    with torch.no_grad():
                        self.change = ref_steps.change_norms(
                            self.config, self.seed,
                            dict(model.named_parameters()))
                return out
            return step
        return make_watched

    def trace(self, losses) -> ref_steps.Trace:
        return ref_steps.Trace(list(losses), self.first_grad, self.change,
                               {k: v for k, v in self.rows.items()
                                if k in self.kept})


def gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| against the larger of |ref| and ``floor``."""
    return abs(prog - ref) / max(abs(ref), floor, 1e-30)


def rows_gap(prog: torch.Tensor, ref: torch.Tensor,
             init: torch.Tensor) -> Dict[str, float]:
    """How far the lookup's rows of a step lie from the reference's, as a
    share of how far the reference moved them from their initial values,
    in float64: ``whole``, over all the step's token rows together
    (``|prog - ref| / |ref - init|``), and ``worst_token``, the worst
    token's gap over the larger of its own move and the median token's.
    The first is compared: AdaGrad's first update of a row is about
    ``lr * sign(g)``, so an element whose gradient is near ``eps`` takes
    rounding of ``g`` to a visible share of the update, and a rare
    token's row can read a worst-token gap of some percent in a sound
    run."""
    D = ref.shape[-1]
    p, r, i = (x.reshape(-1, D).double() for x in (prog, ref, init))
    off = (p - r).norm(dim=1)
    moved = (r - i).norm(dim=1)
    floor = max(float(moved.median()), 1e-30)
    return {"whole": float(off.norm() / moved.norm().clamp_min(1e-30)),
            "worst_token": float((off / moved.clamp_min(floor)).max())}


def compare(prog: ref_steps.Trace, ref: ref_steps.Trace,
            init_rows: Dict[int, torch.Tensor],
            tokens: List[np.ndarray]) -> Dict[str, float]:
    """The numbers the check reads (a cell compares those its limits file
    names):

    * ``loss``: the worst loss gap of the steps before ``CHANGE_AFTER``;
      ``loss_late``: of the steps from it on, through the replan;
    * ``grad``, ``change``: by the worst leaf the gap of the first
      gradient's norm and of the change's norm, each against the
      reference's norm of that leaf or of the median leaf, whichever is
      larger.  Leaves whose reference gradient is under a thousandth of
      the median leaf's (nought to rounding) are left out of the change;
    * ``rows_wrong``: token rows of the kept steps' lookups that should
      be the initial table's (every token at step 0; at the replan's two
      steps, tokens no earlier step touched) and differ from the
      reference's, bit for bit;
    * ``rows_replan``: `rows_gap` (``whole``) of the lookup's rows at the
      first replan's step and the next, the worse of the two (the tables
      have taken that many updates on each side, so they agree to
      rounding, not bit for bit).

    A number the program gave nothing for reads inf (or every row)."""
    def worst(lo, hi):
        want = ref.losses[lo:hi]
        got = prog.losses[lo:hi] + [math.inf] * len(want)
        return max(gap(p, r, 0.0) for p, r in zip(got, want))
    out = {"loss": worst(0, CHANGE_AFTER),
           "loss_late": worst(CHANGE_AFTER, len(ref.losses))}
    med_g = float(np.median(list(ref.first.values())))
    out["grad"] = max(gap(prog.first.get(k, math.inf), v, med_g)
                      for k, v in ref.first.items())
    moving = [k for k, v in ref.first.items() if v >= 1e-3 * med_g]
    med_c = float(np.median([ref.change[k] for k in moving]))
    out["change"] = max(gap(prog.change.get(k, math.inf), ref.change[k],
                            med_c) for k in moving)
    out["rows_wrong"] = 0
    for k, want in sorted(ref.rows.items()):
        D = want.shape[-1]
        fresh = torch.from_numpy(~np.isin(
            tokens[k], np.concatenate([t.ravel() for t in tokens[:k]])
            if k else np.empty(0, tokens[k].dtype)).reshape(-1))
        fresh = fresh.to(want.device)
        got = prog.rows.get(k)
        if got is None:
            out["rows_wrong"] += int(fresh.sum())
            if k:
                out["rows_replan"] = math.inf
            continue
        got = got.to(want.device).reshape(-1, D)
        out["rows_wrong"] += int(((got != want.reshape(-1, D)).any(dim=1)
                                  & fresh).sum())
        if k:
            out["rows_replan"] = max(out.get("rows_replan", 0.0), rows_gap(
                got, want, init_rows[k])["whole"])
    return out


def run(r: Run) -> Outcome:
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.obs.trace import make_tracer
    from repro_torch.train import loop
    from repro_torch.train import steps as train_steps
    cell, config, traffic = r.cell, r.cell.config, r.cell.traffic
    dev = r.device
    cuda = dev.type == "cuda"
    B, S = config["train"]["batch"], traffic["seq"]
    lr = config["train"]["lr"]
    warm = traffic["warm_steps"]
    stream = TokenStream(config["vocab_size"], traffic["dist"],
                         traffic.get("zipf_a", 1.1), r.seed)
    lc = loop.LoopConfig(steps=1 << 40, batch=B, seq=S, lr=lr, pm=True,
                         kernel=True, collective="emulated", n_shards=1,
                         log_every=0, seed=r.seed, **traffic.get("loop", {}))
    n_check, rows_at = checked_steps(lc.plan_every)
    watch = StepWatch(config, r.seed, rows_at, (B, S), dev)
    reads: List[float] = []
    dtrace = DeviceTrace() if r.trace else None

    class Clock(Telemetry):
        """The loop's bus, noting the host clock at every loss read and
        ending the window."""

        def set(self, name, v, **labels):
            if name == "train.loss":
                now = time.perf_counter()
                reads.append(now)
                k = len(reads) - 1
                if dtrace is not None and k == warm - 2:
                    dtrace.start()
                if k >= warm - 1 and lc.steps > watch.calls and \
                        now - reads[warm - 1] >= r.seconds:
                    # dispatch no more steps than the check needs
                    lc.steps = max(watch.calls, n_check)
            super().set(name, v, **labels)

    tracer = make_tracer(True, capacity=1 << 20) if r.trace else None
    make, loader = loop.make_train_step, loop.IntentSignalingLoader
    lookup = train_steps.pm_lookup
    loop.make_train_step = watch.wrap(make)
    loop.IntentSignalingLoader = \
        lambda *a, **k: loader(*a, corpus=stream, **k)
    train_steps.pm_lookup = watch.watch_lookup(lookup)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        res = loop.train_loop(model_config(config), lc, telemetry=Clock(),
                              tracer=tracer, device=dev)
    finally:
        loop.make_train_step, loop.IntentSignalingLoader = make, loader
        train_steps.pm_lookup = lookup
    if cuda:
        torch.cuda.synchronize(dev)
    if dtrace is not None:
        dtrace.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    t_open, t_close = reads[warm - 1], reads[-1]
    window_steps = len(reads) - warm
    tokens = window_steps * B * S
    losses = res.losses
    failed = int(sum(not math.isfinite(x) for x in losses[warm:]))
    metrics = {"train_tokens_per_s": tokens / (t_close - t_open),
               "setup_s": t_open - r.t_start}

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batches = [(t, np.roll(t, -1, axis=1))
               for t in stream.handed[:n_check]]
    t_ref = time.perf_counter()
    ref, init_rows = ref_steps.train(config, r.seed, batches, lr, dev,
                                     change_after=CHANGE_AFTER,
                                     rows_at=rows_at)
    prog = watch.trace(losses[:n_check])
    nums = compare(prog, ref, init_rows, stream.handed[:n_check])
    checks = {k: (v, lim) for k, lim in r.cell.limits.items()
              for v in [nums[k]]}
    med = float(np.median(list(ref.first.values())))
    detail = {"reference_s": time.perf_counter() - t_ref,
              "window_s": t_close - t_open, "losses_read": len(reads),
              "knobs": res.knobs, "plans": res.plans,
              "overflows": res.overflows,
              "capacity_resizes": res.capacity_resizes,
              "step_fns": res.recompiles,
              "left_out": [k for k, v in ref.first.items() if v < 1e-3 * med],
              "read_not_compared": {k: v for k, v in nums.items()
                                    if k not in r.cell.limits},
              "loss_gaps": [gap(x, y, 0.0) for x, y
                            in zip(prog.losses, ref.losses)],
              "rows_worst_token": max(
                  [rows_gap(prog.rows[k].to(dev), ref.rows[k],
                            init_rows[k])["worst_token"]
                   for k in rows_at[1:] if k in prog.rows] or [math.inf])}

    window = None
    if r.trace:
        t0, t1 = int(t_open * 1e9), int(t_close * 1e9)
        spans = [(e["name"], e["t0_ns"], e["t1_ns"])
                 for e in tracer.events()]
        window = Window(cell, t0, t1, clip(dtrace.ops, t0, t1),
                        clip(spans, t0, t1), {
                            "steps": window_steps,
                            "step_tokens": stream.handed[warm:len(reads)],
                            "model_flops": model_flops(config, B, S),
                            "device_kind": torch.cuda.get_device_name(dev)
                            if cuda else "cpu"})
    return Outcome(metrics, window_steps, failed, checks, peak, window,
                   detail)
