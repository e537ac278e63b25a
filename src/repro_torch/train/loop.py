"""Training loop with first-class intent-managed parameter management (the
twin of `repro/train/loop.py`).

Per step:
  1. the loader (already ``prefetch`` steps ahead) has signaled intent for
     upcoming batches;
  2. the planner (Algorithm 1 timing) decides whether to act: emit a new
     placement plan (replica-cache contents + miss-buffer capacity);
  3. the replica cache is synchronized from the table (one grouped gather
     per *refresh round*: on replan rounds, plus every ``refresh_every``
     steps; in between, replicas serve reads at most one refresh round
     stale);
  4. the train step runs with the managed embedding path (with
     ``LoopConfig.kernel`` through the hand-written CUDA kernels).

``LoopResult.overflows`` counts steps whose actual unique-miss count
exceeded the plan's capacity (forcing the lookup's dense fallback); with
exact intent this stays 0.  ``recompiles`` counts the distinct
miss-capacity step functions built, as the reference counts its compiled
executables.

Zero-tuning: ``cache_capacity``, ``refresh_every`` and ``pipeline_depth``
accept ``"auto"`` (the default) and are then owned by the online
controller — capacity follows the planning window's intent demand,
refresh cadence and pipeline depth are hill-climbed on measured loss drop
per second.  Progress signals are published to the telemetry bus
(``train.*`` records) and, with an enabled tracer, as spans
(``train.signal``, ``train.plan``, ``train.refresh``,
``prefetch.refresh``, ``train.step``, ``prefetch.drain``).

The prefetch pipeline (``pipeline_depth >= 1``) defers reading each
step's loss by up to that many steps, builds the next plan in a
background thread, and refreshes only the cache rows the steps since the
last sync touched.  All three are exact: the loss trace does not depend
on the depth.

The model's parameters and the optimizer state are updated in place, so
the (V, D) table and its accumulator are never copied per step.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import IntentSignalingLoader
from repro_torch.device import resolve_device
from repro_torch.models.model import (init_model, load_params,
                                      params_from_jax, params_to_jax)
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.trace import SpanTracer, make_tracer
from repro_torch.optim.optimizers import AdaGradState, AdamState
from repro_torch.pm.collectives import make_backend, resolve
from repro_torch.pm.controller import (AUTO, Knob, OnlineController,
                                       capacity_ladder, is_auto,
                                       resolve_knob)
from repro_torch.pm.embedding import make_state
from repro_torch.pm.planner import IntentPlanner, PlacementPlan
from repro_torch.train.steps import make_opt_init, make_train_step


@dataclass
class LoopConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 64
    lr: float = 0.01
    optimizer: str = "adagrad"
    pm: bool = True                  # intent-managed embedding on/off
    kernel: bool = False             # hand-written kernels on the hot path
    collective: str = "emulated"     # "emulated" (the mesh backend is not
    #                                  ported yet)
    model_shards: int = 0            # mesh size for collective="mesh"
    cache_capacity: Union[int, str] = AUTO  # replica-cache rows; "auto":
    #                                  steered by the planning window's
    #                                  intent demand over pow2 buckets
    n_shards: int = 1
    prefetch: int = 16
    plan_every: int = 8
    refresh_every: Union[int, str] = AUTO  # replica sync cadence (steps);
    #                                  replan rounds always refresh
    pipeline_depth: Union[int, str] = AUTO  # prefetch pipeline: 0 = fully
    #                                  synchronous; >= 1 defers loss
    #                                  blocking up to that many steps, plans
    #                                  one replan round ahead and uses the
    #                                  delta refresh where it is exact
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    init_from: Optional[str] = None  # checkpoint dir to restore from
    log_every: int = 10
    seed: int = 0


@dataclass
class LoopResult:
    losses: List[float] = field(default_factory=list)
    plans: int = 0
    refreshes: int = 0               # replica-cache sync rounds
    overflows: int = 0               # steps with unique misses > capacity
    recompiles: int = 0
    capacity_resizes: int = 0        # mid-run replica-cache bucket changes
    start_step: int = 0              # first step index (restored runs)
    wall_s: float = 0.0
    knobs: Dict[str, object] = field(default_factory=dict)


def checkpoint_tree(model, opt_state) -> dict:
    """``{"params", "opt"}`` in the reference's on-disk layout (stacked
    layers, the optimizer state's NamedTuple fields)."""
    L = model.cfg.n_layers
    params = params_to_jax(dict(model.named_parameters()), L)
    if isinstance(opt_state, AdaGradState):
        opt = AdaGradState(params_to_jax(opt_state.accum, L))
    else:
        opt = AdamState(params_to_jax(opt_state.mu, L),
                        params_to_jax(opt_state.nu, L), opt_state.count)
    return {"params": params, "opt": opt}


def restore(path: str, model, opt_state) -> int:
    """Load a checkpoint written by either package into ``model`` and
    ``opt_state`` in place; returns its step.  ``path`` is a step
    directory or a root of ``step_*`` directories (its newest is used)."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        latest = checkpoint.latest_step(path)
        if latest is None:
            raise FileNotFoundError(
                f"no checkpoint under {path!r} (expected a manifest or "
                f"step_* subdirectories)")
        path = latest
    tree, step = checkpoint.load(path, checkpoint_tree(model, opt_state))
    load_params(model, params_from_jax(tree["params"]))
    states = [(opt_state.accum, tree["opt"].accum)] \
        if isinstance(opt_state, AdaGradState) else \
        [(opt_state.mu, tree["opt"].mu), (opt_state.nu, tree["opt"].nu)]
    with torch.no_grad():
        for own, saved in states:
            for k, v in params_from_jax(saved).items():
                own[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        if isinstance(opt_state, AdamState):
            opt_state.count.fill_(int(tree["opt"].count))
    return step


def train_loop(cfg: ModelConfig, lc: LoopConfig,
               telemetry: Optional[Telemetry] = None,
               tracer: Optional[SpanTracer] = None,
               device=None) -> LoopResult:
    """Train ``cfg`` as ``lc`` says, on ``device`` (None: ``cuda``, which
    raises without a card; pass ``device="cpu"`` for the CPU, where every
    kernel runs its plain version)."""
    t0 = time.time()
    dev = resolve_device(device)
    bus = telemetry if telemetry is not None else Telemetry()
    tr = make_tracer(False, tracer=tracer)
    gen = torch.Generator(device=dev)
    gen.manual_seed(lc.seed)
    model = init_model(cfg, gen)
    opt_state = make_opt_init(lc.optimizer)(model)

    res = LoopResult()
    if lc.init_from:
        res.start_step = restore(lc.init_from, model, opt_state)

    # collective backend for the managed lookup: None = the emulated
    # single-device reference ("mesh" raises: not ported yet)
    backend = make_backend(lc.collective) if lc.pm else None

    # ---- knob resolution: "auto" fields belong to the controller
    auto = {name for name, v in (("cache_capacity", lc.cache_capacity),
                                 ("refresh_every", lc.refresh_every),
                                 ("pipeline_depth", lc.pipeline_depth))
            if is_auto(v)}
    cap_ladder = capacity_ladder(cfg.vocab_size)
    cache_capacity = int(resolve_knob(lc.cache_capacity, cap_ladder[0]))
    refresh_every = int(resolve_knob(lc.refresh_every, 1))
    pipeline_depth = int(resolve_knob(lc.pipeline_depth, 1))
    ctl: Optional[OnlineController] = None
    if lc.pm and auto:
        knobs = []
        if "cache_capacity" in auto:
            knobs.append(Knob("cache_capacity", cap_ladder,
                              index=cap_ladder.index(cache_capacity),
                              adapt=False, prefer_low=True))
        if "refresh_every" in auto:
            ladder = (0, 1, 2, 4, 8)
            knobs.append(Knob("refresh_every", ladder,
                              index=ladder.index(refresh_every),
                              prefer_low=True))
        if "pipeline_depth" in auto:
            ladder = (0, 1, 2, 4)
            knobs.append(Knob("pipeline_depth", ladder,
                              index=ladder.index(pipeline_depth),
                              prefer_low=True))
        ctl = OnlineController(knobs, bus, seed=lc.seed)

    planner = IntentPlanner(cfg.vocab_size, cache_capacity,
                            n_nodes=max(1, lc.n_shards),
                            plan_every=lc.plan_every,
                            per_node_bound=backend is not None,
                            telemetry=bus) if lc.pm else None
    loader = IntentSignalingLoader(
        cfg, lc.batch, lc.seq, n_shards=max(1, lc.n_shards),
        prefetch=lc.prefetch, planner=planner, seed=lc.seed, device=dev)

    step_fns: Dict[int, callable] = {}

    def step_fn(miss_capacity: int):
        if miss_capacity not in step_fns:
            step_fns[miss_capacity] = make_train_step(
                cfg, optimizer=lc.optimizer, lr=lc.lr,
                pm_miss_capacity=miss_capacity, pm_kernel=lc.kernel,
                pm_backend=backend)
        return step_fns[miss_capacity]

    plan: Optional[PlacementPlan] = None
    cache_ids = None
    cache_rows = None
    epoch_t0: Optional[float] = None
    epoch_loss: Optional[float] = None

    # deferred loss blocking: the device queue holds up to pipeline_depth
    # dispatched-but-unread steps; draining preserves the synchronous
    # loop's exact per-step ordering of losses/telemetry/logs
    pending: deque = deque()   # (step, loss_device, step_t0)

    def drain(limit: int) -> None:
        while len(pending) > limit:
            s, loss_d, t0s = pending.popleft()
            _t = tr.now_ns() if tr.enabled else 0
            loss_f = float(loss_d)          # blocks on the device queue
            if tr.enabled:
                tr.record("prefetch.drain", _t, tr.now_ns(), a=s)
            res.losses.append(loss_f)
            bus.set("train.loss", loss_f)
            bus.observe("train.step_ms",
                        (time.perf_counter() - t0s) * 1e3)
            if lc.log_every and s % lc.log_every == 0:
                print(f"step {s:5d}  loss {loss_f:.4f}")

    # background plan-ahead: ONE worker builds the next boundary's plan
    # candidate off the already-signaled window while steps run; only
    # `adopt`'s window-equality check turns a candidate into the plan
    executor = ThreadPoolExecutor(max_workers=1) \
        if planner is not None else None
    pending_plan = None        # (future, target_step, window)
    last_plan_step = -1
    # delta refresh: union of table rows the steps since the last sync
    # updated (the loader's signaled ids)
    touched = np.zeros(0, dtype=np.int64)
    touched_known = True
    # the delta refresh is exact only when untouched rows are bitwise
    # frozen between syncs: sparse/dense AdaGrad leaves zero-grad rows
    # unchanged, but tied embeddings take dense head gradients on every
    # row and momentum-style optimizers decay untouched rows' state
    delta_exact = (lc.optimizer == "adagrad"
                   and not getattr(cfg, "tie_embeddings", False))

    it = iter(loader)
    while True:
        # the loader's __next__ IS the intent-signaling phase
        _t_sig = tr.now_ns() if tr.enabled else 0
        step, batch = next(it)
        if tr.enabled:
            tr.record("train.signal", _t_sig, tr.now_ns(), a=step)
        if step >= lc.steps:
            break
        step_t0 = time.perf_counter()
        if planner is not None:
            planner.observe_round(step)
            replanned = False
            if planner.should_replan(step, plan):
                _t_plan = tr.now_ns() if tr.enabled else 0
                # the controller's reward reads the epoch's losses: the
                # deferred tail lands in res.losses first
                drain(0)
                now = time.perf_counter()
                if ctl is not None and epoch_t0 is not None \
                        and res.losses:
                    cur = float(np.mean(res.losses[-lc.plan_every:]))
                    if epoch_loss is not None and now > epoch_t0:
                        reward = (epoch_loss - cur) / (now - epoch_t0)
                        bus.set("ctl.reward", reward)
                        for name, v in ctl.observe(reward).items():
                            if name == "refresh_every":
                                refresh_every = int(v)
                            elif name == "pipeline_depth":
                                pipeline_depth = int(v)
                    epoch_loss = cur
                elif ctl is not None and res.losses:
                    epoch_loss = float(np.mean(res.losses[-lc.plan_every:]))
                epoch_t0 = now
                cand = None
                if pending_plan is not None:
                    cand = pending_plan[0].result()
                    pending_plan = None
                plan = planner.adopt(cand, step)
                if plan is not None:
                    bus.inc("train.prefetch_plan_hits")
                else:
                    if cand is not None:
                        bus.inc("train.prefetch_plan_misses")
                    plan = planner.plan(step)
                if ctl is not None and "cache_capacity" in auto:
                    new_cap = ctl.steer_capacity("cache_capacity",
                                                 plan.demand)
                    if new_cap is not None:
                        cache_capacity = int(new_cap)
                        planner.set_capacity(cache_capacity)
                        res.capacity_resizes += 1
                        bus.inc("train.capacity_resizes")
                        bus.event("train.capacity_resize", step=step,
                                  capacity=cache_capacity)
                        plan = planner.plan(step)
                cache_ids = torch.from_numpy(
                    np.asarray(plan.cache_ids, np.int32)).to(dev)
                res.plans += 1
                bus.inc("train.plans")
                replanned = True
                last_plan_step = step
                planner.gc(step)
                if tr.enabled:
                    tr.record("train.plan", _t_plan, tr.now_ns(), a=step)
            if replanned or cache_rows is None or (
                    refresh_every > 0
                    and step % refresh_every == 0):
                # delta refresh (pipeline on, same plan, exact-update
                # optimizer, touched set known): re-gather only the cache
                # rows the steps since the last sync updated, in place
                ids = None
                if (pipeline_depth >= 1 and not replanned
                        and cache_rows is not None and touched_known
                        and delta_exact):
                    ids = np.intersect1d(
                        touched, np.asarray(plan.cache_ids, np.int64))
                    n = max(64, 1 << (int(ids.size) - 1).bit_length()) \
                        if ids.size else 64
                    if n >= plan.cache_ids.shape[0]:
                        ids = None       # near-full delta: one gather wins
                if ids is not None:
                    C = plan.cache_ids.shape[0]
                    slots = np.searchsorted(
                        np.asarray(plan.cache_ids, np.int64), ids)
                    ids_p = np.full(n, cfg.vocab_size, np.int32)
                    ids_p[:ids.size] = ids
                    slots_p = np.full(n, C, np.int32)
                    slots_p[:ids.size] = slots
                    with tr.span("prefetch.refresh", a=step):
                        cache_rows = resolve(backend).refresh_rows_delta(
                            model.embed.detach(), cache_rows,
                            torch.from_numpy(ids_p),
                            torch.from_numpy(slots_p), kernel=lc.kernel)
                    bus.inc("train.delta_refreshes")
                else:
                    with tr.span("train.refresh", a=step):
                        state = make_state(model.embed.detach(), cache_ids,
                                           backend)
                        cache_rows = state.cache_rows
                touched = np.zeros(0, dtype=np.int64)
                touched_known = True
                res.refreshes += 1
                bus.inc("train.refreshes")
            batch = dict(batch, pm_cache_ids=cache_ids,
                         pm_cache_rows=cache_rows)
            # exact-bound accounting: unique misses must fit the plan's
            # capacity.  The loader's host-side signals ARE the step's
            # unique ids — no device-to-host readback on the hot path; the
            # count also tells the lookup whether its overflow fallback
            # can fire
            uniq = planner.signaled_ids(step)
            if uniq is not None:
                n_miss = np.setdiff1d(uniq, plan.cache_ids).size
                batch["pm_n_miss"] = int(n_miss)
                if n_miss > plan.miss_capacity:
                    res.overflows += 1
                    bus.inc("train.overflows")
                touched = np.union1d(touched, uniq.astype(np.int64))
            else:
                touched_known = False
            fn = step_fn(plan.miss_capacity)
            # plan-ahead submission: one step before the earliest possible
            # next boundary, hand the worker the window to build against
            if (executor is not None and pipeline_depth >= 1
                    and plan is not None):
                if pending_plan is not None and pending_plan[1] <= step:
                    pending_plan[0].result()
                    pending_plan = None
                t_pred = min(last_plan_step + lc.plan_every,
                             plan.window[1])
                if pending_plan is None and step == t_pred - 1:
                    window = planner.plan_window(t_pred)
                    fut = executor.submit(planner.plan_candidate, window)
                    pending_plan = (fut, t_pred, window)
                    if tr.enabled:
                        _t = tr.now_ns()
                        tr.record("prefetch.plan", _t, _t, a=t_pred)
        else:
            fn = step_fn(0)
        with tr.span("train.step", a=step):
            loss, model, opt_state = fn(model, opt_state, batch)
            if pipeline_depth == 0:
                # blocks: the span covers real step time
                loss = float(loss)
        pending.append((step, loss, step_t0))
        drain(pipeline_depth)
        if lc.ckpt_dir and lc.ckpt_every and step and \
                step % lc.ckpt_every == 0:
            checkpoint.save(f"{lc.ckpt_dir}/step_{step:07d}",
                            checkpoint_tree(model, opt_state), step)

    drain(0)
    if pending_plan is not None:
        pending_plan[0].result()
        pending_plan = None
    if executor is not None:
        executor.shutdown(wait=True)

    res.recompiles = len(step_fns)
    res.wall_s = time.time() - t0
    res.knobs = {"cache_capacity": cache_capacity,
                 "refresh_every": refresh_every,
                 "pipeline_depth": pipeline_depth,
                 "plan_every": lc.plan_every}
    return res
