"""What each rank of the vocab-parallel mesh runs in the mesh tests.

`tests/test_torch_mesh.py` starts the ranks (`launch.mesh.run_ranks`) and
holds what they return against the JAX package and the dense references;
the ranks themselves import no JAX.  Every input is made from a seed with
numpy, the same on every rank and in the parent.
"""

import contextlib
import hashlib

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.pm import collectives
from repro_torch.pm.collectives import MeshBackend, make_backend

V, D, M = 128, 8, 32          # vocab, width, miss-buffer slots
N_EVEN = 20                   # real ids in the even miss buffer
T = 48                        # tokens of the gradient checks
C, N_CACHE = 32, 24           # cache slots, real cache ids
N_DELTA = 16                  # delta-refresh slots


def inputs(seed: int = 0) -> dict:
    """The backend checks' inputs (numpy)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    accum = rng.uniform(0.5, 1.5, (V, D)).astype(np.float32)
    even = np.zeros(M, np.int32)               # probe layout: pads are 0
    even[:N_EVEN] = np.sort(rng.choice(V, N_EVEN, replace=False))
    skew = np.zeros(M, np.int32)               # 24 ids of owner 0 (of 4)
    skew[:24] = np.arange(24)
    mixed = rng.integers(0, V + 1, 40).astype(np.int32)   # V: pad
    tok = rng.integers(0, V, T).astype(np.int32)
    tok[:8] = tok[8:16]                        # duplicates
    g = rng.standard_normal((T, D)).astype(np.float32)
    cache = np.full(C, V, np.int32)
    cache[:N_CACHE] = np.sort(rng.choice(V, N_CACHE, replace=False))
    pick = np.sort(rng.choice(N_CACHE, 10, replace=False))
    delta = np.full(N_DELTA, V, np.int32)
    delta[:10] = cache[pick]
    slots = np.full(N_DELTA, C, np.int32)
    slots[:10] = pick
    return dict(table=table, accum=accum, even=even, skew=skew, mixed=mixed,
                tok=tok, g=g, cache=cache, delta=delta, slots=slots)


@contextlib.contextmanager
def path_counts():
    """Counts of routed gathers that stayed routed and that fell back to
    the replicated gather, in this process."""
    counts = {"routed": 0, "fallback": 0, "gather": 0}
    routed, gather = MeshBackend.gather_rows_routed, MeshBackend.gather_rows

    def counting_gather(self, *a, **k):
        counts["gather"] += 1
        return gather(self, *a, **k)

    def counting_routed(self, *a, **k):
        before = counts["gather"]
        out = routed(self, *a, **k)
        counts["fallback" if counts["gather"] > before else "routed"] += 1
        return out

    MeshBackend.gather_rows, MeshBackend.gather_rows_routed = \
        counting_gather, counting_routed
    try:
        yield counts
    finally:
        MeshBackend.gather_rows, MeshBackend.gather_rows_routed = \
            gather, routed


def backend_checks(seed: int = 0) -> dict:
    """Every `MeshBackend` method on this rank's blocks; returns numpy."""
    x = inputs(seed)
    be = make_backend("mesh")
    t = lambda a: torch.from_numpy(a.copy())    # noqa: E731
    tab = be.place_table(x["table"])
    out = {"rank": be.mesh.rank}
    with path_counts() as counts:
        for kernel in (False, True):
            for om in (None, "host"):
                for name in ("even", "skew"):
                    ids = x[name]
                    nv = N_EVEN if name == "even" else 24
                    # without the host's ids the caller passes no block
                    cap = 0 if om is None else collectives.route_block(
                        ids[:nv], V, be.n_shards, M)
                    out[f"routed_{name}_{kernel}_{om}"] = \
                        be.gather_rows_routed(tab, t(ids), nv, cap,
                                              kernel=kernel).numpy()
            out[f"gather_{kernel}"] = be.gather_rows(
                tab, t(x["mixed"]), kernel=kernel).numpy()
            tok, g = t(x["tok"]), t(x["g"])
            out[f"grad_{kernel}"] = be.scatter_row_grads(
                tok, g, V, kernel=kernel,
                residual=ops.sorted_slots(tok, T)).numpy()
            out[f"grad_nores_{kernel}"] = be.scatter_row_grads(
                tok, g, V, kernel=kernel).numpy()
            out[f"grad_psum_{kernel}"] = be.scatter_row_grads_psum(
                tok, g, V, kernel=kernel).numpy()
            seg_ids, seg_g = ops.segment_rows(tok, g, n_slots=T, pad_id=V)
            tb, ab = be.place_table(x["table"]), be.place_table(x["accum"])
            be.update_rows(tb, ab, seg_ids, seg_g, lr=0.05, kernel=kernel)
            out[f"update_{kernel}"] = (tb.numpy(), ab.numpy())
            cache_rows = be.refresh_rows(tab, t(x["cache"]))
            out["refresh"] = cache_rows.numpy().copy()
            out["refresh_host"] = be.refresh_rows(
                tab, t(x["cache"]), route_cap=collectives.route_block(
                    x["cache"], V, be.n_shards, C)).numpy()
            stale = torch.zeros_like(cache_rows)
            out[f"delta_{kernel}"] = be.refresh_rows_delta(
                tab, stale, t(x["delta"]), t(x["slots"]),
                kernel=kernel).numpy()
    out["counts"] = dict(counts)
    # a vocabulary the ranks do not divide is refused before any collective
    out["refused"] = []
    for call in (lambda: be.place_table(np.zeros((V + 2, D), np.float32)),
                 lambda: be.scatter_row_grads(t(x["tok"]), t(x["g"]), V + 2),
                 lambda: be.scatter_row_grads_psum(t(x["tok"]), t(x["g"]),
                                                   V + 2)):
        try:
            call()
            out["refused"].append(False)
        except ValueError:
            out["refused"].append(True)
    return out


def train_capture(cfg, lc, device="cpu"):
    """``train_loop(cfg, lc)`` and the model it trained."""
    from repro_torch.train import loop
    made = []
    init = loop.init_model

    def capture(*a, **k):
        made.append(init(*a, **k))
        return made[-1]

    loop.init_model = capture
    try:
        res = loop.train_loop(cfg, lc, device=device)
    finally:
        loop.init_model = init
    return res, made[0]


def replicated(model) -> dict:
    """The model's parameters other than the table (numpy)."""
    return {k: p.detach().cpu().numpy().copy()
            for k, p in model.named_parameters() if k != "embed"}


def digest(params: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].tobytes())
    return h.hexdigest()


def train_checks(runs: dict) -> dict:
    """Each named run ``(arch, loop kwargs)`` with ``collective="mesh"``
    over all ranks; returns losses, counters, the routed gathers' paths,
    the replicated parameters' digest (and rank 0's parameters)."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.train.loop import LoopConfig
    rank = dist.get_rank()
    out = {}
    for name, (arch, kw) in runs.items():
        with path_counts() as counts:
            res, model = train_capture(
                get_config(arch, smoke=True),
                LoopConfig(collective="mesh", **kw))
        params = replicated(model)
        out[name] = {"losses": res.losses, "overflows": res.overflows,
                     "plans": res.plans, "refreshes": res.refreshes,
                     "counts": dict(counts), "digest": digest(params),
                     "embed_rows": tuple(model.embed.shape),
                     "params": params if rank == 0 else None}
    return out


def serve_run(n: int, V_: int, D_: int, rounds: int, seed: int, knobs: dict,
              collective: str = "mesh", device="cpu"):
    """A serving run over a seeded table and a recorded drifting Zipf
    stream; returns the counters, the routed gathers' paths and how many
    served requests' rows differ from ``table[keys]``."""
    from repro_torch.serve import (DriftingZipfStream, ReplayStream,
                                   ServeConfig, ServingRuntime)
    table = np.random.default_rng(seed).standard_normal(
        (V_, D_)).astype(np.float32)
    live = DriftingZipfStream(V_, 8, zipf_a=1.1, arrival_rate=16,
                              scenario="rotate", rotate_every=6, seed=seed)
    replay = ReplayStream.record(live, rounds + 40)
    keys = {r.rid: r.keys for wave in replay.per_round for r in wave}
    cfg = ServeConfig(vocab=V_, batch_requests=16, keys_per_request=8,
                      kernel=True, summary=False, seed=seed,
                      collective=collective, model_shards=n, **knobs)
    with path_counts() as counts:
        rt = ServingRuntime(table, cfg, device=device)
        res = rt.run(replay, rounds, collect_outputs=True)
    bad = sum(not np.array_equal(res.outputs[r], table[keys[r]])
              for r in res.outputs)
    return {"served": res.served, "requeues": res.requeues,
            "replans": res.replans, "zero_served": res.zero_served,
            "outputs": len(res.outputs), "bad": bad,
            "counts": dict(counts)}


def rank_main(seed: int, runs: dict, serve_args: list) -> dict:
    """Everything one rank checks, in one process-group lifetime."""
    return {"backend": backend_checks(seed), "train": train_checks(runs),
            "serve": [serve_run(*a) for a in serve_args]}


def fail_on_rank(bad: int) -> int:
    """Rank ``bad`` fails a check; the others wait in a collective it never
    enters."""
    import torch.distributed as dist
    if dist.get_rank() == bad:
        raise AssertionError(f"rank {bad}: check failed")
    dist.barrier()
    return dist.get_rank()


def _dtensor_setup(cfg, steps: int, seed: int, mesh, pm: int = 0,
                   accum_scale: float = 1e-4):
    """The model, warm AdaGrad accumulators and ``steps`` batches of a
    DTensor training run (``mesh`` None: plain tensors), and the FSDP
    spec: parameters and accumulators placed by `launch.sharding`'s specs
    (layers ZeRO-sharded over "data"), batches by the batch specs.
    ``pm``: each batch carries a replica cache of 6 of its first batch's
    ids and one pad, whose rows are the initial table's.  The
    accumulators are uniform in [0.5, 1.5) times ``accum_scale``."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.data.batches import make_batch
    from repro_torch.launch.sharding import (batch_pspecs, param_pspecs,
                                             placements)
    from repro_torch.models.model import init_model
    from repro_torch.pm.embedding import make_state

    model = init_model(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    accum = {n: torch.from_numpy((rng.uniform(0.5, 1.5, tuple(p.shape))
                                  * accum_scale).astype(np.float32))
             for n, p in model.named_parameters()}
    batches = [make_batch(cfg, 2, 16, np.random.default_rng(seed + i))
               for i in range(steps)]
    if pm:
        ids = np.unique(batches[0]["tokens"].numpy())[::3][:6]
        cache = torch.from_numpy(np.append(ids, cfg.vocab_size)
                                 .astype(np.int32))
        state = make_state(model.embed.detach(), cache)
        batches = [dict(b, pm_cache_ids=state.cache_ids,
                        pm_cache_rows=state.cache_rows) for b in batches]
    fsdp = None
    if mesh is not None:
        specs = param_pspecs(dict(model.named_parameters()), cfg, mesh,
                             zero_layers=True)
        fsdp = param_pspecs(dict(model.layers[0].named_parameters()),
                            cfg, mesh, zero_layers=False)
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            setattr(mod, leaf, nn.Parameter(distribute_tensor(
                p.detach(), mesh, placements(specs[name], mesh))))
        accum = {n: distribute_tensor(a, mesh, placements(specs[n], mesh))
                 for n, a in accum.items()}
        bspec = batch_pspecs(cfg, mesh, batches[0])
        batches = [{k: distribute_tensor(v, mesh,
                                         placements(bspec[k], mesh))
                    for k, v in b.items()} for b in batches]
    return model, accum, batches, fsdp


def _losses(step, model, accum, batches) -> list:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.optim.optimizers import AdaGradState
    opt = AdaGradState(accum)
    losses = []
    for b in batches:
        with implicit_replication():
            loss, _, _ = step(model, opt, b)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        losses.append(float(loss))
    return losses


def dtensor_train(archs, mesh_shapes, steps: int = 2, seed: int = 0) -> dict:
    """For each arch (smoke config) and each mesh shape over ("data",
    "model") of this group: the losses of ``steps`` training steps with
    DTensor parameters and AdaGrad state placed by `launch.sharding`'s
    specs (layers ZeRO-sharded over "data", and gathered to their
    tensor-parallel layout as each layer runs: ``fsdp_spec``) and batches
    placed by the batch specs, without and with the vocab-parallel loss
    (``vp_loss_mesh``), beside the plain step's losses from the same
    weights, warm accumulators and batches."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.registry import get_config
    from repro_torch.train.steps import make_train_step

    def run(cfg, mesh, vp=False):
        model, accum, batches, fsdp = _dtensor_setup(cfg, steps, seed, mesh)
        step = make_train_step(cfg, lr=0.01, fsdp_spec=fsdp,
                               vp_loss_mesh=mesh if vp else None)
        return _losses(step, model, accum, batches)

    out = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        plain = run(cfg, None)
        for shape in mesh_shapes:
            mesh = init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=("data", "model"))
            for vp in (False, True):
                out[(arch, tuple(shape), vp)] = (plain, run(cfg, mesh, vp))
    return out


def dtensor_pm_train(archs, mesh_shapes, steps: int = 2, seed: int = 0
                     ) -> dict:
    """The intent-managed embedding with DTensor parameters and batches,
    as `dtensor_train` places them, beside the plain one, strict and not,
    for each arch and mesh shape, each result as (plain, DTensor):

    * ``stage``: every output of the index stage (`step_residual` on the
      placed tokens, whole), 16 slots for 32 tokens, so some unique
      misses overflow;
    * ``rows`` / ``grad``: the lookup's rows and the table's gradient
      (whole) for an integer-valued upstream gradient, whose sums are
      exact in any order;
    * ``losses`` / ``embed``: ``steps`` managed training steps and the
      updated table (whole), strict with 32 slots (no overflow: a strict
      step's overflow tokens read the all-zero trash row, whose gradient
      through the first norm is about 1/sqrt(eps), and the sharded
      matmuls' rounding, scaled by it, would swamp the comparison) and
      not strict with 16 (the overflow tokens read the dense fallback).

    The accumulators start near 1, where AdaGrad's step is about ``lr *
    g``: near 1e-4, as `dtensor_train` starts them, a gradient entry of
    about 1e-2 moves its row by about itself, and the sharded matmuls'
    rounding alone (the unmanaged step's too) moves table entries by up
    to 1e-6."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.pm_forward import step_residual
    from repro_torch.pm.embedding import pm_lookup
    from repro_torch.train.steps import make_train_step

    def whole(t):
        t = t.detach()
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def lookup(model, batch, strict, g):
        table = model.embed.detach().requires_grad_(True)
        if hasattr(batch["tokens"], "placements"):
            g = distribute_tensor(g, batch["tokens"].device_mesh,
                                  batch["tokens"].placements)
        rows = pm_lookup(table, batch["pm_cache_ids"],
                         batch["pm_cache_rows"], batch["tokens"], 16, strict)
        rows.backward(g)
        return whole(rows), whole(table.grad)

    def run(cfg, mesh, strict):
        model, accum, batches, fsdp = _dtensor_setup(
            cfg, steps, seed, mesh, pm=True, accum_scale=1.0)
        b = batches[0]
        r = step_residual(b["pm_cache_ids"], b["tokens"].reshape(-1), 16)
        g = torch.from_numpy(np.random.default_rng(seed).integers(
            -4, 5, (2, 16, cfg.d_model)).astype(np.float32))
        rows, grad = lookup(model, b, strict, g)
        step = make_train_step(cfg, lr=0.01, fsdp_spec=fsdp,
                               pm_miss_capacity=16 if not strict else 32,
                               pm_strict=strict)
        losses = _losses(step, model, accum, batches)
        return dict(stage=[whole(t) for t in (*r.probe, *r.sort, r.n_uniq)],
                    rows=rows, grad=grad, losses=losses,
                    embed=whole(model.embed))

    out = {}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        for strict in (True, False):
            plain = run(cfg, None, strict)
            for shape in mesh_shapes:
                mesh = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=("data", "model"))
                dt = run(cfg, mesh, strict)
                out[(arch, tuple(shape), strict)] = {
                    k: (plain[k], dt[k]) for k in plain}
    return out
