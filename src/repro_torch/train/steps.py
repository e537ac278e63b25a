"""The training step and the decoding steps (the twin of
`repro/train/steps.py`).

`make_train_step` returns ``train_step(model, opt_state, batch) -> (loss,
model, opt_state)``.  The model's parameters and the optimizer state are
updated in place (the reference donates both buffers to its jitted step
for the same effect): the (V, D) table and its AdaGrad accumulator are
never copied.  ``loss`` is a 0-dim device tensor; reading it is the only
point where the host waits for the step.

Two arms, chosen by the reference's gate ``sparse_embed``:

* **fused sparse** (untied AdaGrad with the managed embedding and
  ``pm_kernel``): the token rows are gathered once through the managed
  lookup, the loss is differentiated with respect to those rows (so no
  (V, D) embedding gradient exists), duplicate rows are summed by
  `ops.segment_rows` from the step's sort residual, and the `adagrad_rows`
  kernel updates exactly the touched rows (`EmulatedBackend.update_rows`);
* **dense**: autograd through the model, the managed lookup's backward
  (with ``pm_kernel``: the `segment_scatter_rows` kernel) included, then
  dense AdaGrad (or Adam) on every parameter.

On the mesh backend (`pm.collectives.MeshBackend`) the model's ``embed``
is this rank's block of the table.  Untied models take the fused arm
whatever ``pm_kernel`` is: `MeshBackend.update_rows` routes each summed
row to its owner and updates it there.  Tied models take the dense arm
with the head sharded with the table: the loss is
`losses.vocab_parallel_ce` over the rank's vocab block, and the block's
gradient (the routed lookup scatter plus the head's block) is the only
table gradient any rank holds; dense AdaGrad sweeps that block.  Every
other parameter is replicated: each rank computes the same gradient from
the same batch and applies the same update, so the replicas stay equal
bit for bit without a collective.

Single-sort step: the step computes ONE `pm_forward.step_residual` from
the batch tokens, and every index consumer — forward probe/compact,
backward duplicate pre-sum, the sparse optimizer — reads it.

Each layer is rematerialised by default (``remat=True``, the
reference's default): autograd keeps a layer's inputs and recomputes its
body in the backward (`torch.utils.checkpoint`), so the activations of
one layer at a time are alive.  The managed lookup, the fused arm's
row gather and the encoder run outside the rematerialised layers, once
a step.

Decoding (`make_prefill_step`, `make_prefill_decode_step`,
`make_serve_step`) runs the model forward only, under ``torch.no_grad``
and never rematerialised, on a cache from `models.model.init_cache`
(k/v for the attention families, the O(1) conv and ``h`` state for the
recurrent ones, both for the hybrid).  The cache's tensors are written
in place and its ``len`` is a host integer that each step advances; the
token embedding is a plain index of the table, as the reference's
decode takes it with ``jnp.take`` (no Pallas kernel).  The decode steps
pass tokens only (M-RoPE positions then default to the chunk's position
on all three coordinates); an encoder-decoder model attends to the
cache's ``enc_out``, written by the caller before the prefill.

fp32 matmuls run in full fp32: TF32 is switched off for matmuls and
cuDNN when a step is built.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.parallel import loss_parallel

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.pm_forward import step_residual
from repro_torch.launch.mesh import batch_axes
from repro_torch.launch.sharding import batch_entry
from repro_torch.models.losses import vocab_parallel_ce
from repro_torch.models.model import loss_fn
from repro_torch.optim.optimizers import (adagrad_init, adagrad_update,
                                          adam_init, adam_update)
from repro_torch.pm.collectives import resolve
from repro_torch.pm.embedding import pm_lookup


def full_fp32_matmuls() -> None:
    """Switch TF32 off for fp32 matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_train_step(cfg: ModelConfig, *, optimizer: str = "adagrad",
                    lr: float = 0.01, pm_miss_capacity: int = 0,
                    pm_strict: bool = False, pm_kernel: bool = False,
                    pm_backend=None, remat: bool = True,
                    remat_policy: str = "full", vp_loss_mesh=None,
                    fsdp_spec=None) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (loss, model, state).

    ``pm_miss_capacity > 0`` activates the intent-managed embedding path
    (batch must then carry ``pm_cache_ids`` / ``pm_cache_rows``, and may
    carry the host's unique-miss count ``pm_n_miss``); ``pm_kernel``
    routes the lookup and the embedding update through the hand-written
    kernels.  ``pm_backend``: the collective backend (None: the emulated
    single-device reference; a `MeshBackend` runs the vocab-parallel
    mesh).  ``remat`` (the default, as the reference's): each layer is
    rematerialised in the backward with ``remat_policy`` ("full" or
    "dots", `models.model.DenseLM.forward`); the embedding lookup and the
    encoder stay outside the rematerialised units.

    For a model whose weights are DTensors on a `DeviceMesh` (the dry
    run, `launch.dryrun`): ``vp_loss_mesh``, that mesh, computes the
    cross-entropy on vocab-sharded logits (DTensor's `loss_parallel`, the
    twin of the reference's vocab-parallel loss; the logits are sharded
    over "model" along the vocabulary and over the batch axes along the
    batch); ``fsdp_spec`` gathers each layer's weights to its
    tensor-parallel layout as the layer runs (`DenseLM.forward`)."""
    full_fp32_matmuls()
    update = adagrad_update if optimizer == "adagrad" else adam_update
    # sparse row updates need the gradient support to be exactly the batch
    # tokens: tied embeddings receive dense head gradients, so they keep
    # the dense optimizer sweep
    mesh_real = getattr(pm_backend, "mesh_real", False)
    sparse_embed = (pm_miss_capacity > 0 and optimizer == "adagrad"
                    and not cfg.tie_embeddings
                    and (pm_kernel or mesh_real))

    # a tied head is sharded with the table on the mesh
    vp_mesh = pm_backend.mesh if mesh_real and cfg.tie_embeddings else None

    def run_loss(model, batch, residual, embed_rows=None):
        out, aux, _ = model(batch, pm_miss_capacity=pm_miss_capacity,
                            pm_strict=pm_strict, pm_kernel=pm_kernel,
                            pm_backend=pm_backend, pm_residual=residual,
                            embed_rows=embed_rows,
                            skip_head=vp_mesh is not None, remat=remat,
                            remat_policy=remat_policy, fsdp_spec=fsdp_spec)
        if vp_mesh is not None:
            return vocab_parallel_ce(out, model.embed.T, batch["labels"],
                                     vp_mesh, aux=aux)
        if vp_loss_mesh is not None:
            return sharded_vocab_ce(out, batch["labels"], vp_loss_mesh, aux)
        return loss_fn(out, batch["labels"], aux)

    def loss_and_grads(model, batch, residual, embed_rows=None):
        # DTensor's vocab-parallel loss runs its backward in its context
        with loss_parallel() if vp_loss_mesh is not None else nullcontext():
            loss = run_loss(model, batch, residual, embed_rows)
            loss.backward()
        return loss

    def train_step(model, opt_state, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        T = B * S
        tok = tokens.reshape(T).to(torch.int32)
        pm_on = pm_miss_capacity > 0 and "pm_cache_ids" in batch
        # THE step's one sort: probe/compact + full-token segmentation
        residual = step_residual(batch["pm_cache_ids"], tok,
                                 min(pm_miss_capacity, T)) if pm_on else None
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)

        if not sparse_embed:
            loss = loss_and_grads(model, batch, residual)
            # a parameter the step does not use (a hybrid with no layer
            # applying its shared block) has no gradient and keeps its
            # value, as a zero gradient leaves it under AdaGrad
            grads = {k: p.grad for k, p in params.items()
                     if p.grad is not None}
            update(grads, opt_state, params, lr=lr)
            return loss.detach(), model, opt_state

        # fused sparse path: gather the token rows ONCE, then differentiate
        # the loss with respect to those rows — the lookup's backward (and
        # with it any dense (V, D) gradient buffer) never runs
        emb = model.embed
        with torch.no_grad():
            if pm_on:
                h0 = pm_lookup(emb, batch["pm_cache_ids"],
                               batch["pm_cache_rows"], tokens,
                               min(pm_miss_capacity, T), pm_strict,
                               pm_kernel, pm_backend, residual,
                               batch.get("pm_n_miss"),
                               batch.get("pm_route_cap", 0))
            else:
                h0 = emb[tokens.long()]
        h0.requires_grad_(True)
        loss = loss_and_grads(model, batch, residual, embed_rows=h0)
        rest = {k: p for k, p in params.items() if k != "embed"}
        adagrad_update({k: p.grad for k, p in rest.items()
                        if p.grad is not None}, opt_state, rest, lr=lr)
        # fused sparse AdaGrad on exactly the touched (unique) rows, where
        # the row lives (`EmulatedBackend.update_rows`: the `adagrad_rows`
        # kernel, pads skipped; `MeshBackend.update_rows`: routed to the
        # owner's block first)
        V = cfg.vocab_size
        gt = h0.grad.reshape(T, emb.shape[1])
        seg_ids, seg_g = ops.segment_rows(
            tok, gt, n_slots=T, pad_id=V,
            residual=residual.sort if residual is not None else None)
        with torch.no_grad():
            resolve(pm_backend).update_rows(
                emb, opt_state.accum["embed"], seg_ids, seg_g, lr=lr,
                kernel=pm_kernel)
        return loss.detach(), model, opt_state

    return train_step


def sharded_vocab_ce(logits, labels, mesh, aux=0.0,
                     aux_weight: float = 0.01):
    """`models.model.loss_fn` on DTensor logits (B, S, V) laid out with the
    vocabulary over "model" and the batch over the batch axes, under
    DTensor's `loss_parallel` (which the caller enters, backward
    included): no device holds a row of full-vocabulary logits.
    `loss_parallel` takes logits on a one-dimensional mesh only (torch
    2.11), so each device's batch shard is cross-entropied on the
    "model" mesh alone, and the shards' sums meet as partial sums over
    the batch axes."""
    lay = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names
    lay[names.index("model")] = Shard(2)
    if logits.shape[0] % batch_entry(mesh)[1] == 0:
        for a in batch_axes(mesh):
            lay[names.index(a)] = Shard(0)
    lg = logits.float().redistribute(mesh, lay).to_local()
    # the labels laid out as the logits' batch
    labels = labels.redistribute(mesh, [
        Shard(0) if pl.is_shard(0) else Replicate() for pl in lay])
    row = mesh["model"]
    lg = DTensor.from_local(lg, row, [Shard(2)], run_check=False)
    tgt = DTensor.from_local(labels.to_local().long(), row, [Replicate()],
                             run_check=False)
    ce = F.cross_entropy(lg.flatten(0, 1), tgt.flatten(0, 1),
                         reduction="sum").to_local()
    ce = DTensor.from_local(ce, mesh, [
        Partial() if pl.is_shard(0) else Replicate() for pl in lay],
        run_check=False)
    return ce / labels.numel() + aux_weight * aux


def make_opt_init(optimizer: str = "adagrad") -> Callable:
    """``init(model) -> state`` over the model's named parameters."""
    init = adagrad_init if optimizer == "adagrad" else adam_init
    return lambda model: init(dict(model.named_parameters()))


def make_prefill_step(cfg: ModelConfig, *, last_only: bool = False,
                      fsdp_spec=None) -> Callable:
    """Forward-only prefill without a cache: ``prefill_step(model,
    batch)`` returns the last position's logits (B, V).  ``last_only``
    runs the head on the last position only, so the (B, S, V) logits are
    never computed.  ``fsdp_spec``: as `make_train_step`'s."""
    full_fp32_matmuls()

    @torch.no_grad()
    def prefill_step(model, batch):
        logits, _, _ = model(batch, head_last_only=last_only,
                             fsdp_spec=fsdp_spec)
        return logits[:, -1]

    return prefill_step


def make_prefill_decode_step(cfg: ModelConfig, *, fsdp_spec=None
                             ) -> Callable:
    """Fused prefill into a decode cache: ``prefill(model, cache,
    tokens (B, P), routes=None) -> (last logits (B, V), cache advanced by
    P)``.  The prompt runs as one chunked forward, for every family: the
    attention families write k/v for all P positions at once and
    `layers.decode_attention` is causal within the chunk; the recurrent
    families (ssm, hybrid) run the chunk through `ssm.linear_scan` seeded
    with the cache's ``h`` and a causal conv padded by the cache's conv
    ring, and write back the final ``h`` and ring (the hybrid's shared
    block fills each application's KV cache as the attention families
    do).

    The same result as P one-token serve steps up to rounding, except
    where MoE capacity drops: the chunk routes the whole prompt through
    expert capacity at once (the training-time semantics), where the loop
    routes one token per sequence at a time.  The reference's recurrent
    families instead loop the P positions inside one jit
    (``prefill_scan``); the chunk departs from it by rounding only.  The
    prompt must fit the cache.  ``routes``: a list to which each MoE
    layer appends its `moe.Routing`.  The encoder-decoder family reads
    ``cache["enc_out"]``, which the caller fills first
    (`DenseLM.encode`).  ``fsdp_spec``: as `make_train_step`'s."""
    full_fp32_matmuls()

    @torch.no_grad()
    def prefill_chunk(model, cache, tokens, routes=None):
        P = tokens.shape[1]
        cache = {**cache, "len": cache["len"] + P}
        logits, _, new_cache = model({"tokens": tokens}, cache,
                                     head_last_only=True, routes=routes,
                                     fsdp_spec=fsdp_spec)
        return logits[:, -1], new_cache

    return prefill_chunk


def make_serve_step(cfg: ModelConfig, *, fsdp_spec=None) -> Callable:
    """One decode step: ``serve_step(model, cache, tokens (B, 1),
    routes=None) -> (logits (B, V), new cache)``, one token per sequence
    against the cache.  Advances ``cache["len"]`` itself (the new token
    occupies position len).  ``fsdp_spec``: as `make_train_step`'s."""
    full_fp32_matmuls()

    @torch.no_grad()
    def serve_step(model, cache, tokens, routes=None):
        cache = {**cache, "len": cache["len"] + 1}
        logits, _, new_cache = model({"tokens": tokens}, cache,
                                     routes=routes, fsdp_spec=fsdp_spec)
        return logits[:, -1], new_cache

    return serve_step
