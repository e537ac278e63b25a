"""Model assembly for every family of the reference (the twin of
`repro/models/model.py`), as one `nn.Module`, `DenseLM`:

* dense / moe: a pre-norm GQA transformer whose FFN is an MLP, or a
  mixture of experts when ``cfg.n_experts``;
* ssm (falcon-mamba): a Mamba-1 trunk (attention-free): pre-norm
  residual `SSMLayer`s, no MLP;
* hybrid (zamba2): a Mamba-2 trunk with one *shared* attention block (a
  `DenseLayer`, ``shared_attn``) applied before the Mamba block of every
  layer whose index is a multiple of ``attn_every`` (weight reuse, no
  per-application LoRA, as the reference simplifies it);
* vlm (Qwen2-VL): the dense stack, with precomputed image-patch
  embeddings (the ViT is a stub) written over the token rows at
  ``img_pos``, and M-RoPE positions (B, S, 3);
* encdec (Whisper): an encoder of non-causal self-attention layers over
  precomputed frame embeddings (the audio frontend is a stub), and
  decoder layers of causal self-attention, cross-attention to the
  encoder's output and an MLP;
* falcon_h1 (Falcon-H1, no twin in the reference): parallel-hybrid
  layers (`ParallelHybridLayer`), GQA attention and the published
  Mamba-2 mixer side by side on one norm, then a SwiGLU MLP, with muP
  multipliers on every branch, on the embedded rows and on the logits.
  Trained only: its decoding raises (`check_decodes`).

The reference stacks every layer's weights along a leading layer axis and
scans over it (branching on the layer index with `lax.cond` in the
hybrid); here each layer is its own module and the host decides where
the shared block runs.  `params_from_jax` and `params_to_jax` carry
weights between the two layouts (JAX parameter tree <-> the module's
named parameters; ``layers`` and ``enc_layers`` are stacked,
``shared_attn`` is not), so a checkpoint written by either package loads
in the other (`ckpt/checkpoint.py`).

Training rematerialises each layer when ``forward`` is given ``remat``
(the train step's default, as the reference's): one layer is one
`torch.utils.checkpoint` unit, which keeps its inputs and recomputes its
body in the backward.  An attention family's layer, each `SSMLayer` (in
the hybrid with the shared block's application before it, as the
reference's scan body holds both) and the encoder-decoder's decoder
layer are units; the encoder and the embedding lookup stay outside
them, so the managed lookup runs once a step.  ``remat_policy`` "full"
saves only a unit's inputs; "dots" also keeps the outputs of products
without batch dimensions (`save_dots`), the reference's
``dots_with_no_batch_dims_saveable``; the decoder layer takes "full"
whatever the policy, as the reference's `_decoder_stack` does.

``forward`` returns ``(logits, aux, new_cache)`` like the reference
(``aux`` is the layers' summed MoE load-balance loss, zero without
experts; ``skip_head=True`` returns the final hidden state in place of
the logits, for `losses.vocab_parallel_ce`); ``loss_fn`` is its mean
cross-entropy.  Decoding passes a cache from `init_cache`, whose ``len``
is a host integer (the reference keeps a device scalar): the chunk's
positions and cache writes then need no device read.  The attention
families' caches hold k/v; the ssm family's the O(1) recurrent state (a
conv ring and ``h`` per layer, whatever ``max_seq``); the hybrid's both,
one KV cache per application of the shared block.  Every cache tensor is
written in place.  An encoder-decoder cache also holds ``enc_out``,
which the caller fills with `DenseLM.encode` before the prefill.

On the vocab-parallel mesh the model's ``embed`` is this rank's block of
the table (the training loop places it), and a checkpoint's ``embed``
leaves load as that block (`params_from_jax` with ``shard``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import block_rows, placements
from repro_torch.obs.trace import enter_phase
from repro_torch.pm.embedding import pm_lookup
from .layers import (_dense_init, attention_block, init_attention, init_mlp,
                     init_norm, mlp_block, norm)
from .layouts import (between_layers, laid_out_grad, reduce_partials,
                      reduce_partials_both_ways)
from .moe import init_moe, moe_block
from .ssm import (init_mamba1, init_mamba2, init_mamba2_mixer, mamba1_block,
                  mamba2_block, mamba2_mixer)

#: the recurrent families: `SSMLayer` trunks (the reference's `_ssm_stack`
#: and `_hybrid_stack`), decoded through an O(1) state
RECURRENT = ("ssm", "hybrid")

#: the families the port trains but does not decode (`check_decodes`)
TRAIN_ONLY = ("falcon_h1",)

#: the rematerialisation policies of `DenseLM.forward`'s ``remat_policy``
REMAT_POLICIES = ("full", "dots")

#: products without batch dimensions: the ops whose outputs "dots" keeps
#: (``x @ w`` with a 2-D weight reaches ``aten.mm``; ``bmm``, the
#: experts' products and attention's tiles are batched)
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy of a rematerialised unit, the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of `DOTS`, recompute every other op."""
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, policy: str, *args):
    """``fn(*args)`` as one rematerialised unit (non-reentrant
    `torch.utils.checkpoint`): autograd keeps ``args`` and, with the
    "dots" policy, the outputs of `save_dots`'s products, and recomputes
    the rest in the backward."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=partial(
                              create_selective_checkpoint_contexts,
                              save_dots))
    return checkpoint(fn, *args, use_reentrant=False)


def _params(d: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})


class DenseLayer(nn.Module):
    """One pre-norm decoder layer: attention and FFN sub-layers; the FFN
    is ``moe`` (a mixture of experts) when ``cfg.n_experts``, else
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype):
        super().__init__()
        with_bias = cfg.norm == "layernorm"
        dev = gen.device
        self.norm1 = _params(init_norm(cfg.d_model, dtype, with_bias, dev))
        self.attn = _params(init_attention(gen, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           dtype))
        self.norm2 = _params(init_norm(cfg.d_model, dtype, with_bias, dev))
        if cfg.n_experts:
            self.moe = _params(init_moe(gen, cfg.d_model, cfg.n_experts,
                                        cfg.moe_d_ff, dtype))
        else:
            self.mlp = _params(init_mlp(gen, cfg.d_model, cfg.d_ff,
                                        cfg.activation, dtype))

    def forward(self, h, cfg: ModelConfig, positions, cache=None,
                cache_len: Optional[int] = None, routes=None):
        """Returns ``(h, aux)``: ``aux`` the MoE load-balance loss (None
        without experts).  ``cache``: this layer's {k, v}, written in
        place."""
        a, _ = attention_block(
            norm(h, self.norm1, cfg.norm, cfg.norm_eps), self.attn, cfg,
            positions, cache=cache, cache_len=cache_len)
        h = h + a
        hn = norm(h, self.norm2, cfg.norm, cfg.norm_eps)
        if cfg.n_experts:
            m, aux, _ = moe_block(hn, self.moe, n_experts=cfg.n_experts,
                                  top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  routes=routes)
            return h + m, aux
        return h + mlp_block(hn, self.mlp, cfg.activation), None


class SSMLayer(nn.Module):
    """One pre-norm residual Mamba layer, no MLP: ``norm1`` (RMSNorm
    without bias, as the reference's) and ``mamba``, a Mamba-1 block
    (``cfg.ssm_version`` 1) or a Mamba-2 block."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype):
        super().__init__()
        self.norm1 = _params(init_norm(cfg.d_model, dtype, False,
                                       gen.device))
        if cfg.ssm_version == 1:
            mamba = init_mamba1(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                cfg.ssm_conv, cfg.dt_rank, dtype)
        else:
            mamba = init_mamba2(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                cfg.ssm_conv, cfg.ssm_head_dim, dtype)
        self.mamba = _params(mamba)

    def forward(self, h, cfg: ModelConfig, state=None):
        """``state``: this layer's (conv ring, h) of a decode cache, written
        in place with the state after the chunk."""
        hn = norm(h, self.norm1, cfg.norm, cfg.norm_eps)
        if cfg.ssm_version == 1:
            y, new = mamba1_block(hn, self.mamba, ssm_state=cfg.ssm_state,
                                  dt_rank=cfg.dt_rank, state=state)
        else:
            y, new = mamba2_block(hn, self.mamba, ssm_state=cfg.ssm_state,
                                  head_dim=cfg.ssm_head_dim, state=state)
        if state is not None:
            for old, t in zip(state, new):
                old.copy_(t)
        return h + y


class ParallelHybridLayer(nn.Module):
    """One Falcon-H1 layer, as the published implementation computes it:
    ``norm1`` (RMSNorm without bias) feeds the Mamba-2 mixer
    (``mamba``, `ssm.mamba2_mixer`) and GQA attention (``attn``, its
    input times ``attention_in_multiplier``) side by side; their outputs,
    times ``ssm_out_multiplier`` and ``attention_out_multiplier``, add
    into the residual.  Then ``norm2`` and a SwiGLU MLP (``mlp``) whose
    gate is scaled before the SiLU and whose output after ``w_down``, by
    ``mlp_multipliers``.  The layer names its branches to the step's
    phase listeners as it enters them (``forward/ssm``, ``forward/attn``,
    ``forward/mlp``), in a rematerialised layer's recompute too."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype):
        super().__init__()
        dev = gen.device
        self.norm1 = _params(init_norm(cfg.d_model, dtype, False, dev))
        self.mamba = _params(init_mamba2_mixer(
            gen, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv, dtype))
        self.attn = _params(init_attention(gen, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           dtype))
        self.norm2 = _params(init_norm(cfg.d_model, dtype, False, dev))
        self.mlp = _params(init_mlp(gen, cfg.d_model, cfg.d_ff, "swiglu",
                                    dtype))

    def forward(self, h, cfg: ModelConfig, positions):
        x = norm(h, self.norm1, "rmsnorm", cfg.norm_eps)
        enter_phase("forward/ssm")
        m = mamba2_mixer(x, self.mamba, n_groups=cfg.ssm_groups,
                         ssm_state=cfg.ssm_state,
                         in_multiplier=cfg.ssm_in_multiplier,
                         multipliers=cfg.ssm_multipliers, eps=cfg.norm_eps)
        enter_phase("forward/attn")
        a, _ = attention_block(x * cfg.attention_in_multiplier, self.attn,
                               cfg, positions)
        h = h + (m * cfg.ssm_out_multiplier
                 + a * cfg.attention_out_multiplier)
        enter_phase("forward/mlp")
        u = norm(h, self.norm2, "rmsnorm", cfg.norm_eps)
        gate, down = cfg.mlp_multipliers
        f = F.silu((u @ self.mlp["w_gate"]) * gate) * (u @ self.mlp["w_up"])
        return h + (f @ self.mlp["w_down"]) * down


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder layer's attention runs under: the encoder's
    heads (``d_model // n_heads`` wide, no GQA) and no window, as the
    reference's `_encoder` replaces them."""
    h = cfg.encoder.n_heads
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=h,
                               head_dim=cfg.d_model // h, sliding_window=0)


class EncDecLayer(nn.Module):
    """One layer of the encoder-decoder family, norms with bias as the
    reference's: self-attention (``norm1``, ``attn``), in the decoder
    then cross-attention to the encoder's output (``norm_x``,
    ``cross``), then the MLP (``norm2``, ``mlp``).  An encoder layer is
    built with `encoder_config`."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype,
                 cross: bool):
        super().__init__()
        D, dev = cfg.d_model, gen.device
        self.norm1 = _params(init_norm(D, dtype, True, dev))
        self.attn = _params(init_attention(gen, D, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           dtype))
        if cross:
            self.norm_x = _params(init_norm(D, dtype, True, dev))
            self.cross = _params(init_attention(gen, D, cfg.n_heads,
                                                cfg.n_heads, cfg.head_dim,
                                                dtype))
        self.norm2 = _params(init_norm(D, dtype, True, dev))
        self.mlp = _params(init_mlp(gen, D, cfg.d_ff, cfg.activation, dtype))

    def forward(self, h, cfg: ModelConfig, positions, enc_out=None,
                cache=None, cache_len: Optional[int] = None):
        """``enc_out`` (B, F, D): a decoder layer's encoder output (its
        self-attention is then causal; an encoder layer's is not).  The
        cross k/v are projected from it at every call, as the reference
        does."""
        a, _ = attention_block(
            norm(h, self.norm1, cfg.norm, cfg.norm_eps), self.attn, cfg,
            positions, cache=cache, cache_len=cache_len,
            causal=enc_out is not None)
        h = h + a
        if enc_out is not None:
            B, F = enc_out.shape[:2]
            H, hd = cfg.n_heads, cfg.head_dim
            # (a DTensor's two gradient shares reduced before autograd
            # sums them)
            ck = (laid_out_grad(enc_out, reduce_partials)
                  @ self.cross["wk"]).reshape(B, F, H, hd)
            cv = (laid_out_grad(enc_out, reduce_partials)
                  @ self.cross["wv"]).reshape(B, F, H, hd)
            x, _ = attention_block(
                norm(h, self.norm_x, cfg.norm, cfg.norm_eps), self.cross,
                cfg, positions, cross_kv=(ck, cv))
            h = h + x
        return h + mlp_block(norm(h, self.norm2, cfg.norm, cfg.norm_eps),
                             self.mlp, cfg.activation)


class DenseLM(nn.Module):
    """The LM of every family.  Parameters: ``embed`` (V, D), ``head``
    (D, V) unless tied, ``final_norm``, ``layers.<i>.*`` (`DenseLayer`s;
    ``layers.<i>.moe.*`` with experts: ``router`` (D, E), ``w_gate`` /
    ``w_up`` (E, D, F), ``w_down`` (E, F, D)).  The ssm and hybrid
    families' ``layers.<i>.*`` are `SSMLayer`s (``norm1``, ``mamba.*``),
    and the hybrid adds ``shared_attn.*``, one `DenseLayer`.  The
    encoder-decoder family's ``layers.<i>.*`` are decoder `EncDecLayer`s,
    and it adds ``enc_layers.<i>.*`` (encoder `EncDecLayer`s) and
    ``enc_norm``.  The falcon_h1 family's ``layers.<i>.*`` are
    `ParallelHybridLayer`s (``norm1``, ``mamba.*``, ``attn.*``, ``norm2``,
    ``mlp.*``)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        with_bias = cfg.norm == "layernorm"
        # draw order: embed, head, then the layers in order (the encoder's
        # after the decoder's, the hybrid's shared block last)
        self.embed = nn.Parameter(_dense_init(
            gen, (cfg.vocab_size, cfg.d_model), param_dtype, scale=0.02))
        self.final_norm = _params(init_norm(cfg.d_model, param_dtype,
                                            with_bias, gen.device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_dense_init(
                gen, (cfg.d_model, cfg.vocab_size), param_dtype))
        if cfg.family in RECURRENT:
            self.layers = nn.ModuleList(SSMLayer(cfg, gen, param_dtype)
                                        for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_attn = DenseLayer(cfg, gen, param_dtype)
            return
        if cfg.family == "falcon_h1":
            self.layers = nn.ModuleList(
                ParallelHybridLayer(cfg, gen, param_dtype)
                for _ in range(cfg.n_layers))
            return
        if cfg.family != "encdec":
            self.layers = nn.ModuleList(DenseLayer(cfg, gen, param_dtype)
                                        for _ in range(cfg.n_layers))
            return
        self.layers = nn.ModuleList(
            EncDecLayer(cfg, gen, param_dtype, cross=True)
            for _ in range(cfg.n_layers))
        ecfg = encoder_config(cfg)
        self.enc_layers = nn.ModuleList(
            EncDecLayer(ecfg, gen, param_dtype, cross=False)
            for _ in range(cfg.encoder.n_layers))
        self.enc_norm = _params(init_norm(cfg.d_model, param_dtype,
                                          with_bias, gen.device))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over ``frames`` (B, F, D): non-causal
        self-attention layers at RoPE positions 0 .. F - 1, then
        ``enc_norm``.  Returns ``enc_out`` (B, F, D), which a decode
        cache takes before the prefill (the reference's `_encoder`)."""
        cfg = self.cfg
        B, F, _ = frames.shape
        ecfg = encoder_config(cfg)
        positions = torch.arange(F, device=frames.device).expand(B, F)
        h = frames
        for layer in self.enc_layers:
            h = layer(between_layers(h), ecfg, positions)
        return norm(between_layers(h), self.enc_norm, cfg.norm,
                    cfg.norm_eps)

    def forward(self, batch: Dict[str, Any], cache: Optional[dict] = None,
                *, pm_miss_capacity: int = 0,
                pm_strict: bool = False, pm_kernel: bool = False,
                pm_backend=None, pm_residual=None,
                embed_rows: Optional[torch.Tensor] = None,
                head_last_only: bool = False, skip_head: bool = False,
                routes: Optional[list] = None, remat: bool = False,
                remat_policy: str = "full", fsdp_spec=None):
        """Returns (logits, aux_loss, new_cache), or with ``skip_head``
        (the final hidden state (B, S, D), aux_loss, new_cache).  A
        configuration's ``embedding_multiplier`` scales the embedded
        rows, and its ``lm_head_multiplier`` the final hidden state (so
        the logits; the state ``skip_head`` returns too).

        ``cache``: a decode cache from `init_cache` whose ``len`` already
        counts this chunk; the chunk sits at positions ``[len - S, len)``,
        its k/v are written into the cache's tensors in place, and
        ``new_cache`` is the same dict (None without a cache).  The
        encoder-decoder family reads the encoder's output from the
        cache's ``enc_out``, and without a cache runs the encoder on
        ``batch["frames"]``.
        ``head_last_only``: the head runs on the last position only.
        ``routes``: a list to which each MoE layer appends its
        `moe.Routing` (once, with ``remat`` too).
        ``remat``: each layer a rematerialised unit with ``remat_policy``
        ("full" or "dots", `REMAT_POLICIES`); never with a cache, as the
        reference passes ``remat and cache is None``.
        ``fsdp_spec``: the FSDP gather (the reference's `_constrain`): a
        spec per parameter of one layer of ``layers``, named relative to
        the layer (`launch.sharding.param_pspecs`); each layer's DTensor
        weights are redistributed to those placements as the layer runs
        (inside its rematerialised unit), so the layer gathers its
        ZeRO-sharded weights instead of its activations.  None: nothing.

        batch: ``tokens`` (B, S) int, optional ``positions`` ((B, S), or
        (B, S, 3) for M-RoPE; by default the chunk's positions, the same
        on all three coordinates), the vlm family's ``img_embeds``
        (B, n, D) written over the token rows at ``img_pos`` (B, n), the
        encoder-decoder family's ``frames`` (B, F, D), and the managed
        embedding's replica cache ``pm_cache_ids`` / ``pm_cache_rows``
        (active when ``pm_miss_capacity > 0``), with the host's
        unique-miss count ``pm_n_miss`` and the mesh's routed block
        ``pm_route_cap`` where the loop knows them.
        ``pm_residual``: the step's precomputed `step_residual`.
        ``embed_rows``: already-gathered (B, S, D) token rows; skips the
        embedding lookup (the fused sparse step differentiates with
        respect to these rows instead of the table)."""
        cfg = self.cfg
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        if cache is not None:
            check_decodes(cfg)
        remat = remat and cache is None
        tokens = batch["tokens"]
        B, S = tokens.shape
        if embed_rows is not None:
            h = embed_rows
        elif pm_miss_capacity > 0 and "pm_cache_ids" in batch:
            h = pm_lookup(self._table(), batch["pm_cache_ids"],
                          batch["pm_cache_rows"], tokens, pm_miss_capacity,
                          pm_strict, pm_kernel, pm_backend, pm_residual,
                          batch.get("pm_n_miss"), batch.get("pm_route_cap", 0))
        elif isinstance(self.embed, DTensor):
            # DTensor's rule for a vocab-sharded lookup (the plain index
            # has none) leaves masked partial sums, reduced here once:
            # DTensor keeps their mask for one reduction only
            h = reduce_partials_both_ways(
                F.embedding(tokens.long(), self._table()))
        else:
            h = self.embed[tokens.long()]
        if cfg.family == "vlm" and "img_embeds" in batch:
            # out of place: ``embed_rows`` may be a leaf that requires
            # grad; the overwritten token rows get zero gradient
            rows = torch.arange(B, device=h.device)[:, None]
            h = h.index_put((rows, batch["img_pos"].long()),
                            batch["img_embeds"].to(h.dtype))
        if cfg.embedding_multiplier != 1.0:
            h = h * cfg.embedding_multiplier
        positions = batch.get("positions")
        if positions is None:
            start = 0 if cache is None else cache["len"] - S
            positions = torch.arange(start, start + S,
                                     device=tokens.device).expand(B, S)
            if cfg.mrope:
                positions = positions[..., None].expand(B, S, 3)
        policy = remat_policy if remat else None
        layers = [gathered(layer, fsdp_spec) for layer in self.layers]
        if cfg.family in RECURRENT:
            h = self._recurrent(layers, h, positions, cache, policy)
            aux = torch.zeros((), dtype=h.dtype, device=h.device)
        elif cfg.family == "falcon_h1":
            h = self._parallel(layers, h, positions, policy)
            aux = torch.zeros((), dtype=h.dtype, device=h.device)
        else:
            h, aux = self._attention(layers, batch, h, positions, cache,
                                     routes, policy)
        h = norm(between_layers(h), self.final_norm, cfg.norm, cfg.norm_eps)
        if cfg.lm_head_multiplier != 1.0:
            h = h * cfg.lm_head_multiplier
        if head_last_only:
            h = h[:, -1:]
        if skip_head:
            return h, aux, cache
        head = self._table().T if cfg.tie_embeddings else self.head
        return h @ head, aux, cache

    def _table(self):
        """``embed``; a DTensor table's gradient from each use (the lookup,
        a tied head) with its partial sums reduced before autograd adds
        the two (DTensor cannot add them laid out apart)."""
        return laid_out_grad(self.embed, reduce_partials)

    def _attention(self, layers, batch, h, positions, cache, routes,
                   policy=None):
        """The attention families' stack over ``layers`` (`self.layers`,
        or callables that run them); returns (h, summed MoE aux).
        The encoder-decoder decoder attends to the encoder's output: the
        cache's ``enc_out``, or without a cache the encoder run over
        ``batch["frames"]``.  ``policy``: each layer a rematerialised
        unit with this policy (None: none; the decoder layer's is
        "full")."""
        cfg = self.cfg
        cache_len = None if cache is None else cache["len"]
        aux = torch.zeros((), dtype=h.dtype, device=h.device)
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self.encode(batch["frames"]) if cache is None \
                else cache["enc_out"]
        for i, layer in enumerate(layers):
            h = between_layers(h)
            kv = None if cache is None else \
                {"k": cache["k"][i], "v": cache["v"][i]}
            # each decoder layer's share of the encoder output's gradient
            # laid out alike before autograd sums the shares (DTensor)
            enc = None if enc_out is None else between_layers(enc_out)
            if enc is not None and policy:
                h = remat_call(partial(_decoder_layer, layer, cfg,
                                       positions), "full", h, enc)
                continue
            if enc is not None:
                h = layer(h, cfg, positions, enc, kv, cache_len)
                continue
            if policy:
                h, aux_l = remat_call(_first_routes(layer, cfg, positions,
                                                    routes), policy, h)
            else:
                h, aux_l = layer(h, cfg, positions, kv, cache_len, routes)
            if aux_l is not None:
                aux = aux + aux_l
        return h, aux

    def _recurrent(self, layers, h, positions, cache, policy=None):
        """The ssm / hybrid trunk over ``layers`` (`self.layers`, or
        callables that run them): `SSMLayer`s in order, the hybrid's
        ``shared_attn`` before layer ``i`` when ``i % attn_every == 0``
        (its application ``i // attn_every``, with that application's KV
        cache).  With a cache, each layer reads and writes its (conv,
        h) state in place.  ``policy``: each layer, with the shared
        block's application before it, a rematerialised unit with this
        policy (None: none)."""
        cfg = self.cfg
        every = cfg.attn_every                   # 0 in the ssm family
        for i, layer in enumerate(layers):
            h = between_layers(h)
            if policy:
                h = remat_call(partial(self._recurrent_unit, layer,
                                       positions,
                                       bool(every) and i % every == 0),
                               policy, h)
                continue
            if every and i % every == 0:
                app = i // every
                kv = None if cache is None else \
                    {"k": cache["attn_k"][app], "v": cache["attn_v"][app]}
                h, _ = self.shared_attn(
                    h, cfg, positions, kv,
                    None if cache is None else cache["len"])
                h = between_layers(h)
            state = None if cache is None else \
                (cache["conv"][i], cache["h"][i])
            h = layer(h, cfg, state)
        return h

    def _parallel(self, layers, h, positions, policy=None):
        """The falcon_h1 trunk over ``layers``: `ParallelHybridLayer`s in
        order, each a rematerialised unit with ``policy`` (None: none)."""
        for layer in layers:
            h = between_layers(h)
            if policy:
                h = remat_call(partial(layer, cfg=self.cfg,
                                       positions=positions), policy, h)
            else:
                h = layer(h, self.cfg, positions)
        return h

    def _recurrent_unit(self, layer, positions, shared: bool, h):
        """One training layer of the recurrent trunk (no cache): the
        shared block first when ``shared``, then ``layer``."""
        if shared:
            h, _ = self.shared_attn(h, self.cfg, positions)
            h = between_layers(h)
        return layer(h, self.cfg)


def gathered(layer: nn.Module, fsdp_spec):
    """``layer``, or with ``fsdp_spec`` a callable that runs it on its
    DTensor weights redistributed to the spec's placements (the FSDP
    gather, differentiable: its backward scatters the gradients back);
    plain weights stay as they are."""
    if fsdp_spec is None:
        return layer

    def run(*args, **kwargs):
        params = {n: p.redistribute(p.device_mesh,
                                    placements(fsdp_spec[n], p.device_mesh))
                  if isinstance(p, DTensor) else p
                  for n, p in layer.named_parameters()}
        return functional_call(layer, params, args, kwargs)
    return run


def _decoder_layer(layer, cfg: ModelConfig, positions, h, enc_out):
    """An encoder-decoder decoder layer as a function of (h, enc_out)."""
    return layer(h, cfg, positions, enc_out)


def _first_routes(layer, cfg: ModelConfig, positions, routes):
    """A `DenseLayer` as a function of ``h`` that hands ``routes`` to its
    first call only: a rematerialised MoE layer runs again in the
    backward and must append its `moe.Routing` once."""
    calls = []

    def run(h):
        calls.append(None)
        return layer(h, cfg, positions,
                     routes=routes if len(calls) == 1 else None)
    return run


def check_decodes(cfg: ModelConfig) -> None:
    """Raises `NotImplementedError` for a family the port trains only
    (`TRAIN_ONLY`): its decode cache, prefill and serving step are not
    written."""
    if cfg.family in TRAIN_ONLY:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is trained only; its "
            f"decode cache, prefill and serving step are not written")


def n_attn_apps(cfg: ModelConfig) -> int:
    """How many times the shared attention block runs (hybrid)."""
    return -(-cfg.n_layers // cfg.attn_every) if cfg.attn_every else 0


def cache_seq_len(cfg: ModelConfig, max_seq: int) -> int:
    """KV caches are bounded by the sliding window when one exists."""
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    """An empty decode cache, ``len`` 0 (a host integer), with the
    reference's tensors:

    * attention families: ``k`` / ``v`` of (L, B, S, KvH, hd), S =
      `cache_seq_len` — with a sliding window at most the window, and a
      chunk that would end past S raises (`layers.attention_block`); the
      encoder-decoder family's also holds ``enc_out`` (B, n_frames, D),
      zeros until the caller writes the encoder's output there
      (`DenseLM.encode`);
    * ssm: ``conv`` (L, B, K-1, d_inner) and ``h`` (L, B, d_inner, N) in
      fp32, whatever ``max_seq``;
    * hybrid: ``conv``, ``h`` (L, B, nh, hd, N) in fp32, and ``attn_k`` /
      ``attn_v`` (A, B, S, KvH, hd), one per application of the shared
      block (`n_attn_apps`).

    ``device`` None: ``cuda``, which raises without a card.  A family
    the port trains only raises (`check_decodes`)."""
    check_decodes(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    kv = (batch, cache_seq_len(cfg, max_seq), cfg.n_kv_heads, cfg.head_dim)
    cache: Dict[str, Any] = {"len": 0}
    if cfg.family in RECURRENT:
        cache["conv"] = zeros(L, batch, cfg.ssm_conv - 1, cfg.d_inner)
        if cfg.family == "ssm":
            cache["h"] = zeros(L, batch, cfg.d_inner, cfg.ssm_state,
                               dt=torch.float32)
            return cache
        cache["h"] = zeros(L, batch, cfg.d_inner // cfg.ssm_head_dim,
                           cfg.ssm_head_dim, cfg.ssm_state, dt=torch.float32)
        cache["attn_k"] = zeros(n_attn_apps(cfg), *kv)
        cache["attn_v"] = zeros(n_attn_apps(cfg), *kv)
        return cache
    cache["k"] = zeros(L, *kv)
    cache["v"] = zeros(L, *kv)
    if cfg.family == "encdec":
        cache["enc_out"] = zeros(batch, cfg.encoder.n_frames, cfg.d_model)
    return cache


def init_model(cfg: ModelConfig, gen: torch.Generator,
               param_dtype=torch.float32) -> DenseLM:
    """A freshly initialized model on ``gen``'s device.  torch's generator
    draws other numbers than ``jax.random`` from the same seed: to start
    both packages from the same weights, carry them across
    (`params_from_jax` / `load_params`)."""
    return DenseLM(cfg, gen, param_dtype)


def loss_fn(logits, labels, aux=0.0, aux_weight: float = 0.01):
    """Mean cross-entropy (+ MoE load-balance aux).  The label log-prob is
    a gather; the reference's one-hot mask-and-reduce sums the same
    single term."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    if isinstance(lg, DTensor):
        # the reference's one-hot mask-and-reduce: vocab-sharded logits
        # then sum their shards' terms (DTensor's gather leaves partial
        # sums it cannot reduce)
        hit = labels.long()[..., None] == torch.arange(lg.shape[-1],
                                                       device=lg.device)
        ll = (lg * hit).sum(dim=-1)
    else:
        ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll) + aux_weight * aux

# ------------------------------------------------------- the weight carrier


#: the stacked layer groups of the reference's tree (`params_to_jax`)
STACKS = ("layers", "enc_layers")


def params_to_jax(named: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's parameter tree from the port's named parameters
    (or from any dict keyed like them, such as optimizer state): nested
    dicts by name, with ``layers.<i>.<rest>`` and ``enc_layers.<i>.<rest>``
    stacked along a leading layer axis as the reference stores them.
    Leaves stay tensors."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[Tuple[str, str], Dict[int, Any]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in STACKS:
            per_layer.setdefault((parts[0], ".".join(parts[2:])), {})[
                int(parts[1])] = t
            continue
        _put(tree, parts, t)
    for (stack, rest), ts in per_layer.items():
        if sorted(ts) != list(range(len(ts))):
            raise KeyError(f"{stack}.*.{rest}: layers {sorted(ts)} are not "
                           f"0 .. {len(ts) - 1}")
        _put(tree, [stack] + rest.split("."),
             torch.stack([ts[i] for i in range(len(ts))]))
    return tree


def params_from_jax(tree: Mapping[str, Any],
                    shard: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, Any]:
    """The port's named parameters from the reference's parameter tree
    (leaves as numpy arrays or tensors): the stacked ``layers`` and
    ``enc_layers`` leaves are split into ``<stack>.<i>.<rest>``.  The
    inverse of `params_to_jax`.  ``shard=(rank, n)``: the ``embed`` leaf
    becomes the rows rank ``rank`` of ``n`` owns on the vocab-parallel
    mesh (a view of them)."""
    out: Dict[str, Any] = {}
    for path, leaf in _leaves(tree):
        if path == ("embed",) and shard is not None:
            out["embed"] = leaf[block_rows(leaf.shape[0], *shard)]
        elif path[0] in STACKS:
            rest = ".".join(path[1:])
            for i in range(leaf.shape[0]):
                out[f"{path[0]}.{i}.{rest}"] = leaf[i]
        else:
            out[".".join(path)] = leaf
    return out


def load_params(model: DenseLM, named: Mapping[str, Any]) -> DenseLM:
    """Copy weights (numpy arrays or tensors, keyed as the model's named
    parameters) into ``model`` in place."""
    own = dict(model.named_parameters())
    if set(own) != set(named):
        raise KeyError(f"parameter names differ: "
                       f"{sorted(set(own) ^ set(named))}")
    with torch.no_grad():
        for name, p in own.items():
            v = named[name]
            v = torch.from_numpy(np.ascontiguousarray(v)) \
                if isinstance(v, np.ndarray) else v
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(v.shape)} vs {tuple(p.shape)}")
            p.copy_(v)
    return model


def _put(tree: Dict[str, Any], parts, leaf) -> None:
    for k in parts[:-1]:
        tree = tree.setdefault(k, {})
    tree[parts[-1]] = leaf


def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree
