"""Model assembly for the dense family (the twin of
`repro/models/model.py`): a pre-norm GQA transformer as an `nn.Module`.

The reference stacks every layer's weights along a leading layer axis and
scans over it; here each layer is its own module.  `params_from_jax` and
`params_to_jax` carry weights between the two layouts (JAX parameter tree
<-> the module's named parameters), so a checkpoint written by either
package loads in the other (`ckpt/checkpoint.py`).

``forward`` returns ``(logits, aux, None)`` like the reference (``aux`` is
the MoE load-balance loss, zero for the dense family; ``skip_head=True``
returns the final hidden state in place of the logits, for
`losses.vocab_parallel_ce`); ``loss_fn`` is its mean cross-entropy.

On the vocab-parallel mesh the model's ``embed`` is this rank's block of
the table (the training loop places it), and a checkpoint's ``embed``
leaves load as that block (`params_from_jax` with ``shard``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.sharding import block_rows
from repro_torch.pm.embedding import pm_lookup
from .layers import (_dense_init, attention_block, init_attention, init_mlp,
                     init_norm, mlp_block, norm)


def _params(d: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in d.items()})


class DenseLayer(nn.Module):
    """One pre-norm decoder layer: attention and MLP sub-layers."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype):
        super().__init__()
        with_bias = cfg.norm == "layernorm"
        dev = gen.device
        self.norm1 = _params(init_norm(cfg.d_model, dtype, with_bias, dev))
        self.attn = _params(init_attention(gen, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           dtype))
        self.norm2 = _params(init_norm(cfg.d_model, dtype, with_bias, dev))
        self.mlp = _params(init_mlp(gen, cfg.d_model, cfg.d_ff,
                                    cfg.activation, dtype))

    def forward(self, h, cfg: ModelConfig, positions):
        h = h + attention_block(norm(h, self.norm1, cfg.norm, cfg.norm_eps),
                                self.attn, cfg, positions)
        return h + mlp_block(norm(h, self.norm2, cfg.norm, cfg.norm_eps),
                             self.mlp, cfg.activation)


class DenseLM(nn.Module):
    """Decoder-only LM of the dense family.  Parameters: ``embed`` (V, D),
    ``head`` (D, V) unless tied, ``final_norm``, ``layers.<i>.*``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 param_dtype=torch.float32):
        super().__init__()
        if cfg.family != "dense" or cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.arch_id}: family {cfg.family!r} is not ported to "
                f"PyTorch yet (the port runs the dense family)")
        self.cfg = cfg
        with_bias = cfg.norm == "layernorm"
        # draw order: embed, head, then the layers in order
        self.embed = nn.Parameter(_dense_init(
            gen, (cfg.vocab_size, cfg.d_model), param_dtype, scale=0.02))
        self.final_norm = _params(init_norm(cfg.d_model, param_dtype,
                                            with_bias, gen.device))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_dense_init(
                gen, (cfg.d_model, cfg.vocab_size), param_dtype))
        self.layers = nn.ModuleList(DenseLayer(cfg, gen, param_dtype)
                                    for _ in range(cfg.n_layers))

    def forward(self, batch: Dict[str, Any], *, pm_miss_capacity: int = 0,
                pm_strict: bool = False, pm_kernel: bool = False,
                pm_backend=None, pm_residual=None,
                embed_rows: Optional[torch.Tensor] = None,
                skip_head: bool = False):
        """Returns (logits, aux_loss, None), or with ``skip_head`` (the
        final hidden state (B, S, D), aux_loss, None).

        batch: ``tokens`` (B, S) int, optional ``positions`` (B, S), and
        the managed embedding's replica cache ``pm_cache_ids`` /
        ``pm_cache_rows`` (active when ``pm_miss_capacity > 0``), with the
        host's unique-miss count ``pm_n_miss`` and the mesh's routed block
        ``pm_route_cap`` where the loop knows them.
        ``pm_residual``: the step's precomputed `step_residual`.
        ``embed_rows``: already-gathered (B, S, D) token rows; skips the
        embedding lookup (the fused sparse step differentiates with
        respect to these rows instead of the table)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        if embed_rows is not None:
            h = embed_rows
        elif pm_miss_capacity > 0 and "pm_cache_ids" in batch:
            h = pm_lookup(self.embed, batch["pm_cache_ids"],
                          batch["pm_cache_rows"], tokens, pm_miss_capacity,
                          pm_strict, pm_kernel, pm_backend, pm_residual,
                          batch.get("pm_n_miss"), batch.get("pm_route_cap", 0))
        else:
            h = self.embed[tokens.long()]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        for layer in self.layers:
            h = layer(h, cfg, positions)
        h = norm(h, self.final_norm, cfg.norm, cfg.norm_eps)
        aux = torch.zeros((), dtype=h.dtype, device=h.device)
        if skip_head:
            return h, aux, None
        head = self.embed.T if cfg.tie_embeddings else self.head
        return h @ head, aux, None


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
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll) + aux_weight * aux

# ------------------------------------------------------- the weight carrier


def params_to_jax(named: Mapping[str, Any], n_layers: int) -> Dict[str, Any]:
    """The reference's parameter tree from the port's named parameters
    (or from any dict keyed like them, such as optimizer state): nested
    dicts by name, with ``layers.<i>.<rest>`` stacked along a leading
    layer axis as the reference stores them.  Leaves stay tensors."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(".".join(parts[2:]), [None] * n_layers)[
                int(parts[1])] = t
            continue
        _put(tree, parts, t)
    for rest, ts in per_layer.items():
        _put(tree, ["layers"] + rest.split("."), torch.stack(ts))
    return tree


def params_from_jax(tree: Mapping[str, Any],
                    shard: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, Any]:
    """The port's named parameters from the reference's parameter tree
    (leaves as numpy arrays or tensors): the stacked ``layers`` leaves are
    split into ``layers.<i>.<rest>``.  The inverse of `params_to_jax`.
    ``shard=(rank, n)``: the ``embed`` leaf becomes the rows rank ``rank``
    of ``n`` owns on the vocab-parallel mesh (a view of them)."""
    out: Dict[str, Any] = {}
    for path, leaf in _leaves(tree):
        if path == ("embed",) and shard is not None:
            out["embed"] = leaf[block_rows(leaf.shape[0], *shard)]
        elif path[0] == "layers":
            rest = ".".join(path[1:])
            for i in range(leaf.shape[0]):
                out[f"layers.{i}.{rest}"] = leaf[i]
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
