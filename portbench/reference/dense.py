"""Plain reference of the dense family (nemotron-4-15b): a pre-norm
decoder of GQA attention with rotary positions and an MLP, an untied
head, mean cross-entropy.  fp32 throughout; written from the published
description in plain torch ops, with the port's conventions where the
description leaves a choice:

* weights ``x @ w`` with ``w`` (in, out); q/k/v/o without bias;
* rotary angles ``pos / theta ** (2i / hd)``, applied to the two halves
  of each head (``x1 * cos - x2 * sin``, ``x2 * cos + x1 * sin``);
* LayerNorm with a bias (``norm`` "layernorm") or RMSNorm without one;
* the MLP ``relu(x @ w_in) ** 2 @ w_out`` (Nemotron-4's squared ReLU),
  ``gelu`` (tanh form) or SwiGLU;
* labels are the tokens shifted left by one, the last wrapping around.

`init_leaves` draws the initial weights in the order, shapes and scales
the port's ``init_model`` does, from the same generator: the reference
starts where the program starts without reading the program's tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once per token: the layers'
    projections and the head (the embedding is a lookup, not a
    product)."""
    if cfg.get("n_experts"):
        raise NotImplementedError("the dense reference has no experts")
    D, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    H, KvH, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    mult = 3 if cfg["activation"] == "swiglu" else 2
    layer = D * H * hd + 2 * D * KvH * hd + H * hd * D \
        + mult * D * cfg["d_ff"]
    return L * layer + D * V


def attention_flops(cfg: dict, B: int, S: int) -> float:
    """Forward and backward of causal attention's score and value
    products: 2 products x 2 FLOPs a multiply-add x 3 (forward, two
    backward products), over the half of the (S x S) square at or below
    the diagonal."""
    width = cfg["n_heads"] * head_dim(cfg)
    return cfg["n_layers"] * 6.0 * B * S * S * width


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return w.normal_(generator=gen) * scale


def _norm_leaves(prefix: str, cfg: dict, dev) -> Iterator:
    D = cfg["d_model"]
    yield f"{prefix}.scale", torch.ones(D, device=dev)
    if cfg["norm"] == "layernorm":
        yield f"{prefix}.bias", torch.zeros(D, device=dev)


def init_leaves(cfg: dict, gen: torch.Generator
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, initial tensor) in the order the weights are drawn."""
    if cfg.get("tie_embeddings") or cfg.get("n_experts"):
        raise NotImplementedError("the dense reference is untied, "
                                  "without experts")
    D, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    H, KvH, hd, F_ = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg), \
        cfg["d_ff"]
    dev = gen.device
    yield "embed", normal(gen, (V, D), 0.02)
    yield from _norm_leaves("final_norm", cfg, dev)
    yield "head", normal(gen, (D, V), 1 / math.sqrt(D))
    for i in range(L):
        p = f"layers.{i}"
        yield from _norm_leaves(f"{p}.norm1", cfg, dev)
        for name, shape in (("wq", (D, H * hd)), ("wk", (D, KvH * hd)),
                            ("wv", (D, KvH * hd)), ("wo", (H * hd, D))):
            yield f"{p}.attn.{name}", normal(gen, shape,
                                             1 / math.sqrt(shape[0]))
        yield from _norm_leaves(f"{p}.norm2", cfg, dev)
        if cfg["activation"] == "swiglu":
            mlp = (("w_gate", (D, F_)), ("w_up", (D, F_)),
                   ("w_down", (F_, D)))
        else:
            mlp = (("w_in", (D, F_)), ("w_out", (F_, D)))
        for name, shape in mlp:
            yield f"{p}.mlp.{name}", normal(gen, shape,
                                            1 / math.sqrt(shape[0]))


def norm(x, P: Dict[str, torch.Tensor], prefix: str, cfg: dict):
    eps = cfg.get("norm_eps", 1e-5)
    if cfg["norm"] == "layernorm":
        return F.layer_norm(x, (x.shape[-1],), P[f"{prefix}.scale"],
                            P[f"{prefix}.bias"], eps)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * P[f"{prefix}.scale"]


def rotary(x, pos, theta: float):
    """x (B, S, H, hd), pos (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device,
                                       dtype=torch.float32) / half)
    ang = pos.float()[:, None] * inv                      # (S, half)
    c, s = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(x, P, p: str, cfg: dict):
    B, S, D = x.shape
    H, KvH, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    pos = torch.arange(S, device=x.device)
    theta = cfg.get("rope_theta", 10000.0)
    q = rotary((x @ P[f"{p}.wq"]).view(B, S, H, hd), pos, theta)
    k = rotary((x @ P[f"{p}.wk"]).view(B, S, KvH, hd), pos, theta)
    v = (x @ P[f"{p}.wv"]).view(B, S, KvH, hd)
    rep = H // KvH
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, H * hd)
    return o @ P[f"{p}.wo"]


def mlp(x, P, p: str, cfg: dict):
    act = cfg["activation"]
    if act == "swiglu":
        return (F.silu(x @ P[f"{p}.w_gate"]) * (x @ P[f"{p}.w_up"])) \
            @ P[f"{p}.w_down"]
    h = x @ P[f"{p}.w_in"]
    h = torch.relu(h).square() if act == "relu2" else \
        F.gelu(h, approximate="tanh")
    return h @ P[f"{p}.w_out"]


def layer(h, P, i: int, cfg: dict):
    p = f"layers.{i}"
    h = h + attention(norm(h, P, f"{p}.norm1", cfg), P, f"{p}.attn", cfg)
    return h + mlp(norm(h, P, f"{p}.norm2", cfg), P, f"{p}.mlp", cfg)


def hidden(h, P, cfg: dict):
    """The trunk over the embedded tokens ``h`` (B, S, D), each layer
    recomputed in the backward (memory, not arithmetic), then the final
    norm."""
    for i in range(cfg["n_layers"]):
        h = checkpoint(layer, h, P, i, cfg, use_reentrant=False)
    return norm(h, P, "final_norm", cfg)
