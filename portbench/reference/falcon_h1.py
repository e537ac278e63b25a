"""Plain reference of the falcon_h1 family (Falcon-H1-34B): parallel-hybrid
layers, an untied head, mean cross-entropy.  fp32 throughout; written in
plain torch ops from the published implementation (transformers'
``models/falcon_h1/modeling_falcon_h1.py``: `FalconH1DecoderLayer`,
`FalconH1Mixer`, `FalconH1Attention`, `FalconH1MLP`) and the Mamba-2
paper (arXiv:2405.21060), with the port's conventions where they leave
a choice:

* weights ``x @ w`` with ``w`` (in, out); RMSNorm without a bias;
* a layer: ``x = rmsnorm(h)``; ``h += mixer(x) * ssm_out +
  attn(x * attn_in) * attn_out``; ``h += mlp(rmsnorm(h))``;
* attention: GQA, keys times ``key_multiplier``, rotary angles ``pos /
  theta ** (2i / hd)`` on the two halves of each head, scores over
  ``sqrt(hd)``, causal softmax;
* the MLP ``(up(u) * silu(gate(u) * m0)) @ w_down * m1``;
* the mixer: ``in_proj`` of ``x * ssm_in``, its z, x, B, C and dt
  sections times the five ``ssm_multipliers``; a causal depthwise
  convolution with bias over x, B and C (`F.conv1d`), then SiLU; ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)`` per head; the SSD
  recurrence ``h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_{g,t}``, ``y_t =
  C_{g,t} h_t + D_h x_t`` (each head reads its group's B and C); the
  gated RMSNorm ``rmsnorm(y * silu(z))`` over each group of channels;
  ``out_proj``;
* the embedded rows times ``embedding_multiplier``; the final hidden
  state times ``lm_head_multiplier``, which `steps.loss_of`'s ``h @
  head`` then carries into the logits (``(m h) W = m (h W)``);
* labels are the tokens shifted left by one, the last wrapping around.

The recurrence is the paper's chunked SSD form (``ssd_minimal_discrete``,
chunks of `CHUNK` positions: the quadratic form within a chunk, the
states passed from chunk to chunk), which the program does not use: its
mixer runs the states one position after another, 16 at a time
(`repro_torch.models.ssm.grouped_scan`), so agreement checks that
decomposition too.

`init_leaves` draws the initial weights in the order, shapes and scales
the port's ``init_model`` does, from the same generator.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .dense import normal, rotary

#: positions a chunk of the SSD form
CHUNK = 256


def dims(cfg: dict):
    """(D, di, nh, hd of the mixer, G, N, K, conv channels C)."""
    D, nh, hd = cfg["d_model"], cfg["ssm_heads"], cfg["ssm_head_dim"]
    G, N = cfg["ssm_groups"], cfg["ssm_state"]
    di = nh * hd
    return D, di, nh, hd, G, N, cfg["ssm_conv"], di + 2 * G * N


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once per token: each
    layer's ``in_proj`` and ``out_proj``, q, k, v and o, the MLP's three
    matrices, and the head (the convolution and the scan are
    elementwise; the embedding is a lookup)."""
    D, di, nh, _, _, _, _, C = dims(cfg)
    H, KvH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    layer = D * (di + C + nh) + di * D \
        + D * H * hd + 2 * D * KvH * hd + H * hd * D \
        + 3 * D * cfg["d_ff"]
    return cfg["n_layers"] * layer + D * cfg["vocab_size"]


def attention_flops(cfg: dict, B: int, S: int) -> float:
    """Forward and backward of causal attention's score and value
    products (2 products x 2 FLOPs a multiply-add x 3), over the half of
    the (S x S) square at or below the diagonal, at ``n_heads x
    head_dim``."""
    return cfg["n_layers"] * 6.0 * B * S * S * cfg["n_heads"] \
        * cfg["head_dim"]


def init_leaves(cfg: dict, gen: torch.Generator
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, initial tensor) in the order the weights are drawn."""
    if cfg.get("tie_embeddings"):
        raise NotImplementedError("the falcon_h1 reference is untied")
    D, di, nh, _, _, _, K, C = dims(cfg)
    V, F_, dev = cfg["vocab_size"], cfg["d_ff"], gen.device
    H, KvH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    yield "embed", normal(gen, (V, D), 0.02)
    yield "final_norm.scale", torch.ones(D, device=dev)
    yield "head", normal(gen, (D, V), 1 / math.sqrt(D))
    a_log = torch.from_numpy(np.log(np.arange(1, nh + 1, dtype=np.float32)))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}"
        yield f"{p}.norm1.scale", torch.ones(D, device=dev)
        m = f"{p}.mamba"
        yield f"{m}.in_proj", normal(gen, (D, di + C + nh), 1 / math.sqrt(D))
        yield f"{m}.conv_w", normal(gen, (C, K), 0.5)
        yield f"{m}.conv_b", torch.zeros(C, device=dev)
        yield f"{m}.dt_bias", torch.full((nh,), -4.6, device=dev)
        yield f"{m}.A_log", a_log.to(dev).clone()   # a leaf per layer
        yield f"{m}.D_skip", torch.ones(nh, device=dev)
        yield f"{m}.norm_scale", torch.ones(di, device=dev)
        yield f"{m}.out_proj", normal(gen, (di, D), 1 / math.sqrt(di))
        for name, shape in (("wq", (D, H * hd)), ("wk", (D, KvH * hd)),
                            ("wv", (D, KvH * hd)), ("wo", (H * hd, D))):
            yield f"{p}.attn.{name}", normal(gen, shape,
                                             1 / math.sqrt(shape[0]))
        yield f"{p}.norm2.scale", torch.ones(D, device=dev)
        for name, shape in (("w_gate", (D, F_)), ("w_up", (D, F_)),
                            ("w_down", (F_, D))):
            yield f"{p}.mlp.{name}", normal(gen, shape,
                                            1 / math.sqrt(shape[0]))


def rms(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def segsum(x):
    """(..., T) -> (..., T, T): ``out[..., i, j] = sum_{j < k <= i} x[k]``
    at and below the diagonal, -inf above it."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                     diagonal=-1)
    s = torch.cumsum(x.masked_fill(~low, 0.0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(X, A, Bm, Cm, chunk: int = CHUNK):
    """The Mamba-2 paper's ``ssd_minimal_discrete`` from zero states:
    X (b, l, h, p) the inputs times dt, A (b, l, h) dt times A, Bm, Cm
    (b, l, h, n).  Returns Y (b, l, h, p)."""
    b, L, h, p = X.shape
    c = -(-L // chunk)
    pad = c * chunk - L
    if pad:     # trailing zeros: A = 0 keeps the states, X = 0 adds none
        X, A, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                        for t in (X, A, Bm, Cm))
    X, Bm, Cm = (t.reshape(b, c, chunk, h, t.shape[-1]) for t in (X, Bm, Cm))
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b,h,c,l)
    A_cum = torch.cumsum(A, dim=-1)
    # 1. within each chunk (the diagonal blocks)
    L_ = torch.exp(segsum(A))                                  # (b,h,c,l,s)
    scores = torch.einsum("bclhn,bcshn->bhcls", Cm, Bm) * L_
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, X)
    # 2. each chunk's final state from its own inputs
    decay = torch.exp(A_cum[..., -1:] - A_cum)                 # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, decay, X)
    # 3. the states carried across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. each chunk's output from the state it starts with
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, states,
                         torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, c * chunk, h, p)[:, :L]


def mixer(x, P, m: str, cfg: dict):
    _, di, nh, hd, G, N, K, C = dims(cfg)
    b, S, _ = x.shape
    z0, x0, b0, c0, dt0 = cfg["ssm_multipliers"]
    zxbcdt = (x * cfg["ssm_in_multiplier"]) @ P[f"{m}.in_proj"]
    z, xs, Bm, Cm, dt = zxbcdt.split([di, di, G * N, G * N, nh], dim=-1)
    xbc = torch.cat([xs * x0, Bm * b0, Cm * c0], dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), P[f"{m}.conv_w"][:, None, :],
                   P[f"{m}.conv_b"], padding=K - 1, groups=C)[..., :S]
    xs, Bm, Cm = F.silu(xbc.transpose(1, 2)).split([di, G * N, G * N], -1)
    dt = F.softplus(dt * dt0 + P[f"{m}.dt_bias"])               # (b,S,nh)
    A = -torch.exp(P[f"{m}.A_log"])
    xh = xs.reshape(b, S, nh, hd)
    # each head reads its group's B and C
    Bh, Ch = (t.reshape(b, S, G, N).repeat_interleave(nh // G, dim=2)
              for t in (Bm, Cm))
    y = ssd(xh * dt[..., None], dt * A, Bh, Ch)
    y = (y + P[f"{m}.D_skip"][:, None] * xh).reshape(b, S, di)
    y = (y * F.silu(z * z0)).reshape(b, S, G, di // G)
    y = rms(y, 1.0, cfg.get("norm_eps", 1e-5)).reshape(b, S, di)
    return (y * P[f"{m}.norm_scale"]) @ P[f"{m}.out_proj"]


def attention(x, P, p: str, cfg: dict):
    B, S, _ = x.shape
    H, KvH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pos = torch.arange(S, device=x.device)
    theta = cfg["rope_theta"]
    q = rotary((x @ P[f"{p}.wq"]).view(B, S, H, hd), pos, theta)
    k = rotary((x @ P[f"{p}.wk"]).view(B, S, KvH, hd)
               * cfg["key_multiplier"], pos, theta)
    v = (x @ P[f"{p}.wv"]).view(B, S, KvH, hd)
    k = k.repeat_interleave(H // KvH, dim=2)
    v = v.repeat_interleave(H // KvH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, H * hd)
    return o @ P[f"{p}.wo"]


def mlp(u, P, p: str, cfg: dict):
    gate, down = cfg["mlp_multipliers"]
    f = F.silu((u @ P[f"{p}.w_gate"]) * gate) * (u @ P[f"{p}.w_up"])
    return (f @ P[f"{p}.w_down"]) * down


def layer(h, P, i: int, cfg: dict):
    p, eps = f"layers.{i}", cfg.get("norm_eps", 1e-5)
    x = rms(h, P[f"{p}.norm1.scale"], eps)
    h = h + (mixer(x, P, f"{p}.mamba", cfg) * cfg["ssm_out_multiplier"]
             + attention(x * cfg["attention_in_multiplier"], P,
                         f"{p}.attn", cfg)
             * cfg["attention_out_multiplier"])
    return h + mlp(rms(h, P[f"{p}.norm2.scale"], eps), P, f"{p}.mlp", cfg)


def hidden(h, P, cfg: dict):
    """The trunk over the embedded tokens ``h`` (B, S, D), times the
    embedding multiplier, each layer recomputed in the backward, then the
    final norm, times the head multiplier."""
    h = h * cfg["embedding_multiplier"]
    for i in range(cfg["n_layers"]):
        h = checkpoint(layer, h, P, i, cfg, use_reentrant=False)
    return rms(h, P["final_norm.scale"], cfg.get("norm_eps", 1e-5)) \
        * cfg["lm_head_multiplier"]
