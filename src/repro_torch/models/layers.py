"""Core transformer layers of the dense and MoE families (the twin of
`repro/models/layers.py`): ``init_*`` builds a parameter dict from a
`torch.Generator`, the other functions consume one.  Weights keep the
reference's layout (``x @ w`` with ``w`` of shape (in, out)), so they
cross between the packages unchanged.

Plain torch throughout: the reference computes all of this outside any
Pallas kernel.  Without a cache, `attention` is masked softmax attention
over the whole sequence; the reference's blocked online-softmax
`flash_attention` gives the same result (at the training shapes it runs
one query block and one key block).  With a KV cache, `attention_block`
writes the chunk's k/v into it and `decode_attention` attends to the
cached prefix (the fused prefill and the one-token decode step).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]

# --------------------------------------------------------------------- init


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return (w.normal_(generator=gen) * scale).to(dtype)


def init_norm(d: int, dtype, with_bias: bool,
              device) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype) -> Dict[str, torch.Tensor]:
    return {
        "wq": _dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": _dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wv": _dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wo": _dense_init(gen, (n_heads * head_dim, d_model), dtype),
    }


def init_mlp(gen, d_model: int, d_ff: int, activation: str,
             dtype) -> Dict[str, torch.Tensor]:
    if activation == "swiglu":
        return {
            "w_gate": _dense_init(gen, (d_model, d_ff), dtype),
            "w_up": _dense_init(gen, (d_model, d_ff), dtype),
            "w_down": _dense_init(gen, (d_ff, d_model), dtype),
        }
    return {
        "w_in": _dense_init(gen, (d_model, d_ff), dtype),
        "w_out": _dense_init(gen, (d_ff, d_model), dtype),
    }

# -------------------------------------------------------------------- norms


def norm(x, p: Params, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:  # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)

# --------------------------------------------------------------------- rope


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (B, S) ints.  Returns (cos, sin) of shape
    (B, S, head_dim // 2), float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, head_dim); cos/sin: (B, S, head_dim // 2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

# ---------------------------------------------------------------- attention


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def attention(q, k, v, *, causal: bool, window: int = 0):
    """Masked softmax attention.  q: (B, S, H, d); k, v: (B, S, KvH, d)
    (GQA: H % KvH == 0).  ``window`` > 0 restricts each query to the last
    ``window`` positions.  Scores and sums in fp32; fully masked rows give
    zeros, as the reference's guarded softmax does."""
    B, S, H, hd = q.shape
    k = _repeat_kv(k, H // k.shape[2])
    v = _repeat_kv(v, H // v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(hd))
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1).clamp(min=1e-20)                        # (B,H,Q)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window: int = 0):
    """Chunked attention against a KV cache.

    q: (B, Sq, H, d); caches: (B, S, KvH, d); ``cache_len``: the valid
    prefix length (the chunk's k/v already written at ``cache_len - Sq``).
    Causal within the chunk: query i sits at position ``cache_len - Sq +
    i`` and attends to the positions at or before its own, within the
    last ``window`` when ``window`` > 0.  Sq = 1 is the one-token decode
    step, Sq > 1 the fused prefill.  Scores and softmax in fp32."""
    B, Sq, H, hd = q.shape
    S = k_cache.shape[1]
    k = _repeat_kv(k_cache, H // k_cache.shape[2])
    v = _repeat_kv(v_cache, H // v_cache.shape[2])
    pos = torch.arange(S, device=q.device)
    q_pos = cache_len - Sq + torch.arange(Sq, device=q.device)
    valid = pos[None, :] <= q_pos[:, None]
    if window:
        valid &= pos[None, :] > (q_pos[:, None] - window)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    return o.to(q.dtype)


def attention_block(x, p: Params, cfg, positions, *, cache=None,
                    cache_len: Optional[int] = None, causal: bool = True):
    """Full attention sub-layer: projections + rope + attention + output.
    Returns ``(out, cache)``.

    ``cache``: a dict {k, v} of (B, S_cache, KvH, hd) for decoding, with
    ``cache_len`` the prefix length including this chunk.  The chunk's
    k/v are written in place at ``[cache_len - S, cache_len)`` and the
    queries attend to the cached prefix (`decode_attention`).  A chunk
    that does not fit the cache raises: the reference's
    `dynamic_update_slice` clamps the write index instead, so past a
    sliding-window cache it overwrites the last slots where a rolling
    cache would be needed."""
    B, S, D = x.shape
    H, KvH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KvH, hd)
    v = (x @ p["wv"]).reshape(B, S, KvH, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is None:
        o = attention(q, k, v, causal=causal, window=cfg.sliding_window)
    else:
        S_cache = cache["k"].shape[1]
        idx = cache_len - S
        if idx < 0 or cache_len > S_cache:
            raise ValueError(
                f"a {S}-token chunk ending at position {cache_len} does not "
                f"fit the {S_cache}-position KV cache (a sliding-window "
                f"cache holds the first {S_cache} positions and does not "
                f"roll)")
        cache["k"][:, idx:cache_len] = k
        cache["v"][:, idx:cache_len] = v
        o = decode_attention(q, cache["k"][:, :cache_len],
                             cache["v"][:, :cache_len], cache_len,
                             window=cfg.sliding_window)
    return o.reshape(B, S, H * hd) @ p["wo"], cache

# --------------------------------------------------------------------- mlp


def mlp_block(x, p: Params, activation: str):
    if activation == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_in"]
    if activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif activation == "relu2":
        h = torch.square(F.relu(h))     # Nemotron-4 squared-ReLU
    else:
        raise ValueError(activation)
    return h @ p["w_out"]
