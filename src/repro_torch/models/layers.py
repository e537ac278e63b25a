"""Core transformer layers (the twin of `repro/models/layers.py`):
``init_*`` builds a parameter dict from a `torch.Generator`, the other
functions consume one.  Weights keep the reference's layout (``x @ w``
with ``w`` of shape (in, out)), so they cross between the packages
unchanged.

Plain torch throughout: the reference computes all of this outside any
Pallas kernel.  Without a cache, attention is `flash_attention`: the
reference's blocked online softmax (q blocks of 512 against kv blocks of
1024), so a long prefill holds one tile of scores at a time, never the
(S x S) matrix.  With a KV cache, `attention_block` writes the chunk's
k/v into it and `decode_attention` attends to the cached prefix (the
fused prefill and the one-token decode step).  Cross-attention (the
encoder-decoder family) takes the encoder's k/v through ``cross_kv``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .layouts import laid_out_grad, whole_along, whole_heads

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


def rope_angles(positions, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None):
    """positions: (B, S) ints, or (B, S, 3) for M-RoPE (t/h/w
    coordinates).  Returns (cos, sin) of shape (B, S, head_dim // 2),
    float32.

    M-RoPE (Qwen2-VL): the frequency bands are split into three sections
    of ``mrope_sections`` bands, driven by the temporal, height and width
    coordinate respectively."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** exps)
    if mrope_sections is None:
        pos = positions.float()[..., None]                    # (B,S,1)
    else:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"cover the {half} frequency bands")
        # band i's section, computed on the device (a host list moved
        # there would wait for the device's queue)
        band = torch.arange(half, device=positions.device)
        t, h, _ = mrope_sections
        sec_id = (band >= t).long() + (band >= t + h).long()
        pos = positions.float()[..., sec_id]                  # (B,S,half)
    ang = pos * inv_freq
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
    out = k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)
    # the backward splits the heads into (h, n_rep) again
    return laid_out_grad(out, lambda g: whole_along(g, 2, h))


def _block_attn(q, k, v, mask, scale):
    """One (q-block, kv-block) tile, heads leading: q (B, H, Q, d), k, v
    (B, H, K, d), ``mask`` (Q, K) bool or None (every pair visible).
    Returns the un-normalized (o (B, H, Q, d), m (B, H, Q), l (B, H, Q))
    in fp32, ``m`` floored at 0 where a row is fully masked.

    ``m`` is taken without gradient: the attention's value does not
    depend on it (it cancels between ``o`` and ``l``), so the gradient is
    the same function's, and autograd keeps the tile's probabilities but
    not its raw scores."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.detach().amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m[..., None])          # masked scores give exp(-inf)
    o = torch.matmul(p.to(v.dtype), v).float()
    return o, m, p.sum(dim=-1)


def flash_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, q_block: int = 512,
                    kv_block: int = 1024):
    """Blocked attention with an online softmax, the reference's
    algorithm.

    q: (B, Sq, H, d); k, v: (B, Skv, KvH, d) (GQA: H % KvH == 0; Sq may
    differ from Skv, as in cross-attention).  ``q_offset``: the absolute
    position of q[0] (keys sit at 0 .. Skv - 1).  ``window`` > 0
    restricts each query to the last ``window`` positions.  Scores in
    fp32; the running max starts at 0 and is floored there (the
    reference's ``m_safe``), so a fully masked row comes out as zeros.

    Two departures, both exact: the last q and kv blocks are sliced
    ragged instead of padded, and a tile that masks every pair (wholly
    above the causal diagonal, or wholly out of the window's reach) is
    skipped: with m >= 0 it would give m_j = l_j = o_j = 0 and add
    nothing.  A tile that masks no pair builds no mask."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q, k, v = whole_heads(q), whole_heads(k), whole_heads(v)
    qh = q.transpose(1, 2)                                    # (B,H,Sq,d)
    kh = _repeat_kv(k, H // k.shape[2]).transpose(1, 2)
    vh = _repeat_kv(v, H // v.shape[2]).transpose(1, 2)
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_block):
        q1 = min(q0 + q_block, Sq)
        first, last = q_offset + q0, q_offset + q1 - 1        # positions
        qp = torch.arange(first, last + 1, device=dev)[:, None]
        # from ``qh``: a DTensor's accumulators are DTensors too
        o = qh.new_zeros((B, H, q1 - q0, hd), dtype=torch.float32)
        m = qh.new_zeros((B, H, q1 - q0), dtype=torch.float32)
        l = torch.zeros_like(m)
        for k0 in range(0, Skv, kv_block):
            k1 = min(k0 + kv_block, Skv)
            if causal and k0 > last:
                break                        # this and every later tile
            if window and first - (k1 - 1) >= window:
                continue                     # wholly out of reach
            mask = None
            if (causal and k1 - 1 > first) or \
                    (window and last - k0 >= window):
                kp = torch.arange(k0, k1, device=dev)[None, :]
                mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                                  device=dev)
                if causal:
                    mask &= qp >= kp
                if window:
                    mask &= (qp - kp) < window
            o_j, m_j, l_j = _block_attn(qh[:, :, q0:q1], kh[:, :, k0:k1],
                                        vh[:, :, k0:k1], mask, scale)
            m_new = torch.maximum(m, m_j)
            a = torch.exp(m - m_new)
            b = torch.exp(m_j - m_new)
            o = o * a[..., None] + o_j * b[..., None]
            l = l * a + l_j * b
            m = m_new
        outs.append(o / l.clamp(min=1e-20)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    # the backward's tile products need the gradient's heads whole too
    return laid_out_grad(out.transpose(1, 2).to(q.dtype), whole_heads)


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
    q = whole_heads(q)
    k = _repeat_kv(whole_heads(k_cache), H // k_cache.shape[2])
    v = _repeat_kv(whole_heads(v_cache), H // v_cache.shape[2])
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


def split_heads(t, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor is gathered along the
    split dimension first where ``n`` does not divide among its shards,
    and so is its gradient before the backward merges it again."""
    B, S = t.shape[:2]
    if not isinstance(t, DTensor):
        return t.reshape(B, S, n, hd)
    t = whole_along(t, t.ndim - 1, n)
    return laid_out_grad(t.reshape(B, S, n, hd),
                         lambda g: whole_along(g, 2, n))


def merge_heads(t):
    """(B, S, n, hd) -> (B, S, n * hd), the inverse of `split_heads`."""
    B, S, n = t.shape[:3]
    if not isinstance(t, DTensor):
        return t.reshape(B, S, -1)
    t = whole_along(t, 2, n)
    return laid_out_grad(t.reshape(B, S, -1),
                         lambda g: whole_along(g, 2, n))


def write_chunk(cache: torch.Tensor, t: torch.Tensor, idx: int) -> None:
    """``cache[:, idx:idx + S] = t`` in place (t: (B, S, ...)).  A DTensor
    cache takes one-token chunks, written by a select over the positions:
    a slice along a sharded dimension would be gathered and the write
    lost."""
    S = t.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, idx:idx + S] = t
        return
    if S != 1:
        raise NotImplementedError("a DTensor cache takes one-token chunks")
    pos = torch.arange(cache.shape[1], device=cache.device) == idx
    cache.copy_(torch.where(pos.view((1, -1) + (1,) * (t.ndim - 2)), t,
                            cache))


def attention_block(x, p: Params, cfg, positions, *, cache=None,
                    cache_len: Optional[int] = None, cross_kv=None,
                    causal: bool = True):
    """Full attention sub-layer: projections + rope + attention + output.
    Returns ``(out, cache)``.  The keys are scaled by
    ``cfg.key_multiplier`` (before RoPE and the ``1 / sqrt(hd)`` of the
    scores; 1 but in Falcon-H1).

    ``positions``: (B, S), or (B, S, 3) with ``cfg.mrope`` (M-RoPE).
    ``cross_kv``: the encoder side's (k, v), each (B, F, H, hd), for
    cross-attention: no rope, no cache, no mask.
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
    q = split_heads(x @ p["wq"], H, hd)
    if cross_kv is not None:
        o = flash_attention(q, *cross_kv, causal=False)
        return merge_heads(o) @ p["wo"], cache
    k = split_heads(x @ p["wk"], KvH, hd)
    if cfg.key_multiplier != 1.0:                    # Falcon-H1's muP
        k = k * cfg.key_multiplier
    v = split_heads(x @ p["wv"], KvH, hd)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta,
                           cfg.mrope_sections if cfg.mrope else None)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is None:
        o = flash_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window)
    else:
        S_cache = cache["k"].shape[1]
        idx = cache_len - S
        if idx < 0 or cache_len > S_cache:
            raise ValueError(
                f"a {S}-token chunk ending at position {cache_len} does not "
                f"fit the {S_cache}-position KV cache (a sliding-window "
                f"cache holds the first {S_cache} positions and does not "
                f"roll)")
        for name, t in (("k", k), ("v", v)):
            write_chunk(cache[name], t, idx)
        # a full cache is read whole (a DTensor sharded along the
        # positions cannot be sliced along them)
        o = decode_attention(q, *(cache[n] if cache_len == S_cache
                                  else cache[n][:, :cache_len]
                                  for n in ("k", "v")), cache_len,
                             window=cfg.sliding_window)
    return merge_heads(o) @ p["wo"], cache

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
