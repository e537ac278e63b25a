"""State-space blocks (the twin of `repro/models/ssm.py`): Mamba-1
(selective scan, falcon-mamba), a simplified Mamba-2 / SSD block (the
zamba2 trunk) and, with no twin in the reference, the published Mamba-2
mixer of Falcon-H1 (`mamba2_mixer`, below).  The reference is plain `jnp`: no Pallas kernel computes
any of it.  Mamba-1's training and prefill go through
`kernels.selective_scan`: on the card a CUDA kernel that keeps the states
in registers; on CPU tensors and DTensors its plain version
(`kernels/ref.py::selective_scan_ref`: ``a`` and ``b`` materialised, then
`linear_scan`), the arithmetic of this module's own Mamba-2 path.

Mamba-2's training and prefill run the linear recurrence ``h_t = a_t *
h_{t-1} + b_t`` through `linear_scan`, the reference's chunked scan as a
`torch.autograd.Function`: within a chunk a log-depth (Hillis-Steele)
doubling scan with `_scan_op`'s algebra, across chunks a loop that
carries ``h``.  Its backward is the same scan reversed in time, so it
saves only ``a``, ``h`` and ``h0``: a chain of torch ops would keep every
doubling level's (B, S, ..., N) operands for the backward, about 2 log2
(chunk) tensors of the states' size per layer.  A ragged last chunk is
scanned at its own length; the reference pads it with identity elements
(``a = 1``, ``b = 0``) after its last position, which changes no earlier
position.  ``a`` may broadcast against ``b``: Mamba-2's per-head decay
stays (B, S, nh, 1, 1), the same products as the reference's
materialised ``a_full`` without a (B, S, nh, hd, N) copy.

Decoding passes ``state`` = (conv ring (B, K-1, C), h).  A one-token
step is the reference's single recurrence step ``a_0 * h + b_0``; a
longer chunk (the fused prefill) runs the scan seeded with the state's
``h``, and its causal conv reads the state's ring in place of
zero padding.  Both write the state back: the final ``h`` and the last
K-1 conv inputs.  The reference's prefill of these families instead runs
the prompt one position at a time (`repro/train/steps.py`,
``prefill_scan``); the chunk gives the same values up to rounding.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ref import selective_scan_ref
from ..kernels.selective_scan import N_STATES, selective_scan
from .layers import _dense_init
from .layouts import reduce_partials

Params = Dict[str, torch.Tensor]


def _scan_chunk(a, b, reverse: bool):
    """In place over one chunk (time on axis 1): (a, b) become the
    cumulative compositions of `repro.models.ssm._scan_op`, from the
    chunk's start (or, ``reverse``, from its end) to each position."""
    C, d = b.shape[1], 1
    while d < C:
        if reverse:
            b[:, :-d] += a[:, :-d] * b[:, d:]
            a[:, :-d] = a[:, :-d] * a[:, d:]
        else:
            b[:, d:] += a[:, d:] * b[:, :-d]
            a[:, d:] = a[:, d:] * a[:, :-d]
        d *= 2
    return a, b


def _chunked(a, b, h0, chunk: int, reverse: bool = False):
    """h_t = a_t * h_{t-1} + b_t over axis 1, seeded with ``h0``, chunk by
    chunk.  ``reverse``: the backward's recurrence, from the end, which
    reads the next position's decay: h_t = a_{t+1} * h_{t+1} + b_t (with
    a_S = 1 and h_S = ``h0``).  Returns h (the shape of ``b``)."""
    S = b.shape[1]
    chunk = max(1, min(chunk, S))
    starts = range(0, S, chunk)
    # DTensor operands may hold partial sums, which the in-place adds
    # below cannot take
    b, carry = reduce_partials(b), reduce_partials(h0)
    out = torch.empty_like(b)
    for c0 in (reversed(starts) if reverse else starts):
        c1 = min(c0 + chunk, S)
        ac = a[:, c0 + 1:c1 + 1] if reverse else a[:, c0:c1]
        ac = torch.cat([ac, torch.ones_like(a[:, :1])], dim=1) \
            if reverse and c1 == S else ac.clone()
        a_cum, b_cum = _scan_chunk(ac, b[:, c0:c1].clone(), reverse)
        h = b_cum.add_(a_cum * carry.unsqueeze(1))
        out[:, c0:c1] = h
        carry = h[:, 0] if reverse else h[:, -1]
    return out


def _sum_to(x, shape):
    """``x`` summed over the dimensions where ``shape`` broadcasts."""
    dims = tuple(i for i, (n, m) in enumerate(zip(x.shape, shape))
                 if m == 1 and n != 1)
    return x.sum(dim=dims, keepdim=True) if dims else x


class LinearScan(torch.autograd.Function):
    """`linear_scan`'s autograd: the forward saves ``a``, ``h`` and
    ``h0``; the backward runs the reversed scan
    ``g_t = dL/dh_t + a_{t+1} g_{t+1}`` (seeded with the final state's
    gradient), then ``db_t = g_t``, ``da_t = g_t h_{t-1}`` (summed over
    ``a``'s broadcast dimensions) and ``dh0 = a_0 g_0``."""

    @staticmethod
    def forward(ctx, a, b, h0, chunk: int):
        with torch.no_grad():
            h = _chunked(a, b, h0, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(a, h, h0)
        return h, h[:, -1].clone()

    @staticmethod
    def backward(ctx, g_h, g_last):
        a, h, h0 = ctx.saved_tensors
        g = _chunked(a, g_h, g_last, ctx.chunk, reverse=True)
        da = dh0 = None
        if ctx.needs_input_grad[0]:
            h_prev = torch.cat([h0.unsqueeze(1), h[:, :-1]], dim=1)
            da = _sum_to(h_prev.mul_(g), a.shape)
        if ctx.needs_input_grad[2]:
            dh0 = a[:, 0] * g[:, 0]
        return da, g, dh0, None


def linear_scan(a, b, h0, chunk: int):
    """h_t = a_t * h_{t-1} + b_t along axis 1 (time), the reference's
    `_chunked_linear_scan`.  a: broadcastable against b (B, S, ...); h0:
    (B, ...).  Returns (h (B, S, ...), h_final (B, ...))."""
    return LinearScan.apply(a, b, h0, chunk)


def _causal_conv(x, w, b, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x: (B, S, C); w: (C, K); b: (C,).

    Without ``state`` the sequence is padded with K-1 zeros (the training
    path) and the new state is None.  With ``state`` (B, K-1, C), the
    conv ring of a decode cache, the sequence is padded with the state,
    so a chunk of any length continues the sequence the state ends; the
    new state is the last K-1 inputs.  Returns (y, new_state)."""
    K = w.shape[1]
    B, S, C = x.shape
    pad = state if state is not None else x.new_zeros((B, K - 1, C))
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + S] * w[:, i] for i in range(K)) + b
    return y, (xp[:, S:] if state is not None else None)

# ------------------------------------------------------------------ mamba 1


def init_mamba1(gen: torch.Generator, d_model: int, d_inner: int,
                ssm_state: int, conv: int, dt_rank: int, dtype) -> Params:
    dev = gen.device
    return {
        "in_proj": _dense_init(gen, (d_model, 2 * d_inner), dtype),
        "conv_w": _dense_init(gen, (d_inner, conv), dtype, scale=0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "x_proj": _dense_init(gen, (d_inner, dt_rank + 2 * ssm_state),
                              dtype),
        "dt_proj": _dense_init(gen, (dt_rank, d_inner), dtype),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=dtype, device=dev),
        # log(1..N) on the host, as numpy rounds it (the reference's
        # value; torch's log differs in the last bit at 7)
        "A_log": torch.from_numpy(np.log(np.arange(
            1, ssm_state + 1, dtype=np.float32))).to(dev, dtype).expand(
            d_inner, ssm_state).contiguous(),
        "D_skip": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": _dense_init(gen, (d_inner, d_model), dtype),
    }


def _recur(a, b, state, scan_chunk: int):
    """The states h (B, S, ...) and the final state: from zeros over the
    whole sequence without ``state``; with it, from the state's ``h`` (one
    recurrence step at S = 1, as the reference's decode)."""
    if state is None:
        h0 = b.new_zeros((b.shape[0],) + b.shape[2:], dtype=torch.float32)
        return linear_scan(a, b, h0, scan_chunk)
    if b.shape[1] == 1:
        h = a[:, 0] * state[1] + b[:, 0]
        return h[:, None], h
    return linear_scan(a, b, state[1], scan_chunk)


def mamba1_block(x, p: Params, *, ssm_state: int, dt_rank: int,
                 state: Optional[Tuple] = None):
    """x: (B, S, D).  ``state`` = (conv_state (B,K-1,di), h (B,di,N)) for
    decoding.  Returns (out, new_state), new_state None without a state."""
    N = ssm_state
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)                             # (B,S,di)

    x_c, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                 None if state is None else state[0])
    x_c = F.silu(x_c)

    # a DTensor product over d_inner leaves partial sums: reduced once
    dbc = reduce_partials(x_c @ p["x_proj"])
    dt, Bmat, Cmat = dbc.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])         # (B,S,di)
    A = -torch.exp(p["A_log"].float())                        # (di,N)

    # a decode step stays the reference's single step ``a_0 h + b_0``
    scan = (selective_scan_ref if state is not None and x.shape[1] == 1
            else selective_scan)
    xf = x_c.float()
    y, new_h = scan(xf, dt.float(), A, Bmat.float(), Cmat.float(),
                    p["D_skip"].float(), None if state is None else state[1])
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    return out, (None if state is None else (new_conv, new_h))

# ------------------------------------------------------------------ mamba 2


def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int,
                ssm_state: int, conv: int, head_dim: int, dtype) -> Params:
    nh = d_inner // head_dim
    dev = gen.device
    return {
        "in_proj": _dense_init(gen, (d_model, 2 * d_inner), dtype),
        "conv_w": _dense_init(gen, (d_inner, conv), dtype, scale=0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "dt_proj": _dense_init(gen, (d_model, nh), dtype),
        "dt_bias": torch.full((nh,), -4.6, dtype=dtype, device=dev),
        "B_proj": _dense_init(gen, (d_model, ssm_state), dtype),
        "C_proj": _dense_init(gen, (d_model, ssm_state), dtype),
        "A_log": torch.zeros((nh,), dtype=dtype, device=dev),
        "D_skip": torch.ones((nh,), dtype=dtype, device=dev),
        "out_proj": _dense_init(gen, (d_inner, d_model), dtype),
    }


def mamba2_block(x, p: Params, *, ssm_state: int, head_dim: int,
                 state: Optional[Tuple] = None, scan_chunk: int = 64):
    """Simplified SSD: scalar decay per head.  x: (B, S, D).  ``state`` =
    (conv_state (B,K-1,di), h (B,nh,hd,N)) for decoding.  Returns (out,
    new_state), new_state None without a state."""
    B, S, _ = x.shape
    xz = x @ p["in_proj"]
    x_in, z = xz.chunk(2, dim=-1)
    di = x_in.shape[-1]
    hd = head_dim
    nh = di // hd

    x_c, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                 None if state is None else state[0])
    x_c = F.silu(x_c)

    dt = F.softplus(x @ p["dt_proj"] + p["dt_bias"])          # (B,S,nh)
    Bmat = x @ p["B_proj"]                                    # (B,S,N)
    Cmat = x @ p["C_proj"]                                    # (B,S,N)
    A = -torch.exp(p["A_log"].float())                        # (nh,)

    dtf = dt.float()
    a = torch.exp(dtf * A)[..., None, None]                   # (B,S,nh,1,1)
    xh = x_c.reshape(B, S, nh, hd).float()
    # b_t = dt * x_t (outer) B_t : (B,S,nh,hd,N)
    b = (dtf[..., None, None] * xh[..., None]
         * Bmat.float()[:, :, None, None, :])
    h, new_h = _recur(a, b, state, scan_chunk)

    y = torch.einsum("bshdn,bsn->bshd", h, Cmat.float())
    y = y + p["D_skip"].float()[:, None] * xh
    y = y.reshape(B, S, di).to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    return out, (None if state is None else (new_conv, new_h))

# ------------------------------------------- mamba 2, grouped (falcon-h1)


def init_mamba2_mixer(gen: torch.Generator, d_model: int, n_heads: int,
                      head_dim: int, n_groups: int, ssm_state: int,
                      conv: int, dtype) -> Params:
    """The weights of `mamba2_mixer`, di = ``n_heads * head_dim`` and C =
    di + 2 G N conv channels: ``in_proj`` (D, di + C + nh) gives z (di),
    x, B and C (the conv's channels) and dt (nh); ``conv_w`` (C, K) and
    ``conv_b`` (C,); ``dt_bias``, ``A_log`` (log 1 .. nh, as Mamba-2
    starts) and ``D_skip`` per head; the gated norm's ``norm_scale``
    (di); ``out_proj`` (di, D)."""
    di = n_heads * head_dim
    C = di + 2 * n_groups * ssm_state
    dev = gen.device
    return {
        "in_proj": _dense_init(gen, (d_model, di + C + n_heads), dtype),
        "conv_w": _dense_init(gen, (C, conv), dtype, scale=0.5),
        "conv_b": torch.zeros((C,), dtype=dtype, device=dev),
        "dt_bias": torch.full((n_heads,), -4.6, dtype=dtype, device=dev),
        "A_log": torch.from_numpy(np.log(np.arange(
            1, n_heads + 1, dtype=np.float32))).to(dev, dtype),
        "D_skip": torch.ones((n_heads,), dtype=dtype, device=dev),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": _dense_init(gen, (di, d_model), dtype),
    }


def grouped_scan(x, dt, A, Bm, Cm, n_groups: int):
    """Mamba-2's recurrence with grouped B/C, without the skip: for each
    channel c of head h in group g, ``h_t = exp(dt_{t,h} A_h) h_{t-1} +
    dt_{t,h} x_{t,c} B_{t,g}`` from zeros and ``y_{t,c} = sum_n C_{t,g,n}
    h_{t,n}``.

    The states are independent, so this is `selective_scan` (Mamba-1's
    kernel) with the decay shared across a head's channels: one call per
    group and slice of `N_STATES` states, over the group's channels,
    with ``delta`` the head's dt on each of its channels and ``A`` the
    head's A on each channel and state; the slices' outputs add.

    x (B, S, di); dt (B, S, nh); A (nh,); Bm, Cm (B, S, G N) with N a
    multiple of `N_STATES`.  Returns y (B, S, di)."""
    B, S, di = x.shape
    nh = dt.shape[-1]
    N = Bm.shape[-1] // n_groups
    if N % N_STATES or di % n_groups or nh % n_groups:
        raise ValueError(f"grouped_scan: a state of {N} is not slices of "
                         f"{N_STATES}, or {di} channels and {nh} heads do "
                         f"not split into {n_groups} groups")
    per, k = di // n_groups, N // N_STATES
    delta = dt.repeat_interleave(di // nh, dim=-1)             # (B,S,di)
    a = A.repeat_interleave(di // nh)                          # (di,)
    # every slice's B and C made contiguous in one copy each (and their
    # gradients stacked back in one op), where slicing each call's
    # operands would copy, and in the backward scatter, 2 G k times
    Bs, Cs = (t.reshape(B, S, n_groups * k, N_STATES).permute(2, 0, 1, 3)
              .contiguous().unbind(0) for t in (Bm, Cm))
    no_skip = x.new_zeros(per)
    ys = []
    for g in range(n_groups):
        ch = slice(g * per, (g + 1) * per)
        # one copy a group, shared by its slices' calls
        u, d = x[..., ch].contiguous(), delta[..., ch].contiguous()
        a_g = a[ch, None].expand(per, N_STATES).contiguous()
        y = None
        for j in range(g * k, (g + 1) * k):
            y_s, _ = selective_scan(u, d, a_g, Bs[j], Cs[j], no_skip)
            y = y_s if y is None else y + y_s
        ys.append(y)
    return torch.cat(ys, dim=-1)


def mamba2_mixer(x, p: Params, *, n_groups: int, ssm_state: int,
                 in_multiplier: float, multipliers, eps: float):
    """Falcon-H1's Mamba-2 mixer (training, no decode state), as the
    published implementation computes it: x (B, S, D) times
    ``in_multiplier``, then ``in_proj``, whose z, x, B, C and dt sections
    are scaled by ``multipliers`` (five, in that order); a causal
    depthwise conv with bias, then SiLU, over x, B and C; ``dt =
    softplus(dt + dt_bias)`` (unclamped); `grouped_scan`, plus
    ``D_skip x``; the gated RMSNorm, the gate before the norm:
    ``rmsnorm(y * silu(z))`` over each of the ``n_groups`` groups of
    channels, times ``norm_scale``; then ``out_proj``."""
    B, S, _ = x.shape
    nh, di = p["dt_bias"].shape[0], p["norm_scale"].shape[0]
    GN = n_groups * ssm_state
    mup = torch.cat([x.new_full((n,), m) for n, m
                     in zip((di, di, GN, GN, nh), multipliers)])
    zxbcdt = ((x * in_multiplier) @ p["in_proj"]) * mup
    z, xbc, dt = zxbcdt.split([di, di + 2 * GN, nh], dim=-1)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = F.silu(xbc).split([di, GN, GN], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                         # (B,S,nh)
    A = -torch.exp(p["A_log"].float())                         # (nh,)
    y = grouped_scan(xs, dt, A, Bm, Cm, n_groups)
    y = y + xs * p["D_skip"].repeat_interleave(di // nh)
    y = (y * F.silu(z)).reshape(B, S, n_groups, di // n_groups)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y.reshape(B, S, di) * p["norm_scale"]) @ p["out_proj"]
