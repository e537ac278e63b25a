"""Plain reference of the ssm family with Mamba-1 blocks (falcon-mamba-7b):
pre-norm residual layers of one selective-scan block each, no MLP, an
untied head, mean cross-entropy.  fp32 throughout; written from the
Mamba paper's block in plain torch ops, with the port's conventions
where it leaves a choice:

* RMSNorm without a bias;
* ``in_proj`` (D, 2 di) split into the branch ``x`` and the gate ``z``;
* a depthwise causal convolution of width K over ``x`` (`F.conv1d`),
  then SiLU;
* ``x_proj`` (di, R + 2N) gives dt (R), B (N) and C (N);
  ``dt = softplus(dt @ dt_proj + dt_bias)``, ``A = -exp(A_log)``;
* the recurrence ``h_t = exp(dt_t A) * h_{t-1} + dt_t x_t B_t`` taken one
  position after another, its gradient by the same recurrence from the
  end (the program's scan is log-depth and chunked: the same sums in
  another order), ``y_t = h_t C_t + D x_t``, gated by
  ``silu(z)``, then ``out_proj``.

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

from .dense import normal


def dims(cfg: dict):
    D = cfg["d_model"]
    return (D, cfg.get("ssm_expand", 2) * D, cfg["ssm_state"],
            cfg.get("ssm_conv", 4), max(1, D // 16))


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product once per token: each
    block's in, x, dt and out projections and the head (the convolution
    and the scan are elementwise; the embedding is a lookup)."""
    D, di, N, _, R = dims(cfg)
    layer = D * 2 * di + di * (R + 2 * N) + R * di + di * D
    return cfg["n_layers"] * layer + D * cfg["vocab_size"]


def attention_flops(cfg: dict, B: int, S: int) -> float:
    """No attention."""
    return 0.0


def init_leaves(cfg: dict, gen: torch.Generator
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, initial tensor) in the order the weights are drawn."""
    if cfg.get("tie_embeddings") or cfg.get("ssm_version", 1) != 1:
        raise NotImplementedError("the ssm reference is untied Mamba-1")
    D, di, N, K, R = dims(cfg)
    V, dev = cfg["vocab_size"], gen.device
    yield "embed", normal(gen, (V, D), 0.02)
    yield "final_norm.scale", torch.ones(D, device=dev)
    yield "head", normal(gen, (D, V), 1 / math.sqrt(D))
    a_log = torch.from_numpy(np.log(np.arange(1, N + 1, dtype=np.float32)))
    for i in range(cfg["n_layers"]):
        p = f"layers.{i}"
        yield f"{p}.norm1.scale", torch.ones(D, device=dev)
        m = f"{p}.mamba"
        yield f"{m}.in_proj", normal(gen, (D, 2 * di), 1 / math.sqrt(D))
        yield f"{m}.conv_w", normal(gen, (di, K), 0.5)
        yield f"{m}.conv_b", torch.zeros(di, device=dev)
        yield f"{m}.x_proj", normal(gen, (di, R + 2 * N), 1 / math.sqrt(di))
        yield f"{m}.dt_proj", normal(gen, (R, di), 1 / math.sqrt(R))
        yield f"{m}.dt_bias", torch.full((di,), -4.6, device=dev)
        yield f"{m}.A_log", a_log.to(dev).expand(di, N).contiguous()
        yield f"{m}.D_skip", torch.ones(di, device=dev)
        yield f"{m}.out_proj", normal(gen, (di, D), 1 / math.sqrt(di))


def rms(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


class Scan(torch.autograd.Function):
    """h_t = a_t * h_{t-1} + b_t along axis 1 from zeros, one position at
    a time; its gradient by the same recurrence run from the end:
    g_t = dL/dh_t + a_{t+1} g_{t+1}, then dL/db_t = g_t and dL/da_t =
    g_t h_{t-1}."""

    @staticmethod
    def forward(ctx, a, b):
        h = torch.empty_like(b)
        prev = torch.zeros_like(b[:, 0])
        for t in range(b.shape[1]):
            prev = torch.addcmul(b[:, t], a[:, t], prev)
            h[:, t] = prev
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        S = h.shape[1]
        g = torch.empty_like(gh)
        nxt = gh[:, S - 1]
        g[:, S - 1] = nxt
        for t in range(S - 2, -1, -1):
            nxt = torch.addcmul(gh[:, t], a[:, t + 1], nxt)
            g[:, t] = nxt
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * h_prev, g


def scan(a, b):
    return Scan.apply(a, b)


def mamba(x, P, m: str, cfg: dict):
    D, di, N, K, R = dims(cfg)
    S = x.shape[1]
    xz = x @ P[f"{m}.in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xc = F.conv1d(xi.transpose(1, 2), P[f"{m}.conv_w"][:, None, :],
                  P[f"{m}.conv_b"], padding=K - 1, groups=di)[..., :S]
    xc = F.silu(xc.transpose(1, 2))
    dbc = xc @ P[f"{m}.x_proj"]
    dt, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = F.softplus(dt @ P[f"{m}.dt_proj"] + P[f"{m}.dt_bias"])
    A = -torch.exp(P[f"{m}.A_log"])
    a = torch.exp(dt[..., None] * A)                     # (B, S, di, N)
    b = (dt * xc)[..., None] * Bm[:, :, None, :]
    h = scan(a, b)
    y = (h * Cm[:, :, None, :]).sum(-1) + P[f"{m}.D_skip"] * xc
    return (y * F.silu(z)) @ P[f"{m}.out_proj"]


def layer(h, P, i: int, cfg: dict):
    p = f"layers.{i}"
    hn = rms(h, P[f"{p}.norm1.scale"], cfg.get("norm_eps", 1e-5))
    return h + mamba(hn, P, f"{p}.mamba", cfg)


def hidden(h, P, cfg: dict):
    """The trunk over the embedded tokens ``h`` (B, S, D), each layer
    recomputed in the backward, then the final norm."""
    for i in range(cfg["n_layers"]):
        h = checkpoint(layer, h, P, i, cfg, use_reentrant=False)
    return rms(h, P["final_norm.scale"], cfg.get("norm_eps", 1e-5))
