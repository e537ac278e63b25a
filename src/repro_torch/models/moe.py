"""Mixture-of-Experts block: top-k router + capacity-bounded dispatch (the
twin of `repro/models/moe.py`).

Tokens are placed into a per-expert buffer of fixed capacity (position =
running count of earlier assignments to the same expert, in token-major
order); assignments past the capacity are dropped to a trash slot.  The
expert FFN is batched over the expert dimension.  Plain torch: the
reference computes all of this outside any Pallas kernel.

The router's top-k output is an intent signal in the paper's sense: it
announces which expert parameters each token will access ahead of the
expert computation.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from .layers import _dense_init
from .layouts import laid_out_grad, replicated


def init_moe(gen: torch.Generator, d_model: int, n_experts: int,
             moe_d_ff: int, dtype) -> Dict[str, torch.Tensor]:
    return {
        "router": _dense_init(gen, (d_model, n_experts), dtype),
        "w_gate": _dense_init(gen, (n_experts, d_model, moe_d_ff), dtype),
        "w_up": _dense_init(gen, (n_experts, d_model, moe_d_ff), dtype),
        "w_down": _dense_init(gen, (n_experts, moe_d_ff, d_model), dtype),
    }


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    c = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


class Routing(NamedTuple):
    """One MoE layer's routing of T tokens: ``topk_idx`` (T, K) experts,
    ``gates`` (T, K) renormalised fp32 weights, ``slot`` (T*K,) buffer
    slots in token-major order (E*C: dropped to the trash slot), ``keep``
    (T*K,) whether the assignment fit its expert's capacity, ``aux`` the
    load-balance loss (fp32) and ``capacity`` C."""
    topk_idx: torch.Tensor
    gates: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    capacity: int


def route(xt, router, *, n_experts: int, top_k: int,
          capacity_factor: float = 1.25) -> Routing:
    """The router of `moe_block` over flat tokens ``xt`` (T, D)."""
    T = xt.shape[0]
    E, K = n_experts, top_k
    logits = (xt @ router).float()                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = torch.topk(probs, K, dim=-1)         # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch/Mixtral style)
    me = probs.mean(dim=0)                                     # (E,)
    ce = F.one_hot(topk_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)

    C = expert_capacity(T, E, K, capacity_factor)
    e_flat = topk_idx.reshape(-1)                              # (T*K,)
    onehot = F.one_hot(e_flat, E)                              # (T*K, E)
    pos_in_e = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos_in_e < C
    # dropped assignments go to a trash slot E*C
    slot = torch.where(keep, e_flat * C + pos_in_e,
                       torch.full_like(e_flat, E * C))
    return Routing(topk_idx, gate_vals, slot, keep, aux, C)


def moe_block(x, p, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, routes=None):
    """x: (B, S, D) -> (out, aux_loss, router_topk_idx (B*S, k)).

    ``routes``: a list to which the layer's `Routing` is appended (the
    decode checks read which assignments dropped)."""
    B, S, D = x.shape
    T = B * S
    E, K = n_experts, top_k
    # a DTensor's tokens are gathered for the dispatch: its running
    # counts and slot writes span every token (DTensor has no rule that
    # keeps them sharded)
    xt = replicated(x.reshape(T, D))
    r = route(xt, p["router"], n_experts=E, top_k=K,
              capacity_factor=capacity_factor)
    if routes is not None:
        routes.append(r)
    C = r.capacity

    # Dispatch.  Every kept assignment has a slot of its own, so the sum
    # `index_add` writes each real slot exactly once, in any order (its
    # atomics on the card add into distinct rows); only the trash row E*C
    # sums several rows, and it is cut off below.  Out of place, so
    # autograd gives x the buffer's gradient gathered back by slot.  The
    # K copies of each token are an expanded view, whose backward sums
    # them in a fixed order (`repeat_interleave`'s adds with atomics).
    x_rep = xt[:, None, :].expand(T, K, D).reshape(T * K, D)  # (T*K, D)
    buf = x.new_zeros((E * C + 1, D)).index_add(0, r.slot, x_rep)
    expert_in = buf[: E * C].reshape(E, C, D)

    h = F.silu(torch.bmm(expert_in, p["w_gate"])) \
        * torch.bmm(expert_in, p["w_up"])
    expert_out = torch.bmm(h, p["w_down"])                     # (E, C, D)

    out_flat = torch.cat([expert_out.reshape(E * C, D),
                          expert_out.new_zeros((1, D))], dim=0)
    gathered = out_flat.index_select(0, r.slot)                # (T*K, D)
    weighted = gathered * r.gates.reshape(-1)[:, None].to(x.dtype)
    out = weighted.reshape(T, K, D).sum(dim=1)
    # and the dispatch's backward takes the gradient whole too
    out = laid_out_grad(out, replicated)
    return out.reshape(B, S, D), r.aux.to(x.dtype), r.topk_idx
