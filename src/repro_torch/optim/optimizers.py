"""Functional optimizers on named tensors (the twin of
`repro/optim/optimizers.py`).  AdaGrad is the paper's optimizer; Adam is
provided for the LM examples.

Parameters and state are dicts ``{name: tensor}`` (a model's
``named_parameters()``); state is fp32 like the reference's.  The updates
run in place, where the reference returns new trees (its train loop
donates the old buffers to the same effect), and in chunks of at most
``CHUNK`` elements per tensor so that a (256000, 6144) table's update
needs a few temporaries of one chunk each, not of the table.  Chunking
does not change the result: every operation is elementwise.

The *sparse* AdaGrad row path of the embedding table is the `adagrad_rows`
kernel (`pm.collectives.EmulatedBackend.update_rows`); these dense
versions update every other parameter.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch
from torch.distributed.tensor import DTensor

CHUNK = 1 << 26

Named = Mapping[str, torch.Tensor]


class AdaGradState(NamedTuple):
    accum: Dict[str, torch.Tensor]


def _chunks(*ts: torch.Tensor):
    """Matching flat chunks of equally shaped contiguous tensors (views).
    DTensors come whole: each device's update is elementwise on its own
    shard, and flattening a sharded tensor would gather it."""
    if isinstance(ts[0], DTensor):
        yield list(ts)
        return
    flat = [t.reshape(-1) for t in ts]
    for f, t in zip(flat, ts):
        if not t.is_contiguous():
            raise ValueError("optimizer operands must be contiguous")
    n = flat[0].numel()
    for lo in range(0, n, CHUNK):
        yield [f[lo:lo + CHUNK] for f in flat]


def adagrad_init(params: Named) -> AdaGradState:
    return AdaGradState(accum={
        k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for k, p in params.items()})


@torch.no_grad()
def adagrad_update(grads: Named, state: AdaGradState, params: Named, *,
                   lr: float = 0.1, eps: float = 1e-8):
    """``a += g * g; p -= lr * g / (sqrt(a) + eps)`` for every leaf in
    ``grads``, in place, fp32 math.  Returns ``(params, state)``."""
    for k, g in grads.items():
        p, a = params[k], state.accum[k]
        for pc, gc, ac in _chunks(p, g, a):
            g32 = gc.float()
            ac.add_(g32 * g32)
            pc.copy_(pc.float() - lr * g32 / (torch.sqrt(ac) + eps))
    return params, state


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor


def adam_init(params: Named) -> AdamState:
    def z():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamState(mu=z(), nu=z(),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_update(grads: Named, state: AdamState, params: Named, *,
                lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8):
    """Adam with bias correction, in place, fp32 math.  Returns
    ``(params, state)``."""
    state.count.add_(1)
    cf = state.count.float()
    c1 = 1 - torch.pow(torch.tensor(b1, device=cf.device), cf)
    c2 = 1 - torch.pow(torch.tensor(b2, device=cf.device), cf)
    for k, g in grads.items():
        p, m, v = params[k], state.mu[k], state.nu[k]
        for pc, gc, mc, vc in _chunks(p, g, m, v):
            g32 = gc.float()
            mc.copy_(b1 * mc + (1 - b1) * g32)
            vc.copy_(b2 * vc + (1 - b2) * g32 * g32)
            m_hat = mc / c1
            v_hat = vc / c2
            pc.copy_(pc.float() - lr * m_hat / (torch.sqrt(v_hat) + eps))
    return params, state
