"""The reference's training steps, shared by the families: AdaGrad on every
leaf, written from its definition (``a += g * g``, ``p -= lr * g /
(sqrt(a) + eps)``, an all-zero accumulator at the start), the table's
rows updated where the step's tokens touch them (the same update as a
dense sweep, where untouched rows have a zero gradient and do not move).

What the cell's check compares comes out of `train` as a `Trace`: each
step's loss, each leaf's first gradient norm, each leaf's change after a
given step (`change_norms`), and the table's rows of given steps' tokens
as those steps read them.  ``tf32`` runs the products in TF32.
"""

from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

CHUNK = 1 << 26


def family(cfg: dict):
    """The reference module of ``cfg``'s family (``reference/<name>.py``)."""
    return importlib.import_module(f"{__package__}.{cfg['reference']}")


def sum64(t: torch.Tensor) -> float:
    """The sum of ``t`` in float64, chunk by chunk."""
    flat = t.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=t.device)
    for lo in range(0, flat.numel(), CHUNK):
        total += flat[lo:lo + CHUNK].double().sum()
    return float(total)


def sq64(t: torch.Tensor) -> float:
    """The sum of squares of ``t`` in float64, chunk by chunk."""
    flat = t.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=t.device)
    for lo in range(0, flat.numel(), CHUNK):
        c = flat[lo:lo + CHUNK].double()
        total += (c * c).sum()
    return float(total)


def diff_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """``|a - b|`` in float64, chunk by chunk."""
    fa, fb = a.detach().reshape(-1), b.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for lo in range(0, fa.numel(), CHUNK):
        d = fa[lo:lo + CHUNK].double() - fb[lo:lo + CHUNK].double()
        total += (d * d).sum()
    return float(total) ** 0.5


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products in full fp32 (the configuration's precision) or, for
    the control, in TF32."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def init_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return dict(family(cfg).init_leaves(cfg, gen))


def change_norms(cfg: dict, seed: int, params: Dict[str, torch.Tensor],
                 ) -> Dict[str, float]:
    """Each leaf's ``|params - initial|``, the initial weights drawn again
    leaf by leaf (one leaf alive at a time)."""
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(seed)
    return {name: diff_norm(params[name], p0)
            for name, p0 in family(cfg).init_leaves(cfg, gen)}


def adagrad_(p, a, g, lr: float, eps: float) -> None:
    """One AdaGrad update of ``p`` and its accumulator ``a``, in place,
    ``CHUNK`` elements at a time (elementwise: chunks change nothing)."""
    fp, fa, fg = p.detach().reshape(-1), a.reshape(-1), g.reshape(-1)
    for lo in range(0, fp.numel(), CHUNK):
        pc, ac, gc = fp[lo:lo + CHUNK], fa[lo:lo + CHUNK], fg[lo:lo + CHUNK]
        ac += gc * gc
        pc -= lr * gc / (torch.sqrt(ac) + eps)


def loss_of(cfg: dict, P: Dict[str, torch.Tensor], rows, inv, labels,
            chunk: int = 1024):
    """Mean cross-entropy of the model on tokens whose embedded rows are
    ``rows[inv]``; the head and the loss are taken ``chunk`` positions at
    a time, each chunk's logits recomputed in the backward."""
    B, S = inv.shape
    h = family(cfg).hidden(rows[inv], P, cfg).reshape(B * S, -1)
    lab = labels.reshape(-1)

    def ce(hc, lc):
        return torch.nn.functional.cross_entropy(hc @ P["head"], lc,
                                                 reduction="sum")
    total = 0.0
    for lo in range(0, B * S, chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            ce, h[lo:lo + chunk], lab[lo:lo + chunk], use_reentrant=False)
    return total / (B * S)


@dataclass
class Trace:
    """A run of training steps as the check reads it: each step's loss,
    each leaf's gradient norm at the first step, each leaf's change after
    the step the check names, and the token rows of the table at the
    steps it names (step -> (B, S, D), as the step reads them, before its
    update)."""

    losses: List[float]
    first: Dict[str, float]
    change: Dict[str, float]
    rows: Dict[int, torch.Tensor] = field(default_factory=dict)


def train(cfg: dict, seed: int, batches: Sequence[Tuple[np.ndarray,
                                                        np.ndarray]],
          lr: float, device, *, change_after: int, rows_at=(),
          eps: float = 1e-8, tf32: bool = False, chunk: int = 1024
          ) -> Tuple[Trace, Dict[int, torch.Tensor]]:
    """``len(batches)`` AdaGrad steps from the seed's initial weights on
    (tokens, labels) pairs.  Returns the `Trace` (the change after step
    ``change_after``, the rows of the steps ``rows_at``) and, for each of
    ``rows_at``, the initial rows of that step's tokens.  ``chunk``: the
    positions of the head and the loss taken at a time (another value
    sums the same terms in another order)."""
    with precision(tf32):
        P = init_params(cfg, seed, device)
        acc = {k: torch.zeros_like(v) for k, v in P.items()}
        dense = [k for k in P if k != "embed"]
        for k in dense:
            P[k].requires_grad_(True)
        toks = [torch.from_numpy(np.asarray(tok, np.int64)).to(device)
                for tok, _ in batches]
        init_rows = {k: P["embed"][toks[k]].clone() for k in rows_at}
        out = Trace([], {}, {})
        for step, (t, (_, lab)) in enumerate(zip(toks, batches)):
            if step in rows_at:
                out.rows[step] = P["embed"][t].clone()
            uniq, inv = torch.unique(t.reshape(-1), return_inverse=True)
            rows = P["embed"][uniq].requires_grad_(True)
            loss = loss_of(cfg, P, rows, inv.view(t.shape),
                           torch.from_numpy(np.asarray(lab, np.int64))
                           .to(device), chunk)
            grads = torch.autograd.grad(loss, [rows] + [P[k] for k in dense])
            out.losses.append(float(loss.detach()))
            with torch.no_grad():
                named = [("embed", grads[0])] + list(zip(dense, grads[1:]))
                if step == 0:
                    out.first = {k: sq64(g) ** 0.5 for k, g in named}
                for k, g in named:
                    if k == "embed":
                        a = acc[k][uniq] + g * g
                        acc[k][uniq] = a
                        P[k][uniq] -= lr * g / (torch.sqrt(a) + eps)
                    else:
                        adagrad_(P[k], acc[k], g, lr, eps)
            del grads, named, rows, loss
            if step + 1 == change_after:
                with torch.no_grad():
                    out.change = change_norms(cfg, seed, P)
    return out, init_rows
