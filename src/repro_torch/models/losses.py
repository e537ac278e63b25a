"""Vocab-parallel cross-entropy over the mesh (the twin of
`repro/models/losses.py`).

A tied model on the mesh has its head sharded with its table: rank k
holds rows ``[k·V/n, (k+1)·V/n)`` of ``embed``, so ``embed.T`` is the
head's block of columns.  Each rank computes the logits of its vocab
block only, and what crosses ranks is per token: no rank ever holds the
full ``(V, D)`` table, its logits or its dense gradient.

    logits_k = h @ head_k                       (B, S, V/n), local
    lse_k    = logsumexp(logits_k)              (B, S), local
    lse      = logsumexp over ranks of lse_k    (B, S)
    ll       = sum over ranks of the label's logit (only its owner has it)
    loss     = mean(lse - ll)

The reference combines a max over ranks (without gradient) with a sum of
exponentials over ranks; the log-sum-exp of the ranks' log-sum-exps is
the same function, and at one rank it is `model.loss_fn` bit for bit
(the log-sum-exp of one value is that value, its gradient exactly 1).

Every rank holds the same ``h`` and computes the same loss, so the
gradient that reaches a cross-rank combination from above is already the
same on every rank: each rank takes its own share of it back, and
nothing is summed again (which would count it n times).  ``h`` itself is
used by every rank's block, so its gradient is the sum of the ranks'
contributions: the entry point's backward sums them (forward: the
identity).  Values cross ranks by all-gather, and sums over ranks are
taken in rank order on each rank, so every rank gets the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import gather_ranks


class _GatherRanks(torch.autograd.Function):
    """Forward: every rank's ``x`` stacked in rank order; backward: this
    rank's slice of the gradient (whatever consumes the stack runs alike
    on every rank, so that gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rank = mesh.rank
        return gather_ranks(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _EnterBlocks(torch.autograd.Function):
    """Forward: the identity; backward: the sum over ranks of the
    gradient (each rank's block contributes its share)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_ranks(g, ctx.mesh).sum(0), None


def vocab_parallel_ce(h, head_blk, labels, mesh, *, aux=0.0,
                      aux_weight: float = 0.01):
    """Mean cross-entropy over all (B, S) tokens (+ aux) with the head's
    vocab sharded over ``mesh`` (a `launch.mesh.ModelGroup`): ``h`` (B, S,
    D) and ``labels`` (B, S) the same on every rank, ``head_blk`` (D,
    V/n) this rank's columns.  Returns the same 0-dim loss on every
    rank."""
    v_shard = head_blk.shape[-1]
    h = _EnterBlocks.apply(h, mesh)
    lg = (h @ head_blk).float()
    lse = torch.logsumexp(
        _GatherRanks.apply(torch.logsumexp(lg, dim=-1), mesh), dim=0)
    local = labels.long() - mesh.rank * v_shard
    in_blk = (local >= 0) & (local < v_shard)
    pick = torch.gather(lg, -1, local.clamp(0, v_shard - 1)[..., None])
    ll = _GatherRanks.apply(torch.where(in_blk, pick[..., 0], 0.0),
                            mesh).sum(0)
    return torch.mean(lse - ll) + aux_weight * aux
