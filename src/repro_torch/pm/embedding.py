"""Intent-managed embedding (the twin of `repro/pm/embedding.py`).

A per-device *replica cache* holds the rows the planner decided to
replicate; lookups take two paths:

  hit  : the row is in the replica cache -> pure local read, no collective;
  miss : the row is only on its owner shard -> the *unique* missed ids are
         deduplicated and compacted into a fixed-capacity buffer (capacity
         M is known in advance from intent, bucketed) and only that (M, D)
         buffer moves through the backend's vocab-parallel collective.

Training (`pm_lookup`, a `torch.autograd.Function`) probes on the device
from the step's one sort (`pm_forward.step_residual`); the forward saves
the sort residual, and the backward sums duplicate token gradients along
it and writes them into the table gradient (``kernel=True``: one
`segment_scatter_rows` launch) without sorting again.  Gradients never
flow into the replica cache; it is re-gathered from the table once per
refresh round (`make_state` / `refresh_cache`).

The serving runtime runs the whole index stage on the host at admission
(`probe_host` / `CacheProbeView`), so the device does pure data movement
(`planned_serve_lookup`); `serve_lookup` is the probe-on-device form.  In
all of them, ``kernel=True`` gathers the miss buffer with the
`embed_gather` kernel and selects each token's row with the `pm_combine`
kernel.

On the mesh backend (`pm.collectives.MeshBackend`) ``table`` is this
rank's ``(V/n, D)`` block, the miss buffer moves through the routed
owner-block gather, and the backward routes each summed row to its
owner's block; the replica cache and the lookup's output are the same on
every rank.

A DTensor table (the dry run, `launch.dryrun`) takes DTensor's own
collectives: a replicated index stage, a masked vocab-parallel miss
buffer and a block-local backward (`_vocab_parallel_rows`,
`_block_row_grads`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops, ref
from repro_torch.kernels.pm_forward import (SortResidual, StepResidual,
                                            host_compact, probe_and_compact,
                                            step_residual)
from repro_torch.models.layouts import reduce_partials, replicated
from repro_torch.pm.collectives import resolve


class EmbedPMState(NamedTuple):
    """Device-side state of the intent-managed embedding."""

    table: torch.Tensor       # (V, D)
    cache_ids: torch.Tensor   # (C,) int32, SORTED; padded with V (no match)
    cache_rows: torch.Tensor  # (C, D)


def make_state(table: torch.Tensor, cache_ids: torch.Tensor,
               backend=None, route_cap: int = 0) -> EmbedPMState:
    """Build state with a freshly synchronized cache.  ``cache_ids`` must
    be sorted ascending; pad slots use V (matches no token).  ``backend``
    gathers the hot rows (on the mesh, routed in blocks of ``route_cap``
    rows, which the caller decides on the host with `pm.collectives.
    route_block`; 0: the replicated gather)."""
    cache_ids = cache_ids.to(torch.int32)
    cache_rows = resolve(backend).refresh_rows(table, cache_ids,
                                               route_cap=route_cap)
    return EmbedPMState(table, cache_ids, cache_rows)


def refresh_cache(state: EmbedPMState,
                  cache_ids: Optional[torch.Tensor] = None,
                  backend=None) -> EmbedPMState:
    """Replica sync round: re-gather the hot rows from the table,
    optionally installing a new plan's ids."""
    ids = state.cache_ids if cache_ids is None else cache_ids
    return make_state(state.table, ids, backend)


def combine_miss_buffer(backend, table, cache_rows, hit, cache_slot,
                        buf_ids, buf_slot, *, kernel: bool = False,
                        n_miss=None, route_cap: int = 0):
    """THE shared managed-lookup data path: move the compact unique-miss
    buffer through the backend's vocab-parallel collective, append the
    all-zero trash row (slot M — overflow tokens land there), and
    per-token combine: hits read the local replica cache, misses read the
    buffer.  Returns (T, D) rows.

    On the mesh backend the buffer takes the routed owner-block gather
    (`MeshBackend.gather_rows_routed`) with per-owner blocks of
    ``route_cap`` rows, which the caller decides on the host from the
    batch's miss set (`pm.collectives.route_block`; 0: the replicated
    gather), and ``n_miss`` (the probe's unique-miss count: an int, or a
    0-dim device tensor) tells it where the real ids end."""
    be = resolve(backend)
    if be.mesh_real and route_cap > 0:
        M = buf_ids.shape[0]
        n_valid = n_miss.clamp(max=M) if torch.is_tensor(n_miss) \
            else min(int(n_miss), M)
        buf_rows = be.gather_rows_routed(table, buf_ids, n_valid, route_cap,
                                         kernel=kernel)
    else:
        buf_rows = be.gather_rows(table, buf_ids, kernel=kernel)
    buffer = torch.cat([buf_rows, buf_rows.new_zeros((1, table.shape[1]))])
    return ops.pm_combine(hit, cache_slot, buf_slot, cache_rows, buffer,
                          use_kernel=kernel)


def _lookup_impl(table, cache_ids, cache_rows, tokens, miss_capacity,
                 strict=False, kernel=False, backend=None, residual=None,
                 n_miss=None, route_cap=0):
    B, S = tokens.shape
    T = B * S
    M = min(miss_capacity, T)
    tok = tokens.reshape(T).to(torch.int32)
    # probe + dedup/compact: UNIQUE missed ids fill the M intent-planned
    # slots (duplicates share a slot); computed from the step's one sort,
    # or reused from the caller's
    if residual is None:
        residual = step_residual(cache_ids, tok, M)
    pc = residual.probe
    if isinstance(table, DTensor):
        return _vocab_parallel_rows(
            table, cache_rows, tokens, pc, strict=strict, n_miss=n_miss, M=M,
            kernel=kernel, backend=backend), residual
    out = combine_miss_buffer(backend, table, cache_rows, pc.hit,
                              pc.cache_slot, pc.buf_ids, pc.buf_slot,
                              kernel=kernel, n_miss=pc.n_miss,
                              route_cap=route_cap)
    # rare overflow: correctness fallback via a direct (dense) gather.  The
    # reference branches on the device count (``lax.cond``); reading it
    # here would stall the host on the device, so the branch takes the
    # host's count of unique misses (``n_miss``, which the training loop
    # knows from the loader's intent) and, without one, selects
    # unconditionally.  ``strict=True`` omits the fallback.
    if not strict and (n_miss is None or n_miss > M):
        dense = resolve(backend).gather_rows(table, tok, kernel=kernel)
        out = torch.where(pc.overflow[:, None], dense, out)
    return out.reshape(B, S, table.shape[1]), residual


def _vocab_parallel_rows(table: DTensor, cache_rows, tokens: DTensor, pc, *,
                         strict, n_miss, M, kernel, backend) -> DTensor:
    """`_lookup_impl`'s rows on a DTensor table (the dry run): the (M, D)
    miss buffer comes from DTensor's masked vocab-parallel lookup, whose
    partial sums one reduction over "model" completes (the (V, D) table
    is never gathered), whole on every device; then each device runs the
    plain `pm_combine` on its own tokens (the replicated index stage's
    per-token slots cut to the tokens' layout, which moves nothing)
    against the replicated cache rows and buffer.  Returns (B, S, D) in
    the tokens' layout, whole along D.  Without ``strict`` the overflow
    tokens read the same vocab-parallel lookup of their own ids, as the
    plain dense fallback does."""
    if kernel or backend is not None:
        raise ValueError("a DTensor table takes DTensor's collectives: "
                         "pm_kernel=False and no pm_backend")
    mesh = tokens.device_mesh
    B, S = tokens.shape
    D = table.shape[1]

    def mine(t):
        """A replicated per-token (T,) tensor cut to this device's
        tokens, (B', S')."""
        t = DTensor.from_local(t.to_local().view(B, S), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, tokens.placements).to_local()

    buf = replicated(reduce_partials(
        F.embedding(pc.buf_ids.long(), table))).to_local()
    buffer = torch.cat([buf, buf.new_zeros((1, D))])
    hit = mine(pc.hit)
    rows = ops.pm_combine(hit.reshape(-1), mine(pc.cache_slot).reshape(-1),
                          mine(pc.buf_slot).reshape(-1),
                          replicated(cache_rows).to_local(), buffer,
                          use_kernel=False)
    rows = rows.view(*hit.shape, D)
    if not strict and (n_miss is None or n_miss > M):
        dense = reduce_partials(F.embedding(tokens.long(), table))
        dense = dense.redistribute(mesh, tokens.placements).to_local()
        rows = torch.where(mine(pc.overflow)[..., None], dense, rows)
    return DTensor.from_local(rows, mesh, tokens.placements,
                              run_check=False, shape=(B, S, D),
                              stride=(S * D, D, 1))


def _block_row_grads(layout, tokens: DTensor, g: DTensor) -> DTensor:
    """The table gradient of `_vocab_parallel_rows`, in the table's own
    placements (``layout``: its mesh, placements and shape): each device
    adds the gradients of its tokens that fall in its vocab block into a
    block-sized partial, in token order (`ref.index_add_in_order`), and
    the partials are reduced over the axes that split the tokens.  On
    the axes that split the vocabulary the tokens are gathered first,
    since a block may hold any of them.  No device holds a (V, D)
    gradient unless it holds the whole table."""
    mesh, table_pl, (V, D) = layout
    lay = [Replicate() if tp.is_shard(0) else pl
           for tp, pl in zip(table_pl, tokens.placements)]
    tok = tokens.redistribute(mesh, lay).to_local().reshape(-1).long()
    gl = g.redistribute(mesh, lay).to_local().reshape(-1, D)
    lo, n = 0, V
    coord = mesh.get_coordinate()
    for i, tp in enumerate(table_pl):
        if tp.is_shard(0):    # DTensor's chunks: ceil-sized, in mesh order
            step = -(-n // mesh.size(i))
            start = min(coord[i] * step, n)
            lo, n = lo + start, min(step, n - start)
    ids = tok - lo
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    block = ref.index_add_in_order(gl.new_zeros((n + 1, D)), ids, gl)[:n]
    grad_pl = [Shard(0) if tp.is_shard(0) else
               Partial() if pl.is_shard() else Replicate()
               for tp, pl in zip(table_pl, lay)]
    return DTensor.from_local(block, mesh, grad_pl, run_check=False,
                              shape=(V, D), stride=(D, 1)
                              ).redistribute(mesh, table_pl)


class _PMLookup(torch.autograd.Function):
    """`pm_lookup` with its custom backward (the reference's
    ``jax.custom_vjp``)."""

    @staticmethod
    def forward(ctx, table, cache_ids, cache_rows, tokens, miss_capacity,
                strict, kernel, backend, residual, n_miss, route_cap):
        out, residual = _lookup_impl(table, cache_ids, cache_rows, tokens,
                                     miss_capacity, strict, kernel, backend,
                                     residual, n_miss, route_cap)
        # the sort residual rides to the backward so the duplicate
        # pre-sum never re-sorts the tokens the forward already sorted
        ctx.save_for_backward(tokens, *residual.sort)
        if isinstance(table, DTensor):
            ctx.table_layout = (table.device_mesh, table.placements,
                                table.shape)
        be = resolve(backend)    # on the mesh, table is this rank's block
        ctx.vocab = table.shape[0] * (be.n_shards if be.mesh_real else 1)
        ctx.kernel, ctx.backend = kernel, backend
        return out

    @staticmethod
    def backward(ctx, g):
        tokens, order, sorted_ids, slot = ctx.saved_tensors
        if isinstance(g, DTensor):
            return (_block_row_grads(ctx.table_layout, tokens, g),) \
                + (None,) * 10
        V = ctx.vocab
        T = tokens.numel()
        tok = tokens.reshape(T)
        gt = g.reshape(T, g.shape[-1])
        # ALL row gradients go to the table; the kernel path sums the
        # duplicate token gradients along the forward's sort residual (no
        # second sort) and writes the sums in one `segment_scatter_rows`
        # launch.  The mesh always takes its routed path (the summed rows
        # travel to their owners, whose block gradient comes back); the
        # upstream gradient is the same on every rank, and each unique
        # row is routed from exactly one rank, so nothing is counted n
        # times
        grad_table = resolve(ctx.backend).scatter_row_grads(
            tok, gt, V, kernel=ctx.kernel,
            residual=SortResidual(order, sorted_ids, slot))
        return (grad_table,) + (None,) * 10


def pm_lookup(table, cache_ids, cache_rows, tokens, miss_capacity: int,
              strict: bool = False, kernel: bool = False, backend=None,
              residual: Optional[StepResidual] = None,
              n_miss: Optional[int] = None, route_cap: int = 0):
    """Intent-managed embedding lookup (training mode, differentiable with
    respect to ``table``).

    table (V, D); cache_ids (C,) sorted; cache_rows (C, D); tokens (B, S).
    ``miss_capacity``: bound on unique missed ids per call, planned from
    intent; overflow misses are still served right, by a dense gather
    (see `_lookup_impl`; ``n_miss`` is the host's unique-miss count).
    ``kernel=True`` runs the row data path through the hand-written
    kernels (`embed_gather` + `pm_combine` forward, `segment_scatter_rows`
    backward).  ``residual``: the step's precomputed `step_residual` for
    these (cache_ids, tokens); left None, the lookup derives it (still one
    sort: the backward reuses the forward's).  ``route_cap``: the mesh's
    routed block for this batch's misses, decided on the host from intent
    (`combine_miss_buffer`).  Returns (B, S, D) rows.

    A DTensor ``table`` (the dry run), with DTensor ``tokens`` and cache,
    takes DTensor's collectives (`_vocab_parallel_rows`,
    `_block_row_grads`)."""
    return _PMLookup.apply(table, cache_ids, cache_rows, tokens,
                           miss_capacity, strict, kernel, backend, residual,
                           n_miss, route_cap)


def plain_lookup(table, tokens):
    """Unmanaged lookup (static-partitioning baseline)."""
    return table[tokens.long()]


class ServeLookupResult(NamedTuple):
    """Outputs of the serving-mode lookup."""

    out: torch.Tensor       # (B, K, D) rows; overflow slots are zeros and
    #                         MUST NOT be served (re-queue their requests)
    hit: torch.Tensor       # (B, K) bool, served from the replica cache
    overflow: torch.Tensor  # (B, K) bool, unique misses beyond capacity
    n_miss: torch.Tensor    # () int32, unique missed ids this batch


def shard_partial_sum(table, ids, n_shards: int, *, kernel: bool = False):
    """The emulated vocab-parallel gather under its old name: one
    owner-masked partial per shard, summed (`EmulatedBackend.
    gather_rows`)."""
    return resolve(None, n_shards).gather_rows(table, ids, kernel=kernel)


def serve_lookup(table, cache_ids, cache_rows, tokens, miss_capacity: int,
                 *, n_shards: int = 1, kernel: bool = False,
                 backend=None) -> ServeLookupResult:
    """Serving-mode managed lookup with the probe on the device: read-only
    (no backward, no optimizer), and it never falls back to a dense gather
    silently — misses beyond the planned capacity come back as zeros with
    their ``overflow`` flag set, and the caller re-queues those requests.
    Only the compact (M+1, D) buffer moves through the backend's
    collective.  On the mesh the host does not know the miss set here, so
    the buffer takes the replicated gather; the runtime probes on the
    host (`probe_host`, `planned_serve_lookup`) and routes it."""
    B, K = tokens.shape
    T = B * K
    M = min(miss_capacity, T)
    D = table.shape[1]
    tok = tokens.reshape(T).to(torch.int32)
    pc = probe_and_compact(cache_ids, tok, M)
    out = combine_miss_buffer(resolve(backend, n_shards), table, cache_rows,
                              pc.hit, pc.cache_slot, pc.buf_ids,
                              pc.buf_slot, kernel=kernel, n_miss=pc.n_miss)
    # overflow tokens route to the trash row -> zeros; make that explicit
    out = torch.where(pc.overflow[:, None], 0.0, out)
    return ServeLookupResult(out.reshape(B, K, D), pc.hit.reshape(B, K),
                             pc.overflow.reshape(B, K), pc.n_miss)


def plain_serve_lookup(table, tokens, *, n_shards: int = 1, backend=None):
    """Unmanaged serving baseline: every token's row moves through the
    vocab-parallel collective (the dense (T, D) partial-sum)."""
    B, K = tokens.shape
    tok = tokens.reshape(B * K)
    out = resolve(backend, n_shards).gather_rows(table, tok)
    return out.reshape(B, K, -1)


class HostProbe(NamedTuple):
    """Host-side index stage of the serving lookup (all numpy)."""

    hit: np.ndarray         # (T,) bool, token served by the replica cache
    cache_slot: np.ndarray  # (T,) int32 cache row (clipped; valid on hit)
    buf_ids: np.ndarray     # (M,) int32 unique missed ids asc (pad: 0)
    buf_slot: np.ndarray    # (T,) int32 buffer slot per token (M = trash)
    overflow: np.ndarray    # (T,) bool, unique misses beyond capacity
    n_miss: int             # unique missed ids (may exceed M)


def probe_host(cache_ids, tok, miss_capacity: int, *,
               owner_shards: int = 0, route_capacity: int = 0,
               vocab: int = 0) -> HostProbe:
    """The serving runtime's admission-time index stage (numpy).

    ``owner_shards`` / ``route_capacity`` / ``vocab`` (all three required
    to engage) additionally flag *per-owner* overflow for the mesh
    backend's routed miss path (DESIGN.md §12): a unique missed id whose
    rank within its owner shard (owner = id // (V / owner_shards); the
    compact ids are ascending, so ranks are positional) reaches
    ``route_capacity`` would not fit the routed per-destination block, and
    every token reading its slot gets its ``overflow`` flag set — the
    runtime re-queues those requests exactly like global-capacity
    overflow, so admission capacity matches the per-owner buffers the
    routed collective actually has.

    On the serving hot path the scheduler holds the batch's token ids on
    the host the moment the batch is formed (they came out of the request
    queue) — so the whole index stage (probe, dedup, compact, overflow
    flags) runs here in numpy at admission time, and the device executes
    pure data movement (`planned_serve_lookup`); it also means
    miss-rate/overflow drift feedback needs no device readback at all.

    This IS `pm_forward._compact_math` (`pm_forward.host_compact`)."""
    r = host_compact(cache_ids, tok, miss_capacity)
    overflow = r["overflow"]
    if owner_shards > 0 and route_capacity > 0 and vocab > 0:
        overflow = _route_overflow(r["hit"], r["buf_ids"], r["buf_slot"],
                                   overflow, int(r["n_miss"]),
                                   owner_shards, route_capacity, vocab)
    return HostProbe(r["hit"], r["cache_slot"], r["buf_ids"],
                     r["buf_slot"], overflow, int(r["n_miss"]))


def _route_overflow(hit, buf_ids, buf_slot, overflow, n_miss: int,
                    owner_shards: int, route_capacity: int,
                    vocab: int) -> np.ndarray:
    """Per-owner overflow flags for the routed miss path (DESIGN.md §12),
    shared by `probe_host` and `CacheProbeView`: a unique missed id whose
    rank within its owner shard reaches ``route_capacity`` would not fit
    the routed per-destination block.  The compact ids are ascending, so
    each owner's ids are one contiguous run and rank-within-owner is
    positional (the device router's layout)."""
    M = buf_ids.shape[0]
    nm = min(int(n_miss), M)
    ids = np.asarray(buf_ids[:nm], dtype=np.int64)
    block = -(-vocab // owner_shards)
    starts = np.searchsorted(ids, np.arange(owner_shards,
                                            dtype=np.int64) * block)
    rank = np.arange(nm) - starts[np.minimum(ids // block,
                                             owner_shards - 1)]
    slot_over = np.zeros(M + 1, dtype=bool)
    slot_over[:nm] = rank >= min(route_capacity, M)
    return overflow | (slot_over[buf_slot] & ~hit)


class CacheProbeView:
    """Host probe that follows the replica cache from one generation to
    the next.

    `probe_host` re-derives the probe from scratch on every batch — one
    argsort of the batch tokens PLUS a binary search of every token
    against the sorted cache ids — even though the cache ids only change
    once per refresh/replan round.  This view keeps one table for its
    whole life, ``slot_of[v]``: the cache row of id ``v``, or -1 when
    ``v`` is not cached.  A new generation (`advance`) clears the rows
    that left and sets the rows that entered, O(C) table writes and
    never O(V); a batch then probes with one table read, plus one binary
    search of its missed tokens against the cache ids, O(T_miss log C),
    for the clipped slot `probe_host` reports on a miss.  The only
    per-batch sort left is the `np.unique` over the batch's missed
    tokens, which any compaction needs.  Every `HostProbe` field is
    byte-identical to `probe_host` — `np.unique` returns the missed ids
    ascending with duplicates sharing one inverse slot, exactly
    `_compact_math`'s miss-group ranks.

    ``cache_ids`` is sorted ascending and padded with ``vocab``
    (`PlacementPlan.cache_ids`); the pads never enter the table.  With a
    ``telemetry`` bus, `advance` adds the table entries it writes
    (cleared plus set) to the counter ``serve.probe_rows``."""

    def __init__(self, cache_ids: np.ndarray, vocab: int, *,
                 telemetry=None):
        self.vocab = int(vocab)
        self.telemetry = telemetry
        self._slot_of = np.full(self.vocab, -1, np.int32)
        self._real = np.zeros(0, np.int32)   # the table's cached ids
        self.advance(cache_ids)

    def advance(self, cache_ids: np.ndarray) -> None:
        """Move the table to the cache generation ``cache_ids``, whose
        length may differ from the last one's."""
        cache_ids = np.asarray(cache_ids)
        self.cache_ids = cache_ids
        real = cache_ids[:np.searchsorted(cache_ids, self.vocab)]
        self._slot_of[self._real] = -1
        self._slot_of[real] = np.arange(real.shape[0], dtype=np.int32)
        if self.telemetry is not None:
            self.telemetry.inc("serve.probe_rows",
                               self._real.shape[0] + real.shape[0])
        self._real = real

    def probe(self, tok, miss_capacity: int, *, owner_shards: int = 0,
              route_capacity: int = 0) -> HostProbe:
        """`probe_host(self.cache_ids, tok, ...)`, via the table."""
        tok = np.asarray(tok, dtype=np.int32)
        T = tok.shape[0]
        M = miss_capacity
        cache_slot = self._slot_of[tok]
        hit = cache_slot >= 0
        miss = ~hit
        missed = tok[miss]
        C = self.cache_ids.shape[0]
        cache_slot[miss] = (np.clip(np.searchsorted(self.cache_ids, missed),
                                    0, C - 1) if C else 0)
        uniq, inverse = np.unique(missed, return_inverse=True)
        n_miss = int(uniq.shape[0])
        k = min(n_miss, M)
        buf_ids = np.zeros(M, np.int32)
        buf_ids[:k] = uniq[:k]
        buf_slot = np.full(T, M, np.int32)
        buf_slot[miss] = np.where(inverse < M, inverse, M).astype(np.int32)
        overflow = np.zeros(T, bool)
        overflow[miss] = inverse >= M
        if owner_shards > 0 and route_capacity > 0 and self.vocab > 0:
            overflow = _route_overflow(hit, buf_ids, buf_slot, overflow,
                                       n_miss, owner_shards,
                                       route_capacity, self.vocab)
        return HostProbe(hit, cache_slot, buf_ids, buf_slot, overflow,
                         n_miss)


def planned_serve_lookup(table, cache_rows, buf_ids, hit, cache_slot,
                         buf_slot, *, n_shards: int = 1,
                         kernel: bool = False, backend=None,
                         n_miss: Optional[int] = None, route_cap: int = 0):
    """Device data path of the serving lookup, with the index stage
    already done (`probe_host` at admission — intent means the host knows
    the batch's miss set before the batch runs).  Only the (M+1, D)
    compact buffer moves through the backend's vocab-parallel collective;
    hits read the local replica cache; overflow slots read the all-zero
    trash row (``buf_slot == M``) and their requests are re-queued by the
    runtime, never served.  Returns (T, D) rows.

    On the mesh ``route_cap`` (the batch's `pm.collectives.route_block`,
    bounded by the plan's `route_capacity`; 0: the replicated gather) and
    ``n_miss`` (the host probe's unique-miss count) route the buffer
    through the owner-block gather."""
    return combine_miss_buffer(resolve(backend, n_shards), table,
                               cache_rows, hit, cache_slot, buf_ids,
                               buf_slot, kernel=kernel, n_miss=n_miss,
                               route_cap=route_cap)
