"""Collective backends: the vocab-parallel communication layer of the
intent-managed embedding (the twin of `repro/pm/collectives.py`).

The managed lookup's cost is what moves through the network: only the
compact ``(M+1, D)`` miss buffer instead of every token's row.

  `EmulatedBackend`
      The single-device stand-in: with ``n_shards > 1`` every gather
      materializes one owner-masked ``(n, D)`` partial per shard and sums
      them, the cost model for the all-reduce's wire bytes on a one-device
      host.  ``n_shards == 1`` degenerates to a plain (optionally kernel)
      gather, which is the training default.

  `MeshBackend`
      The real thing over a process group (`launch.mesh`): rank k holds
      rows ``[k·V/n, (k+1)·V/n)`` of the table — every method takes THAT
      BLOCK as its ``table`` (the vocabulary is ``n`` times its rows) —
      and every data movement is an explicit `torch.distributed`
      collective.  The hot path is destination-compacted routing: the
      ascending unique-id layout of the step's one sort already groups
      ids by owner, so per-owner runs are carved with `searchsorted`
      (`ops.owner_segments`, no extra sort) and each rank touches only
      the rows it owns:

        gather_rows_routed  each owner gathers its run of the compact miss
                          ids from its block into a ``(cap, D)`` send
                          block; one all-gather of the blocks reassembles
                          the replicated ``(M, D)`` buffer (per-rank wire
                          ``n · cap · D``, about ``2·M·D``, against the
                          replicated all-reduce's ``n · M · D``);
        gather_rows       the replicated path (masked partial gather per
                          rank + all-reduce of the full buffer): the
                          routed path's fallback and the baseline;
        scatter_row_grads segment slots are chunked over the ranks, each
                          rank destination-compacts its chunk and one
                          all-to-all hands every owner exactly its rows,
                          which are written into its zero ``(V/n, D)``
                          block (`scatter_row_grads_psum` keeps the dense
                          partial + reduce-scatter of the legacy path);
        update_rows       the fused sparse AdaGrad applied where the row
                          lives: the same all-to-all delivers (id, row)
                          pairs to their owners and the `adagrad_rows`
                          kernel updates the owner's blocks in place;
        refresh_rows(_delta)  replica sync through the routed gather.

      Every rank runs the same program on the same batch, so every
      collective is entered by all ranks in the same order, and what a
      rank's replicated results hold is bitwise the same on every rank
      (the gathers assemble them from the same bytes).  The collectives
      are synchronous: PyTorch orders them after the work queued on the
      current stream (the stream the kernels launch on) and orders later
      work on that stream after them.

The reference decides between the routed gather and its fallback on the
device (`lax.cond` on the largest per-owner count).  Here the host
decides, before the batch runs: the training loop and the serving runtime
know every batch's miss set from intent, and `route_block` turns it into
the routed gather's per-owner block (``route_cap``), or 0 when one
owner's run would not fit a block, and the batch then takes the
replicated gather.  A caller without the host's ids passes 0.  Nothing
reads a count back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops, ref
from repro_torch.kernels.pm_forward import SortResidual
from repro_torch.launch.mesh import (ModelGroup, gather_ranks,
                                     make_model_mesh, reduce_scatter_tensor)
from repro_torch.launch.sharding import block_rows, place_table


def route_block_cap(m: int, n: int) -> int:
    """Per-owner block size of the routed miss path: the expected even
    split ``ceil(m / n)`` with 2x headroom for skew, rounded to a power of
    two, never above ``m`` itself.  Batches whose largest per-owner count
    exceeds it take the replicated gather instead."""
    c = 2 * (-(-m // n))
    p = 1
    while p < c:
        p *= 2
    return min(m, p)


def host_owner_max(ids, vocab: int, n_shards: int) -> int:
    """The largest number of ``ids`` (host array) one of ``n_shards``
    contiguous vocab blocks owns; ids outside ``[0, vocab)`` (pads) belong
    to none."""
    ids = np.asarray(ids).reshape(-1)
    ids = ids[(ids >= 0) & (ids < vocab)]
    if not ids.size:
        return 0
    return int(np.bincount(ids // (vocab // n_shards),
                           minlength=n_shards).max())


def route_block(ids, vocab: int, n_shards: int, m: int,
                route_cap: int = 0) -> int:
    """The routed gather's per-owner block for an ``m``-slot buffer whose
    real ids are the host array ``ids``: ``route_cap`` (a plan's bound;
    0: `route_block_cap(m, n_shards)`), at most ``m``, or 0 when one
    owner holds more of ``ids`` than that, and the buffer must take the
    replicated gather.  What the callers of `MeshBackend.
    gather_rows_routed` pass as its ``cap``."""
    cap = min(m, route_cap) if route_cap > 0 \
        else route_block_cap(m, n_shards)
    return cap if host_owner_max(ids, vocab, n_shards) <= cap else 0


@dataclass(frozen=True)
class EmulatedBackend:
    """Single-host stand-in for the vocab-parallel collectives."""

    n_shards: int = 1
    mesh_real: bool = field(default=False, init=False)

    def gather_rows(self, table, ids, *, kernel: bool = False):
        """Rows for ``ids`` through the emulated collective: ``kernel``
        gathers with the `embed_gather` kernel.  Ids outside ``[0, V)``
        (bucket pads) come back as zero rows.  With ``n_shards > 1`` the
        result is the sum of one owner-masked partial per shard, added in
        shard order as the reference adds them."""
        rows = ops.embed_gather(table, ids, use_kernel=kernel)
        if self.n_shards <= 1:
            return rows
        V = table.shape[0]
        block = -(-V // self.n_shards)
        owner = ids.long() // block
        partial = torch.zeros_like(rows)
        for s in range(self.n_shards):
            partial = partial + torch.where((owner == s)[:, None], rows, 0.0)
        return partial

    def scatter_row_grads(self, tok, g, vocab_size: int, *,
                          kernel: bool = False, residual=None):
        """Route all row gradients to the table: a dense scatter-add in
        token order (`ref.index_add_in_order`), or — ``kernel`` — one
        `segment_scatter_rows` launch that sums each run
        of duplicate token ids in sorted order and writes the sums into a
        zero ``(V + 1, D)`` buffer, whose row V (never written) is sliced
        off.  ``residual``: the forward's `SortResidual` of ``tok`` (the
        lookup backward passes it, so no index work happens here); without
        one the tokens are sorted once."""
        V = vocab_size
        base = torch.zeros((V + 1, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        if not kernel:
            return ref.index_add_in_order(base, tok.long().clamp(max=V),
                                          g)[:V]
        if residual is None:
            residual = ops.sorted_slots(tok, tok.shape[0])
        return ops.segment_scatter_rows(base, residual, g)[:V]

    def refresh_rows(self, table, cache_ids, *, route_cap: int = 0):
        """Replica sync: gather the hot rows (pad ids >= V read zeros).
        ``route_cap`` is for the mesh's routing; one device owns every
        row here."""
        return ref.embed_gather_ref(table, cache_ids)

    def refresh_rows_delta(self, table, cache_rows, ids, slots, *,
                           kernel: bool = False):
        """Incremental replica sync, in place: re-gather only ``ids``
        (ascending, V-padded) and write them into ``cache_rows`` at
        ``slots``; pad slots (== C) are dropped.  Rows the optimizer did
        not touch since the last refresh are bitwise unchanged in the
        table, so skipping them is exact — the loop takes this path only
        when that holds (sparse AdaGrad, untied embeddings).  The training
        loop hands the index tensors over on the host.  ``kernel``: the
        `embed_gather` kernel reads the rows (pads read nothing) and the
        `scatter_rows` kernel writes them (pad slots are outside ``[0,
        C)`` and write nothing); otherwise the pads are dropped on the
        host, so neither costs a device sync.  Returns ``cache_rows``."""
        if kernel:
            ids = ids.to(table.device, non_blocking=True)
            slots = slots.to(cache_rows.device, non_blocking=True)
            rows = ops.embed_gather(table, ids)
            return ops.scatter_rows(cache_rows, slots, rows)
        keep = slots < cache_rows.shape[0]
        ids = ids[keep].to(table.device, non_blocking=True)
        slots = slots[keep].to(cache_rows.device, non_blocking=True)
        rows = ref.embed_gather_ref(table, ids)
        return cache_rows.index_copy_(0, slots.long(), rows)

    def update_rows(self, table, accum, seg_ids, seg_g, *, lr: float,
                    eps: float = 1e-8, kernel: bool = False):
        """Fused sparse AdaGrad over segment slots, in place on the table
        and its accumulator: ``seg_ids`` are the ascending unique batch ids
        followed by pad slots (== V) with zero gradients
        (`ops.segment_rows(pad_id=V)`).  Both the `adagrad_rows` kernel
        and its plain version skip every id outside ``[0, V)``, so the
        pads stay V and never touch a live row.  (The reference instead
        aliases pads to row 0 and reverses the slot order so that its
        sequential TPU grid writes row 0's real update last; blocks on a
        GPU run in no order, where that trick would let a pad write the
        stale row back.)  Returns ``(table, accum)``."""
        return ops.adagrad_row_update(table, accum, seg_ids, seg_g, lr=lr,
                                      eps=eps, use_kernel=kernel)

    def agree(self, x: float) -> float:
        """One process: nothing to agree on (see `MeshBackend.agree`)."""
        return x


@dataclass(frozen=True, eq=False)
class MeshBackend:
    """Vocab-parallel collectives over a process group (`launch.mesh`):
    rank k owns rows ``[k·V/n, (k+1)·V/n)`` and every method takes this
    rank's ``(V/n, D)`` block as ``table`` (and ``accum``).  ``V % n``
    must be 0, as in the reference.  Collectives run on the group's
    backend (NCCL on cards, gloo on the CPU), and a failing collective or
    kernel raises: nothing falls back."""

    mesh: ModelGroup
    mesh_real: bool = field(default=True, init=False)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def place_table(self, table):
        """This rank's block of ``table`` (numpy or tensor) on its device
        (`launch.sharding.place_table`)."""
        return place_table(table, self.mesh)

    def gather_table(self, block):
        """The whole table from the ranks' blocks, in host memory on rank
        0 and None on the others, which send their blocks to it one at a
        time: no card holds more than its block and one more.  Every rank
        must call."""
        block = block.detach().contiguous()
        group, k, n = self.mesh.group, self.mesh.rank, self.n_shards
        if k != 0:
            dist.send(block, dst=0, group=group)
            return None
        rows = block.shape[0]
        full = torch.empty((n * rows,) + tuple(block.shape[1:]),
                           dtype=block.dtype)
        full[:rows].copy_(block)
        buf = torch.empty_like(block)
        for src in range(1, n):
            dist.recv(buf, src=src, group=group)
            full[src * rows:(src + 1) * rows].copy_(buf)
        return full

    def agree(self, x: float) -> float:
        """Rank 0's value of ``x`` on every rank (one broadcast).  A
        decision taken from a rank's own clock (the controllers' rewards)
        must be the same on every rank, or the ranks would enter
        different collectives."""
        t = torch.tensor([x], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0, group=self.mesh.group)
        return float(t.item())

    def gather_rows(self, table, ids, *, kernel: bool = False):
        """Rows for global ``ids``, on every rank: each rank gathers the
        rows it owns from its block (zero rows elsewhere; `embed_gather`
        with ``kernel``) and one all-reduce sums the partials.  Ids outside
        every block (pads) come back zero."""
        block = table.shape[0]
        local = ids.to(torch.int64) - self.mesh.rank * block
        local = torch.where((local >= 0) & (local < block), local,
                            block).to(torch.int32)
        rows = ops.embed_gather(table, local, use_kernel=kernel)
        dist.all_reduce(rows, group=self.mesh.group)
        return rows

    def gather_rows_routed(self, table, ids, n_valid, cap: int, *,
                           kernel: bool = False):
        """Destination-compacted miss gather: ``ids`` (M,) must hold
        ascending unique real ids on ``ids[:n_valid]`` (``n_valid`` an int
        or a 0-dim device tensor; the probe/compact contract); entries
        past it may hold anything and come back as zero rows.

        Each owner carves its run out of the id list (`ops.owner_segments`:
        searchsorted, no sort), gathers those rows from its block into a
        ``(cap, D)`` send block, and one all-gather of the send blocks
        gives every rank every row; each rank places them at their buffer
        slots, which it computes itself from the same segment bounds (the
        reference gathers the slots too).  ``cap`` is decided on the host
        (`route_block`) and must hold every owner's run; 0 (no block
        holds the largest run, or the caller does not know the ids) takes
        the replicated `gather_rows` instead — the same rows, more bytes.
        Returns (M, D) rows, equal on every rank."""
        block, D = table.shape
        n, k = self.n_shards, self.mesh.rank
        M = ids.shape[0]
        if M == 0:
            return table.new_zeros((0, D))
        view, seg = ops.owner_segments(ids, n_valid, n, block)
        if cap <= 0:
            return self.gather_rows(table, view, kernel=kernel)
        cap = min(cap, M)
        j = torch.arange(cap, dtype=torch.int32, device=ids.device)
        mine = j[None, :] < (seg[1:] - seg[:-1])[:, None]      # (n, cap)
        pos = seg[:-1, None] + j[None, :]
        slots = torch.where(mine, pos, M).reshape(-1)          # pads: M
        sl = view[pos[k].clamp(max=M - 1).long()]
        local = torch.where(mine[k], sl - k * block, block)    # pads: zero
        rows = ops.embed_gather(table, local, use_kernel=kernel)
        rows_all = gather_ranks(rows, self.mesh).view(n * cap, D)
        return ops.scatter_rows(table.new_zeros((M, D)), slots, rows_all,
                                use_kernel=kernel)

    def _route(self, seg_ids, seg_g, V: int, *, kernel: bool):
        """The all-to-all half of the routed scatter and update.
        ``seg_ids`` (T,) are ascending unique ids followed by pads (== V)
        with ``seg_g`` (T, D) their rows.  The slot list is cut into n
        chunks of ``cap = ceil(T / n)``; rank k destination-compacts chunk
        k (a slice of an ascending list, so each owner's ids are one run:
        `searchsorted` finds the run starts and ``rank = j - start``
        places each row in its owner's ``cap`` rows of the send buffer)
        and one all-to-all of ids and one of rows hands every owner its
        rows.  A run can never exceed the chunk, so the layout needs no
        overflow arm.  Returns the received ids as local rows of this
        rank's block (pads: the block size, outside it) and their rows."""
        n, k = self.n_shards, self.mesh.rank
        block = V // n
        T, D = seg_g.shape
        cap = -(-T // n)
        lo = min(k * cap, T)
        hi = min(lo + cap, T)
        tc = seg_ids[lo:hi].to(torch.int32)
        dev = tc.device
        starts = torch.searchsorted(
            tc, torch.arange(n, dtype=torch.int32, device=dev) * block)
        owner = (tc // block).clamp(max=n - 1)
        j = torch.arange(hi - lo, dtype=torch.int64, device=dev)
        dst = torch.where(tc < V, owner * cap + (j - starts[owner]), n * cap)
        send_ids = torch.full((n * cap + 1,), V, dtype=torch.int32,
                              device=dev)
        send_ids[dst] = tc                  # pads all land on the last slot
        send_g = seg_g.new_zeros((n * cap, D))
        ops.scatter_rows(send_g, dst, seg_g[lo:hi], use_kernel=kernel)
        recv_ids = torch.empty((n * cap,), dtype=torch.int32, device=dev)
        recv_g = torch.empty_like(send_g)
        dist.all_to_all_single(recv_ids, send_ids[:n * cap],
                               group=self.mesh.group)
        dist.all_to_all_single(recv_g, send_g, group=self.mesh.group)
        local = torch.where(recv_ids < V, recv_ids - k * block, block)
        return local.to(torch.int32), recv_g

    def scatter_row_grads(self, tok, g, vocab_size: int, *,
                          kernel: bool = False, residual=None):
        """The table gradient's block on each owner: duplicate token
        gradients are summed per run of equal ids in sorted order into
        compact slots (one `segment_scatter_rows` launch with ``kernel``,
        whose runs are the residual's slot indices), the slots are routed
        to their owners (`_route`) and written into a zero ``(V/n, D)``
        block (`scatter_rows`).  ``residual``: the forward's
        `SortResidual` of ``tok`` (the lookup backward passes it, so no
        index work happens here); without one the tokens are sorted once.
        The dense ``(V, D)`` partial of the legacy path never exists."""
        V = vocab_size
        block_rows(V, self.mesh.rank, self.n_shards)  # raises unless n | V
        T, D = g.shape
        if residual is None:
            residual = ops.sorted_slots(tok, T)
        order, s_ids, slot = residual[:3]
        seg_g = ops.segment_scatter_rows(
            g.new_zeros((T, D)), SortResidual(order, slot, slot), g,
            use_kernel=kernel)
        seg_ids = torch.full((T,), V, dtype=torch.int32, device=g.device)
        seg_ids[slot.long()] = s_ids.to(torch.int32)
        local, recv_g = self._route(seg_ids, seg_g, V, kernel=kernel)
        return ops.scatter_rows(g.new_zeros((V // self.n_shards, D)), local,
                                recv_g, use_kernel=kernel)

    def scatter_row_grads_psum(self, tok, g, vocab_size: int, *,
                               kernel: bool = False, residual=None):
        """The legacy replicated-partial path (the routed path's baseline):
        rank k adds chunk k of the raw tokens' gradients into a dense
        ``(V, D)`` partial (`segment_scatter_rows` with ``kernel``, after
        one sort of the chunk) and one reduce-scatter both sums the
        partials and hands each owner its block.  ``residual`` is not
        used: the chunks are not the forward's sort."""
        V = vocab_size
        n, k = self.n_shards, self.mesh.rank
        block_rows(V, k, n)                 # raises unless n | V
        T, D = g.shape
        cap = -(-T // n)
        lo = min(k * cap, T)
        hi = min(lo + cap, T)
        partial = g.new_zeros((V, D))
        if hi > lo:
            tc, gc = tok[lo:hi], g[lo:hi]
            if kernel:
                ops.segment_scatter_rows(partial,
                                         ops.sorted_slots(tc, hi - lo), gc)
            else:
                partial.index_add_(0, tc.long(), gc)
        out = g.new_empty((V // n, D))
        reduce_scatter_tensor(out, partial, group=self.mesh.group)
        return out

    def update_rows(self, table, accum, seg_ids, seg_g, *, lr: float,
                    eps: float = 1e-8, kernel: bool = False):
        """The fused sparse AdaGrad applied where each row lives: the
        routing of `scatter_row_grads` delivers each (id, gradient row)
        of the segment slots (`ops.segment_rows(pad_id=V)`: ascending
        unique ids, then pads) to its owner, and `adagrad_rows` updates
        the owner's ``table`` / ``accum`` blocks in place.  Received pads
        get the local id ``V/n``, outside the block, which the kernel and
        its plain version skip (the reference aliases them to row 0 and
        relies on its sequential grid; ROADMAP Queue 3).  Returns
        ``(table, accum)``."""
        V = table.shape[0] * self.n_shards
        local, recv_g = self._route(seg_ids, seg_g, V, kernel=kernel)
        return ops.adagrad_row_update(table, accum, local, recv_g, lr=lr,
                                      eps=eps, use_kernel=kernel)

    def refresh_rows(self, table, cache_ids, *, route_cap: int = 0):
        """Replica sync: the plan's hot rows through the routed gather,
        with blocks of ``route_cap`` rows (`route_block` of the plan's
        ids; 0: the replicated gather).  ``cache_ids`` are sorted
        ascending with V-pads (the cache contract), and `searchsorted`
        finds the real-id count without a sort; pads come back zero."""
        V = table.shape[0] * self.n_shards
        ids = cache_ids.to(torch.int32)
        n_valid = torch.searchsorted(ids, V)
        return self.gather_rows_routed(table, ids, n_valid, route_cap)

    def refresh_rows_delta(self, table, cache_rows, ids, slots, *,
                           kernel: bool = False):
        """Incremental replica sync, in place: the routed gather of only
        ``ids`` (ascending, V-padded) written into ``cache_rows`` at
        ``slots`` (pad slots == C are dropped), as
        `EmulatedBackend.refresh_rows_delta`.  The loop hands ``ids`` and
        ``slots`` over on the host, where their real count and per-owner
        counts are read without a device sync.  ``kernel``: `embed_gather`
        reads and `scatter_rows` writes the rows.  Returns
        ``cache_rows``."""
        V = table.shape[0] * self.n_shards
        ids_h = ids.cpu().numpy()
        n_valid = int(np.count_nonzero(ids_h < V))
        rows = self.gather_rows_routed(
            table, ids.to(table.device, non_blocking=True), n_valid,
            route_block(ids_h[:n_valid], V, self.n_shards, ids_h.size),
            kernel=kernel)
        if kernel:
            return ops.scatter_rows(
                cache_rows, slots.to(cache_rows.device, non_blocking=True),
                rows)
        keep = torch.from_numpy(
            np.flatnonzero(slots.cpu().numpy() < cache_rows.shape[0]))
        return cache_rows.index_copy_(
            0, slots[keep].to(cache_rows.device, non_blocking=True).long(),
            rows.index_select(0, keep.to(rows.device, non_blocking=True)))


#: module-level default: the single-device reference.
EMULATED = EmulatedBackend(1)


def resolve(backend, n_shards: int = 1):
    """``backend`` if given, else the emulated backend at ``n_shards`` —
    the rule every `pm.embedding` entry point applies to its arguments."""
    if backend is not None:
        return backend
    return EMULATED if n_shards <= 1 else EmulatedBackend(n_shards)


def make_backend(collective: str, model_shards: int = 0):
    """Config-string entry point shared by the training loop and the
    serving runtime: ``"emulated"`` -> None (the per-call `resolve`
    default), ``"mesh"`` -> a `MeshBackend` over the started default
    process group of ``model_shards`` ranks (0: all of it;
    `launch.mesh.make_model_mesh`).  Callers owning a table place it
    (`MeshBackend.place_table`)."""
    if collective == "emulated":
        return None
    if collective == "mesh":
        return MeshBackend(make_model_mesh(model_shards))
    raise ValueError(f"unknown collective {collective!r}")
