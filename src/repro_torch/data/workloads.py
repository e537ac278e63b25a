"""Synthetic sparse-access workloads mirroring the paper's five ML tasks
(§5.1, Appendix C); the twin of `repro/data/workloads.py`, drawing the
same `np.random.default_rng` streams, so a seed gives the same workload
in both packages.  Each generator produces a `Workload` — per-(node,
worker) streams of batches, each batch being the distinct parameter keys the
batch's training step reads and writes:

  KGE: positive entities/relations follow a skewed (degree-like) Zipf
       distribution; negatives are sampled uniformly over all entities.
  WV:  word frequencies are heavily Zipfian (natural language).
  MF:  row parameters are partitioned per node (pure locality); each worker
       sweeps columns sequentially, giving long single-node access stretches
       per column parameter — the workload where relocation shines (§5.5).
  CTR: Zipf embedding keys plus a handful of dense "wide" keys accessed by
       every batch on every node — extreme hot spots.
  GNN: graph-partitioned keys; batches access large groups, mostly from the
       node's own partition with a boundary fraction from other partitions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.simulator import Workload


def _zipf_probs(n: int, a: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def _streams_from_sampler(rng, n_nodes, wpn, n_batches, sample_batch):
    streams = []
    for node in range(n_nodes):
        node_streams = []
        for w in range(wpn):
            node_streams.append(
                [sample_batch(rng, node, w, b) for b in range(n_batches)])
        streams.append(node_streams)
    return streams


def kge_workload(n_nodes=8, wpn=4, n_batches=200, n_keys=100_000,
                 batch_pos=32, batch_neg=32, zipf_a=1.05,
                 seed=0) -> Workload:
    rng = np.random.default_rng(seed)
    p = _zipf_probs(n_keys, zipf_a)
    perm = rng.permutation(n_keys)  # hot keys spread over the id space

    def sample(rng, node, w, b):
        pos = perm[rng.choice(n_keys, size=batch_pos, p=p)]
        neg = rng.integers(0, n_keys, size=batch_neg)
        return np.unique(np.concatenate([pos, neg]))

    return Workload("KGE", n_keys,
                    _streams_from_sampler(rng, n_nodes, wpn, n_batches, sample))


def wv_workload(n_nodes=8, wpn=4, n_batches=200, n_keys=60_000,
                batch_size=48, zipf_a=1.25, seed=1) -> Workload:
    rng = np.random.default_rng(seed)
    p = _zipf_probs(n_keys, zipf_a)
    perm = rng.permutation(n_keys)

    def sample(rng, node, w, b):
        return np.unique(perm[rng.choice(n_keys, size=batch_size, p=p)])

    return Workload("WV", n_keys,
                    _streams_from_sampler(rng, n_nodes, wpn, n_batches, sample))


def mf_workload(n_nodes=8, wpn=4, n_batches=200, n_rows=8_000,
                n_cols=2_000, batch_points=48, batches_per_col=20,
                seed=2) -> Workload:
    """Rows partitioned to nodes; workers sweep columns sequentially."""
    rng = np.random.default_rng(seed)
    n_keys = n_rows + n_cols
    rows_per_node = n_rows // n_nodes

    streams = []
    for node in range(n_nodes):
        row_lo = node * rows_per_node
        node_streams = []
        for w in range(wpn):
            col_order = rng.permutation(n_cols)
            batches = []
            for b in range(n_batches):
                col = col_order[(b // batches_per_col) % n_cols]
                rows = row_lo + rng.integers(0, rows_per_node,
                                             size=batch_points)
                keys = np.unique(np.concatenate(
                    [rows, np.array([n_rows + col])]))
                batches.append(keys)
            node_streams.append(batches)
        streams.append(node_streams)
    return Workload("MF", n_keys, streams)


def ctr_workload(n_nodes=8, wpn=4, n_batches=200, n_keys=120_000,
                 batch_size=40, zipf_a=1.2, n_dense=8, seed=3) -> Workload:
    """Zipf embedding keys + dense 'wide' keys hit by every batch."""
    rng = np.random.default_rng(seed)
    p = _zipf_probs(n_keys - n_dense, zipf_a)
    perm = rng.permutation(n_keys - n_dense) + n_dense
    dense = np.arange(n_dense)

    def sample(rng, node, w, b):
        emb = perm[rng.choice(n_keys - n_dense, size=batch_size, p=p)]
        return np.unique(np.concatenate([dense, emb]))

    return Workload("CTR", n_keys,
                    _streams_from_sampler(rng, n_nodes, wpn, n_batches, sample))


def gnn_workload(n_nodes=8, wpn=4, n_batches=150, n_keys=160_000,
                 batch_size=128, boundary_frac=0.15, seed=4) -> Workload:
    """Graph-partitioned node embeddings, group access with boundary keys."""
    rng = np.random.default_rng(seed)
    per_node = n_keys // n_nodes

    def sample(rng, node, w, b):
        n_own = int(batch_size * (1.0 - boundary_frac))
        own = node * per_node + rng.integers(0, per_node, size=n_own)
        other = rng.integers(0, n_keys, size=batch_size - n_own)
        return np.unique(np.concatenate([own, other]))

    return Workload("GNN", n_keys,
                    _streams_from_sampler(rng, n_nodes, wpn, n_batches, sample))


def zipf_workload(n_nodes=4, wpn=2, n_batches=100, n_keys=1_000_000,
                  batch_size=64, zipf_a=1.1, seed=5) -> Workload:
    """Pure skewed Zipf stream at arbitrary key counts (scale sweeps).

    Sampling goes through the inverse CDF (``searchsorted``) instead of
    ``rng.choice(p=...)``, which is O(n_keys) per draw — at 10^6+ keys the
    naive sampler dominates the whole simulation."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(_zipf_probs(n_keys, zipf_a))
    perm = rng.permutation(n_keys)  # hot keys spread over the id space

    def sample(rng, node, w, b):
        r = np.minimum(np.searchsorted(cdf, rng.random(batch_size),
                                       side="right"), n_keys - 1)
        return np.unique(perm[r])

    return Workload(f"ZIPF(n={n_keys})", n_keys,
                    _streams_from_sampler(rng, n_nodes, wpn, n_batches,
                                          sample))


TASKS = {
    "KGE": kge_workload,
    "WV": wv_workload,
    "MF": mf_workload,
    "CTR": ctr_workload,
    "GNN": gnn_workload,
    "ZIPF": zipf_workload,
}


def make_workload(task: str, n_nodes: int = 8, wpn: int = 4,
                  scale: float = 1.0, seed: Optional[int] = None,
                  n_keys: Optional[int] = None) -> Workload:
    """Build one of the paper tasks (plus the synthetic ZIPF scale task),
    optionally scaling batch counts and overriding the key-space size."""
    fn = TASKS[task]
    kwargs = {"n_nodes": n_nodes, "wpn": wpn}
    if seed is not None:
        kwargs["seed"] = seed
    if n_keys is not None:
        if task == "MF":
            n_rows = int(n_keys * 0.8)
            kwargs["n_rows"] = n_rows
            kwargs["n_cols"] = n_keys - n_rows
        else:
            kwargs["n_keys"] = n_keys
    wl = fn(**kwargs)
    if scale != 1.0:
        for node_streams in wl.streams:
            for i, stream in enumerate(node_streams):
                node_streams[i] = stream[: max(1, int(len(stream) * scale))]
    return wl
