"""Token data pipeline with intent signaling (the twin of
`repro/data/pipeline.py`).

The loader prepares batches ``prefetch`` steps ahead of training.  The
moment a batch is constructed its token-id set is known, so the loader
signals intent to the `IntentPlanner` right then — the paper's data-loader
integration.  The training loop later asks the planner for placement
plans; the loader itself never makes PM decisions.

The corpora and the loader draw from numpy generators exactly as the JAX
package's do, so a seed gives the same batches in both packages.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.batches import make_batch
from repro_torch.pm.planner import IntentPlanner


class SyntheticCorpus:
    """Zipf-distributed token stream (natural-language-like marginals)."""

    def __init__(self, vocab_size: int, zipf_a: float = 1.1, seed: int = 0):
        self.V = vocab_size
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self.p = p / p.sum()
        self.perm = np.random.default_rng(seed).permutation(vocab_size)
        self.rng = np.random.default_rng(seed + 1)

    def tokens(self, shape) -> np.ndarray:
        flat = self.rng.choice(self.V, size=int(np.prod(shape)), p=self.p)
        return self.perm[flat].reshape(shape).astype(np.int32)


class DriftingZipfCorpus(SyntheticCorpus):
    """Zipf stream whose hot set drifts: `rotate()` re-draws the rank ->
    token-id permutation, so yesterday's head becomes tail mass overnight.
    This is the serving-side access pattern (hot entities change by the
    minute) the online runtime adapts to; the training loader can use it
    too for drift-robustness runs."""

    def __init__(self, vocab_size: int, zipf_a: float = 1.1, seed: int = 0):
        super().__init__(vocab_size, zipf_a=zipf_a, seed=seed)
        self._perm_rng = np.random.default_rng(seed + 2)
        self.rotations = 0

    def rotate(self) -> None:
        self.perm = self._perm_rng.permutation(self.V)
        self.rotations += 1


class IntentSignalingLoader:
    """Iterator of (step, batch) that runs ``prefetch`` steps ahead and
    signals intent per data shard as each batch is constructed.  Batches
    are tensors on ``device`` (None: the CPU)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 n_shards: int = 1, prefetch: int = 16,
                 planner: Optional[IntentPlanner] = None,
                 corpus: Optional[SyntheticCorpus] = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.B, self.S = batch, seq
        self.n_shards = n_shards
        self.prefetch = prefetch
        self.planner = planner
        self.corpus = corpus or SyntheticCorpus(cfg.vocab_size, seed=seed)
        self.rng = np.random.default_rng(seed + 7)
        self.device = device
        self._queue: Deque[Tuple[int, Dict]] = deque()
        self._next_prepare = 0

    def _prepare(self, step: int) -> Dict:
        # the random tokens/labels drawn here are overwritten below; the
        # draw keeps the rng in step with the reference's loader
        batch = make_batch(self.cfg, self.B, self.S, self.rng, self.device)
        toks = self.corpus.tokens((self.B, self.S))
        labels = np.roll(toks, -1, axis=1)
        batch["tokens"] = torch.from_numpy(toks).to(self.device)
        batch["labels"] = torch.from_numpy(labels).to(self.device)
        if self.planner is not None:
            # every row is signaled: the last shard takes the
            # B % n_shards remainder
            shard_size = max(1, self.B // self.n_shards)
            for shard in range(self.n_shards):
                lo = shard * shard_size
                hi = (shard + 1) * shard_size \
                    if shard < self.n_shards - 1 else self.B
                if lo >= self.B:
                    break
                self.planner.signal(step, shard, np.unique(toks[lo:hi]))
        return batch

    def fill(self) -> None:
        while len(self._queue) < self.prefetch:
            self._queue.append(
                (self._next_prepare, self._prepare(self._next_prepare)))
            self._next_prepare += 1

    def __iter__(self) -> Iterator[Tuple[int, Dict]]:
        while True:
            self.fill()
            yield self._queue.popleft()
