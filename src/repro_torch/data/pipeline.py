"""Seeded token streams for the serving path (numpy only).

The corpora draw from numpy generators exactly as the JAX package's do, so
a seed gives the same tokens in both packages.
"""

from __future__ import annotations

import numpy as np


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
