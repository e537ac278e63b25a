"""The one traffic generator: every traffic file's parameters are read
here, and every draw comes from the run's seed.

* `TokenStream`: the token ids of the training steps (``dist`` "zipf",
  drawn as `repro_torch.data.pipeline.SyntheticCorpus` draws them, or
  "uniform").  It records what it hands out, so the reference and the
  work counts read the same tokens as the program.
* `open_schedule`: an open loop's requests, a fixed count at a fixed
  mean rate: due times in seconds (the count's arrivals spread as a
  Poisson process's are, given their number, under an optional periodic
  ``profile`` of relative rates, such as bursts) and the keys of each
  request, Zipf over the table with the hot set re-drawn every
  ``rotate_s`` seconds of schedule time, or uniform.
* `ClosedKeys`: a closed loop's keys, uniform or Zipf over the table,
  drawn block by block on demand.

Every parameter is data, read from the traffic file: a new mix of these
shapes is a new file and no new code.
The numbers are numpy's: the same seed gives the same traffic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def zipf_p(vocab: int, a: float) -> np.ndarray:
    """Rank probabilities ``r ** -a`` over ranks 1 .. vocab."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** (-a)
    return p / p.sum()


class TokenStream:
    """Token ids for training steps; ``tokens(shape)`` is called once per
    step, in step order.  ``zipf``: rank -> id by a permutation drawn from
    ``seed`` and ranks from ``seed + 1``; ``uniform``: ids from
    ``seed + 1``."""

    def __init__(self, vocab: int, dist: str = "zipf", a: float = 1.1,
                 seed: int = 0):
        if dist not in ("zipf", "uniform"):
            raise ValueError(f"unknown token distribution {dist!r}")
        self.V, self.dist = vocab, dist
        self.p = zipf_p(vocab, a) if dist == "zipf" else None
        self.perm = np.random.default_rng(seed).permutation(vocab) \
            if dist == "zipf" else None
        self.rng = np.random.default_rng(seed + 1)
        self.handed: List[np.ndarray] = []

    def tokens(self, shape) -> np.ndarray:
        n = int(np.prod(shape))
        if self.dist == "zipf":
            flat = self.perm[self.rng.choice(self.V, size=n, p=self.p)]
        else:
            flat = self.rng.integers(0, self.V, size=n)
        out = flat.reshape(shape).astype(np.int32)
        self.handed.append(out)
        return out


@dataclass
class Schedule:
    """An open loop's requests, in due order."""

    due_s: np.ndarray            # (n,) seconds after the schedule starts
    keys: np.ndarray             # (n, K) int64 row ids


def due_times(rng: np.random.Generator, n: int, span_s: float,
              profile=None) -> np.ndarray:
    """``n`` sorted due times in ``[0, span_s)``: uniform (a Poisson
    process's arrivals, given their count) or, with ``profile``, a list of
    ``[seconds, relative rate]`` pieces repeated over the span, each
    piece taking its share of the arrivals (the times mapped through the
    inverse of the cumulative rate, so the same draws serve every
    profile)."""
    u = np.sort(rng.uniform(0.0, span_s, size=n))
    if not profile:
        return u
    lengths = np.array([float(x) for x, _ in profile])
    rates = np.array([float(r) for _, r in profile])
    if np.any(lengths <= 0) or np.any(rates < 0) or not rates.any():
        raise ValueError(f"bad rate profile {profile!r}")
    reps = int(np.ceil(span_s / lengths.sum())) + 1
    t = np.concatenate([[0.0], np.cumsum(np.tile(lengths, reps))])
    mass = np.concatenate([[0.0], np.cumsum(np.tile(lengths * rates,
                                                    reps))])
    total = np.interp(span_s, t, mass)
    return np.minimum(np.interp(u / span_s * total, mass, t),
                      np.nextafter(span_s, 0.0))


def key_ranks(rng: np.random.Generator, vocab: int, shape, dist: str,
              zipf_a: float) -> np.ndarray:
    """Ranks (``zipf``) or ids (``uniform``) of ``shape`` keys."""
    if dist == "zipf":
        return rng.choice(vocab, size=shape, p=zipf_p(vocab, zipf_a))
    if dist == "uniform":
        return rng.integers(0, vocab, size=shape, dtype=np.int64)
    raise ValueError(f"unknown key distribution {dist!r}")


def open_schedule(vocab: int, keys_per_request: int, rate: float,
                  span_s: float, *, dist: str = "zipf",
                  zipf_a: float = 1.1, rotate_s: float = 0.0,
                  profile=None, seed: int = 0) -> Schedule:
    """``round(rate * span_s)`` requests due in ``[0, span_s)``
    (`due_times`), so every seed offers the same number of requests.
    Zipf keys are ranks mapped to ids through a permutation that is
    re-drawn every ``rotate_s`` seconds (0: never); uniform keys are
    ids."""
    rng = np.random.default_rng(seed)
    n = int(round(rate * span_s))
    due = due_times(rng, n, span_s, profile)
    perm_rng = np.random.default_rng(seed + 2)
    epoch = (np.floor(due / rotate_s).astype(np.int64) if rotate_s > 0
             else np.zeros(n, np.int64))
    keys = np.empty((n, keys_per_request), np.int64)
    perm = perm_rng.permutation(vocab) if dist == "zipf" \
        else np.arange(vocab)
    for e in range(int(epoch[-1]) + 1 if n else 0):
        if e and dist == "zipf":
            perm = perm_rng.permutation(vocab)
        sel = np.flatnonzero(epoch == e)
        if sel.size:
            keys[sel] = perm[key_ranks(rng, vocab,
                                       (sel.size, keys_per_request), dist,
                                       zipf_a)]
    return Schedule(due, keys)


class ClosedKeys:
    """Keys of a closed loop's requests, uniform over the table or Zipf
    (ranks mapped to ids through a permutation drawn from ``seed + 2``),
    drawn in blocks of ``block`` requests: request ``i``'s keys are
    ``keys(i)`` whatever order they are asked for in."""

    def __init__(self, vocab: int, keys_per_request: int, seed: int = 0,
                 block: int = 4096, dist: str = "uniform",
                 zipf_a: float = 1.1):
        self.V, self.K, self.block = vocab, keys_per_request, block
        self.dist, self.a = dist, zipf_a
        self.perm = np.random.default_rng(seed + 2).permutation(vocab) \
            if dist == "zipf" else None
        self.rng = np.random.default_rng(seed)
        self._blocks: List[np.ndarray] = []

    def keys(self, i: int) -> np.ndarray:
        b = i // self.block
        while len(self._blocks) <= b:
            k = key_ranks(self.rng, self.V, (self.block, self.K),
                          self.dist, self.a)
            self._blocks.append(self.perm[k] if self.perm is not None
                                else k)
        return self._blocks[b][i % self.block]


def sample_ids(n: int, k: int, seed: int) -> np.ndarray:
    """``min(k, n)`` distinct indices of ``range(n)`` drawn from ``seed``,
    sorted: the requests whose answers a run checks."""
    rng = np.random.default_rng(seed + 3)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
