"""Adaptive action timing (paper §4.2, Algorithm 1).

AdaPM acts on intent signals in point-to-point communication rounds.  It must
decide, per intent, whether to act in the *current* round or whether a later
round still suffices.  A later round suffices if the *next* round will finish
before the worker reaches the intent's start clock.

AdaPM models the number of clock advances of worker ``i`` during one round as
Poisson(lambda_t^i), estimates the rate by exponential smoothing over observed
per-round clock deltas, and acts on an intent in round ``t`` iff

    C_start < C_t^i + Q_Poiss(2 * max(lambda_hat_t^i, Delta), p)

i.e. iff the worker might plausibly reach C_start within the next two rounds
(the current one plus the next).  Robustness details from the paper:
  * the estimate is NOT updated when the worker did not advance its clock
    during the previous round (evaluation pauses, end of epoch, ...);
  * ``max(lambda_hat, Delta)`` lets the estimate escape "slow regimes" where
    a too-low estimate caused remote-access stalls that kept clocks slow.

Defaults are the paper's zero-tuning constants: alpha=0.1, p=0.9999,
lambda_0=10 — used unchanged for every task in the paper's evaluation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

# z-scores for the normal approximation of high Poisson quantiles.
_Z = {0.5: 0.0, 0.9: 1.2816, 0.99: 2.3263, 0.999: 3.0902,
      0.9999: 3.7190, 0.99999: 4.2649}


def _z_for(p: float) -> float:
    if p in _Z:
        return _Z[p]
    # Acklam-style rational approximation of the normal quantile.
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile p must be in (0,1), got {p}")
    # Beasley-Springer-Moro.
    a = [2.50662823884, -18.61500062529, 41.39119773534, -25.44106049637]
    b = [-8.47351093090, 23.08336743743, -21.06224101826, 3.13082909833]
    c = [0.3374754822726147, 0.9761690190917186, 0.1607979714918209,
         0.0276438810333863, 0.0038405729373609, 0.0003951896511919,
         0.0000321767881768, 0.0000002888167364, 0.0000003960315187]
    y = p - 0.5
    if abs(y) < 0.42:
        r = y * y
        num = y * (((a[3] * r + a[2]) * r + a[1]) * r + a[0])
        den = (((b[3] * r + b[2]) * r + b[1]) * r + b[0]) * r + 1.0
        return num / den
    r = p if y <= 0 else 1.0 - p
    s = math.log(-math.log(r))
    t = c[0]
    for i in range(1, 9):
        t += c[i] * s ** i
    return t if y > 0 else -t


def poisson_quantile(lam: float, p: float) -> int:
    """Smallest k with CDF_Poisson(lam)(k) >= p.

    Exact summation for small rates; normal approximation with continuity
    correction for large rates (error negligible at the quantiles AdaPM uses).
    """
    if lam < 0:
        raise ValueError("rate must be non-negative")
    if lam == 0.0:
        return 0
    if lam <= 64.0:
        # exact: iterate pmf/cdf
        k = 0
        pmf = math.exp(-lam)
        cdf = pmf
        # upper iteration guard: mean + 12*std + slack
        guard = int(lam + 12.0 * math.sqrt(lam) + 32)
        while cdf < p and k < guard:
            k += 1
            pmf *= lam / k
            cdf += pmf
        return k
    z = _z_for(p)
    return int(math.ceil(lam + z * math.sqrt(lam) + 0.5))


@dataclass
class WorkerRateEstimate:
    lam_hat: float
    last_clock: int = 0
    last_delta: int = 0


@dataclass
class ActionTimer:
    """Algorithm 1 state for one node, tracking each worker's clock rate."""

    alpha: float = 0.1
    p: float = 0.9999
    lam0: float = 10.0
    _workers: Dict[int, WorkerRateEstimate] = field(default_factory=dict)

    def _est(self, worker: int) -> WorkerRateEstimate:
        est = self._workers.get(worker)
        if est is None:
            est = WorkerRateEstimate(lam_hat=self.lam0)
            self._workers[worker] = est
        return est

    def observe_round(self, worker: int, clock_now: int) -> None:
        """Called once per communication round with the worker's current
        clock; performs the exponential-smoothing update (Alg. 1, l.1-6)."""
        est = self._est(worker)
        delta = clock_now - est.last_clock
        if delta < 0:
            raise ValueError("clocks are monotone")
        if delta > 0:
            est.lam_hat = (1.0 - self.alpha) * est.lam_hat + self.alpha * delta
        # delta == 0: keep estimate (training pause, §4.2.2)
        est.last_delta = delta
        est.last_clock = clock_now

    def horizon(self, worker: int) -> int:
        """Soft upper bound on clock advance over the next two rounds."""
        est = self._est(worker)
        lam = 2.0 * max(est.lam_hat, float(est.last_delta))
        return poisson_quantile(lam, self.p)

    def should_act(self, worker: int, clock_now: int, c_start: int) -> bool:
        """Algorithm 1 return: act on the intent in this round iff the worker
        might reach ``c_start`` before the *next* round completes."""
        return c_start < clock_now + self.horizon(worker)

    def rate(self, worker: int) -> float:
        """The worker's smoothed clock advance per round."""
        return self._est(worker).lam_hat
