"""Latency accounting shared by the serving scheduler (numpy only)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class LatencyRecorder:
    """Streaming latency accounting: record seconds, read percentiles."""

    def __init__(self):
        self._vals: List[float] = []

    def record(self, seconds: float) -> None:
        self._vals.append(float(seconds))

    def extend(self, seconds: Sequence[float]) -> None:
        self._vals.extend(float(s) for s in seconds)

    def __len__(self) -> int:
        return len(self._vals)

    def reset(self) -> None:
        self._vals.clear()

    def percentile(self, q: float) -> float:
        if not self._vals:
            return 0.0
        return float(np.percentile(np.asarray(self._vals), q))

    def mean(self) -> float:
        return float(np.mean(self._vals)) if self._vals else 0.0

    def summary_ms(self, qs: Tuple[float, ...] = (50.0, 99.0)
                   ) -> Dict[str, float]:
        out = {f"p{q:g}_ms": round(self.percentile(q) * 1e3, 4)
               for q in qs}
        out["mean_ms"] = round(self.mean() * 1e3, 4)
        out["count"] = len(self._vals)
        return out
