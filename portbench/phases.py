"""What the readers of the program's finer spans share: the train step's
device marks and the serving runtime's child spans.

The training loop marks each part of a step on the device's clock
(``train.mark.forward``, ``.backward``, ``.update``, ``.update/adagrad``,
``.update/rows``, ``.end``; `repro_torch.train.loop._PhaseMarks`), as
zero-length records on the spans' clock.  The window keeps no step
number, so the marks are grouped by time: one stream orders them, and a
step runs from a ``train.mark.forward`` to the next ``train.mark.end``.
A step cut by either edge of the window, or missing a mark, is left out.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Iterable, List, Optional

from portbench.readers import span_ms

MARK = "train.mark."
#: the marks a step must hold to be read
PARTS = ("forward", "backward", "update", "end")


def steps(w) -> List[Dict[str, int]]:
    """The window's whole steps: each a dict from part to its mark's ns."""
    marks = sorted(((s, n[len(MARK):]) for n, s, _ in w.spans
                    if n.startswith(MARK)), key=lambda m: m[0])
    out, cur = [], None
    for t, part in marks:
        if part == "forward":
            cur = {part: t}
        elif cur is not None:
            cur.setdefault(part, t)
            if part == "end":
                if all(p in cur for p in PARTS):
                    out.append(cur)
                cur = None
    return out


def phase_ms(w, start: str, end: str) -> Optional[float]:
    """Mean device ms from the mark ``start`` to the mark ``end`` over the
    window's whole steps; None where there are none."""
    st = steps(w)
    if not st:
        return None
    return sum(s[end] - s[start] for s in st) / len(st) / 1e6


def per_round_ms(w, names: Iterable[str]) -> Optional[float]:
    """Host ms in the spans ``names`` over the window's count of
    ``serve.round`` spans (so they compare with `serve_round_host_ms`);
    None where either is missing."""
    rounds = sum(n == "serve.round" for n, _, _ in w.spans)
    return span_ms(w, names, rounds)


def mark_overlap_ns(w) -> Optional[int]:
    """How deep the deepest train-step mark lies inside a device
    operation, in ns (0 where none does).  One stream orders a step's
    marks between its operations, so this reads how far the marks' clock
    and the device trace's clock disagree.  None without marks or
    operations."""
    marks = [s for n, s, _ in w.spans if n.startswith(MARK)]
    if not marks or not w.ops:
        return None
    ops = sorted((s, e) for _, s, e in w.ops)
    starts = [s for s, _ in ops]
    worst = 0
    for m in marks:
        i = bisect_left(starts, m)
        # operations of one stream do not overlap: the few that start
        # last before the mark are the ones that can hold it
        for s, e in ops[max(0, i - 8):i]:
            if s < m < e:
                worst = max(worst, min(m - s, e - m))
    return worst
