"""What the readers of a Falcon-H1 layer's branch marks share.

Each layer of the falcon_h1 family names its branches to the train step
as it enters them (``train.mark.forward/ssm``, ``forward/attn``,
``forward/mlp``; `repro_torch.models.model.ParallelHybridLayer`).  A
branch's time is the device time from its mark to the next mark of the
step, summed over the step's forward: between its ``forward`` and
``backward`` marks, so a rematerialised layer's recompute, which marks
the branches again inside the backward, is not read.  Steps are the
window's whole steps (`phases.steps`).
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Optional

from portbench.phases import MARK, steps


def forward_branch_ms(w, branch: str) -> Optional[float]:
    """Mean device ms a whole window step in the forward's ``branch``
    (``ssm``, ``attn`` or ``mlp``); None where no whole step marks it
    (a model without such layers, or a program that does not mark
    them)."""
    marks = sorted((s, n[len(MARK):]) for n, s, _ in w.spans
                   if n.startswith(MARK))
    times = [t for t, _ in marks]
    want = "forward/" + branch
    per_step = []
    for st in steps(w):
        total, seen = 0, False
        i = bisect_left(times, st["forward"])
        while i + 1 < len(marks) and marks[i][0] < st["backward"]:
            if marks[i][1] == want:
                total += marks[i + 1][0] - marks[i][0]
                seen = True
            i += 1
        if seen:
            per_step.append(total)
    if not per_step:
        return None
    return sum(per_step) / len(per_step) / 1e6
