"""Device ms a window step in the Falcon-H1 layers' Mamba-2 mixers, in
the forward: from each ``forward/ssm`` mark to the next mark, summed
between the step's ``forward`` and ``backward`` marks
(`portbench.branches`)."""
from portbench.branches import forward_branch_ms


def read(w):
    return forward_branch_ms(w, "ssm")
