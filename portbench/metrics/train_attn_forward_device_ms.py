"""Device ms a window step in the Falcon-H1 layers' attention branches,
in the forward: from each ``forward/attn`` mark to the next mark, summed
between the step's ``forward`` and ``backward`` marks
(`portbench.branches`)."""
from portbench.branches import forward_branch_ms


def read(w):
    return forward_branch_ms(w, "attn")
