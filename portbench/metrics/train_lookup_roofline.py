"""The managed lookup's and the row update's least bytes for the window
steps' tokens at HBM bandwidth, over the device time of their kernels
(gather_tma_kernel, gather_kernel, combine_kernel, the adagrad_rows
kernels, scatter_kernel, segment_scatter_kernel)."""
from portbench.readers import roofline_pct


def read(w):
    return roofline_pct(w, w.values.get("step_tokens"), update=True)
