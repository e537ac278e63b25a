"""The managed lookup's least bytes for the window batches' tokens at
HBM bandwidth, over the device time of its kernels (gather_tma_kernel,
gather_kernel, combine_kernel)."""
from portbench.readers import roofline_pct


def read(w):
    return roofline_pct(w, w.values.get("batch_tokens"), update=False)
