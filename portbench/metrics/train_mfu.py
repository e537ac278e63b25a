"""Model FLOPs of the window's steps over the window and the chip's peak
at the configuration's precision (fp32, TF32 off: 67 TFLOP/s)."""
from portbench.readers import mfu_pct


def read(w):
    return mfu_pct(w)
