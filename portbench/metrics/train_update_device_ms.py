"""Device ms a window step from the ``update`` mark to the step's
``end`` mark: the gradients laid out, the dense AdaGrad and the fused
row AdaGrad."""
from portbench.phases import phase_ms


def read(w):
    return phase_ms(w, "update", "end")
