"""Device ms a window step from the ``backward`` mark to the ``update``
mark: the backward, remat's recompute included."""
from portbench.phases import phase_ms


def read(w):
    return phase_ms(w, "backward", "update")
