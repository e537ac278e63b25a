"""Device ms a window step from the train step's ``forward`` mark to its
``backward`` mark: the forward, the managed lookup and the loss."""
from portbench.phases import phase_ms


def read(w):
    return phase_ms(w, "forward", "backward")
