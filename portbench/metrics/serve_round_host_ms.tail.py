"""Mean host ms per executed round, from the serving runtime's own
``serve.round`` spans inside the window."""
from portbench.readers import span_mean_ms


def read(w):
    return span_mean_ms(w, "serve.round")
