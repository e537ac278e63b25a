"""Host ms per window step in the training loop's own managed-embedding
spans: intent signaling, planning and the replica refreshes."""
from portbench.readers import span_ms


def read(w):
    return span_ms(w, ("train.signal", "train.plan", "train.refresh",
                       "prefetch.refresh"), w.values.get("steps"))
