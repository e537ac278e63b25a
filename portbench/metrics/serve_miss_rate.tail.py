"""Token-level miss share of the replica cache, the mean over the
window's batches of the rate the runtime publishes (``serve.miss_rate``)."""
from portbench.readers import mean_pct


def read(w):
    return mean_pct(w.values.get("miss_rates", []))
