"""The share of the training window in which no operation ran on the
device (the union of the traced device operations)."""
from portbench.readers import idle_pct


def read(w):
    return idle_pct(w)
