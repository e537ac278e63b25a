"""The share of the serving window in which no operation ran on the
device."""
from portbench.readers import idle_pct


def read(w):
    return idle_pct(w)
