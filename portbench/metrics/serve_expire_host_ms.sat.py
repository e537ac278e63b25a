"""Host ms a round in expiring the served requests' intent
(``serve.expire``)."""
from portbench.phases import per_round_ms


def read(w):
    return per_round_ms(w, ("serve.expire",))
