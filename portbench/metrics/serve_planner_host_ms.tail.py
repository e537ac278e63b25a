"""Host ms a round in the replan's intent snapshot and planner
arithmetic (``serve.plan.snapshot``, ``serve.plan.solve``)."""
from portbench.phases import per_round_ms


def read(w):
    return per_round_ms(w, ("serve.plan.snapshot", "serve.plan.solve"))
