"""Parameter management: planner, controller, collectives, managed
embedding (serving half)."""
