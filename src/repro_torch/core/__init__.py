"""The AdaPM core (the twin of `repro/core`): intent signaling, the
unified vectorized intent engine, the simulator-drivable policies (AdaPM
and the paper's baselines) and the discrete-event cluster simulator, all
numpy on the host.  The engine (`repro_torch.core.engine`) is the single
decision procedure: the simulator's policies drive its state machine, and
the planner (`repro_torch.pm.planner`) routes its placement decisions
through its window classifiers.
"""

from .api import AccessResult, CostModel, Metrics, PMPolicy, RoundLedger
from .engine import (IntentEngine, IntentStore, OwnerTable,
                     concurrent_intent, decide_on_activate, home_nodes,
                     intent_miss_bound)
from .intent import Intent, IntentTable, IntentType, LogicalClock
from .manager import AdaPM
from .simulator import SimConfig, Workload, simulate

__all__ = [
    "AccessResult", "AdaPM", "CostModel", "Intent", "IntentEngine",
    "IntentStore", "IntentTable", "IntentType", "LogicalClock", "Metrics",
    "OwnerTable", "PMPolicy", "RoundLedger", "SimConfig", "Workload",
    "concurrent_intent", "decide_on_activate", "home_nodes",
    "intent_miss_bound", "simulate",
]
