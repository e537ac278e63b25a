"""Online serving runtime: intent-signaled request scheduling over the
managed embedding (DESIGN.md §9).

    queue -> intent -> plan -> execute
"""

from repro_torch.serve.requests import (DriftingZipfStream, ReplayStream,
                                        RequestQueue, ServeRequest)
from repro_torch.serve.runtime import (ServeConfig, ServeResult,
                                       ServingRuntime)
from repro_torch.serve.scheduler import (LatencyRecorder, MicroBatch,
                                         MicroBatchScheduler)

__all__ = [
    "DriftingZipfStream", "ReplayStream", "RequestQueue", "ServeRequest",
    "ServeConfig", "ServeResult", "ServingRuntime",
    "LatencyRecorder", "MicroBatch", "MicroBatchScheduler",
]
