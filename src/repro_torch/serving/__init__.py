"""Online serving runtime of the port: deadline-aware micro-batching,
an epoch-consistent result cache, the hub-label hot tier, concurrent
index refresh, and an open-loop load harness over the port's
``EpochedEngine`` (copied from ``src/repro/serving/__init__.py``, with
the same exports).

Owned invariant — the tier order EpochCache -> label merge -> planner
changes only COST, never answers: every response is exact for the one
epoch its flush pinned, whichever tier resolved it, and carries that
tier on the Request for per-tier accounting.

Workload mixes come straight from ``repro_torch.data.queries``
(``workload_pairs``, re-exported here for the load-harness callers)."""
from ..core.refresh_pipeline import (RefreshPipeline, Staleness,
                                     UpdateQueue)
from ..data.queries import workload_pairs
from .cache import CacheStats, EpochCache
from .loadgen import (LoadReport, run_load, run_load_with_refresh,
                      validate_against_epochs)
from .runtime import RefreshDriver, ServingRuntime
from .scheduler import MicroBatcher, Request

__all__ = [
    "CacheStats", "EpochCache", "LoadReport", "MicroBatcher",
    "RefreshDriver", "RefreshPipeline", "Request", "ServingRuntime",
    "Staleness", "UpdateQueue", "run_load", "run_load_with_refresh",
    "validate_against_epochs", "workload_pairs",
]
