from .paging import (
    DEFAULT_DEGRADE_LADDER, KVPagePool, LOSSLESS_POLICY, PAPER_POLICY,
    PagePolicy, PrefixShareIndex,
)
from .serving import (
    MultiStreamEngine, RequestRecord, SchedulerReport, ServeEngine,
    ServeRequest, ServeScheduler, ServeStats, projected_kv_bytes,
)
from .weights import DEFAULT_TIERS, UnitMeta, WeightStore

__all__ = ["DEFAULT_DEGRADE_LADDER", "DEFAULT_TIERS", "KVPagePool",
           "LOSSLESS_POLICY", "MultiStreamEngine", "PAPER_POLICY",
           "PagePolicy", "PrefixShareIndex", "RequestRecord",
           "SchedulerReport", "ServeEngine", "ServeRequest",
           "ServeScheduler", "ServeStats", "UnitMeta", "WeightStore",
           "projected_kv_bytes"]
