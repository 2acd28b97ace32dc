"""Continuous-batching multi-graph MBE serving layer (twin of
``repro.serving``, main path): bucket planner, executable cache, the
``LocalExecutor`` with its work-stealing ``BigGraphLane``, and the
``MBEServer`` scheduler."""
from repro_torch.serving.buckets import (BucketPolicy,  # noqa: F401
                                         BucketSpec, plan_batch_size,
                                         plan_bucket, plan_route)
from repro_torch.serving.cache import (CacheEntry,  # noqa: F401
                                       ExecutableCache)
from repro_torch.serving.executor import (BigGraphLane,  # noqa: F401
                                          Executor, LanePool,
                                          LocalExecutor, RoundTelemetry)
from repro_torch.serving.scheduler import (MONOTONIC_STATS,  # noqa: F401
                                           STATS_SCHEMA, MBEResult,
                                           MBEServer, Request, imbalance)
