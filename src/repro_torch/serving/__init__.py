"""Continuous-batching multi-graph MBE serving layer (twin of
``repro.serving``): bucket planner, executable cache, the
``LocalExecutor`` and the ``ShardedExecutor`` (lane pools over a serving
mesh) with their work-stealing ``BigGraphLane``, the
``MBEServer`` scheduler, the fault-tolerance subsystem (``faults``:
the deterministic ``FaultInjector``; ``recovery``: ``RetryPolicy``,
``CheckpointStore``, ``verified_read``) and the SLO subsystem
(``slo``: tracing, replay simulation, admission control, planner)."""
from repro_torch.serving.buckets import (BucketPolicy,  # noqa: F401
                                         BucketSpec, plan_batch_size,
                                         plan_bucket, plan_route)
from repro_torch.serving.cache import (CacheEntry,  # noqa: F401
                                       ExecutableCache)
from repro_torch.serving.executor import (BigGraphLane,  # noqa: F401
                                          Executor, LanePool,
                                          LocalExecutor, RoundTelemetry,
                                          ShardedExecutor)
from repro_torch.serving.faults import (DeviceLostError,  # noqa: F401
                                        FaultError, FaultInjector,
                                        FaultPlan, InjectedCompileError,
                                        PoisonError, TransientLaunchError)
from repro_torch.serving.recovery import (CheckpointStore,  # noqa: F401
                                          RetryPolicy, verified_read)
from repro_torch.serving.scheduler import (MONOTONIC_STATS,  # noqa: F401
                                           STATS_SCHEMA, MBEResult,
                                           MBEServer, Request, imbalance)
from repro_torch.serving.slo import (AdmissionController,  # noqa: F401
                                     AdmissionPolicy, CostModel,
                                     TraceReader, TraceRecorder,
                                     load_requests)
