"""SLO serving subsystem: request tracing, trace-replay simulation,
admission control and what-if policy sweeps.

Twin of ``src/repro/serving/slo/`` (pure Python, copied with the same
schema, scalars and decisions): ``trace`` (``TraceRecorder``, the JSONL
request trace and its readers), ``simulate`` (``CostModel`` and the
host-side discrete-event replay), ``admission`` (``AdmissionController``:
backpressure, weighted per-tenant fairness, shed-on-deadline) and
``planner`` (policy sweeps and their Pareto frontier).  A trace written
by either package loads in the other's reader.

Wiring: ``MBEOptions(admission=..., trace_path=...)`` /
``MBEClient.submit(..., tenant=...)``; with admission disabled and
tracing off the server takes no extra branch.
"""
from repro_torch.serving.slo.admission import (  # noqa: F401
    AdmissionController, AdmissionPolicy, Decision)
from repro_torch.serving.slo.planner import (  # noqa: F401
    candidate_policies, frontier, sweep)
from repro_torch.serving.slo.simulate import (  # noqa: F401
    CostModel, SimReport, SimRequest, compare_trace, replay, simulate)
from repro_torch.serving.slo.trace import (  # noqa: F401
    TraceReader, TraceRecord, TraceRecorder, load_requests, read_trace)
