"""Request tracing for the MBE serving layer.

Twin of ``src/repro/serving/slo/trace.py`` (pure Python, copied as it
is): the same schema and version, so a trace written by either package
loads in the other's reader.

A *trace* is an append-only JSONL file of scheduler events — one JSON
object per line, every line carrying ``event`` and a monotonic timestamp
``t`` measured in seconds from the recorder's birth.  Event kinds:

* ``admit``  — one per request, at admission: arrival time, submitted
  shape, engine, bucket, route taken, priority, deadline, tenant, and
  the admission decision (``admitted`` / ``rejected`` + reason).
* ``result`` — one per request, at delivery: terminal ``status``
  (done | cancelled | timed_out | rejected), the request's measured
  ``queue_s`` / ``service_s`` / ``compile_s`` / ``latency_s`` split, and
  its workload counters (``steps``, ``nodes``, ``metric``).
* ``poll``   — one per scheduling round: the cumulative occupancy
  ledger (``busy_steps`` / ``total_lane_steps``), live request gauges,
  and the executable-cache compile count, so occupancy and saturation
  can be re-plotted over time after the fact.
* ``fault`` / ``retry`` / ``recovery`` — the fault-tolerance subsystem's
  ledger (schema version 2, DESIGN.md §13): one ``fault`` per observed
  fault (site + exception kind), one ``retry`` per backoff-and-retry
  (site, attempt ordinal, slept delay), one ``recovery`` per recovery
  action (``checkpoint`` / ``quarantine`` / ``failover`` + detail).
  Absent entirely when no retry policy or injector is attached.

The schema is versioned (``meta`` line, ``TRACE_VERSION``) and flat —
every value is a JSON scalar — so traces stay greppable and diffable.
The reader accepts every version in ``SUPPORTED_TRACE_VERSIONS``
(version-1 traces predate the fault events and still load; the replay
simulator skips-and-counts event kinds it does not model).
``read_trace`` returns raw event dicts; ``load_requests`` merges each
request's admit + result pair into one ``TraceRecord`` row, which is the
unit the replay simulator (``repro_torch.serving.slo.simulate``) and the
what-if planner consume.

Recording costs one dict + one ``json.dump`` per event on the host side
and nothing on the device side; with no recorder attached the server
takes no branch at all (the byte-identity guarantee).
"""
from __future__ import annotations

import dataclasses
import json
import time

TRACE_VERSION = 2           # v2: + fault / retry / recovery events
SUPPORTED_TRACE_VERSIONS = frozenset((1, 2))


class TraceRecorder:
    """Append-only JSONL trace writer.

    Opens ``path`` lazily on the first event (so constructing a server
    with a trace path but never serving leaves no file), prepends one
    ``meta`` line with the schema version, and flushes every line — a
    crash mid-stream loses at most the event being written.
    """

    def __init__(self, path: str):
        self.path = path
        self.t0 = time.perf_counter()
        self.n_events = 0
        self._f = None

    # ------------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the recorder's birth (the trace clock)."""
        return time.perf_counter() - self.t0

    def write(self, event: str, **fields) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
            json.dump(dict(event="meta", version=TRACE_VERSION, t=0.0),
                      self._f, sort_keys=True)
            self._f.write("\n")
        rec = dict(event=event, t=round(self.now(), 6), **fields)
        json.dump(rec, self._f, sort_keys=True)
        self._f.write("\n")
        self._f.flush()
        self.n_events += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # -- event helpers (the scheduler's hook surface) -------------------
    def admit(self, *, rid: int, name: str, n_u: int, n_v: int,
              engine: str, route: str, bucket: tuple[int, int],
              priority: int, deadline_s: float | None, tenant: str,
              admitted: bool, reason: str = "ok") -> None:
        self.write("admit", rid=rid, name=name, n_u=n_u, n_v=n_v,
                   engine=engine, route=route, bucket_u=bucket[0],
                   bucket_v=bucket[1], priority=priority,
                   deadline_s=deadline_s, tenant=tenant,
                   admitted=admitted, reason=reason)

    def result(self, *, rid: int, status: str, steps: int, nodes: int,
               metric: int, queue_s: float, service_s: float,
               compile_s: float, latency_s: float) -> None:
        self.write("result", rid=rid, status=status, steps=steps,
                   nodes=nodes, metric=metric,
                   queue_s=round(queue_s, 6),
                   service_s=round(service_s, 6),
                   compile_s=round(compile_s, 6),
                   latency_s=round(latency_s, 6))

    def poll(self, *, busy_steps: int, total_lane_steps: int,
             exec_s: float, pending: int, in_flight: int,
             compiles: int) -> None:
        self.write("poll", busy_steps=busy_steps,
                   total_lane_steps=total_lane_steps,
                   exec_s=round(exec_s, 6), pending=pending,
                   in_flight=in_flight, compiles=compiles)

    # -- fault-tolerance events (schema v2, DESIGN.md §13) --------------
    def fault(self, *, site: str, kind: str) -> None:
        """One observed fault: where it surfaced and the exception kind
        (or ``corrupted-read`` for a caught scoreboard corruption)."""
        self.write("fault", site=site, kind=kind)

    def retry(self, *, site: str, attempt: int, delay_s: float) -> None:
        """One backoff-and-retry: the site, the attempt ordinal that just
        failed, and the (deadline-clamped) backoff actually slept."""
        self.write("retry", site=site, attempt=attempt,
                   delay_s=round(delay_s, 6))

    def recovery(self, *, action: str, detail: str = "") -> None:
        """One recovery action: ``checkpoint`` | ``quarantine`` |
        ``failover``, with a human-readable detail string."""
        self.write("recovery", action=action, detail=detail)


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    """One request's full life, merged from its admit + result events.

    ``t_arrival`` is on the trace clock; measured latency components are
    ``None`` for requests whose result event never landed (trace cut
    short).  This is the replay simulator's input row.
    """

    rid: int
    name: str
    t_arrival: float
    n_u: int
    n_v: int
    engine: str
    route: str
    bucket: tuple[int, int]
    priority: int
    deadline_s: float | None
    tenant: str
    admitted: bool
    reason: str
    status: str | None = None
    steps: int | None = None
    nodes: int | None = None
    metric: int | None = None
    queue_s: float | None = None
    service_s: float | None = None
    compile_s: float | None = None
    latency_s: float | None = None


def read_trace(path: str) -> list[dict]:
    """Raw event dicts, meta line validated and dropped."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("event") == "meta":
                v = rec.get("version")
                if v not in SUPPORTED_TRACE_VERSIONS:
                    raise ValueError(
                        f"trace {path!r} has schema version {v}, "
                        f"reader speaks "
                        f"{sorted(SUPPORTED_TRACE_VERSIONS)}")
                continue
            out.append(rec)
    return out


def load_requests(path_or_events) -> list[TraceRecord]:
    """Per-request ``TraceRecord`` rows (admit + result merged by rid),
    in arrival order.  Accepts a trace path or pre-read event dicts."""
    events = (read_trace(path_or_events)
              if isinstance(path_or_events, str) else list(path_or_events))
    admits: dict[int, dict] = {}
    results: dict[int, dict] = {}
    for e in events:
        if e["event"] == "admit":
            admits[e["rid"]] = e
        elif e["event"] == "result":
            results[e["rid"]] = e
    rows = []
    for rid in sorted(admits):
        a = admits[rid]
        r = results.get(rid, {})
        rows.append(TraceRecord(
            rid=rid, name=a["name"], t_arrival=a["t"], n_u=a["n_u"],
            n_v=a["n_v"], engine=a["engine"], route=a["route"],
            bucket=(a["bucket_u"], a["bucket_v"]),
            priority=a["priority"], deadline_s=a["deadline_s"],
            tenant=a["tenant"], admitted=a["admitted"],
            reason=a["reason"], status=r.get("status"),
            steps=r.get("steps"), nodes=r.get("nodes"),
            metric=r.get("metric"), queue_s=r.get("queue_s"),
            service_s=r.get("service_s"), compile_s=r.get("compile_s"),
            latency_s=r.get("latency_s")))
    return rows


class TraceReader:
    """Convenience view over one trace file: the raw events, the merged
    per-request rows, and the poll-event occupancy series."""

    def __init__(self, path: str):
        self.path = path
        self.events = read_trace(path)
        self.requests = load_requests(self.events)

    def polls(self) -> list[dict]:
        return [e for e in self.events if e["event"] == "poll"]

    def cost_model(self):
        """A ``CostModel`` calibrated from this trace (poll-ledger rate
        when the trace has poll events; see ``CostModel.from_trace``)."""
        from repro_torch.serving.slo.simulate import CostModel
        return CostModel.from_trace(self.requests, polls=self.polls())

    def occupancy(self) -> float:
        """Final cumulative occupancy from the last poll event (0.0 for
        a trace with no polls)."""
        ps = self.polls()
        if not ps:
            return 0.0
        last = ps[-1]
        total = last["total_lane_steps"]
        return (last["busy_steps"] / total) if total else 0.0
