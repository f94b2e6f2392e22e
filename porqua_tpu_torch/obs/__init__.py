"""Observability for the serve stack (the port of ``porqua_tpu/obs``).

* Request spans (:mod:`~porqua_tpu_torch.obs.trace`), recorded at every
  pipeline transition and exported as Chrome-trace JSON, and the
  structured event bus (:mod:`~porqua_tpu_torch.obs.events`).
* The convergence rings decoder (:mod:`~porqua_tpu_torch.obs.rings`)
  and the stage profiler (:mod:`~porqua_tpu_torch.obs.profile`).
* The telemetry warehouse (:mod:`~porqua_tpu_torch.obs.harvest`).
* The live plane: SLOs and burn-rate alerting
  (:mod:`~porqua_tpu_torch.obs.slo`), the incident flight recorder
  (:mod:`~porqua_tpu_torch.obs.flight`), convergence anomaly detection
  (:mod:`~porqua_tpu_torch.obs.anomaly`) and the closed route
  calibration loop (:mod:`~porqua_tpu_torch.obs.calibrate`).
* Prometheus exposition with a stdlib ``/metrics`` + ``/healthz``
  endpoint (:mod:`~porqua_tpu_torch.obs.exposition`) and process vitals
  (:mod:`~porqua_tpu_torch.obs.vitals`).
* The device-cost plane (:mod:`~porqua_tpu_torch.obs.devprof`): one
  CostRecord per compiled serving entry (its counted warm-up: flops,
  bytes, peak memory, an op-sequence hash), the ``CostLog``
  warehouse, a bounded ``torch.profiler`` window and the roofline
  verdict.
* The readers: the text report (:mod:`~porqua_tpu_torch.obs.report`),
  the run ledger (:mod:`~porqua_tpu_torch.obs.ledger`) and the fleet
  federation (:mod:`~porqua_tpu_torch.obs.federation`).

:class:`Observability` bundles one span recorder and one event bus;
pass it to ``SolveService(obs=...)``. Everything here is host code: it
changes nothing the card runs.
"""

from porqua_tpu_torch.obs.anomaly import AnomalyDetector
from porqua_tpu_torch.obs.calibrate import Calibrator, replay_audit
from porqua_tpu_torch.obs.devprof import (
    CostLog,
    ProfileWindow,
    cost_record,
    load_cost_records,
    roofline_verdict,
)
from porqua_tpu_torch.obs.events import EventBus, load_jsonl
from porqua_tpu_torch.obs.exposition import ObsHTTPServer, prometheus_text
from porqua_tpu_torch.obs.federation import FleetCollector, WorkerStream
from porqua_tpu_torch.obs.flight import FlightRecorder, load_bundle
from porqua_tpu_torch.obs.harvest import (
    HarvestSink,
    aggregate,
    harvest_solution,
    load_harvest,
    solve_record,
)
from porqua_tpu_torch.obs.ledger import (
    append_row,
    ledger_row,
    load_ledger,
    rolling_median,
)
from porqua_tpu_torch.obs.profile import (
    StageProfiler,
    annotate,
    chrome_counter_events,
    profiled_stage,
    qp_solve_profile,
)
from porqua_tpu_torch.obs.report import render_report
from porqua_tpu_torch.obs.rings import ring_history, solution_ring_history
from porqua_tpu_torch.obs.slo import (
    SLO,
    BurnRateRule,
    SLOEngine,
    TenantSLOSet,
    default_slos,
)
from porqua_tpu_torch.obs.trace import Span, SpanRecorder
from porqua_tpu_torch.obs.vitals import VitalsTrend, process_vitals


class Observability:
    """One span recorder + one event bus, shared by a serve stack."""

    def __init__(self, span_capacity: int = 262144,
                 event_capacity: int = 65536,
                 event_path=None) -> None:
        self.spans = SpanRecorder(capacity=span_capacity)
        self.events = EventBus(capacity=event_capacity, path=event_path)

    def write(self, trace_path=None, events_path=None) -> None:
        """Dump whichever artifacts were requested."""
        if trace_path:
            self.spans.write(trace_path)
        if events_path:
            self.events.write_jsonl(events_path)


__all__ = [
    "AnomalyDetector",
    "BurnRateRule",
    "Calibrator",
    "CostLog",
    "EventBus",
    "FleetCollector",
    "FlightRecorder",
    "HarvestSink",
    "Observability",
    "ObsHTTPServer",
    "ProfileWindow",
    "SLO",
    "SLOEngine",
    "Span",
    "SpanRecorder",
    "StageProfiler",
    "TenantSLOSet",
    "VitalsTrend",
    "WorkerStream",
    "aggregate",
    "annotate",
    "append_row",
    "chrome_counter_events",
    "cost_record",
    "default_slos",
    "harvest_solution",
    "ledger_row",
    "load_bundle",
    "load_cost_records",
    "load_harvest",
    "load_jsonl",
    "load_ledger",
    "process_vitals",
    "profiled_stage",
    "prometheus_text",
    "qp_solve_profile",
    "render_report",
    "replay_audit",
    "ring_history",
    "rolling_median",
    "roofline_verdict",
    "solution_ring_history",
    "solve_record",
]
