"""Observability (the port of ``porqua_tpu/obs``, in part): the stage
profiler of :mod:`~porqua_tpu_torch.obs.profile`. Events, spans, rings,
the harvest, SLOs, the flight recorder and the rest are not ported
(ROADMAP queue A, item 18); the device-cost plane is item 19."""

from porqua_tpu_torch.obs.profile import (
    StageProfiler,
    annotate,
    chrome_counter_events,
    profiled_stage,
    qp_solve_profile,
)

__all__ = [
    "StageProfiler",
    "annotate",
    "chrome_counter_events",
    "profiled_stage",
    "qp_solve_profile",
]
