"""Observability (the port of ``porqua_tpu/obs``, in part): the stage
profiler of :mod:`~porqua_tpu_torch.obs.profile` and the convergence
ring decoder of :mod:`~porqua_tpu_torch.obs.rings`. Events, spans, the
harvest, SLOs, the flight recorder and the rest are not ported
(ROADMAP queue A, item 18); the device-cost plane is item 19."""

from porqua_tpu_torch.obs.profile import (
    StageProfiler,
    annotate,
    chrome_counter_events,
    profiled_stage,
    qp_solve_profile,
)
from porqua_tpu_torch.obs.rings import ring_history, solution_ring_history

__all__ = [
    "StageProfiler",
    "annotate",
    "chrome_counter_events",
    "profiled_stage",
    "qp_solve_profile",
    "ring_history",
    "solution_ring_history",
]
