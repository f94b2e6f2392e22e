"""Per-dispatch stage profiling (the port of ``porqua_tpu/obs/profile.py``).

:class:`StageProfiler` is host-side stage accounting around the
solver's device dispatches (``admit`` / ``segment_step`` / ``finalize``
in the continuous batcher, ``solve_batch`` in the classic one). Each
bracketed region also enters a ``torch.profiler.record_function``
range, so a ``torch.profiler`` trace captured in the same run carries
matching ``porqua/<stage>`` ranges, and :func:`chrome_counter_events`
exports the accumulated stage seconds as Chrome-trace counter tracks.
Stage seconds cover dispatch and completion: the bracketed loops
read a result on the host at every boundary.

:func:`qp_solve_profile` is the per-dispatch MFU / bandwidth estimate:
the analytic cost of the dispatched work
(:func:`porqua_tpu_torch.profiling.admm_flop_model`), or the entry's
counted warm-up where a CostRecord is given, against measured seconds
and the card's published peaks. The harvest producers export it into
SolveRecords (``profile`` field).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = [
    "StageProfiler",
    "annotate",
    "chrome_counter_events",
    "profiled_stage",
    "qp_solve_profile",
]


@contextlib.contextmanager
def annotate(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` (it
    costs little unless a profiler is recording)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profiled_stage(profiler, name: str, annotation: str):
    """The one dispatch bracket every batching loop uses: enter the
    ``porqua/<annotation>`` range, time the block, feed ``profiler`` (a
    :class:`StageProfiler`, or ``None`` for the range only), and expose
    the elapsed seconds to the caller — ``with profiled_stage(p,
    "serve/solve_batch", "solve_batch") as h: ...; solve_s =
    h["seconds"]``."""
    holder = {"seconds": 0.0}
    t0 = time.monotonic()
    with annotate(f"porqua/{annotation}"):
        try:
            yield holder
        except BaseException:
            # A raising dispatch still reports its elapsed time to the
            # caller but is not a stage sample.
            holder["seconds"] = time.monotonic() - t0
            raise
        t1 = time.monotonic()
        holder["seconds"] = t1 - t0
        if profiler is not None:
            profiler.observe(name, holder["seconds"], t_end=t1)


class StageProfiler:
    """Thread-safe per-stage seconds/counts accumulator with a bounded
    sample log (for counter tracks)."""

    def __init__(self, sample_capacity: int = 65536) -> None:
        self._lock = tsan.lock("StageProfiler")
        # guarded-by: self._lock
        self._stages: Dict[str, Dict[str, float]] = {}
        # (t_mono_end, stage, cumulative_seconds); guarded-by: self._lock
        self._samples: List[Tuple[float, str, float]] = []
        self._sample_capacity = int(sample_capacity)
        self._samples_dropped = 0          # guarded-by: self._lock

    def observe(self, name: str, seconds: float,
                t_end: Optional[float] = None) -> None:
        with self._lock:
            slot = self._stages.setdefault(
                name, {"seconds": 0.0, "count": 0.0})
            slot["seconds"] += float(seconds)
            slot["count"] += 1.0
            if len(self._samples) < self._sample_capacity:
                self._samples.append(
                    (time.monotonic() if t_end is None else float(t_end),
                     name, slot["seconds"]))
            else:
                self._samples_dropped += 1

    @contextlib.contextmanager
    def stage(self, name: str):
        """Bracket one device dispatch: times the block and enters the
        matching ``porqua/<name>`` profiler range."""
        t0 = time.monotonic()
        with annotate(f"porqua/{name}"):
            try:
                yield
            finally:
                t1 = time.monotonic()
                self.observe(name, t1 - t0, t_end=t1)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stages": {k: dict(v) for k, v in self._stages.items()},
                "samples": len(self._samples),
                "samples_dropped": self._samples_dropped,
            }

    def stage_seconds(self) -> Dict[str, float]:
        with self._lock:
            return {k: v["seconds"] for k, v in self._stages.items()}

    def samples(self) -> List[Tuple[float, str, float]]:
        with self._lock:
            return list(self._samples)


def chrome_counter_events(profiler: StageProfiler,
                          anchor_mono: float,
                          pid: Optional[int] = None) -> List[Dict]:
    """The profiler's sample log as Chrome-trace ``"C"`` (counter)
    events, timed from ``anchor_mono`` (a ``time.monotonic`` reading):
    cumulative per-stage seconds tracks."""
    import os

    pid = os.getpid() if pid is None else pid
    return [{
        "name": f"porqua/profile/{name}",
        "cat": "profile",
        "ph": "C",
        "ts": (t - anchor_mono) * 1e6,
        "pid": pid,
        "args": {"seconds": round(cum, 6)},
    } for t, name, cum in profiler.samples()]


def qp_solve_profile(n: int, m: int, iters: float, seconds: float,
                     params=None,
                     batch: int = 1,
                     factor_rows: Optional[int] = None,
                     window: Optional[int] = None,
                     device_kind: str = "",
                     stage_seconds: Optional[Dict[str, float]] = None,
                     cost: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """FLOPs/bytes of the dispatched batch + achieved rates.

    ``seconds`` is the measured wall of the whole ``batch``-lane
    dispatch; the analytic model
    (:func:`porqua_tpu_torch.profiling.admm_flop_model`) multiplies
    per-lane cost by ``batch``, so achieved figures describe the
    dispatch, which every lane's record shares. ``window`` (or a
    factored objective's ``factor_rows``, T for tracking problems)
    re-enables the Gram-assembly accounting; the default 0 counts only
    what a pure QP solve runs. MFU fields appear only for a card
    :func:`~porqua_tpu_torch.profiling.device_peaks` knows (its name,
    ``torch.cuda.get_device_name``); on the CPU the record carries the
    cost and achieved rates alone.

    ``cost`` is the dispatched entry's CostRecord
    (:func:`porqua_tpu_torch.obs.devprof.cost_record`, looked up with
    :meth:`~porqua_tpu_torch.serve.bucketing.ExecutableCache.
    cost_record_for`). Where it carries counted flops/bytes they become
    the numerators (``cost_source``: the record's, ``"torch"`` for the
    port's), recorded under the JAX package's field names ``flops_xla``
    and ``bytes_xla`` (here they hold the warm-up's harvested count,
    not XLA's), with ``peak_bytes``; the analytic figures ride beside
    as ``model_flops``/``model_bytes`` with their
    ``flops_model_ratio``/``bytes_model_ratio``. Without ``cost`` the
    model is the numerator (``cost_source: "model"``)."""
    from porqua_tpu_torch.profiling import admm_flop_model, roofline_report
    from porqua_tpu_torch.qp.admm import SolverParams

    params = SolverParams() if params is None else params
    T = int(window if window is not None
            else (factor_rows if factor_rows is not None else 0))
    model = admm_flop_model(
        int(n), int(m), T, float(max(iters, 1.0)), int(batch),
        check_interval=params.check_interval,
        scaling_iters=params.scaling_iters,
        scaling_mode=params.scaling_mode,
        polish_passes=params.polish_passes if params.polish else 0,
        linsolve="trinv" if params.linsolve == "auto" else params.linsolve,
        woodbury_refine=params.woodbury_refine,
    )
    num_flops = model["flops_total"]
    num_bytes = model["bytes_total"]
    out: Dict[str, Any] = {
        "seconds": float(seconds),
        "batch": int(batch),
        "cost_source": "model",
    }
    cost_flops = None if cost is None else cost.get("flops")
    cost_bytes = None if cost is None else cost.get("bytes_accessed")
    if cost_flops or cost_bytes:
        from porqua_tpu_torch.obs.devprof import measured_rates

        out["cost_source"] = str(cost.get("cost_source", "torch"))
        out["model_flops"] = model["flops_total"]
        out["model_bytes"] = model["bytes_total"]
        out.update(measured_rates(cost,
                                  model_flops=model["flops_total"],
                                  model_bytes=model["bytes_total"]))
        if cost_flops:
            num_flops = float(cost_flops)
            out["flops_xla"] = num_flops
        if cost_bytes:
            num_bytes = float(cost_bytes)
            out["bytes_xla"] = num_bytes
        if cost.get("peak_bytes") is not None:
            out["peak_bytes"] = float(cost["peak_bytes"])
    out["flops_est"] = num_flops
    out["bytes_est"] = num_bytes
    if seconds > 0:
        roof = roofline_report(
            {"flops_total": num_flops, "bytes_total": num_bytes},
            float(seconds), device_kind)
        out["achieved_tflops"] = roof["achieved_tflops"]
        out["achieved_hbm_gbps"] = roof["achieved_hbm_gbps"]
        for key in ("mfu_bf16_peak", "mfu_f32_est", "hbm_utilization",
                    "roofline_bound"):
            if key in roof:
                out[key] = roof[key]
    if stage_seconds:
        out["stage_seconds"] = {k: round(v, 6)
                                for k, v in stage_seconds.items()}
    return out
