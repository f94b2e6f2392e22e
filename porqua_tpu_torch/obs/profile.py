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

The per-solve roofline estimate :func:`qp_solve_profile` needs the
flop model of ``profiling.py`` and the device-cost plane; it is not
ported yet and raises.
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


def qp_solve_profile(*args, **kwargs):
    """The per-solve FLOPs/bytes estimate of the JAX package (its
    ``profiling.admm_flop_model`` against the executable's cost
    analysis): not ported yet."""
    from porqua_tpu_torch.batch import _not_ported

    raise _not_ported("qp_solve_profile (profiling.py, obs/devprof.py)",
                      "item 19")
