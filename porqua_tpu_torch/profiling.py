"""Per-stage timing, the analytic ADMM cost model and the card's
roofline (the port of ``porqua_tpu/profiling.py``).

Stage timers that know CUDA launches are asynchronous (a device stage
is synchronised before its clock stops), the host-side rollup of the
counters a batched solve reports (iterations, residuals, status), a
bridge to ``torch.profiler`` for Chrome traces, and the analytic FLOP
and byte model of one batched tracking solve held against the card's
published peaks.

The online solve service bridges its accumulated stage seconds into a
:class:`Tracer` (``ServeMetrics.bridge_tracer`` -> ``serve/queue_wait``,
``serve/solve``, ``serve/compile``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class StageTiming:
    name: str
    seconds: float
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _tensors(tree):
    """Every tensor of a nested tuple / list / dict / NamedTuple."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _map_tensors(fn, tree):
    """``fn`` applied to every tensor of a nested tuple / list / dict /
    NamedTuple; other leaves unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        parts = [_map_tensors(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*parts)
        return type(tree)(parts)
    return tree


def synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``; a
    tree on the host returns at once."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Tracer:
    """Collects named stage timings; nestable via context manager.

    Usage::

        tracer = Tracer()
        with tracer.stage("build"):
            problems = build_problems(bs)          # host work: no holder
        with tracer.stage("solve") as holder:
            holder["value"] = solve_batch(problems, params)  # device work
        tracer.report()

    Device stages must put their output in the yielded holder: CUDA
    launches return before the card finishes, so a stage that merely
    launches records the enqueue while the device seconds land on
    whatever waits next. The holder value's devices are synchronised
    (``torch.cuda.synchronize``) before the clock stops.
    """

    def __init__(self) -> None:
        self.timings: List[StageTiming] = []

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = True, **meta):
        """Time a stage. Yields a dict; store the stage's device output
        under ``"value"`` and (with ``block=True``) its devices are
        synchronised before the clock stops."""
        t0 = time.perf_counter()
        result_holder: Dict[str, Any] = {}
        try:
            yield result_holder
        finally:
            if block and "value" in result_holder:
                synchronize(result_holder["value"])
            self.timings.append(
                StageTiming(name, time.perf_counter() - t0, dict(meta))
            )

    def total(self) -> float:
        return sum(t.seconds for t in self.timings)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for t in self.timings:
            out[t.name] = out.get(t.name, 0.0) + t.seconds
        return out

    def report(self, file=None) -> str:
        lines = [f"{t.name:<24s} {t.seconds * 1e3:10.1f} ms  {t.meta or ''}"
                 for t in self.timings]
        lines.append(f"{'total':<24s} {self.total() * 1e3:10.1f} ms")
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text

    def to_json(self) -> str:
        return json.dumps(
            [dataclasses.asdict(t) for t in self.timings], default=str
        )


def _perturb(tree, eps: float):
    """``tree`` with ``eps`` added to every floating tensor, so that no
    layer can serve a repeated call from a cache."""
    return _map_tensors(
        lambda t: t + eps if t.is_floating_point() else t, tree)


def timed_stages(fn: Callable, *args,
                 lower_kwargs: Optional[dict] = None) -> Dict[str, float]:
    """Split a call into its first-use and steady costs; seconds per
    stage under the JAX package's keys.

    The port has no trace or lower step (``trace_lower`` is 0). Its
    ``compile`` is the first call: the kernels' build and library load,
    solver handles and allocator growth. ``execute_first`` is a second
    call on the same inputs, ``execute`` a third on inputs perturbed by
    1e-7 (the :func:`measure_device` discipline). Each call ends with
    its outputs' devices synchronised."""
    kwargs = lower_kwargs or {}
    args2 = _perturb(args, 1e-7)
    kwargs2 = _perturb(kwargs, 1e-7)
    synchronize((args2, kwargs2))  # the perturbation off the clock
    t1 = time.perf_counter()
    synchronize(fn(*args, **kwargs))
    t2 = time.perf_counter()
    synchronize(fn(*args, **kwargs))
    t3 = time.perf_counter()
    synchronize(fn(*args2, **kwargs2))
    t4 = time.perf_counter()
    return {
        "trace_lower": 0.0,
        "compile": t2 - t1,
        "execute_first": t3 - t2,
        "execute": t4 - t3,
    }


def solve_stats(solution) -> Dict[str, Any]:
    """The host-side rollup of the counters a batched solve reports
    (per-problem status, iterations and residuals)."""
    from porqua_tpu_torch.qp.admm import Status

    arr = lambda t: (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                     else np.asarray(t))
    status = arr(solution.status)
    iters = arr(solution.iters)
    return {
        "n_problems": int(status.size),
        "solved": int((status == Status.SOLVED).sum()),
        "max_iter": int((status == Status.MAX_ITER).sum()),
        "primal_infeasible": int((status == Status.PRIMAL_INFEASIBLE).sum()),
        "dual_infeasible": int((status == Status.DUAL_INFEASIBLE).sum()),
        "iters_mean": float(iters.mean()) if iters.size else 0.0,
        "iters_max": int(iters.max()) if iters.size else 0,
        "prim_res_max": float(arr(solution.prim_res).max()),
        "dual_res_max": float(arr(solution.dual_res).max()),
    }


def profiler_activities() -> list:
    """``torch.profiler`` activities: the CPU, and CUDA where a card
    is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def trace_path(logdir: str) -> str:
    """A fresh Chrome-trace file name under ``logdir`` (created)."""
    os.makedirs(logdir, exist_ok=True)
    return os.path.join(logdir,
                        f"porqua_trace_{os.getpid()}_{time.time_ns()}.json")


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace (CPU and CUDA activity) of the block,
    exported as a Chrome trace into ``logdir`` (Perfetto or
    chrome://tracing read it). Wrap the steady-state call, not the
    first one."""
    prof = torch.profiler.profile(activities=profiler_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir))


def _first_leaf(tree):
    return next(_tensors(tree), None)


def measure_device(fn, base, n_runs: int = 3):
    """Steady-state timing of ``fn(base)``: every run's input perturbed
    by a tiny constant (no layer can serve it from a cache), completion
    forced by a ``.cpu()`` of one output leaf, the first run discarded
    and the median of the rest reported.

    Returns ``(median_seconds, all_run_seconds, last_output)``."""
    times = []
    out = None
    for i in range(n_runs + 1):
        arg = _perturb(base, 1e-7 * (i + 1))
        synchronize(arg)
        t0 = time.perf_counter()
        out = fn(arg)
        leaf = _first_leaf(out)
        if leaf is not None:
            leaf.cpu()
        times.append(time.perf_counter() - t0)
    runs = times[1:]
    return sorted(runs)[len(runs) // 2], runs, out


def measure_steady_state(scalar_fn, base, k: int = 4, n_runs: int = 3,
                         return_floor: bool = False):
    """Per-execution seconds with the per-call constant cancelled.

    ``scalar_fn(base) -> scalar tensor`` runs ``k`` times on inputs
    perturbed per repetition, summed, in one call, and once alone; the
    per-execution time is ``(t_k - t_1) / (k - 1)``, so the constant
    cost of a call (the final read-back, the first launch's latency)
    cancels. A host loop, where the JAX package scans on the device.
    With ``return_floor`` also returns that constant."""

    def repeat(reps):
        def run(a):
            tot = None
            for i in range(reps):
                out = scalar_fn(_perturb(a, 1e-9 * i)).to(torch.float32)
                tot = out if tot is None else tot + out
            return tot
        return run

    r1, rk = repeat(1), repeat(k)
    synchronize((r1(base), rk(base)))  # first use of both
    t1, _, _ = measure_device(r1, base, n_runs=n_runs)
    tk, _, _ = measure_device(rk, base, n_runs=n_runs)
    per = max((tk - t1) / (k - 1), 0.0)
    if return_floor:
        return per, max(t1 - per, 0.0)
    return per


# ---------------------------------------------------------------------------
# Roofline accounting: analytic FLOPs + device-memory bytes of the ADMM work
# ---------------------------------------------------------------------------

# Per-card peaks from NVIDIA's H100 Tensor Core GPU data sheet (SXM5
# part, dense rates without sparsity, at its 700 W power limit):
# substring of torch.cuda.get_device_name -> (bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores, HBM3 bytes/s). The port runs its
# solver in f32 with TF32 off, so the f32 rate is its compute ceiling.
_PEAKS = {
    "h100 80gb hbm3": (989e12, 67e12, 3.35e12),
}


def _peaks(device_kind: str):
    kind = (device_kind or "").lower()
    for key, peaks in _PEAKS.items():
        if key in kind:
            return peaks
    return None


def device_peaks(device_kind: str):
    """(bf16 peak FLOP/s, HBM B/s) for a card's name
    (``torch.cuda.get_device_name``), or (None, None) for a card the
    table does not know."""
    peaks = _peaks(device_kind)
    return (None, None) if peaks is None else (peaks[0], peaks[2])


def device_f32_peak(device_kind: str) -> Optional[float]:
    """The card's f32 FLOP/s outside the tensor cores, or None."""
    peaks = _peaks(device_kind)
    return None if peaks is None else peaks[1]


def admm_flop_model(n: int, m: int, window: int, iters: float,
                    n_dates: int = 1, *, segments: Optional[float] = None,
                    check_interval: int = 25, scaling_iters: int = 10,
                    scaling_mode: str = "ruiz",
                    pallas: bool = False, polish_passes: int = 3,
                    polish_refine_steps: int = 3,
                    l1_kkt_solves: int = 1,
                    linsolve: str = "trinv",
                    woodbury_refine: int = 0,
                    polish_k: Optional[int] = None) -> Dict[str, float]:
    """Analytic FLOP + device-memory byte count for one batched
    tracking solve, the JAX package's model term for term: Gram
    assembly, equilibration, per-segment operator (re)factorization,
    the iteration loop, per-segment residual checks and the active-set
    polish. All counts are per problem, multiplied by ``n_dates`` at
    the end. ``iters`` is the average iteration count executed;
    ``pallas`` counts the fused segment kernels' traffic (each reads
    its resident operator once per segment)."""
    if scaling_mode not in ("ruiz", "factored"):
        raise ValueError(f"unknown scaling_mode {scaling_mode!r}; "
                         "expected 'ruiz' or 'factored'")
    T = window
    segs = (iters / check_interval) if segments is None else segments
    # On the fully factored pipeline (woodbury segments, factor-derived
    # scaling, polish off or factored) the dense P is never built.
    dense_p = not (linsolve == "woodbury" and scaling_mode == "factored"
                   and (polish_passes == 0 or polish_k is not None))
    flops = {}
    flops["gram"] = (2.0 * T * n * n if dense_p else 0.0) + 4.0 * T * n
    if scaling_mode == "factored":
        flops["scaling"] = 2.0 * T * n + (2.0 * n * n if dense_p else 0.0)
    else:
        flops["scaling"] = scaling_iters * 4.0 * (m * n + n * n)
    kcap = T + m  # capacitance dimension of the woodbury segment path
    if linsolve == "woodbury":
        # S = I + (V D^-1) V' (2 k^2 n), chol(S) and its triangular
        # inverse (k^3/3 + k^3), W = L^-1 V D^-1 (2 k^2 n).
        fact = 4.0 * kcap * kcap * n + (kcap ** 3) / 3.0 + (kcap ** 3)
    else:
        fact = (n ** 3) / 3.0 + 2.0 * m * n * n  # chol + C'rhoC assembly
        if pallas:
            if linsolve == "trinv":
                fact += (n ** 3)
            else:
                # Explicit inverse (n-rhs solve) plus one Newton
                # refinement step (two further n^3 matmuls).
                fact += 2.0 * (n ** 3) + 4.0 * (n ** 3)
        elif linsolve == "trinv":
            fact += (n ** 3)  # explicit triangular-factor inverse
        elif linsolve == "inverse":
            fact += 2.0 * (n ** 3) + 4.0 * (n ** 3)
    flops["factorize"] = segs * fact
    # Linear-solve FLOPs per iteration: chol's two triangular solves
    # (2n^2), trinv's two dense n x n matvecs (4n^2), inverse's one
    # (2n^2), woodbury's two (k x n) matvecs plus refinement pairs.
    solve_flops = {
        "chol": 2.0 * n * n,
        "trinv": 4.0 * n * n,
        "inverse": 2.0 * n * n,
        "woodbury": 4.0 * kcap * n * (1.0 + 2.0 * woodbury_refine),
    }.get(linsolve, 2.0 * n * n)
    per_iter = solve_flops + 4.0 * m * n + 15.0 * n
    flops["iterate"] = iters * per_iter
    flops["residual_checks"] = segs * (2.0 * n * n + 4.0 * m * n)
    # Each polish pass runs ``l1_kkt_solves`` reduced-Schur solves; a
    # factored objective (``polish_k`` = T + m) factors at k x k.
    if polish_k is not None:
        kk = float(polish_k)
        flops["polish"] = polish_passes * l1_kkt_solves * (
            kk ** 3 / 3.0 + kk ** 3
            + 4.0 * kk * kk * n
            + (polish_refine_steps + 1) * 8.0 * kk * n
        )
    else:
        flops["polish"] = polish_passes * l1_kkt_solves * (
            (n ** 3) / 3.0 + 2.0 * m * n * n
            + (polish_refine_steps + 1) * 8.0 * n * n
        )
    flops["tracking_error"] = 2.0 * T * n

    item = 4.0  # f32 bytes
    bytes_ = {}
    bytes_["gram"] = item * (T * n + (n * n if dense_p else 0.0))
    # Each Ruiz sweep reads P three times and writes it once; the
    # factored mode reads Pf once (plus one P read+write when dense).
    if scaling_mode == "factored":
        bytes_["scaling"] = item * (T * n
                                    + (2.0 * n * n if dense_p else 0.0))
    else:
        bytes_["scaling"] = scaling_iters * item * 4.0 * n * n
    # Operator traffic: the plain path re-reads the factor twice per
    # iteration, woodbury re-reads W per apply; a fused segment kernel
    # reads its resident operator once per segment.
    if linsolve == "woodbury":
        if pallas:
            resident = (kcap * n * (2.0 if woodbury_refine else 1.0)
                        + n * m + m * m)
            bytes_["iterate"] = segs * item * (resident + 2.0 * m * n)
        else:
            bytes_["iterate"] = iters * item * (
                2.0 * kcap * n * (1.0 + 2.0 * woodbury_refine) + 2 * m * n)
        bytes_["factorize"] = segs * item * (4.0 * kcap * n
                                             + 3.0 * kcap * kcap)
    elif pallas:
        bytes_["iterate"] = segs * item * (n * n + m * n)
        bytes_["factorize"] = segs * item * 6.0 * n * n
    else:
        bytes_["iterate"] = iters * item * 2.0 * (n * n) + iters * item * 2 * m * n
        bytes_["factorize"] = segs * item * 4.0 * n * n
    if polish_k is not None:
        bytes_["polish"] = polish_passes * l1_kkt_solves * item * float(polish_k) * n * (
            3.0 + (polish_refine_steps + 1) * 2.0
        )
    else:
        bytes_["polish"] = polish_passes * l1_kkt_solves * item * (
            3.0 * n * n + (polish_refine_steps + 1) * 2.0 * n * n
        )

    total_flops = float(sum(flops.values())) * n_dates
    total_bytes = float(sum(bytes_.values())) * n_dates
    return {
        "flops_total": total_flops,
        "bytes_total": total_bytes,
        "flops_breakdown": {k: v * n_dates for k, v in flops.items()},
        "bytes_breakdown": {k: v * n_dates for k, v in bytes_.items()},
    }


def roofline_report(model: Dict[str, float], seconds: float,
                    device_kind: str = "") -> Dict[str, Any]:
    """Achieved FLOP/s, device-memory GB/s, and MFU against the card's
    peaks.

    ``model`` is :func:`admm_flop_model` output (or any dict with
    ``flops_total``/``bytes_total``); ``seconds`` the measured wall of
    the same work. ``mfu_bf16_peak`` divides by the bf16 tensor-core
    peak; ``mfu_f32_est`` by the f32 peak outside the tensor cores: the
    port turns TF32 off, so its solver's f32 work runs there (the JAX
    package divides by its chip's bf16 peak over 3 instead). The
    compute wall of ``roofline_bound`` is the f32 peak too. MFU fields
    appear only for a card :func:`device_peaks` knows."""
    peak_flops, peak_bw = device_peaks(device_kind)
    achieved_flops = model["flops_total"] / seconds
    achieved_bw = model["bytes_total"] / seconds
    out: Dict[str, Any] = {
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_hbm_gbps": achieved_bw / 1e9,
        "model_flops": model["flops_total"],
        "model_bytes": model["bytes_total"],
    }
    if peak_flops:
        f32_peak = device_f32_peak(device_kind)
        out["mfu_bf16_peak"] = achieved_flops / peak_flops
        out["mfu_f32_est"] = achieved_flops / f32_peak
        out["hbm_utilization"] = achieved_bw / peak_bw
        # Which wall does the work hit first at full utilization?
        t_compute = model["flops_total"] / f32_peak
        t_memory = model["bytes_total"] / peak_bw
        out["roofline_bound"] = "compute" if t_compute > t_memory else "memory"
        out["roofline_seconds_min"] = max(t_compute, t_memory)
    return out
