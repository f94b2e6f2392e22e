"""Contracts on the op trace of the public entry points (the port of
``porqua_tpu/analysis/contracts.py``).

The JAX package traces each entry point abstractly and asserts
properties of the jaxpr. The port has no trace without a run: each
entry point (``solve_batch`` dense and factored, the serving entry
body, ``tracking_step``, the compaction step-and-repack, the
continuous-batching admit/step/finalize triple, on every backend) runs
on real seeded inputs at the JAX programs' sizes (batch 4, n 16, m 4)
under :func:`porqua_tpu_torch.analysis.hlo.record_program`, which
records every aten op and kernel launch, and the recording is held to:

GC101  **No float64 in a float32 program**: no op produces a float64
       result (a Python or numpy float64 leaking into a tensor, an
       unpinned ``torch.tensor`` default).
GC102  **No undeclared transfer or host read**: no copy between devices
       and no host read of a tensor's value inside the program, apart
       from the reads declared with ``sanitize.explicit_transfer()``,
       which are at most one per segment boundary (the segment loop's
       "is any lane still active?").
GC103  **Stable output dtypes**: every output tensor is the input float
       dtype, int32, bool or int64 (torch indexes with int64: the
       compaction repack's lane map), so entries cached per shape bucket
       agree on their result buffers.
GC104-GC111  **Identity**: each host plane (fault injection, harvest and
       profiling, SLO/flight/anomaly, the cost plane, federation,
       tenancy, routing, calibration) exercised for real between two
       recordings leaves every program's op trace identical: the port's
       counterpart of the JAX package's string-identical jaxprs.

The programs are small and run for real on ``device`` (default: the
card; ``device="cpu"`` runs the plain twins), so a full sweep costs
seconds on the CPU.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from porqua_tpu_torch.analysis.lint import Finding

__all__ = [
    "check_calibration_identity",
    "check_devprof_identity",
    "check_entry_points",
    "check_federation_identity",
    "check_observability_identity",
    "check_op_trace",
    "check_resilience_identity",
    "check_routing_identity",
    "check_run_batch",
    "check_telemetry_identity",
    "check_tenancy_identity",
    "compaction_step_program",
    "continuous_programs",
    "example_batch",
    "serve_entry_program",
    "solve_batch_program",
    "trace_program",
    "tracking_program",
]

def trace_program(label: str, fn, args, device=None):
    """Record ``fn(*args)``'s op trace (:func:`porqua_tpu_torch.analysis.
    hlo.record_program` without the cost counts)."""
    from porqua_tpu_torch.analysis.hlo import record_program

    return record_program(label, fn, args, device=device, cost=False)


def _out_dtypes(out) -> List[torch.dtype]:
    if isinstance(out, torch.Tensor):
        return [out.dtype]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [d for o in out for d in _out_dtypes(o)]
    return []


def check_op_trace(recording, label: str,
                   expect_float=torch.float32) -> List[Finding]:
    """Assert the GC101/GC102/GC103 contracts on one recorded program
    (an :class:`~porqua_tpu_torch.analysis.hlo.OpRecording`)."""
    from porqua_tpu_torch.analysis import hlolint

    findings: List[Finding] = []
    path = f"<trace:{label}>"

    def emit(rule: str, message: str) -> None:
        findings.append(Finding(rule, path, 0, 0, message))

    trace = hlolint.parse_trace(recording.text)
    inputs_f64 = any(p.shape.startswith("f64") for p in trace.params)
    seen_f64, seen_102 = set(), set()
    undeclared_reads = 0
    for instr in trace.ops:
        base = instr.base
        if base == "_local_scalar_dense":
            if not instr.declared:
                undeclared_reads += 1
                if base not in seen_102:
                    seen_102.add(base)
                    emit("GC102", f"host read of a tensor's value ({instr.op}"
                                  f", line {instr.line}) inside the program "
                                  "that is not declared with "
                                  "sanitize.explicit_transfer(): a sync per "
                                  "call")
        elif base in ("_to_copy", "copy_") and not instr.declared:
            devs = {trace.by_name[o].device for o in instr.operands
                    if o in trace.by_name} | {instr.device}
            if len(devs) > 1 and "copy" not in seen_102:
                seen_102.add("copy")
                emit("GC102", f"copy between devices {sorted(devs)} "
                              f"({instr.op}, line {instr.line}) inside the "
                              "program: a transfer per call")
        if inputs_f64:
            continue  # an f64 caller opted in; dtype policing is moot
        if "f64" in hlolint.shape_dtypes(instr.shape) and instr.op not in \
                seen_f64:
            seen_f64.add(instr.op)
            emit("GC101", f"{instr.op} produces float64 inside a float32 "
                          f"program (line {instr.line})")
    boundaries = recording.segments + 1
    if recording.declared_reads > boundaries:
        emit("GC102", f"{recording.declared_reads} declared host reads for "
                      f"{recording.segments} segments: more than one per "
                      "segment boundary")
    expect = torch.float64 if inputs_f64 else expect_float
    for i, dt in enumerate(_out_dtypes(recording.output)):
        if dt in (expect, torch.int32, torch.bool, torch.int64):
            continue
        emit("GC103", f"output {i} has dtype {dt} (expected {expect}/"
                      "int32/bool/int64): entries cached per shape bucket "
                      "must agree on result buffers")
    return findings


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

def example_batch(batch: int = 4, n: int = 16, m: int = 4,
                  factor_rows: Optional[int] = None,
                  dtype=torch.float32, device=None, seed: int = 0):
    """A seeded batch of small long-only tracking-style QPs at ``(batch,
    n, m)`` on ``device`` (default: the card): ``P = 2 X'X`` (+ a ridge
    on the diagonal; with ``factor_rows`` the factor ``Pf = X`` of that
    many rows), a budget row and ``m - 1`` group caps, box ``[0, 1]``."""
    from porqua_tpu_torch.qp.canonical import CanonicalQP, stack_qps
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = factor_rows or 2 * n
    qps = []
    for _ in range(batch):
        X = rng.standard_normal((rows, n)) * 0.1
        y = X @ rng.dirichlet(np.ones(n)) + 0.01 * rng.standard_normal(rows)
        ridge = 1e-3 * np.ones(n)
        C = np.vstack([np.ones((1, n)),
                       (rng.random((m - 1, n)) < 0.5).astype(float)])
        l = np.concatenate([[1.0], np.zeros(m - 1)])
        u = np.concatenate([[1.0], np.full(m - 1, 0.7)])
        factor = (dict(Pf=X, Pdiag=2 * ridge)
                  if factor_rows else {})
        qps.append(CanonicalQP.build(
            2 * X.T @ X + np.diag(2 * ridge), -2 * X.T @ y, C=C, l=l, u=u,
            lb=np.zeros(n), ub=np.ones(n), dtype=dtype, device="cpu",
            **factor))
    return stack_qps(qps).to(dev)


def _params(params):
    from porqua_tpu_torch.qp.canonical import HP
    from porqua_tpu_torch.qp.solve import SolverParams

    HP.apply()
    return SolverParams() if params is None else params


def solve_batch_program(batch: int = 4, n: int = 16, m: int = 4,
                        factor_rows: Optional[int] = None,
                        params=None, dtype=torch.float32, device=None):
    """The ``(fn, example_args)`` pair behind the batched solve: the body
    ``solve_qp_batch`` / ``solve_batch`` run (``_solve_impl``) on a
    seeded batch on ``device``. The contracts record it; the harvester
    (:mod:`porqua_tpu_torch.analysis.hlo`) records the same closure."""
    from porqua_tpu_torch.qp.solve import _solve_impl

    params = _params(params)
    qp = example_batch(batch, n, m, factor_rows, dtype, device)
    return (lambda q: _solve_impl(q, params)), (qp,)


def serve_entry_program(batch: int = 4, n: int = 16, m: int = 4,
                        factor_rows: Optional[int] = None,
                        params=None, dtype=torch.float32, device=None):
    """``(fn, example_args)`` for the serving entry body (what
    ``aot_compile_batch``'s entry runs: the batch solve with warm-start
    inputs)."""
    from porqua_tpu_torch.qp.solve import _solve_impl

    params = _params(params)
    qp = example_batch(batch, n, m, factor_rows, dtype, device)
    x0, y0 = torch.zeros_like(qp.q), torch.zeros_like(qp.l)
    return (lambda q, xx, yy: _solve_impl(q, params, xx, yy)), (qp, x0, y0)


def tracking_program(batch: int = 2, window: int = 8, n_assets: int = 6,
                     params=None, dtype=torch.float32, device=None):
    """``(fn, example_args)`` for the tracking backtest step (build +
    solve + evaluate) on seeded data."""
    from porqua_tpu_torch.qp.solve import resolve_device
    from porqua_tpu_torch.tracking import synthetic_universe_np, tracking_step

    params = _params(params)
    dev = resolve_device(device)
    Xs, ys = synthetic_universe_np(0, batch, window, n_assets)
    Xs = torch.as_tensor(Xs, dtype=dtype).to(dev)
    ys = torch.as_tensor(ys, dtype=dtype).to(dev)
    return (lambda X, y: tracking_step(X, y, params, device=dev)), (Xs, ys)


def compaction_step_program(batch: int = 6, group: int = 4,
                            n: int = 16, m: int = 4,
                            factor_rows: Optional[int] = None,
                            params=None, dtype=torch.float32, device=None):
    """``(fn, example_args)`` for the compaction driver's step-and-repack
    as :class:`porqua_tpu_torch.compaction.CompactingDriver` runs it: one
    segment over a ``group``-wide lane set, the per-lane freeze, the
    scatter-back into the ``batch``-wide buffer and the stable
    active-first repack. GC102 on it is the checked form of "the repack
    makes no host read or transfer"."""
    from porqua_tpu_torch.compaction import step_and_repack
    from porqua_tpu_torch.qp.solve import map_tensors, prepare_batch

    params = _params(params)
    qp = example_batch(batch, n, m, factor_rows, dtype, device)
    scaled, scaling, carry, _, _ = prepare_batch(qp, params)
    take = lambda t: map_tensors(lambda a: a[:group], t)
    dev = qp.q.device
    grp = (take(scaled), take(scaling), take(carry), None, None,
           torch.arange(group, device=dev),
           torch.full((group,), 80, dtype=torch.int32, device=dev))
    return (lambda buf, g: step_and_repack(buf, g, params)), \
        (carry.state, grp)


def continuous_programs(batch: int = 4, n: int = 16, m: int = 4,
                        factor_rows: Optional[int] = None,
                        params=None, dtype=torch.float32, device=None):
    """The continuous-batching triple (admit / step / finalize), the
    closures ``aot_compile_continuous`` binds, as
    ``[(label, fn, example_args)]``."""
    from porqua_tpu_torch.qp.solve import (continuous_entries,
                                           neutral_batch, prepare_batch)

    params = _params(params)
    qp = example_batch(batch, n, m, factor_rows, dtype, device)
    dev = qp.q.device
    x0, y0 = torch.zeros_like(qp.q), torch.zeros_like(qp.l)
    mask = torch.ones(batch, dtype=torch.bool, device=dev)
    old = prepare_batch(neutral_batch(qp, dev), params, x0, y0)[:3]
    scaled, scaling, carry = prepare_batch(qp, params, x0, y0)[:3]
    admit, step, fin = continuous_entries(params)
    return [
        ("continuous_admit", admit, (qp, x0, y0, mask) + tuple(old)),
        ("continuous_step", step, (scaled, scaling, carry, mask)),
        ("continuous_finalize", fin, (qp, scaled, scaling, carry.state)),
    ]


def _fp(pair) -> str:
    """The op-trace fingerprint of one ``(fn, args)`` program."""
    fn, args = pair
    return trace_program("program", fn, args).fingerprint


def check_resilience_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC104: fault injection must be invisible to the programs.

    The resilience plane's seams live in host dispatch code only: with
    the injector disabled the solve/serve programs are the ones without
    the plane. The solve-batch and serve entry points are recorded bare
    and again with a live injector whose scenario covers every seam and
    fault kind; the two op traces must be identical (same fingerprint)
    and no seam may fire while a program runs. Requires no injector to
    be active (it installs its own; an installed one raises)."""
    from porqua_tpu_torch.resilience import faults

    def trace_all():
        return [("solve_batch", _fp(solve_batch_program(dtype=dtype, device=device))),
                ("serve_entry", _fp(serve_entry_program(dtype=dtype, device=device)))]

    findings: List[Finding] = []
    baseline = trace_all()
    mk = faults.FaultSpec.make
    scenario = faults.Scenario("gc104-contract", (
        mk("serve.dispatch", "device_lost", count=1_000_000),
        mk("serve.continuous", "device_lost", count=1_000_000),
        mk("serve.result", "nan_lanes", count=1_000_000, lanes=1),
        mk("serve.admission", "clock_skew", count=1_000_000, skew_s=1.0),
        mk("health.probe", "probe_fail", count=1_000_000),
        mk("cache.get", "compile_storm", count=1_000_000),
        mk("data.feed", "feed_corrupt", count=1_000_000),
        mk("backtest.chunk", "crash", count=1_000_000),
    ))
    # Install OUTSIDE the recording try-block: a pre-installed injector is
    # a usage error (install raises RuntimeError) and must propagate as
    # such, not be misreported as a seam reachable from tracing.
    inj = faults.install(faults.FaultInjector(scenario))
    try:
        try:
            injected = trace_all()
            fired = inj.fires()
        except BaseException as exc:  # noqa: BLE001 - seam fired mid-trace
            return [Finding(
                "GC104", "<trace:resilience_identity>", 0, 0,
                f"recording with a live injector raised "
                f"{type(exc).__name__}: {exc} — a fault seam is "
                f"reachable from a program")]
    finally:
        faults.uninstall()
    if fired:
        findings.append(Finding(
            "GC104", "<trace:resilience_identity>", 0, 0,
            f"{fired} fault seam hit(s) fired while a program ran — seams "
            "must live strictly in host dispatch code"))
    for (label, base), (_, inj_str) in zip(baseline, injected):
        if base != inj_str:
            findings.append(Finding(
                "GC104", f"<trace:{label}>", 0, 0,
                "recorded op trace differs with a fault injector "
                "installed: the injector-disabled program is no longer "
                "the pre-resilience one (bit-identical-when-disabled "
                "contract broken)"))
    return findings


def check_telemetry_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC105: the telemetry warehouse must be invisible to the programs.

    Harvest and profiling are host post-processing: the solve/serve/
    compaction-step programs are recorded bare, then inside a live
    ``StageProfiler`` stage with a live ``HarvestSink``, and the op
    traces must be identical; a sink emit between recordings must not
    change the next one."""
    from porqua_tpu_torch.obs.harvest import HarvestSink, solve_record
    from porqua_tpu_torch.obs.profile import StageProfiler
    from porqua_tpu_torch.qp.solve import SolverParams

    ring_params = SolverParams(ring_size=4)

    def trace_all():
        return [
            ("solve_batch", _fp(solve_batch_program(dtype=dtype, device=device))),
            ("solve_batch[rings]", _fp(solve_batch_program(
                params=ring_params, dtype=dtype, device=device))),
            ("serve_entry", _fp(serve_entry_program(dtype=dtype, device=device))),
            ("compaction_step", _fp(compaction_step_program(dtype=dtype, device=device))),
        ]

    findings: List[Finding] = []
    baseline = trace_all()
    profiler = StageProfiler()
    sink = HarvestSink(path=None)
    with profiler.stage("gc105-contract"):
        telemetered = trace_all()
    # The sink must also demonstrably be pure host code: emitting a
    # record between traces cannot perturb the next trace.
    sink.emit(solve_record("batch", 4, 2, 1, 10, 0.0, 0.0, 0.0))
    post_emit = _fp(solve_batch_program(dtype=dtype, device=device))
    for (label, base), (_, tele) in zip(baseline, telemetered):
        if base != tele:
            findings.append(Finding(
                "GC105", f"<trace:{label}>", 0, 0,
                "recorded op trace differs inside an active StageProfiler "
                "stage: the telemetry plane is no longer invisible to "
                "the programs (harvest-disabled bit-identity contract broken)"))
    if post_emit != baseline[0][1]:
        findings.append(Finding(
            "GC105", "<trace:solve_batch>", 0, 0,
            "recorded op trace differs after a HarvestSink.emit — the "
            "sink leaked state into the programs"))
    if sink.records != 1 or sink.write_failures:
        findings.append(Finding(
            "GC105", "<trace:telemetry_identity>", 0, 0,
            "in-memory HarvestSink did not record the probe emit"))
    return findings


def check_observability_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC106: the live SLO/flight/anomaly plane must be invisible to the
    programs.

    The programs are recorded bare; then an SLO engine bound to real
    metrics fires a burn-rate alert on a stepped clock, the alert trips
    a flight-recorder dump through an event-bus listener, an anomaly
    detector crosses its band, and the programs are recorded again. The
    op traces must be identical, and the probe checks it exercised the
    plane."""
    from porqua_tpu_torch.obs.anomaly import AnomalyDetector
    from porqua_tpu_torch.obs.events import EventBus
    from porqua_tpu_torch.obs.flight import FlightRecorder
    from porqua_tpu_torch.obs.slo import SLOEngine, default_slos
    from porqua_tpu_torch.resilience.faults import FaultClock
    from porqua_tpu_torch.serve.metrics import ServeMetrics

    def trace_all():
        return [
            ("solve_batch", _fp(solve_batch_program(dtype=dtype, device=device))),
            ("serve_entry", _fp(serve_entry_program(dtype=dtype, device=device))),
            ("compaction_step", _fp(compaction_step_program(dtype=dtype, device=device))),
        ]

    findings: List[Finding] = []
    baseline = trace_all()

    clock = FaultClock()
    metrics = ServeMetrics()
    events = EventBus(capacity=1024)
    engine = SLOEngine(default_slos(), clock=clock,
                       min_eval_interval_s=0.0).bind(metrics,
                                                     events=events)
    flight = FlightRecorder(out_dir=None, debounce_s=0.0, clock=clock)
    flight.attach(metrics=metrics, slo=engine)
    events.add_listener(flight.on_event)
    detector = AnomalyDetector.from_aggregate(
        {"groups": [{"bucket": "16x4", "eps_abs": 1e-3,
                     "iters": {"p50": 50.0, "p95": 100.0, "max": 150.0},
                     "wasted_iteration_fraction": 0.1, "count": 64}]},
        min_samples=4, events=events)
    # Drive the plane hot: a hard availability breach across two
    # evaluations (so the windows have a real delta), plus anomaly
    # observations far past the baseline band.
    engine.evaluate()
    metrics.inc("completed", 5)
    metrics.inc("failed", 95)
    clock.advance(10.0)
    engine.evaluate()
    for _ in range(8):
        detector.observe("16x4", 1e-3, iters=5000, segments=200,
                         check_interval=25)
    live = trace_all()
    post = _fp(solve_batch_program(dtype=dtype, device=device))

    if engine.status()["alerts_fired"] < 1 or not flight.bundles():
        findings.append(Finding(
            "GC106", "<trace:observability_identity>", 0, 0,
            "the live-plane probe did not exercise itself (no alert "
            "fired or no bundle dumped) — the identity check proved "
            "nothing"))
    if detector.status()["fired"] < 1:
        findings.append(Finding(
            "GC106", "<trace:observability_identity>", 0, 0,
            "the anomaly-detector probe never crossed its baseline "
            "band — the identity check proved nothing"))
    for (label, base), (_, lv) in zip(baseline, live):
        if base != lv:
            findings.append(Finding(
                "GC106", f"<trace:{label}>", 0, 0,
                "recorded op trace differs with the live SLO/flight/"
                "anomaly plane active: the plane is no longer "
                "invisible to the programs (disabled-bit-identity contract "
                "broken)"))
    if post != baseline[0][1]:
        findings.append(Finding(
            "GC106", "<trace:solve_batch>", 0, 0,
            "recorded op trace differs after a flight-recorder dump — "
            "the incident plane leaked state into the programs"))
    return findings


def check_devprof_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC107: the device-cost plane must be invisible to the programs.

    The programs are recorded bare; then a probe call (one 8 x 8
    product) is counted, its CostRecord built and logged through a live
    ``CostLog`` and a measured profile computed from it, and the
    programs are recorded again. The op traces must be identical, and
    the probe must have harvested."""
    from porqua_tpu_torch.obs.devprof import (CostLog, cost_record,
                                              count_call)
    from porqua_tpu_torch.obs.profile import qp_solve_profile
    from porqua_tpu_torch.qp.solve import resolve_device

    def trace_all():
        return [("solve_batch", _fp(solve_batch_program(dtype=dtype, device=device))),
                ("serve_entry", _fp(serve_entry_program(dtype=dtype, device=device)))]

    findings: List[Finding] = []
    baseline = trace_all()

    # Drive the plane hot: a real AOT compile -> harvest -> log ->
    # measured profile. The probe program is tiny (one 8x8 matmul) so
    # the contract stays CI-cheap; the harvesting path it exercises is
    # exactly the one ExecutableCache._build runs per executable.
    dev = resolve_device(device)
    _, probe = count_call(lambda a: a @ a,
                          torch.ones((8, 8), dtype=dtype, device=dev))
    log = CostLog(path=None)
    rec = cost_record(probe, entry="gc107-probe", kind="contract",
                      bucket="8x8", slots=1, dtype=str(dtype),
                      compile_s=0.0)
    log.emit(rec)
    prof = qp_solve_profile(8, 8, 10.0, 0.01, cost=rec)
    live = trace_all()

    if rec.get("flops") is None and rec.get("bytes_accessed") is None:
        findings.append(Finding(
            "GC107", "<trace:devprof_identity>", 0, 0,
            "the probe executable yielded no cost analysis on this "
            "backend — the identity check exercised nothing"))
    if log.records != 1 or prof.get("cost_source") != "torch":
        findings.append(Finding(
            "GC107", "<trace:devprof_identity>", 0, 0,
            "the cost-plane probe did not run end to end (no record "
            "logged or the profile never switched to measured numerators) "
            "— the identity check proved nothing"))
    for (label, base), (_, lv) in zip(baseline, live):
        if base != lv:
            findings.append(Finding(
                "GC107", f"<trace:{label}>", 0, 0,
                "recorded op trace differs with the device-truth cost "
                "plane active: cost harvesting is no longer invisible "
                "to the programs (disabled-bit-identity contract broken)"))
    return findings


def check_federation_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC108: the fleet federation plane must be invisible to the programs.

    The programs are recorded bare; then two worker streams are written
    and drained, counters and histograms merged, the fleet SLO engine
    evaluated on a stepped clock, a vitals leak trended to firing, one
    worker left stale so ``worker_lost`` dumps a fleet bundle, a ledger
    row round-tripped, and the programs are recorded again. The op
    traces must be identical, and the probe checks it exercised the
    plane."""
    import os
    import tempfile

    from porqua_tpu_torch.obs.federation import FleetCollector, WorkerStream
    from porqua_tpu_torch.obs.flight import FlightRecorder
    from porqua_tpu_torch.obs.ledger import ledger_row, rolling_median
    from porqua_tpu_torch.obs.slo import SLOEngine, default_slos
    from porqua_tpu_torch.obs.vitals import VitalsTrend
    from porqua_tpu_torch.resilience.faults import FaultClock

    def trace_all():
        return [("solve_batch", _fp(solve_batch_program(dtype=dtype, device=device))),
                ("serve_entry", _fp(serve_entry_program(dtype=dtype, device=device)))]

    findings: List[Finding] = []
    baseline = trace_all()

    with tempfile.TemporaryDirectory() as td:
        clock = FaultClock()
        flight = FlightRecorder(out_dir=None, debounce_s=0.0,
                                clock=clock)
        engine = SLOEngine(default_slos(), clock=clock,
                           min_eval_interval_s=0.0)
        trend = VitalsTrend(min_samples=4, alpha_fast=0.6,
                            alpha_slow=0.05)
        collector = FleetCollector(
            heartbeat_timeout_s=2.0, rollup_window_s=1.0,
            slo=engine, flight=flight, vitals_trend=trend, clock=clock)
        streams = {}
        for wid in ("w0", "w1"):
            path = os.path.join(td, f"{wid}.jsonl")
            collector.add_worker(wid, path)
            streams[wid] = WorkerStream(path, wid)
            streams[wid].hello(latency_le=[0.01, 0.1])

        def sample(completed, failed, counts, rss):
            return dict(
                slo={"completed": completed, "failed": failed,
                     "expired": 0, "retry_giveups": 0,
                     "validation_failures": 0,
                     "latency_le": (0.01, 0.1),
                     "latency_counts": tuple(counts),
                     "latency_count": sum(counts)},
                vitals={"rss_bytes": rss, "threads": 4})

        streams["w0"].sample(**sample(5, 0, [3, 2, 0], 1000))
        for i in range(8):
            # w1 keeps heartbeating with a leaking RSS while w0 goes
            # silent — the liveness deadline and the vitals trend both
            # cross inside this loop.
            clock.advance(1.0)
            streams["w1"].sample(**sample(10 + i, 0, [6, 4, i],
                                          1000 * (1.4 ** i)))
            collector.drain()
        merged = collector.slo_sample()
        row = ledger_row("fleet_loadgen",
                         {"fleet.completed": merged["completed"]})
        med = rolling_median([row], "fleet.completed", window=3)
    live = trace_all()

    rows = {r["worker"]: r for r in collector.worker_rows()}
    bundle_kinds = [b["trigger"]["kind"] for b in flight.bundles()]
    if (not rows.get("w0", {}).get("status") == "lost"
            or "worker_lost" not in bundle_kinds):
        findings.append(Finding(
            "GC108", "<trace:federation_identity>", 0, 0,
            "the federation probe never lost its stale worker or "
            "never dumped the worker_lost bundle — the identity check "
            "proved nothing"))
    if merged["completed"] != 22 or merged["latency_counts"][0] != 9:
        findings.append(Finding(
            "GC108", "<trace:federation_identity>", 0, 0,
            "the collector merge produced wrong fleet counters — the "
            "identity check exercised a broken plane"))
    if trend.status()["fired"] < 1:
        findings.append(Finding(
            "GC108", "<trace:federation_identity>", 0, 0,
            "the vitals-trend probe never crossed its leak band — the "
            "identity check proved nothing"))
    if med != float(merged["completed"]):
        findings.append(Finding(
            "GC108", "<trace:federation_identity>", 0, 0,
            "the ledger probe did not round-trip its row — the "
            "identity check exercised a broken plane"))
    for (label, base), (_, lv) in zip(baseline, live):
        if base != lv:
            findings.append(Finding(
                "GC108", f"<trace:{label}>", 0, 0,
                "recorded op trace differs with the fleet federation "
                "plane active: the plane is no longer invisible to "
                "the programs (disabled-bit-identity contract broken)"))
    return findings


def check_tenancy_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC109: the tenant plane must be invisible to the programs.

    The programs are recorded bare; then a quota shed, a DRR interleave
    across a 10:1 backlog, a tenant-labelled burn-rate alert, a
    tenant-tagged SolveRecord and a seeded three-tenant blend run, and
    the programs are recorded again. The op traces must be identical,
    and every probe checks it exercised its path."""
    from porqua_tpu_torch.obs.events import EventBus
    from porqua_tpu_torch.obs.harvest import solve_record
    from porqua_tpu_torch.obs.slo import TenantSLOSet
    from porqua_tpu_torch.resilience.faults import FaultClock
    from porqua_tpu_torch.serve.metrics import ServeMetrics
    from porqua_tpu_torch.serve.tenancy import FairPendingQueue, TenantAdmission
    from porqua_tpu_torch.serve.workloads import (
        build_blend, parse_tenant_specs)

    def trace_all():
        return [("solve_batch", _fp(solve_batch_program(dtype=dtype, device=device))),
                ("serve_entry", _fp(serve_entry_program(dtype=dtype, device=device)))]

    findings: List[Finding] = []
    baseline = trace_all()

    def probe_fail(msg: str) -> None:
        findings.append(Finding(
            "GC109", "<trace:tenancy_identity>", 0, 0, msg))

    # Quota shed: the offender hits its bound, the victim never does.
    admission = TenantAdmission(quota={"noisy": 2})
    sheds = sum(not admission.try_admit("noisy") for _ in range(5))
    victim_ok = all(admission.try_admit("quiet") for _ in range(5))
    if sheds != 3 or not victim_ok:
        probe_fail("the quota probe did not shed exactly the "
                   "offender's overflow — the identity check "
                   "exercised a broken admission plane")

    # DRR interleave: a 10:1 backlog imbalance still alternates
    # tenants 1:1 at equal weights.
    class _Req:
        def __init__(self, tenant, i):
            self.tenant, self.submitted = tenant, float(i)

    fq = FairPendingQueue()
    for i in range(10):
        fq.append(_Req("noisy", i))
    fq.append(_Req("quiet", 100.0))
    first_four = [fq.popleft().tenant for _ in range(4)]
    if "quiet" not in first_four[:2]:
        probe_fail(f"DRR probe served {first_four} — the quiet "
                   "tenant waited behind the burst backlog")

    # Per-tenant SLO engines on a stepped clock: the offender's
    # availability alert fires WITH its tenant label; the victim's
    # engine stays quiet.
    clock = FaultClock()
    metrics = ServeMetrics()
    events = EventBus(capacity=256)
    tset = TenantSLOSet(clock=clock, min_eval_interval_s=0.0)
    tset.bind(metrics, events=events)
    for t in ("noisy", "quiet"):
        metrics.inc_tenant(t, "completed")
    tset.evaluate()
    metrics.inc_tenant("noisy", "completed", 2)
    metrics.inc_tenant("noisy", "rejected", 98)
    metrics.inc_tenant("quiet", "completed", 100)
    metrics.observe_tenant_latency("quiet", 0.004)
    clock.advance(10.0)
    tset.evaluate()
    fired = tset.alerts_fired()
    alert_tenants = {e.get("tenant")
                     for e in events.events("slo_alert")
                     if e.get("state") == "firing"}
    if fired.get("noisy", 0) < 1 or fired.get("quiet", 0) != 0 \
            or alert_tenants != {"noisy"}:
        probe_fail("the per-tenant SLO probe did not fire exactly "
                   "the offender's tenant-labeled alert "
                   f"(fired={fired}, labels={alert_tenants})")

    # Tenant-tagged SolveRecord + a seeded workload blend (numpy).
    rec = solve_record("serve", 4, 2, 1, 10, 0.0, 0.0, 0.0,
                       tenant="noisy")
    blend = build_blend(parse_tenant_specs(
        "a:tracking:steady:rate=20,n_assets=4,window=8,pool=2;"
        "b:lad:heavy_tailed:rate=10,n_assets=4,window=8,pool=2;"
        "c:turnover:bursty:rate=5,n_assets=4,window=8,pool=2"),
        duration_s=2.0, seed=1)
    if rec.get("tenant") != "noisy" or len(blend) < 3 \
            or len(blend.shares()) != 3:
        probe_fail("the harvest/workload probe did not produce a "
                   "tenant-tagged record and a three-tenant blend")

    live = trace_all()
    for (label, base), (_, lv) in zip(baseline, live):
        if base != lv:
            findings.append(Finding(
                "GC109", f"<trace:{label}>", 0, 0,
                "recorded op trace differs with the tenant plane "
                "exercised: tenancy is no longer host-side "
                "scheduling + attribution only (disabled-bit-identity "
                "contract broken)"))
    return findings


def check_routing_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC110: solver routing must be invisible to the programs.

    Every backend's solve/serve programs are recorded bare; then a live
    ``SolverRouter`` is seeded from a harvest aggregate, takes
    decisions, is forced both ways and snapshotted, and the programs are
    recorded again. The op traces must be identical, and the probe
    checks it routed."""
    import dataclasses

    from porqua_tpu_torch.qp.solve import SolverParams
    from porqua_tpu_torch.serve.bucketing import Bucket
    from porqua_tpu_torch.serve.routing import SolverRouter

    params = SolverParams()

    def trace_all():
        out = []
        for method in ("admm", "pdhg", "napg"):
            p = dataclasses.replace(params, method=method)
            out.append((f"solve_batch[{method}]",
                        _fp(solve_batch_program(params=p, dtype=dtype, device=device))))
            out.append((f"serve_entry[{method}]",
                        _fp(serve_entry_program(params=p, dtype=dtype, device=device))))
        return out

    findings: List[Finding] = []
    baseline = trace_all()

    def probe_fail(msg: str) -> None:
        findings.append(Finding(
            "GC110", "<trace:routing_identity>", 0, 0, msg))

    # A live router, exercised end to end on the host: seed a route
    # table from a two-backend aggregate (PDHG the clear winner at
    # 16x4), take decisions on the seeded cell AND an unseeded one,
    # flip the force pin both ways.
    router = SolverRouter(params)
    eps = float(params.eps_abs)
    agg = {"groups": [{
        "bucket": "16x4", "eps_abs": eps,
        "by_solver": {
            "admm": {"count": 8, "iters": {"p95": 900.0},
                     "status_counts": {"1": 8}, "solve_s_mean": 4e-3},
            "pdhg": {"count": 8, "iters": {"p95": 200.0},
                     "status_counts": {"1": 8}, "solve_s_mean": 1e-3},
        }}]}
    seeded = router.seed_from_aggregate(agg)
    routed = router.route(Bucket(16, 4))
    default = router.route(Bucket(32, 8))
    router.force("admm")
    forced = router.route(Bucket(16, 4))
    router.force(None)
    unpinned = router.route(Bucket(16, 4))
    snap = router.snapshot()
    if seeded != {f"16x4@{eps:.0e}": "pdhg"} or routed != "pdhg" \
            or default != "admm" or forced != "admm" \
            or unpinned != "pdhg" or snap["decisions"]["pdhg"] != 2:
        probe_fail("the routing probe did not seed and take the "
                   "expected decisions — the identity check exercised "
                   f"a broken router (seeded={seeded}, snap={snap})")

    live = trace_all()
    for (label, base), (_, lv) in zip(baseline, live):
        if base != lv:
            findings.append(Finding(
                "GC110", f"<trace:{label}>", 0, 0,
                "recorded op trace differs with a live SolverRouter "
                "exercised: routing is no longer host-side dispatch "
                "selection only (disabled-bit-identity contract "
                "broken)"))
    return findings


def check_calibration_identity(dtype=torch.float32,
        device=None) -> List[Finding]:
    """GC111: the closed calibration loop must be invisible to the programs.

    Every backend's solve/serve programs are recorded bare, then again
    mid-lifecycle (canary held) and after a live ``Calibrator`` went
    through evidence, canary, promotion, a guard breach and the
    auto-rollback on a stepped clock. Every op trace must be identical,
    and the probe checks each transition happened."""
    import dataclasses

    from porqua_tpu_torch.obs.calibrate import Calibrator, replay_audit
    from porqua_tpu_torch.obs.events import EventBus
    from porqua_tpu_torch.obs.harvest import HarvestSink, solve_record
    from porqua_tpu_torch.qp.solve import SolverParams
    from porqua_tpu_torch.resilience.faults import FaultClock
    from porqua_tpu_torch.serve.routing import SolverRouter

    params = SolverParams()

    def trace_all():
        out = []
        for method in ("admm", "pdhg", "napg"):
            p = dataclasses.replace(params, method=method)
            out.append((f"solve_batch[{method}]",
                        _fp(solve_batch_program(params=p, dtype=dtype, device=device))))
            out.append((f"serve_entry[{method}]",
                        _fp(serve_entry_program(params=p, dtype=dtype, device=device))))
        return out

    findings: List[Finding] = []
    baseline = trace_all()

    def probe_fail(msg: str) -> None:
        findings.append(Finding(
            "GC111", "<trace:calibration_identity>", 0, 0, msg))

    class _GuardAnomaly:
        """Anomaly-counter stand-in the probe flips to breach the
        guard window deterministically (the real detector's counters()
        shape)."""

        fired = 0

        def counters(self):
            return {"anomalies_fired": self.fired}

    clock = FaultClock()
    router = SolverRouter(params)
    events = EventBus()
    sink = HarvestSink()
    guard = _GuardAnomaly()
    cal = Calibrator(router=router, harvest=sink, events=events,
                     anomaly=guard, min_interval_s=1.0, min_samples=4,
                     win_rate=0.6, canary_dwell_s=2.0,
                     guard_window_s=30.0, clock=clock)
    eps = float(params.eps_abs)
    p_admm = dataclasses.replace(params, method="admm")
    p_pdhg = dataclasses.replace(params, method="pdhg")
    for _ in range(6):
        cal.observe(solve_record(
            "serve", 16, 4, 1, 40, 1e-6, 1e-6, -1.0, params=p_admm,
            bucket="16x4", solve_s=4e-3))
        cal.observe(solve_record(
            "serve.shadow", 16, 4, 1, 12, 1e-6, 1e-6, -1.0,
            params=p_pdhg, bucket="16x4", solve_s=1e-3,
            shadow_of="admm", delta_iters=-28, delta_obj=0.0,
            agree=True, delta_solve_s=-3e-3))
    rejected = cal.observe(solve_record(
        "serve", 16, 4, 1, 40, 1e-6, 1e-6, float("nan"),
        params=p_admm, bucket="16x4"))
    clock.advance(1.5)
    cal.maybe_tick()
    if rejected is not False or cal.status()["state"] != "canary":
        probe_fail("the calibration probe did not reach canary with "
                   "the poison record rejected — the identity check "
                   f"exercised a broken loop (status={cal.status()})")

    # Mid-promotion: the candidate is live, the dwell is running.
    mid = trace_all()

    clock.advance(2.5)
    cal.maybe_tick()   # dwell held -> promoted, guard window opens
    promoted = router.snapshot()
    guard.fired = 1    # policy-induced drift: breach the guard
    clock.advance(1.5)
    cal.maybe_tick()   # breach -> auto-rollback
    snap = router.snapshot()
    table, version = replay_audit(cal.audit_records())
    counters = cal.counters()
    if (promoted["table"] != {f"16x4@{eps:.0e}": "pdhg"}
            or promoted["table_version"] != 1
            or snap["table"] != {} or snap["table_version"] != 2
            or (table, version) != (snap["table"], 2)
            or counters["calibration_promotions"] != 1
            or counters["calibration_rollbacks"] != 1):
        probe_fail("the calibration probe did not promote, roll back "
                   "and replay its audit chain as expected — the "
                   "identity check exercised a broken loop "
                   f"(promoted={promoted}, snap={snap}, "
                   f"counters={counters})")

    live = trace_all()
    for traced in (mid, live):
        for (label, base), (_, lv) in zip(baseline, traced):
            if base != lv:
                findings.append(Finding(
                    "GC111", f"<trace:{label}>", 0, 0,
                    "recorded op trace differs with a live Calibrator "
                    "mid-promotion: calibration is no longer "
                    "host-side dispatch selection only (disabled-"
                    "bit-identity contract broken)"))
                break
    return findings


def check_run_batch(bs, params=None, dtype=torch.float32,
                    device=None) -> List[Finding]:
    """GC101-GC103 on ``run_batch``'s device pass against a real
    ``BacktestService``: the host pass (``build_problems``) runs, the
    problems are uploaded once, and ``solve_batch`` is recorded."""
    import dataclasses

    from porqua_tpu_torch.batch import build_problems, solve_batch
    from porqua_tpu_torch.qp.solve import resolve_device

    problems = build_problems(bs, dtype=dtype)
    if params is None:
        params = bs.optimization.solver_params(solve_dtype=dtype)
    dev = resolve_device(device)
    qp = problems.qp.to(dev)
    rec = trace_program(
        "run_batch",
        lambda q: solve_batch(dataclasses.replace(problems, qp=q), params,
                              device=dev), (qp,), device=dev)
    return check_op_trace(rec, "run_batch", expect_float=dtype)


def _check(label: str, pair, expect, device) -> List[Finding]:
    fn, args = pair
    return check_op_trace(trace_program(label, fn, args, device=device),
                          label, expect_float=expect)


def check_entry_points(dtype=torch.float32,
                       factor_rows: int = 8,
                       ring_size: int = 8,
                       device=None) -> List[Finding]:
    """The sweep: every entry point reachable without market data, on
    ``device`` (default: the card), held to GC101-GC103 on every backend
    (ADMM, PDHG, NAPG; with and without the convergence rings, dense and
    factored), then the identity contracts GC104-GC111."""
    from porqua_tpu_torch.qp.solve import SolverParams

    kw = dict(dtype=dtype, device=device)
    findings: List[Finding] = []

    def add(label, pair):
        findings.extend(_check(label, pair, dtype, device))

    add("solve_batch", solve_batch_program(**kw))
    add("solve_batch[factored]", solve_batch_program(
        factor_rows=factor_rows, **kw))
    add("serve_entry", serve_entry_program(**kw))
    add("serve_entry[factored]", serve_entry_program(
        factor_rows=factor_rows, **kw))
    add("tracking_step", tracking_program(**kw))
    if ring_size:
        rings = SolverParams(ring_size=ring_size)
        add("solve_batch[rings]", solve_batch_program(params=rings, **kw))
        add("serve_entry[rings]", serve_entry_program(params=rings, **kw))
    add("compaction_step", compaction_step_program(**kw))
    add("compaction_step[factored]", compaction_step_program(
        factor_rows=factor_rows, **kw))
    for label, fn, args in continuous_programs(**kw):
        add(label, (fn, args))
    findings += check_resilience_identity(**kw)
    findings += check_telemetry_identity(**kw)
    findings += check_observability_identity(**kw)
    findings += check_devprof_identity(**kw)
    findings += check_federation_identity(**kw)
    findings += check_tenancy_identity(**kw)
    # The PDHG and NAPG backends are routed peers: the same proofs
    # through the same finalize/compaction/continuous plumbing.
    for method in ("pdhg", "napg"):
        p = SolverParams(method=method)
        add(f"solve_batch[{method}]", solve_batch_program(params=p, **kw))
        add(f"serve_entry[{method}]", serve_entry_program(params=p, **kw))
        if ring_size:
            add(f"solve_batch[{method},rings]", solve_batch_program(
                params=SolverParams(method=method, ring_size=ring_size),
                **kw))
        add(f"compaction_step[{method}]", compaction_step_program(
            params=p, **kw))
        for label, fn, args in continuous_programs(params=p, **kw):
            add(f"{label}[{method}]", (fn, args))
    findings += check_routing_identity(**kw)
    findings += check_calibration_identity(**kw)
    return findings
