"""Fleet load generator: N worker processes, one federated obs plane.

The millions-of-users regime is multi-process by construction: this
driver spawns ``--workers`` processes (``multiprocessing`` spawn
context — each worker owns its torch runtime and CUDA context,
``SolveService``, and open-loop arrival shard), shards ONE
deterministic seeded arrival stream across them (global arrival ``k``
at ``k / rate`` seconds is worker ``k % N``'s), and runs a sustained
soak (``--duration-s``, hours-scale) while the parent federates
telemetry through a
:class:`porqua_tpu_torch.obs.federation.FleetCollector`:

* per-worker JSONL streams (cumulative ``slo_sample()`` counters, raw
  latency histograms, events, process vitals) drained incrementally;
* fleet-wide SLO evaluation + burn-rate alerting over the MERGED
  histograms/counters (existing ``SLOEngine``);
* a fleet ``/metrics`` + ``/healthz`` endpoint (``--port``) with
  per-worker labeled gauges;
* bounded soak rollups (fixed ring of per-window aggregates) and EWMA
  leak/trend detection over per-worker vitals (``vitals_anomaly`` is
  a flight-recorder trigger);
* worker liveness: a stream stale past ``--heartbeat-timeout-s``
  fires ``worker_lost`` and dumps a fleet incident bundle
  (``--flight-out``), so a crashed shard is an incident, not a silent
  throughput dip. A worker silent ``START_GRACE_S`` after its spawn
  (hung before its hello) is watched all the same, and a lost worker
  still alive is killed once the others are done, so a hang ends the
  run as an incident too. ``--crash-worker W --crash-after-s S`` seeds the
  resilience plane's ``crash`` fault kind (seam ``loadgen.worker``)
  into worker W — the chaos cell the worker-failure invariants run
  against.

Every worker serves on ``--device`` (default: the card, each worker
with its own CUDA context on ``cuda:0``; ``--device cpu`` runs on the
host, each worker's torch on one thread). There is no fallback: a
worker that cannot reach its device exits non-zero, its stream goes
stale, and the report is not ``ok``. The services run the serving
solver defaults (``loadgen.SERVE_PARAMS``, backend ``"auto"``).

The merged fleet report reconciles EXACTLY: fleet ``completed`` ==
sum of worker ``completed`` == sum of worker harvest-record counts
(over the surviving workers under a crash cell), and every worker's
steady-state recompile count must be 0. ``--ledger`` appends one
longitudinal run-ledger row (:mod:`porqua_tpu_torch.obs.ledger`).

``--selftest`` runs (1) a collector unit pass — merge /
reconciliation / liveness / rollup-bounds / namespacing / ladder
refusal on synthetic streams — and (2) a real 2-worker ~10 s
mini-soak on ``--device``.

Examples::

    python -m porqua_tpu_torch.cli.fleet_loadgen \\
        --workers 4 --rate 2000 --duration-s 600 \\
        --flight-out /tmp/fleet_incidents --ledger LEDGER.jsonl
    python -m porqua_tpu_torch.cli.fleet_loadgen --workers 4 --duration-s 120 \\
        --crash-worker 3 --crash-after-s 30   # seeded worker-crash cell
    python -m porqua_tpu_torch.cli.fleet_loadgen --selftest --device cpu

Prints one JSON report line on stdout (diagnostics on stderr).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time

#: The checkout the port lives in (the ledger row's git revision).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Worker exit code for an injected (or real) hard death — the driver
#: treats it as the expected outcome of a seeded crash cell.
CRASH_EXIT = 17

#: Seconds after its spawn that a worker which has said no hello joins
#: the collector all the same (a hello on the card came 14.8 s after the
#: spawn of four workers), so that a hang before the hello goes stale.
START_GRACE_S = 60.0

#: ``platform`` values (the JAX script's ``JAX_PLATFORMS`` for the
#: workers) and the device type each names.
_PLATFORM_DEVICE = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _worker_device(name: str):
    """The worker's device, reached once: a CUDA device without an index
    is ``cuda:0``; one the process cannot use raises (no fallback)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    else:
        torch.set_num_threads(1)
    return dev


def _worker_run(cfg: dict) -> None:
    """One loadgen shard: own service, own open-loop schedule, one
    telemetry stream. Follows the loadgen protocol (build -> prewarm ->
    warmup round -> reset window -> measured soak)."""
    import threading

    from porqua_tpu_torch.obs import HarvestSink, Observability
    from porqua_tpu_torch.obs.federation import WorkerStream
    from porqua_tpu_torch.obs.vitals import process_vitals
    from porqua_tpu_torch.resilience import faults as _faults
    from porqua_tpu_torch.serve.loadgen import (SERVE_PARAMS,
                                                build_tracking_requests,
                                                prewarm_buckets)
    from porqua_tpu_torch.serve.metrics import LATENCY_BUCKETS_S, ServeMetrics
    from porqua_tpu_torch.serve.service import QueueFull, SolveService

    wid = cfg["worker_id"]
    idx = int(cfg["worker_idx"])
    n_workers = int(cfg["n_workers"])
    rate = float(cfg["rate"])
    duration_s = float(cfg["duration_s"])
    emit_interval_s = float(cfg["emit_interval_s"])
    stream = WorkerStream(cfg["stream_path"], wid)
    # Hello lands BEFORE the (potentially long, CPU-contended) device
    # bring-up, pool build and prewarm, and a daemon heartbeat thread
    # keeps the stream warm through any blocking phase: liveness means
    # "the process is alive", not "the main loop is between
    # dispatches". A crash (os._exit) kills the thread with the process
    # — the stream goes stale exactly when the worker actually dies.
    stream.hello(latency_le=LATENCY_BUCKETS_S, worker_idx=idx,
                 n_workers=n_workers, rate=rate)
    hb_stop = threading.Event()

    def _heartbeat() -> None:
        while not hb_stop.wait(emit_interval_s):
            stream.heartbeat()

    threading.Thread(target=_heartbeat, name=f"porqua-fleet-hb-{wid}",
                     daemon=True).start()
    device = _worker_device(cfg["device"])

    # Every worker builds the SAME deterministic global request pool
    # (seeded synthetic universe) and replays it by global arrival
    # index — the shard is defined by the schedule, not the data.
    # With --tenants, the pool is a seeded multi-tenant workload blend
    # (porqua_tpu_torch.serve.workloads): one global arrival stream of
    # (offset, tenant, qp) sharded k % N exactly like the grid.
    blend = None
    tenant_set = None
    tenant_kwargs = {}
    if cfg.get("tenant_spec"):
        from porqua_tpu_torch.obs.slo import TenantSLOSet
        from porqua_tpu_torch.serve.workloads import (
            build_blend, parse_tenant_specs)

        blend = build_blend(parse_tenant_specs(cfg["tenant_spec"]),
                            duration_s=duration_s,
                            seed=int(cfg["seed"]))
        pool = blend.requests
        tenant_set = TenantSLOSet()
        tenant_kwargs = dict(tenant_quota=blend.quota_map(),
                             tenant_weights=blend.weight_map(),
                             tenant_slos=tenant_set)
    else:
        pool = build_tracking_requests(
            int(cfg["pool"]), n_assets=int(cfg["n_assets"]),
            window=int(cfg["window"]), seed=int(cfg["seed"]))

    obs = Observability()
    # Forward every structured event into the worker stream: the fleet
    # bus re-emits them namespaced, so breaker flips / fault injections
    # in any shard land in the merged incident evidence.
    obs.events.add_listener(stream.event)
    # In-memory harvest sink: the `records` counter is the per-worker
    # reconciliation figure (one SolveRecord per resolved request);
    # the bounded buffer keeps soak memory flat.
    sink = HarvestSink(None, events=obs.events)
    service = SolveService(
        params=SERVE_PARAMS, metrics=ServeMetrics(),
        max_batch=int(cfg["max_batch"]),
        max_wait_ms=float(cfg["max_wait_ms"]),
        queue_capacity=max(4 * int(cfg["max_batch"]), 1024),
        obs=obs, harvest=sink, continuous=bool(cfg.get("continuous")),
        device=device, **tenant_kwargs)
    service.start()
    try:
        # One prewarm per DISTINCT bucket (a tenant blend mixes
        # tracking/LAD/turnover shapes; the classic pool is one) —
        # shared helper with run_loadgen so warmup semantics can't
        # drift between the drivers.
        n_compiled, warm_examples = prewarm_buckets(service, pool)
        warm = [service.submit(q)
                for q in pool[:min(len(pool), int(cfg["max_batch"]))]]
        warm += [service.submit(q) for q in warm_examples]
        for t in warm:
            service.result(t, timeout=300)
        service.metrics.reset_window()
        records0 = sink.records
        buffered0 = len(sink.buffered())

        if cfg.get("crash_after_s") is not None:
            # The seeded worker-crash cell: the resilience plane's
            # `crash` kind at the loadgen.worker seam, seeded per
            # worker, armed to fire at the arrival index this worker
            # reaches ~crash_after_s into the soak. InjectedCrash is a
            # BaseException; _worker_main turns it into a hard
            # os._exit — no stream close, no report, exactly the
            # evidence shape a kill -9 leaves.
            start_hit = max(
                int(float(cfg["crash_after_s"]) * rate / n_workers), 0)
            scenario = _faults.Scenario(
                name=f"fleet-crash-{wid}",
                faults=(_faults.FaultSpec.make(
                    "loadgen.worker", "crash", start=start_hit),),
                seed=int(cfg.get("crash_seed", 0)) + idx)
            _faults.install(_faults.FaultInjector(
                scenario, metrics=service.metrics, events=obs.events))

        dropped = 0
        k = idx  # global arrival index; this worker owns k % N == idx
        t0 = time.perf_counter()
        deadline = t0 + duration_s
        next_emit = t0 + emit_interval_s

        def emit_sample() -> None:
            snapshot = service.snapshot()
            snap = {kk: vv for kk, vv in snapshot.items()
                    if kk in ("submitted", "rejected", "batches",
                              "compiles", "warm_hits", "expired",
                              "occupancy_mean")}
            if snapshot.get("tenants"):
                # The collector's per-tenant merge surface
                # (fleet-wide tenant counters + labeled gauges).
                snap["tenants"] = snapshot["tenants"]
            stream.sample(
                service.metrics.slo_sample(),
                hist=service.metrics.histograms(),
                snap=snap,
                vitals=process_vitals(
                    queue_depth=service.batcher.queue.qsize()))

        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            if now >= next_emit:
                emit_sample()
                next_emit += emit_interval_s
                continue
            # Global schedule: arrival k fires at k/rate (or at the
            # blend's k-th workload-shaped offset); this worker owns
            # exactly the k ≡ idx (mod N) slice of it. An exhausted
            # blend idles to the deadline so sampling keeps flowing.
            if blend is not None:
                due = (deadline if k >= len(blend)
                       else t0 + float(blend.offsets[k]))
            else:
                due = t0 + k / rate
            if due > now:
                time.sleep(max(min(due - now, next_emit - now,
                                   deadline - now), 0.0))
                continue
            if _faults.enabled():
                try:
                    _faults.fire("loadgen.worker", k=k, worker=wid)
                except _faults.InjectedCrash:
                    # Die HARD at the raise site: os._exit skips every
                    # finally (no service.stop, no stream.close, no
                    # report) — the kill -9 evidence shape the
                    # collector's liveness tracking exists for.
                    sys.stderr.flush()
                    os._exit(CRASH_EXIT)
            qp = blend.requests[k] if blend is not None \
                else pool[k % len(pool)]
            try:
                # Open-loop: never block on a full queue — a stalled
                # service must show as dropped arrivals, not as a
                # silently degraded arrival rate. (A tenant-quota shed
                # raises the same QueueFull and is additionally
                # counted on the tenant's own rejected series.)
                service.submit(
                    qp, timeout=0.0,
                    tenant=(blend.tenants[k] if blend is not None
                            else None))
            except QueueFull:
                dropped += 1
            k += n_workers

        # Drain: wait for the queue + in-flight cohorts to resolve
        # (bounded — a wedged service must not hang the whole fleet).
        drain_deadline = time.perf_counter() + float(cfg["drain_s"])
        while time.perf_counter() < drain_deadline:
            snap = service.snapshot()
            if (snap["completed"] + snap["failed"] + snap["expired"]
                    >= snap["submitted"]):
                break
            time.sleep(0.05)
        emit_sample()

        if tenant_set is not None:
            tenant_set.evaluate()
            emit_sample()  # the final per-tenant counters must land
        snap = service.snapshot()
        measured = time.perf_counter() - t0
        status_counts = {kk[len("status_"):]: vv
                         for kk, vv in snap.items()
                         if kk.startswith("status_") and vv}
        # Where the measured window's answers were served, by device
        # label, from the harvest buffer (the stream's report only: the
        # fleet rows keep the JAX script's fields).
        devices = {}
        for rec in sink.buffered()[buffered0:]:
            label = str(rec.get("device"))
            devices[label] = devices.get(label, 0) + 1
        stream.report({
            "worker": wid,
            "completed": snap["completed"],
            "failed": snap["failed"],
            "expired": snap["expired"],
            "errors": snap["failed"] + snap["expired"],
            "dropped_arrivals": dropped,
            "harvest_records": sink.records - records0,
            "recompiles_after_warmup": snap["compiles"],
            "prewarm_compiles": n_compiled,
            "throughput_solves_per_s": (snap["completed"] / measured
                                        if measured > 0 else 0.0),
            "latency_p50_ms": snap["latency_p50_ms"],
            "latency_p99_ms": snap["latency_p99_ms"],
            "occupancy_mean": snap["occupancy_mean"],
            "status_counts": status_counts,
            "duration_s": measured,
            "devices": devices,
        })
    finally:
        hb_stop.set()
        if _faults.enabled():
            _faults.uninstall()
        service.stop()
        stream.close()


def _worker_main(cfg: dict) -> None:
    """Process entry: contain nothing — an injected crash dies HARD
    (``os._exit``), leaving a stale stream for the collector's
    liveness tracking, exactly like a real kill -9."""
    from porqua_tpu_torch.resilience.faults import InjectedCrash

    try:
        _worker_run(cfg)
    except InjectedCrash:
        sys.stderr.flush()
        os._exit(CRASH_EXIT)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _fleet_device(platform, device) -> str:
    """The workers' device: ``device`` through ``resolve_device`` (the
    card unless named; raises without one), checked against the JAX
    script's ``platform``."""
    from porqua_tpu_torch.qp.solve import resolve_device

    want = None
    if platform is not None:
        want = _PLATFORM_DEVICE.get(str(platform).lower())
        if want is None:
            raise ValueError(
                f"platform {platform!r} names no device of the port "
                f"(one of {sorted(_PLATFORM_DEVICE)}, or None)")
        if device is None:
            device = want
    dev = resolve_device(device)
    if want is not None and dev.type != want:
        raise ValueError(f"platform {platform!r} contradicts device "
                         f"{str(dev)!r}")
    return str(dev)


def run_fleet(workers: int = 4,
              rate: float = 2000.0,
              duration_s: float = 60.0,
              n_assets: int = 24,
              window: int = 252,
              pool: int = 512,
              seed: int = 5,
              max_batch: int = 128,
              max_wait_ms: float = 2.0,
              continuous: bool = False,
              emit_interval_s: float = 1.0,
              poll_interval_s: float = 1.0,
              heartbeat_timeout_s: float = 10.0,
              rollup_window_s: float = 30.0,
              rollup_capacity: int = 512,
              drain_s: float = 60.0,
              out_dir: str = "fleet_run",
              flight_out=None,
              slo_latency_target_s: float = 0.25,
              crash_worker=None,
              crash_after_s=None,
              crash_seed: int = 0,
              port=None,
              platform=None,
              events_out=None,
              tenants=None,
              device=None) -> dict:
    """Run one fleet soak; returns the merged fleet report (see
    module docstring for the moving parts).

    ``device`` is where every worker serves, resolved through
    ``qp.solve.resolve_device``: the card (``cuda:0``) by default,
    raising without one. ``platform`` is the JAX script's name for the
    workers' backend: ``"cpu"`` means the host and ``"gpu"``/``"cuda"``
    the card; given alone it picks the device, given with a ``device``
    of another type it raises ValueError, as does any other value."""
    from porqua_tpu_torch.obs import FlightRecorder, SLOEngine, default_slos
    from porqua_tpu_torch.obs.events import EventBus
    from porqua_tpu_torch.obs.federation import FleetCollector
    from porqua_tpu_torch.obs.flight import DEFAULT_TRIGGERS
    from porqua_tpu_torch.obs.vitals import VitalsTrend

    worker_device = _fleet_device(platform, device)
    os.makedirs(out_dir, exist_ok=True)
    engine = SLOEngine(default_slos(
        latency_target_s=slo_latency_target_s))
    # worker_lost gets its OWN recorder (debounce 0): the recorder
    # dumps one bundle per debounce window across ALL trigger kinds,
    # so on the shared recorder a breaker flip or slo_alert landing
    # just before the staleness detection would debounce the crash
    # cell's worker_lost bundle away. A loss is once-per-worker by
    # construction — it needs no debounce, and it must never lose the
    # race (same per-cell-recorder pattern as the chaos suite).
    flight = FlightRecorder(
        out_dir=flight_out if flight_out else None,
        triggers=tuple(t for t in DEFAULT_TRIGGERS
                       if t != "worker_lost"),
        debounce_s=min(heartbeat_timeout_s, 30.0))
    liveness_flight = FlightRecorder(
        out_dir=flight_out if flight_out else None,
        triggers=("worker_lost",), debounce_s=0.0)
    vitals_trend = VitalsTrend()
    # The fleet event bus streams to --events-out as events are
    # emitted: an end-of-run buffer dump would silently truncate an
    # hours-scale soak's log to the bus's bounded ring. The sink
    # appends, so a previous run's log must not leak into this one.
    if events_out and os.path.exists(events_out):
        os.remove(events_out)
    fleet_events = EventBus(path=events_out) if events_out else None
    collector = FleetCollector(
        heartbeat_timeout_s=heartbeat_timeout_s,
        rollup_window_s=rollup_window_s,
        rollup_capacity=rollup_capacity,
        events=fleet_events,
        slo=engine, flight=flight, vitals_trend=vitals_trend)
    liveness_flight.attach(metrics=collector, slo=engine)
    collector.events.add_listener(liveness_flight.on_event)

    # Spawn, never fork: a parent on the card has initialised CUDA, and
    # each worker opens its own context.
    ctx = multiprocessing.get_context("spawn")
    procs = []
    streams = {}
    for i in range(int(workers)):
        wid = f"w{i}"
        stream_path = os.path.join(out_dir, f"{wid}.stream.jsonl")
        # A stale stream from a previous run in the same out_dir would
        # replay a dead worker's telemetry into this run's collector.
        if os.path.exists(stream_path):
            os.remove(stream_path)
        cfg = {
            "worker_id": wid, "worker_idx": i, "n_workers": int(workers),
            "stream_path": stream_path, "rate": float(rate),
            "duration_s": float(duration_s), "n_assets": int(n_assets),
            "window": int(window), "pool": int(pool), "seed": int(seed),
            "max_batch": int(max_batch),
            "max_wait_ms": float(max_wait_ms),
            "continuous": bool(continuous),
            "emit_interval_s": float(emit_interval_s),
            "drain_s": float(drain_s),
            "device": worker_device,
            "tenant_spec": tenants,
        }
        if crash_worker is not None and int(crash_worker) == i:
            cfg["crash_after_s"] = float(crash_after_s
                                         if crash_after_s is not None
                                         else duration_s / 3.0)
            cfg["crash_seed"] = int(crash_seed)
        streams[wid] = stream_path
        procs.append(ctx.Process(target=_worker_main, args=(cfg,),
                                 name=f"porqua-fleet-{wid}"))

    http_port = None
    if port is not None:
        http_port = collector.start_http(port=int(port))
        print(f"fleet /metrics+/healthz on :{http_port}",
              file=sys.stderr)

    # A worker joins the collector when its stream's first line (the
    # hello) lands, when its process ends without one, or, still silent,
    # START_GRACE_S after the spawn: the liveness clock starts there. A
    # spawned worker first imports torch and the port, which on a
    # freshly booted card host took longer than the heartbeat timeout;
    # the heartbeat covers everything after the hello, the grace a hang
    # before it (which then ends as ``worker_lost``).
    by_id = dict(zip(streams, procs))
    pending = dict(by_id)

    def register(grace_over: bool) -> None:
        for wid, p in list(pending.items()):
            path = streams[wid]
            if grace_over or not p.is_alive() or (
                    os.path.exists(path) and os.path.getsize(path) > 0):
                collector.add_worker(wid, path)
                del pending[wid]

    t0 = time.monotonic()
    for p in procs:
        p.start()
    lost = set()
    try:
        # A lost worker is no longer waited for: one still alive (hung)
        # is killed, so that a hang ends the run as an incident.
        while any(p.is_alive() for wid, p in by_id.items()
                  if wid not in lost):
            time.sleep(poll_interval_s)
            register(time.monotonic() - t0 > START_GRACE_S)
            lost.update(collector.drain()["workers_lost"])
        register(True)
        for wid in lost:
            if by_id[wid].is_alive():
                by_id[wid].kill()
        for p in procs:
            p.join(timeout=30)
        # Post-exit settling: the tail of every stream must land, and
        # a crashed worker's stream must have time to go stale so the
        # worker_lost incident fires before the report is cut.
        settle_deadline = (time.monotonic() + heartbeat_timeout_s
                           + 2 * poll_interval_s)
        while time.monotonic() < settle_deadline:
            collector.drain()
            rows = collector.worker_rows()
            if all(r["status"] != "running" for r in rows):
                break
            time.sleep(poll_interval_s)
        collector.drain()
    finally:
        collector.stop_http()
        for p in procs:
            # A worker still alive here (an interrupted run) must not
            # outlive the driver.
            if p.is_alive():
                p.kill()
                p.join(timeout=30)

    report = collector.report()
    # The liveness recorder's bundles belong in the fleet incident
    # accounting next to the shared recorder's.
    report["incident_bundles"] += len(liveness_flight.bundles())
    report["incident_bundle_paths"] = (
        report["incident_bundle_paths"]
        + [p for p in liveness_flight.bundles()
           if isinstance(p, str)])[:8]
    if events_out:
        # The merged, worker-namespaced fleet event log — the
        # obs_report --events timeline input (slo_alert / worker_lost
        # / forwarded worker events, chronological) — was streamed
        # per-emit; count the complete file, not the bounded buffer.
        report["events_out"] = events_out
        with open(events_out) as f:
            report["events_written"] = sum(1 for _ in f)
    report["duration_s"] = float(duration_s)
    report["wall_s"] = time.monotonic() - t0
    report["rate"] = float(rate)
    report["workers_exit"] = {p.name.rsplit("-", 1)[-1]: p.exitcode
                              for p in procs}
    report["crash_worker"] = (None if crash_worker is None
                              else f"w{int(crash_worker)}")
    if tenants:
        report["tenant_spec"] = tenants
    if http_port is not None:
        report["http_port"] = http_port
    # Exactly-one-incident accounting for the crash cell: the
    # liveness recorder triggers on worker_lost alone, so its bundle
    # count IS the number of losses that produced incident evidence.
    wl = len(liveness_flight.bundles())
    report["worker_lost_bundles"] = wl
    surv = [r for r in report["rows"] if r["status"] != "lost"]
    report["survivor_recompiles"] = sum(
        int(r.get("recompiles_after_warmup", 0)) for r in surv)
    expect_lost = 0 if crash_worker is None else 1
    report["ok"] = bool(
        report["reconciled"]
        and len(report["workers_lost"]) == expect_lost
        and wl == expect_lost
        and report["survivor_recompiles"] == 0
        and all(r.get("status") == ("lost" if r["worker"]
                                    == report["crash_worker"] else "ok")
                for r in report["rows"]))
    return report


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _unit_pass(api) -> dict:
    """The collector unit pass on synthetic streams and a stepped clock,
    through ``api`` (a namespace holding ``FleetCollector``,
    ``WorkerStream``, ``FlightRecorder``, ``SLOEngine``,
    ``default_slos``, ``VitalsTrend`` and ``FaultClock``); asserts the
    JAX script's invariants and returns what it observed at each step."""
    import tempfile

    def sample(completed, failed, counts):
        return {"completed": completed, "failed": failed, "expired": 0,
                "retry_giveups": 0, "validation_failures": 0,
                "latency_le": (0.01, 0.1), "latency_counts": tuple(counts),
                "latency_count": sum(counts)}

    seen = {}
    with tempfile.TemporaryDirectory() as td:
        clk = api.FaultClock()
        flight = api.FlightRecorder(out_dir=None, debounce_s=0.0, clock=clk)
        engine = api.SLOEngine(api.default_slos(), clock=clk,
                               min_eval_interval_s=0.0)
        trend = api.VitalsTrend(min_samples=4, alpha_fast=0.6,
                                alpha_slow=0.05)
        col = api.FleetCollector(heartbeat_timeout_s=5.0,
                                 rollup_window_s=2.0, rollup_capacity=4,
                                 slo=engine, flight=flight,
                                 vitals_trend=trend, clock=clk)
        streams = {}
        for w in ("w0", "w1"):
            path = os.path.join(td, f"{w}.jsonl")
            col.add_worker(w, path)
            streams[w] = api.WorkerStream(path, w)
            streams[w].hello(latency_le=[0.01, 0.1])
        # Merge: counters sum, RAW histograms merge bucket-wise.
        streams["w0"].sample(sample(10, 1, [6, 4, 1]),
                             vitals={"rss_bytes": 1000, "threads": 8})
        streams["w1"].sample(sample(20, 0, [15, 5, 0]))
        streams["w1"].event({"kind": "breaker_open", "severity": "error",
                             "trace_id": "abc", "primary": "cpu:0"})
        col.drain()
        merged = col.slo_sample()
        assert merged["completed"] == 30 and merged["failed"] == 1, merged
        assert merged["latency_counts"] == (21, 9, 1), merged
        seen["merged"] = {k: merged[k] for k in (
            "completed", "failed", "expired", "latency_counts",
            "latency_count")}
        # Per-tenant merge: tenant counters sum across workers into
        # the fleet snapshot + labeled tenant gauges (latency
        # percentiles deliberately never merge).
        streams["w0"].sample(
            sample(10, 1, [6, 4, 1]),
            snap={"tenants": {"alpha": {"completed": 7, "rejected": 1,
                                        "latency_p99_ms": 9.0}}})
        streams["w1"].sample(
            sample(20, 0, [15, 5, 0]),
            snap={"tenants": {"alpha": {"completed": 3},
                              "beta": {"completed": 20}}})
        col.drain()
        ften = col.snapshot()["tenants"]
        assert ften["alpha"]["completed"] == 10, ften
        assert ften["alpha"]["rejected"] == 1, ften
        assert ften["beta"]["completed"] == 20, ften
        assert "latency_p99_ms" not in ften["alpha"], ften
        gauges = col.worker_gauges()
        assert ("tenant_completed" in gauges
                and ({"tenant": "beta"}, 20.0)
                in gauges["tenant_completed"]), gauges
        seen["tenants"] = ften
        seen["tenant_completed"] = sorted(
            (sorted(lab.items()), val)
            for lab, val in gauges["tenant_completed"])
        # Namespacing: the worker's trace id arrives prefixed.
        evs = col.events.events("breaker_open")
        assert len(evs) == 1 and evs[0]["trace_id"] == "w1/abc", evs
        assert evs[0]["worker"] == "w1", evs
        seen["namespaced"] = (evs[0]["trace_id"], evs[0]["worker"])
        # Partial trailing line: not consumed until the newline lands.
        with open(streams["w0"].path, "a") as f:
            f.write('{"t": 0, "w": "w0", "kind": "sample", "slo": ')
        before = col.counters()["fleet_parse_errors"]
        col.drain()
        assert col.counters()["fleet_parse_errors"] == before
        assert col.slo_sample()["completed"] == 30
        with open(streams["w0"].path, "a") as f:
            f.write('null}\n')
        col.drain()  # now complete (slo=null is ignored, no crash)
        seen["parse_errors"] = col.counters()["fleet_parse_errors"]
        # Liveness: w0 goes silent; exactly ONE worker_lost + bundle.
        for _ in range(4):
            clk.advance(2.0)
            streams["w1"].sample(sample(25, 0, [18, 7, 0]),
                                 vitals={"rss_bytes": 1000, "threads": 8})
            col.drain()
        rows = {r["worker"]: r for r in col.worker_rows()}
        assert rows["w0"]["status"] == "lost", rows
        lost_events = col.events.events("worker_lost")
        assert len(lost_events) == 1, lost_events
        bundles = flight.bundles()
        kinds = [b["trigger"]["kind"] for b in bundles]
        assert kinds.count("worker_lost") == 1, kinds
        seen["statuses"] = {w: r["status"] for w, r in rows.items()}
        seen["bundle_kinds"] = kinds
        # Reconciliation over the survivors after a clean finish.
        streams["w1"].sample(sample(30, 0, [22, 8, 0]))
        streams["w1"].report({"completed": 30, "failed": 0,
                              "harvest_records": 30,
                              "recompiles_after_warmup": 0})
        col.drain()
        rep = col.report()
        assert rep["reconciled"], rep["reconciliation"]
        assert rep["fleet"]["completed"] == 40, rep["fleet"]  # 10 + 30
        assert rep["fleet"]["harvest_records"] == 30, rep["fleet"]
        assert rep["workers_lost"] == ["w0"], rep
        seen["reconciliation"] = rep["reconciliation"]
        seen["fleet"] = {k: rep["fleet"][k] for k in (
            "completed", "failed", "harvest_records")}
        seen["workers_lost"] = rep["workers_lost"]
        # Rollup ring stays bounded at its capacity.
        for _ in range(12):
            clk.advance(2.0)
            col.drain()
        assert len(col.rollups()) <= 4, len(col.rollups())
        seen["rollups"] = len(col.rollups())
        # Vitals trend: a leaking RSS fires exactly one vitals_anomaly.
        for i in range(12):
            trend.observe("w1", {"rss_bytes": 1000 * (1.3 ** i)})
        st = trend.status()
        assert st["fired"] == 1 and st["anomalous"], st
        seen["trend"] = (st["fired"], sorted(st["anomalous"]))
        # Ladder refusal: a mismatched histogram ladder must raise.
        col2 = api.FleetCollector(clock=clk)
        for w, le in (("a", [0.01, 0.1]), ("b", [0.02, 0.2])):
            p = os.path.join(td, f"m-{w}.jsonl")
            col2.add_worker(w, p)
            s = api.WorkerStream(p, w)
            s.hello(latency_le=le)
            s.close()
        try:
            col2.drain()
        except ValueError as exc:
            assert "ladder" in str(exc)
            seen["ladder"] = str(exc)
        else:
            raise AssertionError("mismatched ladder merged silently")
    return seen


def _port_api():
    """The port's collector plane, as :func:`_unit_pass` takes it."""
    from types import SimpleNamespace

    from porqua_tpu_torch.obs import FlightRecorder, SLOEngine, default_slos
    from porqua_tpu_torch.obs.federation import FleetCollector, WorkerStream
    from porqua_tpu_torch.obs.vitals import VitalsTrend
    from porqua_tpu_torch.resilience.faults import FaultClock

    return SimpleNamespace(
        FleetCollector=FleetCollector, WorkerStream=WorkerStream,
        FlightRecorder=FlightRecorder, SLOEngine=SLOEngine,
        default_slos=default_slos, VitalsTrend=VitalsTrend,
        FaultClock=FaultClock)


def _selftest_units() -> None:
    """Collector unit pass: merge, reconciliation, liveness, rollup
    bounds, namespacing, ladder refusal, partial-line tolerance, vitals
    trend — on synthetic streams and a stepped clock."""
    _unit_pass(_port_api())
    print("fleet_loadgen selftest: collector units ok", file=sys.stderr)


def _selftest_soak(device=None) -> None:
    """The 2-worker ~10 s mini-soak on ``device``: spawn real worker
    processes, reconcile exactly, 0 recompiles, 0 lost workers."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        report = run_fleet(
            workers=2, rate=300.0, duration_s=10.0, n_assets=16,
            window=64, pool=128, max_batch=64, emit_interval_s=0.5,
            poll_interval_s=0.5, heartbeat_timeout_s=8.0,
            rollup_window_s=2.0, drain_s=60.0,
            out_dir=os.path.join(td, "run"), device=device)
        assert report["ok"], json.dumps(report, indent=1, default=str)
        assert report["workers_lost"] == [], report["workers_lost"]
        assert report["fleet"]["completed"] > 0, report["fleet"]
        assert report["reconciled"], report["reconciliation"]
        assert report["survivor_recompiles"] == 0, report
        assert report["rollup_windows"] >= 2, report["rollup_windows"]
        per_worker = sum(int(r["completed"]) for r in report["rows"])
        assert per_worker == report["fleet"]["completed"], report
        assert report["fleet"]["harvest_records"] == per_worker, report
    print(f"fleet_loadgen selftest: mini-soak ok "
          f"({report['fleet']['completed']} solves, "
          f"{report['fleet']['throughput_solves_per_s']:.0f}/s)",
          file=sys.stderr)


def _selftest(device=None) -> int:
    _selftest_units()
    _selftest_soak(device)
    print("fleet_loadgen selftest: ok")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="GLOBAL open-loop arrival rate, solves/s "
                         "(sharded across workers)")
    ap.add_argument("--duration-s", type=float, default=60.0,
                    help="soak duration (hours-scale supported; memory "
                         "stays bounded by the rollup ring)")
    ap.add_argument("--n-assets", type=int, default=24)
    ap.add_argument("--window", type=int, default=252)
    ap.add_argument("--pool", type=int, default=512,
                    help="distinct seeded requests in the replay pool")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--emit-interval-s", type=float, default=1.0,
                    help="worker telemetry sample cadence (doubles as "
                         "the heartbeat)")
    ap.add_argument("--heartbeat-timeout-s", type=float, default=10.0,
                    help="a stream stale past this fires worker_lost")
    ap.add_argument("--rollup-window-s", type=float, default=30.0)
    ap.add_argument("--rollup-capacity", type=int, default=512,
                    help="bounded ring of per-window soak aggregates")
    ap.add_argument("--out-dir", default="fleet_run",
                    help="worker stream files land here")
    ap.add_argument("--flight-out", default=None, metavar="DIR",
                    help="fleet incident bundles (worker_lost, fleet "
                         "SLO alerts, forwarded worker triggers)")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the merged worker-namespaced fleet "
                         "event log (JSONL; cli.obs_report --events "
                         "renders the SLO/alert timeline from it)")
    ap.add_argument("--slo-latency-target", type=float, default=0.25)
    ap.add_argument("--crash-worker", type=int, default=None,
                    metavar="W",
                    help="seed the resilience crash fault kind into "
                         "worker W (the worker-failure chaos cell)")
    ap.add_argument("--crash-after-s", type=float, default=None)
    ap.add_argument("--crash-seed", type=int, default=0)
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="multi-tenant workload blend spec (same "
                         "syntax as cli.serve_loadgen --tenants): each "
                         "worker replays its k %% N shard of ONE "
                         "seeded blend; the fleet report and /metrics "
                         "gain merged per-tenant series")
    ap.add_argument("--port", type=int, default=None,
                    help="serve the fleet /metrics+/healthz here "
                         "(0 = ephemeral)")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="append one longitudinal run-ledger row "
                         "(porqua_tpu_torch.obs.ledger reads the "
                         "series back)")
    ap.add_argument("--out", default=None,
                    help="also write the report JSON here")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device every worker serves on (default: the "
                         "card, cuda:0)")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest(args.device)

    report = run_fleet(
        workers=args.workers, rate=args.rate, duration_s=args.duration_s,
        n_assets=args.n_assets, window=args.window, pool=args.pool,
        seed=args.seed, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, continuous=args.continuous,
        emit_interval_s=args.emit_interval_s,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        rollup_window_s=args.rollup_window_s,
        rollup_capacity=args.rollup_capacity,
        out_dir=args.out_dir, flight_out=args.flight_out,
        slo_latency_target_s=args.slo_latency_target,
        crash_worker=args.crash_worker,
        crash_after_s=args.crash_after_s, crash_seed=args.crash_seed,
        port=args.port, events_out=args.events_out,
        tenants=args.tenants, device=args.device)
    if args.ledger:
        from porqua_tpu_torch.obs import ledger as _ledger

        row = _ledger.ledger_row(
            "fleet_loadgen", _ledger.metrics_from_fleet(report),
            rev=_ledger.git_rev(_REPO_ROOT),
            artifact=args.out, note=f"workers={args.workers} "
                                    f"rate={args.rate:g}")
        _ledger.append_row(args.ledger, row)
        report["ledger_row"] = row["run_id"]
    print(json.dumps(report, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
