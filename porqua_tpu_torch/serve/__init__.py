"""Online QP solve service (the port of ``porqua_tpu/serve``):
shape-bucketed dynamic batching over the compiled-entry cache, with
device-health fallback.

A stream of independent solve requests is padded to a small
shape-bucket ladder, coalesced by a micro-batcher (max-batch / max-wait
policy) or run by the continuous batcher (lanes admitted and retired at
segment boundaries), warm-started per portfolio key, and dispatched
through entries compiled once per (bucket, slot count, device).

    from porqua_tpu_torch.serve import SolveService
    with SolveService(max_batch=256, max_wait_ms=2.0) as svc:
        svc.prewarm(example_qp)              # compile before traffic
        t = svc.submit(qp, warm_key="fund-a")
        res = svc.result(t, timeout=10.0)    # res.x, res.found, ...

The service runs on the card unless ``device=`` names another; its
breaker falls back only to a device the caller names
(``SolveService(fallback="cpu")``). Per-bucket solver routing with
shadow compares and its calibration loop (``SolverRouter``,
``SolveService(router=..., calibrator=...)``), the retry layer
(``retry=``), the observability planes (``obs=``, ``harvest=``,
``slo=``, ``flight=``, ``anomaly=``, ``tenant_slos=``,
``start_http()``, ``vitals()``) and the multi-tenant workload library
(:mod:`porqua_tpu_torch.serve.workloads`) are the JAX package's.
"""

from porqua_tpu_torch.serve.batcher import (
    DeadlineExpired,
    MicroBatcher,
    SolveError,
    SolveResult,
    WarmStartCache,
    problem_fingerprint,
)
from porqua_tpu_torch.serve.bucketing import (
    Bucket,
    BucketLadder,
    BucketOverflow,
    ExecutableCache,
    slot_count,
    slot_ladder,
)
from porqua_tpu_torch.serve.continuous import ContinuousBatcher
from porqua_tpu_torch.serve.metrics import ServeMetrics, TenantMetricsView
from porqua_tpu_torch.serve.routing import METHODS, SolverRouter
from porqua_tpu_torch.serve.service import (
    DeviceHealth,
    QueueFull,
    SolveService,
    Ticket,
)
from porqua_tpu_torch.serve.tenancy import (
    DEFAULT_TENANT,
    FairPendingQueue,
    TenantAdmission,
)

__all__ = [
    "Bucket",
    "BucketLadder",
    "BucketOverflow",
    "ContinuousBatcher",
    "DEFAULT_TENANT",
    "DeadlineExpired",
    "DeviceHealth",
    "METHODS",
    "ExecutableCache",
    "FairPendingQueue",
    "MicroBatcher",
    "QueueFull",
    "ServeMetrics",
    "SolveError",
    "SolveResult",
    "SolveService",
    "SolverRouter",
    "TenantAdmission",
    "TenantMetricsView",
    "Ticket",
    "WarmStartCache",
    "problem_fingerprint",
    "slot_count",
    "slot_ladder",
]
