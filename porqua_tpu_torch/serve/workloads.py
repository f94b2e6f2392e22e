"""Production-shaped workload library for the serve load generators
(the port of ``porqua_tpu/serve/workloads.py``: the same numpy draws,
so arrivals and problems equal the JAX package's bit for bit).

Every committed serving artifact through round 10 measured a single
anonymous tenant on a uniform or fixed-rate arrival grid; the ROADMAP
is explicit that "throughput/latency claims should be made against
traffic shaped like production, not a uniform grid". This module is
that traffic:

* **Seeded arrival traces** — :func:`arrival_times` generates
  open-loop arrival offsets per tenant: ``steady`` (fixed rate),
  ``diurnal`` (inhomogeneous Poisson, sinusoidal intensity — the
  daily rebalance tide), ``bursty`` (a base rate punctuated by
  periodic ``burst_factor``x windows — the noisy-neighbor shape), and
  ``heavy_tailed`` (Pareto inter-arrivals at matched mean rate — the
  long-silence/packed-cluster shape uniform grids hide). Everything
  is driven by ``numpy.random.Generator(PCG64(seed))`` keyed per
  (seed, tenant), so traces are replay-exact across processes — the
  fleet driver shards ONE deterministic blend by arrival index.
* **Per-tenant problem streams** — :func:`build_problems` builds each
  tenant's request stream in the reference PorQua's multi-strategy
  shape: ``tracking`` (per-date index replication, the round-1 serve
  workload), ``lad`` (least-absolute-deviation tracking lifted to a
  QP over ``(w, t)`` with ``-t <= Xw - y <= t`` — the reference's
  L5/L4 robust objective, dimension-doubled so it lands in its own
  shape bucket), and ``turnover`` (tracking with the reference's
  linearized turnover-cost objective via
  :func:`porqua_tpu_torch.qp.lift.lift_turnover_objective` — the
  multi-period coupled stream). All host numpy, built into host
  tensors (``device="cpu"``): the service moves them to its device.
* **Mixed-tenant blends** — :func:`build_blend` merges per-tenant
  traces into one time-sorted stream of ``(offset_s, tenant, qp)``
  driven by ``run_loadgen(arrivals=, tenants=)`` (the JAX package's
  CLI drivers are not ported yet).

Spec syntax (``parse_tenant_specs``): one tenant per ``;``-separated
element, ``name:problem:arrival[:key=value,...]`` — e.g.::

    alpha:tracking:diurnal:rate=40,amplitude=0.8;
    beta:lad:heavy_tailed:rate=15;
    gamma:tracking:bursty:rate=8,burst_factor=10,offender=1,quota=64

``offender=1`` marks the tenant the fairness report treats as the
noisy neighbor; ``quota=K`` feeds ``SolveService(tenant_quota=)``;
``weight=W`` feeds the DRR dequeue.

``selftest()`` pins seeded determinism and blend-share reconciliation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ARRIVALS",
    "Blend",
    "PROBLEMS",
    "TenantSpec",
    "arrival_times",
    "build_blend",
    "build_problems",
    "parse_tenant_specs",
    "selftest",
]

#: Known arrival-trace shapes.
ARRIVALS = ("steady", "diurnal", "bursty", "heavy_tailed")

#: Known per-tenant problem streams (the reference's strategy mix).
PROBLEMS = ("tracking", "lad", "turnover")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's workload: who, what problems, what arrival shape.

    ``rate`` is the tenant's BASE arrival rate (solves/s). ``steady``
    hits it exactly, ``diurnal``/``heavy_tailed`` modulate around it
    without changing the mean, and ``bursty`` adds its bursts ON TOP:
    the expected mean is ``rate * (1 + (burst_factor - 1) *
    burst_len_s / burst_every_s)`` — :meth:`expected_arrivals` is the
    one reconciliation formula the selftest and reports use.
    """

    name: str
    problem: str = "tracking"
    arrival: str = "steady"
    rate: float = 10.0
    # Arrival-shape knobs (ignored where not applicable):
    period_s: float = 60.0        # diurnal: one "day"
    amplitude: float = 0.8        # diurnal: intensity swing in [0, 1)
    burst_factor: float = 10.0    # bursty: rate multiplier in a burst
    burst_every_s: float = 30.0   # bursty: burst cadence
    burst_len_s: float = 5.0      # bursty: burst width
    pareto_alpha: float = 1.7     # heavy_tailed: tail exponent (> 1)
    # Problem-stream knobs:
    n_assets: int = 24
    window: int = 64
    pool: int = 64                # distinct problems, cycled
    transaction_cost: float = 2e-3  # turnover: linearized tc
    # Scheduling/fairness knobs:
    weight: float = 1.0           # DRR dequeue weight
    quota: Optional[int] = None   # admission quota (None = unbounded)
    offender: bool = False        # the fairness report's noisy neighbor

    def __post_init__(self) -> None:
        if self.problem not in PROBLEMS:
            raise ValueError(f"unknown problem {self.problem!r}; "
                             f"expected one of {PROBLEMS}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r}; "
                             f"expected one of {ARRIVALS}")
        if self.rate <= 0:
            raise ValueError("rate must be positive")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        if self.pareto_alpha <= 1.0:
            raise ValueError("pareto_alpha must be > 1 (finite mean)")

    def expected_arrivals(self, duration_s: float) -> float:
        """Expected arrival count over ``duration_s`` (exact for
        steady, the Poisson/Pareto mean otherwise)."""
        mean_rate = self.rate
        if self.arrival == "bursty":
            mean_rate = self.rate * (
                1.0 + (self.burst_factor - 1.0)
                * self.burst_len_s / self.burst_every_s)
        return mean_rate * float(duration_s)


def parse_tenant_specs(text: str) -> Tuple[TenantSpec, ...]:
    """Parse the CLI spec syntax (module docstring) into specs."""
    specs: List[TenantSpec] = []
    for element in text.split(";"):
        element = element.strip()
        if not element:
            continue
        parts = element.split(":")
        if len(parts) < 3:
            raise ValueError(
                f"tenant spec {element!r} needs name:problem:arrival"
                f"[:key=value,...]")
        kwargs: Dict[str, object] = {}
        if len(parts) > 3:
            for kv in ":".join(parts[3:]).split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(f"bad key=value {kv!r} in tenant "
                                     f"spec {element!r}")
                key, value = kv.split("=", 1)
                key = key.strip()
                field = {f.name: f for f in
                         dataclasses.fields(TenantSpec)}.get(key)
                if field is None or key in ("name", "problem", "arrival"):
                    raise ValueError(f"unknown tenant-spec key {key!r}")
                if field.type in ("float", float):
                    kwargs[key] = float(value)
                elif field.type in ("bool", bool):
                    kwargs[key] = value.strip() in ("1", "true", "yes")
                elif key == "quota":
                    kwargs[key] = (None if value.strip() in ("", "none")
                                   else int(value))
                else:
                    kwargs[key] = int(value)
        specs.append(TenantSpec(name=parts[0].strip(),
                                problem=parts[1].strip(),
                                arrival=parts[2].strip(), **kwargs))
    if not specs:
        raise ValueError("empty tenant spec")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    return tuple(specs)


def _rng(seed: int, tenant: str, salt: str) -> np.random.Generator:
    """One deterministic stream per (seed, tenant, purpose) — traces
    replay exactly however many tenants share the blend seed. The key
    is a full digest of the identity, not a byte-sum: anagram tenant
    names ("fund-ab"/"fund-ba") must NOT share a stream, or a blend
    would submit perfectly synchronized duplicate traffic and corrupt
    the very fairness measurements this module exists to make."""
    import hashlib

    digest = hashlib.blake2b(f"{seed}|{tenant}|{salt}".encode(),
                             digest_size=16).digest()
    return np.random.Generator(np.random.PCG64(
        int.from_bytes(digest, "little")))


def arrival_times(spec: TenantSpec, duration_s: float,
                  seed: int = 0) -> np.ndarray:
    """Seeded arrival offsets (seconds, sorted, within
    ``[0, duration_s)``) for one tenant."""
    duration_s = float(duration_s)
    rng = _rng(seed, spec.name, "arrivals")
    if spec.arrival == "steady":
        n = max(int(round(spec.rate * duration_s)), 1)
        return (np.arange(n) / spec.rate).astype(np.float64)
    if spec.arrival == "heavy_tailed":
        # Pareto(alpha) inter-arrivals, scaled so the MEAN matches
        # 1/rate: long silences and packed clusters at the same
        # sustained load a uniform grid would report.
        a = spec.pareto_alpha
        mean = a / (a - 1.0)
        n_expect = int(spec.rate * duration_s * 2) + 16
        gaps = (rng.pareto(a, size=n_expect) + 1.0) / mean / spec.rate
        times = np.cumsum(gaps)
        return times[times < duration_s]
    # Inhomogeneous Poisson via thinning (diurnal and bursty are both
    # rate-modulated Poisson streams; only the intensity differs).
    if spec.arrival == "diurnal":
        peak = spec.rate * (1.0 + spec.amplitude)

        def intensity(t: np.ndarray) -> np.ndarray:
            return spec.rate * (1.0 + spec.amplitude * np.sin(
                2.0 * np.pi * t / spec.period_s))
    else:  # bursty
        peak = spec.rate * spec.burst_factor

        def intensity(t: np.ndarray) -> np.ndarray:
            in_burst = np.mod(t, spec.burst_every_s) < spec.burst_len_s
            return np.where(in_burst, spec.rate * spec.burst_factor,
                            spec.rate)

    n_candidate = int(peak * duration_s * 1.2) + 16
    gaps = rng.exponential(1.0 / peak, size=n_candidate)
    times = np.cumsum(gaps)
    times = times[times < duration_s]
    keep = rng.random(times.shape) < intensity(times) / peak
    return times[keep]


# ---------------------------------------------------------------------------
# per-tenant problem streams (host numpy, host tensors)
# ---------------------------------------------------------------------------

def _tracking_parts(X: np.ndarray, y: np.ndarray) -> dict:
    """Index-replication QP parts (budget + long-only box) at ridge 0
    — the same P = 2XᵀX / q = -2Xᵀy shape the round-1 serve workload
    uses."""
    n = X.shape[1]
    return dict(
        P=2.0 * X.T @ X, q=-2.0 * (X.T @ y),
        C=np.ones((1, n)), l=np.ones(1), u=np.ones(1),
        lb=np.zeros(n), ub=np.ones(n), constant=float(y @ y))


def build_problems(spec: TenantSpec, seed: int = 0) -> list:
    """Build one tenant's pool of :class:`CanonicalQP` requests
    (cycled by arrival index — a pool bounds build time for
    hours-scale soaks the same way the fleet driver's request pool
    does)."""
    from porqua_tpu_torch.qp import lift
    from porqua_tpu_torch.qp.canonical import CanonicalQP
    from porqua_tpu_torch.tracking import synthetic_universe_np

    Xs, ys = synthetic_universe_np(
        seed=int(_rng(seed, spec.name, "universe").integers(2**31 - 1)),
        n_dates=spec.pool, window=spec.window, n_assets=spec.n_assets)
    out = []
    rng = _rng(seed, spec.name, "problems")
    for i in range(spec.pool):
        X = Xs[i].astype(np.float64)
        y = ys[i].astype(np.float64)
        n = X.shape[1]
        if spec.problem == "tracking":
            parts = _tracking_parts(X, y)
            out.append(CanonicalQP.build(**parts, device="cpu"))
            continue
        if spec.problem == "turnover":
            # The reference's linearized turnover-cost objective over
            # (w, t): previous-date holdings as the reference position
            # (date 0 starts from equal weight).
            parts = _tracking_parts(X, y)
            constant = parts.pop("constant")
            x_prev = (np.full(n, 1.0 / n) if not out
                      else rng.dirichlet(np.ones(n)))
            parts = lift.lift_turnover_objective(
                parts, x_prev, spec.transaction_cost)
            out.append(CanonicalQP.build(**parts, constant=constant,
                                         device="cpu"))
            continue
        # LAD: min sum|Xw - y| / T as a QP over (w, t) with
        # -t <= Xw - y <= t, plus a tiny ridge keeping P PD (the
        # ADMM path assumes a strictly convex objective). Dimension
        # 2n — lands in its own shape bucket, so a LAD tenant
        # exercises a different executable than the tracking tenants.
        T = X.shape[0]
        P = np.zeros((2 * n, 2 * n))
        P[:n, :n] = 1e-4 * np.eye(n)
        q = np.concatenate([np.zeros(n), np.ones(n) / T])
        # Compress the T residual rows onto n aggregate rows (random
        # signed aggregation, seeded): keeps m = 2n + 1 bounded by the
        # asset count instead of the window length while preserving
        # the |residual| <= t coupling shape.
        S = rng.choice([-1.0, 1.0], size=(n, T)) / np.sqrt(T)
        SX, Sy = S @ X, S @ y
        eye = np.eye(n)
        C = np.concatenate([
            np.concatenate([SX, -eye], axis=1),   # Sx r - t <= Sy
            np.concatenate([-SX, -eye], axis=1),  # -Sx r - t <= -Sy
            np.concatenate([np.ones((1, n)), np.zeros((1, n))], axis=1),
        ])
        l = np.concatenate([np.full(2 * n, -np.inf), np.ones(1)])
        u = np.concatenate([Sy, -Sy, np.ones(1)])
        lb = np.concatenate([np.zeros(n), np.zeros(n)])
        ub = np.concatenate([np.ones(n), np.full(n, np.inf)])
        out.append(CanonicalQP.build(P, q, C=C, l=l, u=u, lb=lb, ub=ub,
                                     device="cpu"))
    return out


# ---------------------------------------------------------------------------
# blends
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Blend:
    """One merged multi-tenant request stream (time-sorted)."""

    specs: Tuple[TenantSpec, ...]
    offsets: np.ndarray            # arrival offsets, seconds, sorted
    tenants: List[str]             # tenant per arrival
    requests: list                 # CanonicalQP per arrival
    duration_s: float
    seed: int

    def __len__(self) -> int:
        return len(self.tenants)

    def shares(self) -> Dict[str, int]:
        """Arrivals per tenant (the reconciliation figure)."""
        out: Dict[str, int] = {}
        for t in self.tenants:
            out[t] = out.get(t, 0) + 1
        return out

    def quota_map(self) -> Dict[str, int]:
        return {s.name: s.quota for s in self.specs
                if s.quota is not None}

    def weight_map(self) -> Dict[str, float]:
        return {s.name: s.weight for s in self.specs if s.weight != 1.0}

    def offenders(self) -> List[str]:
        return [s.name for s in self.specs if s.offender]


def build_blend(specs: Sequence[TenantSpec], duration_s: float,
                seed: int = 0) -> Blend:
    """Merge per-tenant traces + problem pools into one time-sorted
    arrival stream. Deterministic per (specs, duration, seed)."""
    specs = tuple(specs)
    per: List[Tuple[float, str, object]] = []
    for spec in specs:
        times = arrival_times(spec, duration_s, seed=seed)
        pool = build_problems(spec, seed=seed)
        for i, t in enumerate(times):
            per.append((float(t), spec.name, pool[i % len(pool)]))
    per.sort(key=lambda row: (row[0], row[1]))
    return Blend(
        specs=specs,
        offsets=np.asarray([row[0] for row in per], dtype=np.float64),
        tenants=[row[1] for row in per],
        requests=[row[2] for row in per],
        duration_s=float(duration_s),
        seed=int(seed))


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def selftest() -> None:
    """Seeded determinism + share reconciliation + spec parsing."""
    specs = parse_tenant_specs(
        "alpha:tracking:diurnal:rate=40,amplitude=0.5,period_s=20;"
        "beta:lad:heavy_tailed:rate=15,n_assets=12,window=32,pool=8;"
        "gamma:turnover:bursty:rate=8,burst_factor=10,offender=1,"
        "quota=64,weight=2")
    assert [s.name for s in specs] == ["alpha", "beta", "gamma"]
    assert specs[2].offender and specs[2].quota == 64
    assert specs[2].weight == 2.0

    b1 = build_blend(specs, duration_s=30.0, seed=7)
    b2 = build_blend(specs, duration_s=30.0, seed=7)
    # Replay-exact: same seed -> identical offsets, tenants, problem
    # bytes (the fleet driver shards one blend across processes by
    # arrival index, so any drift would split requests across shards).
    assert np.array_equal(b1.offsets, b2.offsets)
    assert b1.tenants == b2.tenants
    assert np.array_equal(np.asarray(b1.requests[0].P),
                          np.asarray(b2.requests[0].P))
    b3 = build_blend(specs, duration_s=30.0, seed=8)
    assert not np.array_equal(b1.offsets, b3.offsets), \
        "different seeds must produce different traces"
    # Anagram tenant names must NOT share a stream (the RNG key is a
    # full digest, not a byte-sum — regression: equal-byte-sum names
    # produced byte-identical traces and synchronized their traffic).
    t_ab = arrival_times(dataclasses.replace(specs[0], name="fund-ab"),
                         30.0, seed=7)
    t_ba = arrival_times(dataclasses.replace(specs[0], name="fund-ba"),
                         30.0, seed=7)
    assert not np.array_equal(t_ab, t_ba), \
        "anagram tenant names shared an RNG stream"

    # Shares reconcile: every arrival is attributed to exactly one
    # tenant, totals match, and each tenant's share sits near its
    # rate*duration expectation (Poisson-loose bands; steady exact).
    shares = b1.shares()
    assert sum(shares.values()) == len(b1)
    for spec in specs:
        expect = spec.expected_arrivals(b1.duration_s)
        lo, hi = 0.6 * expect, 1.5 * expect
        assert lo <= shares[spec.name] <= hi, (
            spec.name, shares[spec.name], expect)
    # The bursty offender actually bursts: its peak 1 s window carries
    # several times its mean rate.
    gtimes = b1.offsets[np.asarray(b1.tenants) == "gamma"]
    binned = np.histogram(gtimes, bins=np.arange(0.0, 31.0))[0]
    assert binned.max() >= 3 * specs[2].rate, binned.max()
    # Offsets are sorted and inside the window.
    assert np.all(np.diff(b1.offsets) >= 0)
    assert b1.offsets[-1] < b1.duration_s

    # Problem shapes: LAD doubles the variable count (own bucket);
    # turnover lifts to 2n with the tc term on the aux block.
    from porqua_tpu_torch.qp.canonical import CanonicalQP

    by_tenant = {t: r for t, r in zip(b1.tenants, b1.requests)}
    assert isinstance(by_tenant["alpha"], CanonicalQP)
    assert by_tenant["alpha"].n == specs[0].n_assets
    assert by_tenant["beta"].n == 2 * specs[1].n_assets
    assert by_tenant["gamma"].n == 2 * specs[2].n_assets
    q_gamma = np.asarray(by_tenant["gamma"].q)
    n = specs[2].n_assets
    assert np.allclose(q_gamma[n:2 * n], specs[2].transaction_cost,
                       atol=1e-6)
