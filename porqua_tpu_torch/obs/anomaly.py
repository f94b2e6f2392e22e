"""Harvest-calibrated online convergence anomaly detection (the port
of ``porqua_tpu/obs/anomaly.py``, a host copy).

The telemetry warehouse (:mod:`porqua_tpu_torch.obs.harvest`) turned every
solve into a record and ``scripts/harvest_report.py`` rolls them into
per-(bucket, eps) iteration quantiles — an offline picture of what
"normal" convergence looks like. This module closes the loop online:
:class:`AnomalyDetector` loads those aggregates as **baselines** and,
at every request retirement in both batchers, folds the lane's final
iteration count and wasted-iteration fraction into per-group EWMAs.
When a group's EWMA drifts past its baseline quantile band (iters EWMA
above ``iters_factor`` x the baseline p95, or waste EWMA above the
baseline waste + ``waste_margin``), the detector fires ONE
``convergence_anomaly`` event (``state="firing"``) — a flight-recorder
trigger — and resolves it with hysteresis once the EWMA falls back
under ``clear_fraction`` of the band.

This is exactly the detection the ROADMAP's learned-adaptive-policy
item presupposes: a policy that adapts per problem ("Learning
context-aware adaptive solvers to accelerate quadratic programming",
PAPERS.md) first needs to know, live, when convergence has left the
distribution it was fitted on (HARVEST_r07-style datasets).

Pure host arithmetic on integers the batchers already fetched: a live
detector changes nothing the card runs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from porqua_tpu_torch.analysis import tsan

__all__ = ["AnomalyDetector"]


class _GroupState:
    """Per-(bucket, eps) online state (guarded by the detector lock)."""

    __slots__ = ("n", "ewma_iters", "ewma_waste", "anomalous")

    def __init__(self) -> None:
        self.n = 0
        self.ewma_iters = 0.0
        self.ewma_waste = 0.0
        self.anomalous = False


def _eps_key(eps) -> Optional[float]:
    """Normalize an eps value into a stable group key (floats from
    params and from a JSON round-trip of the same params compare
    equal; ``None`` stays ``None``)."""
    return None if eps is None else float(eps)


class AnomalyDetector:
    """Online EWMA-vs-baseline convergence monitor (module docstring).

    ``baseline`` maps ``(bucket, eps_abs)`` to quantile bands — build
    it from a harvest dataset via :meth:`from_harvest` (the
    ``--anomaly-baseline`` path) or from a precomputed
    :func:`porqua_tpu_torch.obs.harvest.aggregate` payload via
    :meth:`from_aggregate`. Groups the baseline has never seen are
    counted (``anomaly_unknown_group``) but never judged — an unknown
    workload is not evidence of drift.

    Thread-safety: ``observe`` runs on the dispatch thread,
    ``status``/``counters`` on scrape threads; state is guarded by the
    instance lock and events are emitted OUTSIDE it (the flight
    recorder's dump path reads ``status()`` from an event listener).
    """

    def __init__(self,
                 baseline: Dict[Tuple[str, Optional[float]],
                                Dict[str, float]],
                 alpha: float = 0.2,
                 iters_factor: float = 1.5,
                 waste_margin: float = 0.25,
                 clear_fraction: float = 0.9,
                 min_samples: int = 8,
                 events=None) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.baseline = {(str(b), _eps_key(e)): dict(v)
                         for (b, e), v in baseline.items()}
        self.alpha = float(alpha)
        self.iters_factor = float(iters_factor)
        self.waste_margin = float(waste_margin)
        self.clear_fraction = float(clear_fraction)
        self.min_samples = int(min_samples)
        self.events = events
        self._lock = tsan.lock("AnomalyDetector")
        # (tenant, bucket, eps) online groups against (bucket, eps)
        # baselines.                            guarded-by: self._lock
        self._groups: Dict[Tuple[Optional[str], str, Optional[float]],
                           _GroupState] = {}
        self._fired = 0            # guarded-by: self._lock
        self._resolved = 0         # guarded-by: self._lock
        self._unknown = 0          # guarded-by: self._lock
        self._observed = 0         # guarded-by: self._lock

    # -- constructors -------------------------------------------------

    @classmethod
    def from_aggregate(cls, agg: Dict[str, Any],
                       **kwargs) -> "AnomalyDetector":
        """Baselines from one :func:`porqua_tpu_torch.obs.harvest.aggregate`
        payload (``scripts/harvest_report.py``'s table).

        Aggregates are per ``(tenant, bucket, eps)`` since harvest
        schema v2; the BASELINE stays per ``(bucket, eps)`` — solver
        convergence is physics of the problem class, not of who
        submitted it — so tenant rows of the same (bucket, eps) merge:
        counts sum, the p95/max band takes the widest tenant's value
        (conservative: the band only ever loosens), the waste
        attribution count-weights. Online EWMAs are still tracked per
        (tenant, bucket, eps), so a single tenant's drift fires an
        event naming that tenant."""
        merged: Dict[tuple, Dict[str, float]] = {}
        for g in agg.get("groups", ()):
            key = (str(g["bucket"]), _eps_key(g.get("eps_abs")))
            count = int(g.get("count", 0))
            row = {
                "iters_p50": float(g["iters"]["p50"]),
                "iters_p95": float(g["iters"]["p95"]),
                "iters_max": float(g["iters"]["max"]),
                "wasted": float(g.get("wasted_iteration_fraction", 0.0)),
                "count": count,
            }
            base = merged.get(key)
            if base is None:
                merged[key] = row
                continue
            total = base["count"] + count
            if total > 0:
                base["iters_p50"] = (
                    base["iters_p50"] * base["count"]
                    + row["iters_p50"] * count) / total
                base["wasted"] = (base["wasted"] * base["count"]
                                  + row["wasted"] * count) / total
            base["iters_p95"] = max(base["iters_p95"], row["iters_p95"])
            base["iters_max"] = max(base["iters_max"], row["iters_max"])
            base["count"] = total
        return cls(merged, **kwargs)

    @classmethod
    def from_harvest(cls, path: str, **kwargs) -> "AnomalyDetector":
        """Baselines straight from a harvest dataset (JSONL/.gz) —
        ``HARVEST_r07.json``-era datasets load unchanged."""
        from porqua_tpu_torch.obs.harvest import aggregate, load_harvest

        return cls.from_aggregate(aggregate(load_harvest(path)), **kwargs)

    # -- online path --------------------------------------------------

    def _bands(self, base: Dict[str, float]) -> Tuple[float, float]:
        iters_band = max(base.get("iters_p95", 0.0), 1.0) * self.iters_factor
        waste_band = base.get("wasted", 0.0) + self.waste_margin
        return iters_band, waste_band

    def observe(self, bucket: str, eps, iters: int,
                segments: Optional[int] = None,
                check_interval: int = 1,
                tenant: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Fold one retired lane into its group's EWMAs and step the
        anomaly state machine; returns the transition event emitted
        (``None`` almost always). ``segments`` is the executed segment
        count where the caller knows it (continuous/compacted modes);
        classic mode derives ``ceil(iters / check_interval)`` — the
        same convention :func:`porqua_tpu_torch.obs.harvest.solve_record`
        uses, so online waste matches the baseline's attribution.
        ``tenant`` splits the online EWMA per tenant against the
        shared (bucket, eps) baseline, so one tenant's corrupt feed or
        pathological stream fires an event carrying that tenant while
        the others' groups stay clean."""
        base_key = (str(bucket), _eps_key(eps))
        key = (tenant, str(bucket), _eps_key(eps))
        base = self.baseline.get(base_key)
        iters = int(iters)
        ci = max(int(check_interval), 1)
        segs = int(segments) if segments else max(-(-iters // ci), 1)
        waste = 1.0 - iters / max(segs * ci, 1)
        waste = min(max(waste, 0.0), 1.0)
        event: Optional[Dict[str, Any]] = None
        with self._lock:
            self._observed += 1
            if base is None:
                self._unknown += 1
                return None
            g = self._groups.setdefault(key, _GroupState())
            if g.n == 0:
                g.ewma_iters = float(iters)
                g.ewma_waste = waste
            else:
                a = self.alpha
                g.ewma_iters += a * (iters - g.ewma_iters)
                g.ewma_waste += a * (waste - g.ewma_waste)
            g.n += 1
            iters_band, waste_band = self._bands(base)
            breach = g.n >= self.min_samples and (
                g.ewma_iters > iters_band or g.ewma_waste > waste_band)
            clear = (g.ewma_iters <= iters_band * self.clear_fraction
                     and g.ewma_waste
                     <= waste_band * self.clear_fraction)
            if breach and not g.anomalous:
                g.anomalous = True
                self._fired += 1
                event = self._event("firing", "warn", key, g, base)
            elif g.anomalous and clear:
                g.anomalous = False
                self._resolved += 1
                event = self._event("resolved", "info", key, g, base)
        if event is not None and self.events is not None:
            self.events.emit(**event)
        return event

    def _event(self, state: str, severity: str, key, g: _GroupState,  # guarded-by: self._lock
               base: Dict[str, float]) -> Dict[str, Any]:
        iters_band, waste_band = self._bands(base)
        extra = {} if key[0] is None else {"tenant": key[0]}
        return dict(
            kind="convergence_anomaly", severity=severity,
            state=state, bucket=key[1], eps=key[2], **extra,
            ewma_iters=round(g.ewma_iters, 2),
            ewma_waste=round(g.ewma_waste, 4),
            iters_band=round(iters_band, 2),
            waste_band=round(waste_band, 4),
            baseline_iters_p95=base.get("iters_p95"),
            baseline_wasted=base.get("wasted"),
            n=g.n)

    # -- readers ------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """Per-group EWMA-vs-band state (the flight bundle's
        ``anomaly`` section and the ``/healthz`` surface)."""
        with self._lock:
            groups = {}
            anomalous: List[str] = []
            for (tenant, bucket, eps), g in self._groups.items():
                base = self.baseline[(bucket, eps)]
                iters_band, waste_band = self._bands(base)
                label = (f"{bucket}@{eps:.0e}" if eps is not None
                         and math.isfinite(eps) else f"{bucket}@-")
                if tenant is not None:
                    label = f"{tenant}/{label}"
                groups[label] = {
                    "n": g.n,
                    "ewma_iters": round(g.ewma_iters, 2),
                    "ewma_waste": round(g.ewma_waste, 4),
                    "iters_band": round(iters_band, 2),
                    "waste_band": round(waste_band, 4),
                    "anomalous": g.anomalous,
                }
                if g.anomalous:
                    anomalous.append(label)
            return {
                "groups": groups,
                "anomalous": anomalous,
                "fired": self._fired,
                "resolved": self._resolved,
                "observed": self._observed,
                "unknown_group": self._unknown,
                "baseline_groups": len(self.baseline),
            }

    def counters(self) -> Dict[str, int]:
        """Exposition counters (``/metrics`` extra_counters path)."""
        with self._lock:
            return {"anomalies_fired": self._fired,
                    "anomaly_unknown_group": self._unknown}
