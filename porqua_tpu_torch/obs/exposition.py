"""Prometheus text exposition + optional stdlib-HTTP scrape endpoint
(the port of ``porqua_tpu/obs/exposition.py``, a host copy).

:func:`prometheus_text` renders a :class:`porqua_tpu_torch.serve.metrics.
ServeMetrics` snapshot in the Prometheus text exposition format
(version 0.0.4): window counters as ``counter`` metrics, derived
rates/percentiles/gauges as ``gauge``, the current device identity as
an info-style labeled gauge. :class:`ObsHTTPServer` is the zero-
dependency scrape endpoint — ``http.server.ThreadingHTTPServer`` on a
daemon thread serving ``/metrics`` (exposition) and ``/healthz``
(JSON liveness + degradation) — started via
``SolveService.start_http()``. Plane gauges ride the same snapshot:
a wired :class:`~porqua_tpu_torch.obs.calibrate.Calibrator` surfaces its
``calibration_*`` counters and gauges (route-table version, state-
machine position, promotion/rollback totals, last-reseed age) here
and its full status section on ``/healthz``. Metric names: README
"Observability".
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

#: Snapshot keys that are free-form metadata, not metrics.
_NON_METRIC_KEYS = ("device", "t")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, key: str) -> str:
    return f"{prefix}_{_NAME_RE.sub('_', key)}"


def _escape_label(value) -> str:
    """Label-value escaping per the exposition format spec: an
    unescaped ``"``/``\\``/newline in any label would invalidate the
    WHOLE scrape, not just its line."""
    return (str(value).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _histogram_lines(name: str, hist: Dict[str, Any]) -> list:
    """Render one histogram as cumulative ``_bucket``/``_sum``/
    ``_count`` series (Prometheus histogram semantics: each ``le``
    bucket counts every observation <= its bound, ``+Inf`` == count).
    ``hist`` is :meth:`porqua_tpu_torch.serve.metrics.ServeMetrics.
    histograms` state — per-bucket (non-cumulative) counts with the
    overflow bucket last."""
    lines = [f"# TYPE {name} histogram"]
    cum = 0
    for le, count in zip(hist["le"], hist["counts"]):
        cum += int(count)
        le_s = f"{float(le):g}"
        lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
    cum += int(hist["counts"][-1])
    lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
    lines.append(f"{name}_sum {float(hist['sum'])}")
    lines.append(f"{name}_count {int(hist['count'])}")
    return lines


def prometheus_text(snapshot: Dict[str, Any],
                    prefix: str = "porqua_serve",
                    histograms: Optional[Dict[str, Dict[str, Any]]] = None,
                    extra_counters: Optional[Dict[str, Any]] = None,
                    extra_gauges: Optional[Dict[str, Any]] = None,
                    labeled_gauges: Optional[Dict[str, Any]] = None) -> str:
    """Render one metrics snapshot as Prometheus exposition text.

    Every numeric snapshot key is exported; keys in the window-counter
    set (:data:`porqua_tpu_torch.serve.metrics.COUNTERS`) are typed
    ``counter`` (they reset with the measurement window — scrapers
    should treat window resets like process restarts), everything else
    ``gauge``. ``degraded`` exports as 0/1 and ``device`` as a labeled
    ``_device_info`` gauge.

    ``histograms`` renders real cumulative-histogram series
    (``<prefix>_<name>_bucket{le=...}`` / ``_sum`` / ``_count`` —
    :meth:`ServeMetrics.histograms` state) next to the percentile
    gauges, which stay for backward compatibility. ``extra_counters``
    exports observability-plane counters that live outside the
    snapshot (``EventBus.dropped``, harvest sink failures, span
    drops) as ``counter`` series — a saturated bounded bus is
    invisible to a scraper otherwise. ``extra_gauges`` does the same
    with ``gauge`` typing — the SLO engine's ``slo_burn_rate`` /
    ``slo_alert_state`` / ``slo_compliance`` series ride this path
    (:meth:`porqua_tpu_torch.obs.slo.SLOEngine.gauges`).

    ``labeled_gauges`` renders label-carrying gauge series:
    ``{name: [(labels_dict, value), ...]}`` becomes one ``# TYPE``
    header plus ``<prefix>_<name>{k="v",...} value`` per entry — the
    executable cache's per-bucket compile-seconds / hit / peak-memory
    series (:meth:`porqua_tpu_torch.serve.bucketing.ExecutableCache.
    prometheus_gauges`) ride this path.
    """
    # Imported lazily: serve imports obs, so a module-level import here
    # would be circular; at call time both modules are initialized.
    from porqua_tpu_torch.serve.metrics import COUNTERS

    counters = set(COUNTERS)
    lines = []
    for key, value in snapshot.items():
        if key in _NON_METRIC_KEYS:
            continue
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        name = _metric_name(prefix, key)
        kind = "counter" if key in counters else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {value}")
    for key, hist in (histograms or {}).items():
        lines.extend(_histogram_lines(_metric_name(prefix, key), hist))
    for kind, extras in (("counter", extra_counters),
                         ("gauge", extra_gauges)):
        for key, value in (extras or {}).items():
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            name = _metric_name(prefix, key)
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {value}")
    for key, series in (labeled_gauges or {}).items():
        rendered = []
        for labels, value in series:
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            lbl = ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in sorted(labels.items()))
            rendered.append((lbl, value))
        if not rendered:
            continue
        name = _metric_name(prefix, key)
        lines.append(f"# TYPE {name} gauge")
        for lbl, value in rendered:
            lines.append(f"{name}{{{lbl}}} {value}")
    device = snapshot.get("device")
    if device:
        name = _metric_name(prefix, "device_info")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f'{name}{{device="{_escape_label(device)}"}} 1')
    return "\n".join(lines) + "\n"


class ObsHTTPServer:
    """``/metrics`` + ``/healthz`` on a daemon thread; stdlib only.

    ``metrics_fn`` returns the exposition text; ``health_fn`` returns a
    JSON-able dict (must carry ``ok``: a falsy ``ok`` answers 503 so
    load balancers can eject a degraded-and-drowning instance while
    scrapers keep reading ``/metrics``).
    """

    def __init__(self, metrics_fn: Callable[[], str],
                 health_fn: Callable[[], Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._metrics_fn = metrics_fn
        self._health_fn = health_fn
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = outer._metrics_fn().encode()
                        self._reply(200, body,
                                    "text/plain; version=0.0.4")
                    elif self.path.split("?")[0] == "/healthz":
                        health = outer._health_fn()
                        body = json.dumps(health).encode()
                        code = 200 if health.get("ok", True) else 503
                        self._reply(code, body, "application/json")
                    else:
                        self._reply(404, b"not found\n", "text/plain")
                except Exception as exc:  # noqa: BLE001 - never kill the server
                    self._reply(500, f"{exc!r}\n".encode(), "text/plain")

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes must not spam the serving process's stderr

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> int:
        """Begin serving; returns the bound port (useful with port=0)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="porqua-obs-http", daemon=True)
            self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread = None
