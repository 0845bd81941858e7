"""OpenMetrics / Prometheus text exposition of the metrics hub.

The port's copy of ``uda_tpu/utils/openmetrics.py``: an optional stdlib
HTTP endpoint (``uda.tpu.metrics.http.port``; 0 = off) serving
``GET /metrics`` in the Prometheus text format over the same registry
MSG_STATS exports: counters (labelled series included) as ``_total``,
gauges, and histogram summaries as quantile gauges plus ``_count`` and
``_sum``. Names mangle dots to underscores under a ``uda_`` prefix
(``fetch.bytes`` -> ``uda_fetch_bytes``); labels are re-parsed from the
hub's ``name{k=v,...}`` keys.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from uda_tpu_torch.utils.logging import get_logger
from uda_tpu_torch.utils.metrics import METRICS_REGISTRY, Metrics
from uda_tpu_torch.utils.metrics import metrics as global_metrics

__all__ = ["render_openmetrics", "MetricsHTTP", "metrics_http"]

log = get_logger()


def _mangle(name: str) -> str:
    return "uda_" + name.replace(".", "_")


def _labels_of(key: str) -> tuple:
    """Split ``name{k=v,...}`` -> (name, rendered label string)."""
    if not key.endswith("}") or "{" not in key:
        return key, ""
    name, _, inner = key.partition("{")
    pairs = []
    for kv in inner[:-1].split(","):
        if "=" in kv:
            k, _, v = kv.partition("=")
            v = v.replace("\\", "\\\\").replace('"', '\\"')
            pairs.append(f'{k}="{v}"')
    return name, "{" + ",".join(pairs) + "}"


def render_openmetrics(m: Optional[Metrics] = None) -> str:
    """The whole hub as Prometheus text exposition format."""
    m = m or global_metrics
    lines = []
    seen_help = set()

    def _help(name: str, kind: str) -> None:
        if name in seen_help:
            return
        seen_help.add(name)
        reg = METRICS_REGISTRY.get(name)
        doc = (reg[1] if reg else "").replace("\n", " ")
        lines.append(f"# HELP {_mangle(name)} {doc}")
        lines.append(f"# TYPE {_mangle(name)} {kind}")

    for key, val in sorted(m.snapshot().items()):
        name, labels = _labels_of(key)
        _help(name, "counter")
        lines.append(f"{_mangle(name)}_total{labels} {val:g}")
    for key, val in sorted(m.gauges_snapshot().items()):
        name, labels = _labels_of(key)
        _help(name, "gauge")
        lines.append(f"{_mangle(name)}{labels} {val:g}")
    for key, s in sorted(m.histogram_summaries().items()):
        name, labels = _labels_of(key)
        _help(name, "summary")
        base, inner = _mangle(name), labels[1:-1] if labels else ""
        for q, p in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if p in s:
                qlabels = (f'{{quantile="{q}"'
                           + (f",{inner}" if inner else "") + "}")
                lines.append(f"{base}{qlabels} {s[p]:g}")
        lines.append(f"{base}_count{labels} {s.get('count', 0):g}")
        lines.append(f"{base}_sum{labels} {s.get('sum', 0.0):g}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = render_openmetrics().encode("utf-8")
        except Exception as e:  # noqa: BLE001 - a scrape must answer
            # 500, never kill the handler thread
            self.send_error(500, str(e)[:200])
            return
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not log lines
        pass


class MetricsHTTP:
    """Lifecycle wrapper: one exposition endpoint per process
    (module singleton :data:`metrics_http`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        with self._lock:
            return self._server.server_address[1] if self._server else 0

    def start(self, port: int, host: str = "127.0.0.1") -> int:
        """Bind + serve in a daemon thread (idempotent; port 0 = any).
        Returns the bound port."""
        with self._lock:
            if self._server is not None:
                return self._server.server_address[1]
            srv = ThreadingHTTPServer((host, int(port)), _Handler)
            srv.daemon_threads = True
            self._server = srv
            self._thread = threading.Thread(
                target=srv.serve_forever, kwargs={"poll_interval": 0.2},
                daemon=True, name="uda-openmetrics")
            self._thread.start()
            log.info(f"OpenMetrics exposition on "
                     f"http://{host}:{srv.server_address[1]}/metrics")
            return srv.server_address[1]

    def stop(self) -> None:
        with self._lock:
            srv, self._server = self._server, None
            t, self._thread = self._thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if t is not None:
            t.join(timeout=5.0)


metrics_http = MetricsHTTP()
