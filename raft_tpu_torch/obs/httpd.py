"""Tiny stdlib HTTP exposition server: ``/metrics`` + ``/healthz``.

One ``ThreadingHTTPServer`` on a daemon thread per :class:`MetricsServer`
— no framework, no dependency, good enough for a scraper hitting it a
few times a minute (counterpart of ``raft_tpu.obs.httpd``). The serving
:class:`~raft_tpu_torch.serving.engine.Engine` owns one when
``EngineConfig.metrics_port`` is set (or via ``Engine.serve_metrics()``);
anything else with a registry and an optional health callable can run
one too.

Routes:

- ``GET /metrics``  → Prometheus text exposition (0.0.4), 200.
- ``GET /metrics.json`` → the registry's JSON dump, 200.
- ``GET /healthz``  → JSON health doc; 200 for ``ok``/``degraded``
  (alive but shedding is still alive), 503 for anything else — a
  pre-flight probe curls this before pointing traffic at a host.
- ``GET /debug/bundle`` → a freshly-built flight-recorder diagnostics
  bundle (``bundle_fn``, typically ``Engine.dump_diagnostics`` — the
  span tape + registry snapshot + health + config in one JSON doc);
  404 when no ``bundle_fn`` is wired.
- ``GET /slo`` → the SLO monitor's burn-rate report (``slo_fn``,
  typically ``SLOMonitor.report`` — per-SLO burn rates, budget
  remaining, and fast-burn flags as JSON); 404 when no ``slo_fn`` is
  wired.
- anything else → offered to ``text_route_fn`` (dynamic text routes),
  else 404.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from raft_tpu_torch.obs import metrics as _metrics

__all__ = ["MetricsServer"]

_OK_STATUSES = ("ok", "degraded")


class MetricsServer:
    """Serve ``registry`` (default: the global one) on ``host:port``.
    ``port=0`` binds an ephemeral port (tests); read ``.port`` after
    ``start()``. ``health_fn`` returns the health doc — typically
    ``Engine.health`` — and its ``"status"`` picks the HTTP code."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[_metrics.Registry] = None,
                 health_fn: Optional[Callable[[], dict]] = None,
                 bundle_fn: Optional[Callable[[], dict]] = None,
                 slo_fn: Optional[Callable[[], dict]] = None,
                 extra_text_fn: Optional[Callable[[], str]] = None,
                 text_route_fn: Optional[
                     Callable[[str], Optional[str]]] = None) -> None:
        self._registry = registry if registry is not None else \
            _metrics.REGISTRY
        self._health_fn = health_fn
        self._bundle_fn = bundle_fn
        self._slo_fn = slo_fn
        # appended verbatim to the /metrics body (foreign families from
        # another registry); a raising fn is counted + silenced like
        # every other telemetry path
        self._extra_text_fn = extra_text_fn
        # dynamic text routes: called with any otherwise-unmatched GET
        # path; a str return is served as Prometheus text, None falls
        # through to 404
        self._text_route_fn = text_route_fn
        self._requested = (host, int(port))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # exposed after start()
    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("MetricsServer not started")
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._requested[0]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # stay quiet
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        text = server._registry.to_prometheus_text()
                        if server._extra_text_fn is not None:
                            try:
                                extra = server._extra_text_fn()
                            except Exception as e:
                                extra = ""
                                server._registry.counter(
                                    "raft_tpu_http_errors_total",
                                    "Handler failures by path and "
                                    "exception type.",
                                    ("path", "error")).labels(
                                        "/metrics[extra]",
                                        type(e).__name__).inc()
                            if extra:
                                text = text.rstrip("\n") + "\n" + extra
                        self._send(200,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8", text.encode())
                    elif path == "/metrics.json":
                        doc = server._registry.to_json()
                        self._send(200, "application/json",
                                   json.dumps(doc, sort_keys=True).encode())
                    elif path == "/healthz":
                        self._do_healthz()
                    elif path == "/slo":
                        if server._slo_fn is None:
                            self._send(404, "text/plain",
                                       b"no SLO monitor wired\n")
                        else:
                            doc = server._slo_fn()
                            self._send(200, "application/json",
                                       (json.dumps(doc, sort_keys=True,
                                                   default=str)
                                        + "\n").encode())
                    elif path == "/debug/bundle":
                        if server._bundle_fn is None:
                            self._send(404, "text/plain",
                                       b"no flight recorder wired\n")
                        else:
                            doc = server._bundle_fn()
                            self._send(200, "application/json",
                                       (json.dumps(doc, sort_keys=True,
                                                   default=str)
                                        + "\n").encode())
                    else:
                        body = (server._text_route_fn(path)
                                if server._text_route_fn is not None
                                else None)
                        if body is None:
                            self._send(404, "text/plain", b"not found\n")
                        else:
                            self._send(200,
                                       "text/plain; version=0.0.4; "
                                       "charset=utf-8",
                                       str(body).encode())
                except BrokenPipeError:
                    # scraper hung up mid-response; count it so a flaky
                    # collector shows up on the dashboard it scrapes
                    server._registry.counter(
                        "raft_tpu_http_disconnects_total",
                        "Scrapes aborted by the client mid-response.",
                        ("path",)).labels(path).inc()
                except Exception as e:
                    # count before answering: a client that sees the 500
                    # must also see the incremented counter on a scrape
                    server._registry.counter(
                        "raft_tpu_http_errors_total",
                        "Handler failures by path and exception type.",
                        ("path", "error")).labels(
                            path, type(e).__name__).inc()
                    try:
                        self._send(500, "text/plain",
                                   f"{type(e).__name__}: {e}\n".encode())
                    except Exception:
                        # the 500 itself failed: the socket is already
                        # gone, which is a disconnect, not a new error
                        server._registry.counter(
                            "raft_tpu_http_disconnects_total",
                            "Scrapes aborted by the client mid-response.",
                            ("path",)).labels(path).inc()

            def _do_healthz(self):
                if server._health_fn is None:
                    doc, code = {"status": "ok"}, 200
                else:
                    try:
                        doc = dict(server._health_fn())
                        code = 200 if doc.get("status") in _OK_STATUSES \
                            else 503
                    except Exception as e:
                        doc = {"status": "error",
                               "error": f"{type(e).__name__}: {e}"}
                        code = 503
                self._send(code, "application/json",
                           (json.dumps(doc, sort_keys=True, default=str)
                            + "\n").encode())

        host, port = self._requested
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name="raft-tpu-metrics-httpd", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
