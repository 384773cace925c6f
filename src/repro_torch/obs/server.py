"""Stdlib HTTP sidecar exposing the observability surface.

Port of ``repro.obs.server`` (standard library only).

:class:`MetricsServer` wraps a ``ThreadingHTTPServer`` on a daemon
thread serving three read-only endpoints:

  * ``GET /metrics``  — Prometheus text exposition from the registry
    (``text/plain; version=0.0.4``);
  * ``GET /healthz``  — ``ok`` once the serving source answers a
    ``metrics()`` snapshot, 503 with the error otherwise;
  * ``GET /stats``    — JSON dump: the full ``EngineMetrics`` snapshot
    plus per-collection stats (residency split, delta fill) when the
    source exposes ``stats()``.

No third-party dependencies — the sidecar must run wherever the serving
CLI runs. Bind with ``port=0`` to take an ephemeral port (``.port``
reports the bound one), which is how tests and the CI smoke scrape a
just-started server without a port race.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _jsonable(obj):
    """Best-effort conversion of stats payloads (NamedTuples, numpy
    scalars, nested dicts) into JSON-serializable structures."""
    if hasattr(obj, "_asdict"):
        return {k: _jsonable(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, bool)) or obj is None:
        return obj
    if isinstance(obj, (int, float)):
        return obj
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return repr(obj)


class MetricsServer:
    """Serve ``registry`` (and optionally ``source`` stats) over HTTP.

    ``source`` is duck-typed: ``metrics()`` backs ``/healthz`` and the
    snapshot half of ``/stats``; ``stats()``, when present, adds the
    per-collection residency dump. Runs on a daemon thread; ``close()``
    shuts the listener down (also a context manager).
    """

    def __init__(self, registry, *, source=None, host: str = "127.0.0.1",
                 port: int = 0):
        self._registry = registry
        self._source = source

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = server._registry.render().encode()
                        self._reply(200, body, PROMETHEUS_CONTENT_TYPE)
                    elif path == "/healthz":
                        server._check_health()
                        self._reply(200, b"ok\n", "text/plain")
                    elif path == "/stats":
                        body = json.dumps(
                            server._stats_payload(), indent=2
                        ).encode()
                        self._reply(200, body, "application/json")
                    else:
                        self._reply(404, b"not found\n", "text/plain")
                except Exception as exc:  # noqa: BLE001 — surface as 503
                    self._reply(
                        503, f"unhealthy: {exc}\n".encode(), "text/plain"
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-server",
            daemon=True,
        )
        self._thread.start()

    def _check_health(self) -> None:
        if self._source is not None:
            self._source.metrics()  # raises if the engine is wedged

    def _stats_payload(self) -> dict:
        payload: dict = {}
        if self._source is not None:
            payload["metrics"] = _jsonable(self._source.metrics())
            stats_fn = getattr(self._source, "stats", None)
            if callable(stats_fn):
                payload["collections"] = _jsonable(stats_fn())
        return payload

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0``)."""
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
