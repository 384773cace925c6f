"""Network frontend: the service fleet's stdlib HTTP surface.

Port of ``repro.serve.http`` (standard library only, as there).

:class:`HttpFrontend` puts a ``ThreadingHTTPServer`` on a daemon thread
in front of a :class:`~repro_torch.serve.service.VectorService`:

  * ``POST /search``       — one query or a batch against a collection;
  * ``POST /insert``       — write vectors into a mutable collection;
  * ``POST /delete``       — remove ids from a mutable collection;
  * ``GET  /collections``  — the registry: names, dims, default k;
  * ``GET  /metrics`` / ``/healthz`` / ``/stats`` — the observability
    surface (``repro_torch.obs``), mounted on the SAME port so one scrape
    target covers API and engine.

Admission control happens before any engine work:

  * **bounded in-flight queue** — at most ``max_inflight`` requests may
    hold engine work concurrently; excess requests are shed immediately
    with **503** (no queueing behind a stampede);
  * **per-collection token buckets** — sustained rate + burst per
    collection; an empty bucket sheds with **429** and ``Retry-After``;
  * **per-request deadlines** — ``deadline_ms`` (or the server default)
    rides through ``BatchingEngine.submit``; a request whose deadline
    passes while queued completes with **504** and counts as an engine
    ``shed``.

Rejections are cheap by design: a 429/503 touches no lock shared with
dispatch. Every decision is visible in the exposition —
``pageann_http_requests_total{route=,code=}`` and
``pageann_http_rejected_total{reason=}`` ride the same registry as the
engine series. No third-party dependencies.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.obs.server import PROMETHEUS_CONTENT_TYPE, _jsonable

MAX_BODY_BYTES = 64 * 1024 * 1024


class TokenBucket:
    """Sustained ``rate``/s with ``burst`` capacity; thread-safe."""

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic):
        if not rate > 0 or not burst > 0:
            raise ValueError("rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will have accrued (>= 0)."""
        with self._lock:
            return max(0.0, (n - self._tokens) / self.rate)


class _RequestError(Exception):
    def __init__(self, code: int, message: str, *, reason: str | None = None,
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.reason = reason          # rejected-counter label, None = no shed
        self.retry_after_s = retry_after_s


class HttpFrontend:
    """Serve ``service`` over HTTP with admission control + QoS.

    ``rate_limits`` maps collection name -> ``(rate_per_s, burst)``; a
    collection without an entry is not rate limited.  ``registry`` is an
    ``obs.MetricsRegistry`` already carrying the engine series (e.g. from
    ``serve_registry(service)``); the frontend adds its own http series
    to it, so ``/metrics`` exposes both.  Bind ``port=0`` for an
    ephemeral port (``.port``/``.url`` report it).
    """

    def __init__(
        self,
        service,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_inflight: int = 64,
        default_deadline_ms: float | None = None,
        rate_limits: dict | None = None,
        registry=None,
        clock=time.monotonic,
    ):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self._service = service
        self._default_deadline_ms = default_deadline_ms
        self._inflight = threading.Semaphore(max_inflight)
        self._buckets = {
            name: TokenBucket(rate, burst, clock)
            for name, (rate, burst) in (rate_limits or {}).items()
        }
        if registry is None:
            from repro_torch.obs import serve_registry

            registry = serve_registry(service)
        self._registry = registry
        self._requests_total = registry.counter(
            "pageann_http_requests_total",
            "HTTP requests by route and status code",
        )
        self._rejected_total = registry.counter(
            "pageann_http_rejected_total",
            "HTTP requests shed by admission control, by reason",
        )

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, body: bytes, ctype: str,
                       headers: dict | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, doc: dict,
                            headers: dict | None = None) -> None:
                self._reply(code, json.dumps(doc).encode(),
                            "application/json", headers)

            def _route(self) -> str:
                return self.path.split("?", 1)[0]

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_BODY_BYTES:
                    raise _RequestError(413, "request body too large")
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    doc = json.loads(raw or b"{}")
                except json.JSONDecodeError as e:
                    raise _RequestError(400, f"invalid JSON body: {e}")
                if not isinstance(doc, dict):
                    raise _RequestError(400, "body must be a JSON object")
                return doc

            def _dispatch(self, fn) -> None:
                route = self._route()
                try:
                    code, doc, headers = fn(route)
                except _RequestError as e:
                    if e.reason is not None:
                        frontend._rejected_total.inc(
                            labels={"reason": e.reason}
                        )
                    headers = {}
                    if e.retry_after_s is not None:
                        headers["Retry-After"] = (
                            f"{max(1, int(np.ceil(e.retry_after_s)))}"
                        )
                    code, doc = e.code, {"error": e.message}
                except Exception as e:  # noqa: BLE001 — surface, don't die
                    code, doc, headers = 500, {"error": repr(e)}, {}
                frontend._requests_total.inc(
                    labels={"route": route, "code": str(code)}
                )
                self._reply_json(code, doc, headers)

            def do_GET(self):
                route = self._route()
                try:
                    if route == "/metrics":
                        body = frontend._registry.render().encode()
                        self._reply(200, body, PROMETHEUS_CONTENT_TYPE)
                        return
                    if route == "/healthz":
                        frontend._service.metrics()
                        self._reply(200, b"ok\n", "text/plain")
                        return
                    if route == "/stats":
                        payload = {
                            "metrics": _jsonable(frontend._service.metrics()),
                            "collections": _jsonable(
                                frontend._service.stats()
                            ),
                        }
                        self._reply_json(200, payload)
                        return
                except Exception as exc:  # noqa: BLE001
                    self._reply(503, f"unhealthy: {exc}\n".encode(),
                                "text/plain")
                    return
                if route == "/collections":
                    self._dispatch(frontend._handle_collections)
                else:
                    self._reply_json(404, {"error": f"no route {route}"})

            def do_POST(self):
                route = self._route()
                handlers = {
                    "/search": frontend._handle_search,
                    "/insert": frontend._handle_insert,
                    "/delete": frontend._handle_delete,
                }
                fn = handlers.get(route)
                if fn is None:
                    self._reply_json(404, {"error": f"no route {route}"})
                    return
                self._dispatch(lambda _route: fn(self._body()))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="pageann-http-frontend",
            daemon=True,
        )
        self._thread.start()

    # -------------------------------------------------------- admission
    def _admit(self, collection: str):
        """503 when the in-flight cap is hit, 429 when the collection's
        token bucket is dry. Returns a release callable on success."""
        if not self._inflight.acquire(blocking=False):
            raise _RequestError(
                503, "overloaded: in-flight request cap reached",
                reason="inflight", retry_after_s=0.05,
            )
        bucket = self._buckets.get(collection)
        if bucket is not None and not bucket.try_acquire():
            self._inflight.release()
            raise _RequestError(
                429, f"rate limit exceeded for collection {collection!r}",
                reason="ratelimit",
                retry_after_s=bucket.retry_after_s(),
            )
        return self._inflight.release

    @staticmethod
    def _collection_of(doc: dict) -> str:
        name = doc.get("collection")
        if not isinstance(name, str) or not name:
            raise _RequestError(400, "missing 'collection'")
        return name

    # --------------------------------------------------------- handlers
    def _handle_collections(self, _route: str):
        svc = self._service
        out = []
        for name in sorted(svc.list_collections()):
            try:
                idx = svc.index_of(name)
                out.append({"name": name, "dim": int(idx.dim)})
            except KeyError:
                continue  # dropped between list and lookup
        return 200, {"collections": out}, {}

    def _handle_search(self, doc: dict):
        name = self._collection_of(doc)
        if "queries" in doc:
            queries = doc["queries"]
            single = False
        elif "query" in doc:
            queries = [doc["query"]]
            single = True
        else:
            raise _RequestError(400, "missing 'query' or 'queries'")
        try:
            q = np.asarray(queries, np.float32)
        except (TypeError, ValueError) as e:
            raise _RequestError(400, f"bad query payload: {e}")
        if q.ndim != 2 or q.shape[0] == 0:
            raise _RequestError(
                400, f"queries must be a non-empty (Q, d) matrix, "
                     f"got shape {q.shape}"
            )
        k = doc.get("k")
        deadline_ms = doc.get("deadline_ms", self._default_deadline_ms)
        release = self._admit(name)
        try:
            t0 = time.perf_counter()
            try:
                futs = [
                    self._service.submit(
                        name, row, k=k, deadline_ms=deadline_ms
                    )
                    for row in q
                ]
                self._service.flush(name)
            except KeyError:
                raise _RequestError(404, f"no collection {name!r}")
            except ValueError as e:
                raise _RequestError(400, str(e))
            results = []
            shed = 0
            for fut in futs:
                try:
                    rr = fut.result()
                except TimeoutError:
                    shed += 1
                    results.append(None)
                    continue
                res = rr.result
                ids = np.asarray(res.ids)
                dists = np.asarray(res.dists)
                results.append({
                    "ids": ids.reshape(-1).tolist(),
                    "dists": dists.reshape(-1).tolist(),
                    "cached": bool(rr.cached),
                })
            if shed == len(futs):
                # the whole request expired in queue: one 504, engine
                # sheds already counted per request
                raise _RequestError(
                    504, "deadline passed while queued", reason="deadline",
                )
            wall_ms = (time.perf_counter() - t0) * 1e3
            doc_out = {
                "results": results if not single else results[0],
                "shed": shed,
                "wall_ms": wall_ms,
            }
            return 200, doc_out, {}
        finally:
            release()

    def _handle_insert(self, doc: dict):
        name = self._collection_of(doc)
        vectors = doc.get("vectors")
        if vectors is None:
            raise _RequestError(400, "missing 'vectors'")
        try:
            v = np.asarray(vectors, np.float32)
        except (TypeError, ValueError) as e:
            raise _RequestError(400, f"bad vectors payload: {e}")
        release = self._admit(name)
        try:
            try:
                ids = self._service.insert(
                    name, v, doc.get("ids"), metadata=doc.get("metadata")
                )
            except KeyError:
                raise _RequestError(404, f"no collection {name!r}")
            except (RuntimeError, ValueError) as e:
                raise _RequestError(400, str(e))
            return 200, {"ids": np.asarray(ids).tolist()}, {}
        finally:
            release()

    def _handle_delete(self, doc: dict):
        name = self._collection_of(doc)
        ids = doc.get("ids")
        if ids is None:
            raise _RequestError(400, "missing 'ids'")
        release = self._admit(name)
        try:
            try:
                removed = self._service.delete(name, np.asarray(ids))
            except KeyError:
                raise _RequestError(404, f"no collection {name!r}")
            except (RuntimeError, ValueError) as e:
                raise _RequestError(400, str(e))
            return 200, {"removed": int(removed)}, {}
        finally:
            release()

    # ---------------------------------------------------------- plumbing
    @property
    def port(self) -> int:
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
