"""HTTP introspection server: /metrics, /healthz, /readyz, /debug/labels
and POST /probe (twin: ``gpu_feature_discovery_tpu/obs/server.py``).

A stdlib ``ThreadingHTTPServer`` on daemon threads, so a wedged scrape
never holds up the daemon's shutdown. Endpoints:

- ``/metrics``: the registry as text exposition 0.0.4.
- ``/healthz``: 200 while the loop is live, i.e. the last completed
  cycle (full, degraded or re-served: the heartbeat event) is within 3x
  ``--sleep-interval``; 503 once cycles stop completing. Degraded is
  healthy: the supervisor owns recovery.
- ``/readyz``: 200 once this epoch has written a label file; it stays
  ready while degraded.
- ``/debug/labels``: JSON of the last written labels with per-source
  provenance, write mode and generation; gated by ``--debug-endpoints``.
  It never carries the probe token.
- ``POST /probe``: an on-demand reconcile wake (``--reconcile=event``),
  authenticated by ``--probe-token`` (``X-TFD-Probe-Token`` or
  ``Authorization: Bearer``, compared with ``hmac.compare_digest``):
  202 and a ``probe_request`` event; 404 without an event loop, 403
  without a configured token, 401 on a missing or wrong one.

``HEAD`` answers every GET endpoint with the same status and headers
(Content-Length states the GET body's size) and no body. A handler that
raises answers 500 naming the error class and counts
``tfd_http_errors_total{endpoint}``, whose label is clamped to the known
endpoints. The twin's ``/peer/snapshot``, ``/peer/notify`` and
``/fleet/snapshot`` come with the peering and fleet modules of this port
and answer 404 here, as on a twin daemon without coordination; the
twin's ``--max-inflight-requests`` gate, which its node daemon does not
pass, is not ported.

cmd/main.run binds the server for daemon epochs only (oneshot never
serves; ``--metrics-port 0`` disables it) and closes it at epoch end,
so a SIGHUP reload rebinds the same port.
"""

from __future__ import annotations

import hmac
import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import urlsplit

from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.obs.registry import CONTENT_TYPE, Registry

log = logging.getLogger("tfd.obs")

# The loop is stale once no cycle completed for this many sleep
# intervals: one is the cadence, a second absorbs a slow cycle.
HEALTHZ_INTERVALS = 3.0

# The only values the tfd_http_errors_total{endpoint} label may take
# besides "other": the twin's endpoint set, so the label vocabulary is
# the same on both.
_KNOWN_ENDPOINTS = (
    "/metrics",
    "/healthz",
    "/readyz",
    "/debug/labels",
    "/peer/snapshot",
    "/fleet/snapshot",
    "/probe",
    "/peer/notify",
)

# Largest POST body the handler drains to keep a keep-alive connection
# parseable; anything bigger closes the connection instead.
_MAX_PROBE_BODY = 65536


class IntrospectionState:
    """What the daemon loop tells the endpoints. Written by the run loop
    (cycle completions, label writes), read by server threads; every
    access takes the lock."""

    def __init__(
        self,
        sleep_interval_s: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._sleep_interval = max(float(sleep_interval_s), 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._started = clock()
        self._last_cycle: Optional[float] = None
        self._cycles_completed = 0
        self._ready = False
        self._debug: Dict[str, Any] = {
            "generation": 0,
            "mode": None,
            "degraded": False,
            "labels": {},
            "sources": {},
        }

    def cycle_completed(self) -> None:
        """A cycle completed (full, degraded or re-served): the event
        that touches the heartbeat file feeds /healthz."""
        with self._lock:
            self._last_cycle = self._clock()
            self._cycles_completed += 1
        metrics.LAST_CYCLE_COMPLETED.set(time.time())

    def labels_written(
        self,
        labels: Dict[str, str],
        sources: Optional[Dict[str, Dict[str, Any]]] = None,
        mode: str = "full",
    ) -> None:
        """A label file landed this epoch: flips /readyz and refreshes
        /debug/labels. ``mode`` is full | degraded | reserved | restored;
        ``sources`` is the engine's per-source provenance."""
        with self._lock:
            self._ready = True
            self._debug = {
                "generation": self._debug["generation"] + 1,
                "mode": mode,
                "degraded": mode != "full",
                "labels": dict(labels),
                "sources": dict(sources or {}),
            }

    def healthy(self) -> "tuple[bool, str]":
        with self._lock:
            last = self._last_cycle if self._last_cycle is not None else self._started
            since = self._clock() - last
            threshold = HEALTHZ_INTERVALS * self._sleep_interval
            if self._sleep_interval and since > threshold:
                return False, (
                    f"no completed cycle for {since:.1f}s "
                    f"(threshold {threshold:.1f}s)"
                )
            return True, f"ok: {self._cycles_completed} cycles completed"

    def ready(self) -> "tuple[bool, str]":
        with self._lock:
            if self._ready:
                return True, "ok: label file written this epoch"
            return False, "no label file written yet this epoch"

    def debug_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return json.loads(json.dumps(self._debug))


def _endpoint_label(path: str) -> str:
    """Clamp a requested path to the known endpoints: a client minting
    unique paths must not mint unbounded series."""
    return path if path in _KNOWN_ENDPOINTS else "other"


def _make_handler(
    registry: Registry,
    state: IntrospectionState,
    debug_endpoints: bool,
    probe_request: Optional[Callable[[], None]] = None,
    probe_token: str = "",
):
    class _Handler(BaseHTTPRequestHandler):
        # Content-Length is always sent, so keep-alive is safe.
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            self._contained(self._dispatch)

        def do_HEAD(self):  # noqa: N802 - BaseHTTPRequestHandler API
            # The GET dispatch; _reply drops the body for HEAD.
            self.do_GET()

        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
            self._contained(self._dispatch_post)

        def _contained(self, dispatch: Callable[[str], None]) -> None:
            """Run one dispatch; a handler that raises answers 500 with
            the error class (the message may carry internals and stays
            in the log) instead of tearing the connection down."""
            path = urlsplit(self.path).path
            try:
                dispatch(path)
            except Exception as e:  # noqa: BLE001 - handler containment
                metrics.HTTP_ERRORS.labels(endpoint=_endpoint_label(path)).inc()
                log.warning("handler for %s %s raised:", self.command, path,
                            exc_info=True)
                try:
                    self._reply(500, f"{type(e).__name__}\n".encode())
                except OSError:
                    # The client hung up mid-reply.
                    self.close_connection = True

        def _dispatch(self, path: str) -> None:
            if path == "/metrics":
                self._reply(200, registry.render().encode(), CONTENT_TYPE)
            elif path == "/healthz":
                ok, detail = state.healthy()
                self._reply(200 if ok else 503, (detail + "\n").encode())
            elif path == "/readyz":
                ok, detail = state.ready()
                self._reply(200 if ok else 503, (detail + "\n").encode())
            elif path == "/debug/labels" and debug_endpoints:
                body = json.dumps(state.debug_snapshot(), indent=2, sort_keys=True)
                self._reply(200, body.encode() + b"\n", "application/json")
            else:
                self._reply(404, b"not found\n")

        def _dispatch_post(self, path: str) -> None:
            self._drain_body()
            if path != "/probe" or probe_request is None:
                # The hook exists only under --reconcile=event: without
                # an event loop there is nothing a probe request wakes.
                self._reply(404, b"not found\n")
                return
            if not probe_token:
                # The server listens on every interface: an
                # unauthenticated trigger would hand the node network a
                # probe-storm lever, so no token means the endpoint is off.
                self._reply(403, b"probe endpoint disabled: --probe-token not set\n")
                return
            if not hmac.compare_digest(
                self._provided_token().encode(), probe_token.encode()
            ):
                self._reply(401, b"unauthorized\n")
                return
            probe_request()
            # 202: queued; the loop debounces and rate-guards it like any
            # other wake, and the label file is the result.
            self._reply(202, b"probe scheduled\n")

        def _drain_body(self) -> None:
            """Consume the request body so keep-alive framing survives;
            an oversized body closes the connection instead."""
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length > _MAX_PROBE_BODY:
                self.close_connection = True
                return
            if length:
                self.rfile.read(length)

        def _provided_token(self) -> str:
            provided = self.headers.get("X-TFD-Probe-Token", "")
            auth = self.headers.get("Authorization", "")
            if not provided and auth.startswith("Bearer "):
                provided = auth[len("Bearer "):]
            return provided

        def _reply(self, code: int, body: bytes, ctype: str = "text/plain") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.command != "HEAD":
                self.wfile.write(body)

        def log_message(self, format, *args):  # noqa: A002 - stdlib name
            log.debug("introspection: %s", format % args)

    return _Handler


class _TrackingHTTPServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer that can sever its established connections.
    ``server_close`` closes only the listener, so a keep-alive client
    would go on being answered by a retired epoch's handler thread; the
    server tracks its client sockets and shuts them down on close."""

    def __init__(self, *args, **kwargs):
        self._clients: set = set()
        self._clients_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._clients_lock:
            self._clients.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._clients_lock:
            self._clients.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._clients_lock:
            clients = list(self._clients)
        for sock in clients:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closing; its handler thread reaps it


class IntrospectionServer:
    """The daemon-threaded HTTP server over a registry and a state.
    ``port`` 0 binds an ephemeral port (tests); the flag's 0 means
    "disabled" and is resolved by the caller before this is built."""

    def __init__(
        self,
        registry: Registry,
        state: IntrospectionState,
        addr: str = "0.0.0.0",
        port: int = 0,
        debug_endpoints: bool = True,
        probe_request: Optional[Callable[[], None]] = None,
        probe_token: str = "",
    ):
        self._httpd = _TrackingHTTPServer(
            (addr, port),
            _make_handler(
                registry,
                state,
                debug_endpoints,
                probe_request=probe_request,
                probe_token=probe_token,
            ),
        )
        self._httpd.daemon_threads = True
        self.addr = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="tfd-introspection",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        """Stop serving and release the port, synchronously, so a SIGHUP
        reload can rebind it at once; established connections are
        severed too."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd.close_all_connections()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
