"""HTTP introspection server: /metrics, /healthz, /readyz, /debug/labels,
POST /probe and the peer and fleet surfaces (twin:
``gpu_feature_discovery_tpu/obs/server.py``).

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
- ``/debug/spans`` (the port's own): the span ring of this process
  (``obs/spans.py``) as Chrome trace-event JSON, on torch.profiler's
  clock (``?base_ns=`` subtracts a profiler export's
  ``baseTimeNanoseconds``); gated by ``--debug-endpoints``.
- ``POST /probe``: an on-demand reconcile wake (``--reconcile=event``),
  authenticated by ``--probe-token`` (``X-TFD-Probe-Token`` or
  ``Authorization: Bearer``, compared with ``hmac.compare_digest``):
  202 and a ``probe_request`` event; 404 without an event loop, 403
  without a configured token, 401 on a missing or wrong one.
- ``GET /peer/snapshot``: the slice peer layer's wire surface
  (peering/snapshot.py), the coordinator's body serialized at PUBLISH
  time with its strong ``ETag``; a matching ``If-None-Match`` answers
  ``304`` with no body. Served only while slice coordination built a
  coordinator (independent of ``--debug-endpoints``: peers depend on
  it), 404 otherwise. With ``--peer-token`` set it requires the secret
  through the same transport and ``hmac.compare_digest`` as ``POST
  /probe``: missing 403, wrong 401. A poll's ``X-TFD-Poll-Tier`` header
  names its coordination plane (the tier fault sites read it), and its
  ``X-TFD-Notify-Port``/``X-TFD-Notify-Name`` headers subscribe the
  poller to push notifications.
- ``POST /peer/notify``: a child's push-on-delta hint
  (peering/notify.py): 404 without a notify hook (push off), 403
  without a configured ``--peer-token``, 401 on a mismatch, 400 on an
  unparseable body, 404 for a name outside the peer set, 202 accepted.
- ``GET /fleet/snapshot``: the fleet collector's inventory
  (fleet/inventory.py), served only by the ``fleet-collector`` mode
  (cmd/fleet.py; 404 on a node daemon) with the same publish-time body,
  ETag, 304 and ``--peer-token`` gate as ``/peer/snapshot``. A request
  without a query string is the unfiltered pane; any query string goes
  to the collector's query surface (fleet/query.py): filters, the
  ``?since=`` delta, ``?watch=`` long-poll parking (HEAD never parks),
  400 on anything outside the grammar, 503 + Retry-After past
  ``--max-watchers``.

``HEAD`` answers every GET endpoint with the same status and headers
(Content-Length states the GET body's size) and no body. A handler that
raises answers 500 naming the error class and counts
``tfd_http_errors_total{endpoint}``, whose label is clamped to the known
endpoints.

``--max-inflight-requests`` (the collector's flag; a node daemon passes
0) bounds concurrent handler work: past the cap a request is answered
503 + Retry-After at once (``tfd_http_rejected_total``;
``tfd_http_inflight`` gauges the moment). A parked fleet watcher
releases its slot, so watchers are bounded by ``--max-watchers`` alone.

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
from urllib.parse import parse_qs, urlsplit

from gpu_feature_discovery_tpu_torch.obs import metrics, spans
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

# How long a fault-armed /peer/snapshot (peer.slow) or /peer/notify
# (notify.slow) handler stalls: past the default --peer-timeout (2 s) and
# the notify sender's timeout, so the caller counts a miss first.
PEER_SLOW_DELAY_S = 5.0

# Header names restated from peering/ (obs does not import peering; a
# test pins the spellings equal): the poller's coordination plane, and a
# parent's notify subscription.
_POLL_TIER_HEADER = "X-TFD-Poll-Tier"
_NOTIFY_PORT_HEADER = "X-TFD-Notify-Port"
_NOTIFY_NAME_HEADER = "X-TFD-Notify-Name"


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


# What a 503 at the --max-inflight-requests gate tells the client to wait:
# slots turn over in milliseconds on a healthy server.
_INFLIGHT_RETRY_AFTER_S = 1


class _InflightGate:
    """The --max-inflight-requests admission gate: a counted semaphore
    that rejects instead of queueing (the handler thread exists already;
    the gate bounds concurrent work). ``limit`` 0 = unlimited: the gauge
    still tracks, nothing is shed."""

    def __init__(self, limit: int):
        self.limit = max(0, int(limit))
        self._lock = threading.Lock()
        self._count = 0

    def enter(self) -> bool:
        with self._lock:
            if self.limit and self._count >= self.limit:
                metrics.HTTP_REJECTED.inc()
                return False
            self._count += 1
            metrics.HTTP_INFLIGHT.set(self._count)
            return True

    def leave(self) -> None:
        with self._lock:
            self._count = max(0, self._count - 1)
            metrics.HTTP_INFLIGHT.set(self._count)


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
    peer_snapshot: Optional[Callable[[], "tuple[bytes, str]"]] = None,
    peer_fault: Optional[Callable[[str], bool]] = None,
    peer_token: str = "",
    peer_notify: Optional[Callable[[str, int, str], bool]] = None,
    notify_subscribe: Optional[Callable[[str, int, str], None]] = None,
    fleet_snapshot: Optional[Callable[[], "tuple[bytes, str]"]] = None,
    fleet_query: Optional[Callable[..., "tuple"]] = None,
    inflight: Optional[_InflightGate] = None,
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
            if not self._enter_inflight():
                return
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
            finally:
                self._release_inflight()

        def _enter_inflight(self) -> bool:
            """Take one --max-inflight-requests slot, or answer the 503
            shed; True = proceed. The release latch is reset per request:
            a handler instance serves every request of a keep-alive
            connection."""
            self._inflight_held = False
            if inflight is None:
                return True
            if not inflight.enter():
                self._reply(503, b"server busy: inflight request cap reached\n",
                            retry_after=_INFLIGHT_RETRY_AFTER_S)
                return False
            self._inflight_held = True
            return True

        def _release_inflight(self) -> None:
            """Release the slot exactly once: at the request's end, or
            earlier through the fleet watch hook when a watcher parks."""
            if getattr(self, "_inflight_held", False):
                self._inflight_held = False
                inflight.leave()

        def _reply_snapshot(self, body: bytes, etag: Optional[str], counter) -> None:
            """A publish-time body and its strong ETag, or a 304 on a
            matching If-None-Match counted in the surface's own series."""
            if etag and self.headers.get("If-None-Match") == etag:
                counter.inc()
                self._reply(304, b"", "application/json", etag=etag)
            else:
                self._reply(200, body, "application/json", etag=etag)

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
            elif path == "/debug/spans" and debug_endpoints:
                # ?base_ns= takes a profiler export's baseTimeNanoseconds,
                # so the two files' ts share an origin.
                query = parse_qs(urlsplit(self.path).query)
                try:
                    base_ns = int(query.get("base_ns", ["0"])[-1])
                except ValueError:
                    self._reply(400, b"base_ns: want an integer (ns)\n")
                    return
                body = json.dumps(spans.chrome_trace(base_ns))
                self._reply(200, body.encode() + b"\n", "application/json")
            elif path == "/peer/snapshot" and peer_snapshot is not None:
                if not self._peer_auth_ok():
                    return
                self._observe_notify_subscription()
                if self._peer_fault():
                    return
                # The body and ETag were rendered at publish time; this
                # handler serializes nothing.
                self._reply_snapshot(
                    *peer_snapshot(), counter=metrics.PEER_SNAPSHOT_NOT_MODIFIED
                )
            elif path == "/fleet/snapshot" and fleet_snapshot is not None:
                if not self._peer_auth_ok():
                    return
                self._observe_notify_subscription()
                raw_query = urlsplit(self.path).query
                if raw_query and fleet_query is not None:
                    # The query surface owns parsing, the view economy,
                    # delta-vs-resync and parking; HEAD never parks.
                    status, body, etag, retry_after, filtered = fleet_query(
                        raw_query,
                        self.headers.get("If-None-Match"),
                        self.command != "HEAD",
                        self._release_inflight,
                    )
                    if status == 200:
                        self._reply_snapshot(
                            body,
                            etag,
                            counter=(
                                metrics.FLEET_FILTERED_NOT_MODIFIED
                                if filtered
                                else metrics.FLEET_INVENTORY_NOT_MODIFIED
                            ),
                        )
                    else:
                        self._reply(status, body, retry_after=retry_after)
                else:
                    self._reply_snapshot(
                        *fleet_snapshot(), counter=metrics.FLEET_INVENTORY_NOT_MODIFIED
                    )
            else:
                self._reply(404, b"not found\n")

        def _peer_auth_ok(self) -> bool:
            """The --peer-token gate: True lets the request through (no
            token configured keeps the surface open); False means a 403
            (missing) or 401 (wrong) was sent."""
            if not peer_token:
                return True
            provided = self._provided_token()
            if not provided:
                self._reply(403, b"peer token required: set --peer-token\n")
                return False
            if not hmac.compare_digest(provided.encode(), peer_token.encode()):
                self._reply(401, b"unauthorized\n")
                return False
            return True

        def _observe_notify_subscription(self) -> None:
            """Record an authenticated poller's notify subscription: the
            poll connection's source address (never a client-asserted
            host), the advertised port and the name it knows us by."""
            if notify_subscribe is None:
                return
            name = self.headers.get(_NOTIFY_NAME_HEADER, "")
            raw_port = self.headers.get(_NOTIFY_PORT_HEADER, "")
            if not name or not raw_port:
                return
            try:
                port = int(raw_port)
            except ValueError:
                return
            notify_subscribe(self.client_address[0], port, name)

        def _peer_fault(self) -> bool:
            """Enact an armed peer.* fault (utils/faults.py) on the serving
            side; True when the normal reply must be skipped."""
            from gpu_feature_discovery_tpu_torch.utils import faults

            if faults.consume("peer.unreachable"):
                # No response at all: the poller sees what a dead host's
                # RST gives it.
                self.close_connection = True
                return True
            if faults.consume("peer.junk"):
                self._reply(200, b"not json {", "application/json")
                return True
            if faults.consume("peer.slow"):
                time.sleep(PEER_SLOW_DELAY_S)
            if peer_fault is not None:
                # The two-tier sites need the request's plane and this
                # daemon's role, so their gate is the coordinator's
                # (SliceCoordinator.serving_fault); the dropped connection
                # is enacted here.
                if peer_fault(self.headers.get(_POLL_TIER_HEADER, "")):
                    self.close_connection = True
                    return True
            return False

        def _dispatch_post(self, path: str) -> None:
            if path == "/peer/notify":
                self._handle_notify()
                return
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

        def _handle_notify(self) -> None:
            """POST /peer/notify: mark the named child dirty. The token
            gate is POST /probe's: a notification wakes the poll loop, so
            the endpoint never works unauthenticated, and a failed check
            returns before the hook runs."""
            body = self._read_body()
            if peer_notify is None:
                metrics.NOTIFY_RECEIVED.labels(outcome="disabled").inc()
                self._reply(404, b"not found\n")
                return
            if not peer_token:
                metrics.NOTIFY_RECEIVED.labels(outcome="unauthorized").inc()
                self._reply(403, b"notify endpoint disabled: --peer-token not set\n")
                return
            if not hmac.compare_digest(
                self._provided_token().encode(), peer_token.encode()
            ):
                metrics.NOTIFY_RECEIVED.labels(outcome="unauthorized").inc()
                self._reply(401, b"unauthorized\n")
                return
            from gpu_feature_discovery_tpu_torch.utils import faults

            if faults.consume("notify.slow"):
                time.sleep(PEER_SLOW_DELAY_S)
            if faults.consume("notify.reject"):
                metrics.NOTIFY_RECEIVED.labels(outcome="rejected").inc()
                self._reply(503, b"notify rejected\n")
                return
            try:
                doc = json.loads(body.decode("utf-8"))
                name = str(doc["name"])
                generation = int(doc.get("generation", 0))
                etag = str(doc.get("etag", ""))
            except (ValueError, KeyError, TypeError, AttributeError, OverflowError,
                    RecursionError):
                # Anything but an object with a name and an integral
                # generation is the sender's error (the twin answers a
                # 500 for the JSON that is not such an object).
                metrics.NOTIFY_RECEIVED.labels(outcome="invalid").inc()
                self._reply(400, b"invalid notify body\n")
                return
            if not peer_notify(name, generation, etag):
                metrics.NOTIFY_RECEIVED.labels(outcome="unknown").inc()
                self._reply(404, b"unknown child\n")
                return
            metrics.NOTIFY_RECEIVED.labels(outcome="ok").inc()
            self._reply(202, b"notify accepted\n")

        def _read_body(self) -> bytes:
            """Consume and return the request body so keep-alive framing
            survives; an oversized body closes the connection instead."""
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                length = 0
            if length > _MAX_PROBE_BODY:
                self.close_connection = True
                length = 0
            return self.rfile.read(length) if length else b""

        def _drain_body(self) -> None:
            self._read_body()

        def _provided_token(self) -> str:
            provided = self.headers.get("X-TFD-Probe-Token", "")
            auth = self.headers.get("Authorization", "")
            if not provided and auth.startswith("Bearer "):
                provided = auth[len("Bearer "):]
            return provided

        def _reply(
            self, code: int, body: bytes, ctype: str = "text/plain",
            etag: Optional[str] = None, retry_after: Optional[int] = None,
        ) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if etag:
                self.send_header("ETag", etag)
            if retry_after is not None:
                self.send_header("Retry-After", str(int(retry_after)))
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
        peer_snapshot: Optional[Callable[[], "tuple[bytes, str]"]] = None,
        peer_fault: Optional[Callable[[str], bool]] = None,
        peer_token: str = "",
        peer_notify: Optional[Callable[[str, int, str], bool]] = None,
        notify_subscribe: Optional[Callable[[str, int, str], None]] = None,
        fleet_snapshot: Optional[Callable[[], "tuple[bytes, str]"]] = None,
        fleet_query: Optional[Callable[..., "tuple"]] = None,
        max_inflight: int = 0,
    ):
        self._httpd = _TrackingHTTPServer(
            (addr, port),
            _make_handler(
                registry,
                state,
                debug_endpoints,
                probe_request=probe_request,
                probe_token=probe_token,
                peer_snapshot=peer_snapshot,
                peer_fault=peer_fault,
                peer_token=peer_token,
                peer_notify=peer_notify,
                notify_subscribe=notify_subscribe,
                fleet_snapshot=fleet_snapshot,
                fleet_query=fleet_query,
                inflight=_InflightGate(max_inflight),
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
