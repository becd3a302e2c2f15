"""Lockstep twin/port proxies for the fleet collector's parity suites
(tests/test_torch_fleet*.py, tests/test_torch_notify.py).

A ``Pair`` holds one object of the JAX package (the twin) and its
counterpart in the PyTorch port. Calling a method on it calls the twin's
and then the port's with the same arguments, and the two results must be
equal: bytes, strings, numbers, ``None``, and dicts, lists, tuples and
sets of them compare exactly; any other object comes back as a Pair, so
a chain like ``collector._slices["s0"].hosts[0].etag`` walks both sides
and compares at the leaf. An exception must be raised by both sides with
the same class name; the twin's is re-raised, so ``pytest.raises`` with
the twin's class works. So a scenario of the twin's tests reads as it
did, and every body, ETag, status and counter it touches is held equal
on the way.

What legitimately differs between the sides is mapped, never compared
loosely:

- servers: ``serve()`` starts a twin and a port server over a Pair of
  hooks; the port side of every argument naming the twin server's port
  (an int, or ``127.0.0.1:<port>`` in a string) is the port server's;
- state directories registered with ``side_dir`` get a ``-port`` sibling
  on the port side, so the two collectors never share a state file;
- label keys follow the port's one key rule, ``google.com/tpu.`` ->
  ``nvidia.com/gpu.``;
- metrics live in two registries: ``Metrics`` answers ``value()`` with a
  ``Num`` pair that compares and does arithmetic on both sides at once,
  so ``X.value() == before + 1`` holds the DELTA on each side.

Both collectors poll the same scripted peers (the twin's coordinators
and servers, or ``fleet_scale.MockFleet``) and read one clock:
``LOCKSTEP`` freezes the monotonic and the wall clock for the length of
each paired call, so both sides see the same instant.
"""

import contextlib
import dataclasses
import http.client
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import gpu_feature_discovery_tpu.cmd.events as twin_events
import gpu_feature_discovery_tpu.cmd.fleet as twin_cmd_fleet
import gpu_feature_discovery_tpu.config.spec as twin_spec
import gpu_feature_discovery_tpu.fleet as twin_fleet
import gpu_feature_discovery_tpu.fleet.collector as twin_collector
import gpu_feature_discovery_tpu.fleet.ha as twin_ha
import gpu_feature_discovery_tpu.fleet.inventory as twin_inventory
import gpu_feature_discovery_tpu.fleet.query as twin_query
import gpu_feature_discovery_tpu.fleet.targets as twin_targets
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.obs import server as twin_server
import gpu_feature_discovery_tpu_torch.cmd.events as port_events
import gpu_feature_discovery_tpu_torch.cmd.fleet as port_cmd_fleet
import gpu_feature_discovery_tpu_torch.config.spec as port_spec
import gpu_feature_discovery_tpu_torch.fleet as port_fleet
import gpu_feature_discovery_tpu_torch.fleet.collector as port_collector
import gpu_feature_discovery_tpu_torch.fleet.ha as port_ha
import gpu_feature_discovery_tpu_torch.fleet.inventory as port_inventory
import gpu_feature_discovery_tpu_torch.fleet.query as port_query
import gpu_feature_discovery_tpu_torch.fleet.targets as port_targets
from gpu_feature_discovery_tpu_torch.obs import metrics as port_metrics
from gpu_feature_discovery_tpu_torch.obs import server as port_server


class _Lockstep:
    """One clock for both sides: frozen while any paired call runs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._mono = 0.0
        self._wall = 0.0

    @contextlib.contextmanager
    def frozen(self):
        with self._lock:
            if self._depth == 0:
                self._mono, self._wall = time.monotonic(), time.time()
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1

    def monotonic(self):
        return self._mono if self._depth else time.monotonic()

    def time(self):
        return self._wall if self._depth else time.time()


LOCKSTEP = _Lockstep()

# twin server port -> port server port, for every paired server.
PORT_TWINS = {}
# state directories whose port side is "<dir>-port".
SIDE_DIRS = set()

_HOSTPORT = re.compile(r"(127\.0\.0\.1:)(\d+)")
_SCALARS = (bool, int, float, str, bytes, type(None))
# Twin value types the port side receives as its own type.
_TO_PORT_TYPE = {twin_targets.SliceTarget: port_targets.SliceTarget}
# Constructors that get the lockstep clocks unless the scenario passes its
# own.
_CLOCKED = {twin_collector.FleetCollector: ("clock", "wall_clock"),
            twin_ha.HaMonitor: ("clock",)}


def side_dir(path):
    """Register a state directory: each side keeps its own copy."""
    SIDE_DIRS.add(str(path))
    return str(path)


def port_side_path(path):
    for d in SIDE_DIRS:
        if path == d or path.startswith(d + "/"):
            return d + "-port" + path[len(d):]
    return path


def _port_str(value):
    # The one key rule of the port: google.com/tpu. -> nvidia.com/gpu.
    value = value.replace("google.com/tpu.", "nvidia.com/gpu.")
    value = _HOSTPORT.sub(
        lambda m: m.group(1) + str(PORT_TWINS.get(int(m.group(2)), m.group(2))), value
    )
    return port_side_path(value)


def side(value, i):
    """``value`` as side ``i`` (0 twin, 1 port) receives it."""
    if isinstance(value, Pair):
        return value._sides[i]
    if isinstance(value, Num):
        return value.pair[i]
    if i == 0:
        if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
            return type(value)(side(v, 0) for v in value)
        if isinstance(value, dict):
            return {k: side(v, 0) for k, v in value.items()}
        return value
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return PORT_TWINS.get(value, value)
    if isinstance(value, str):
        return _port_str(value)
    if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
        return type(value)(side(v, 1) for v in value)
    if isinstance(value, dict):
        return {side(k, 1): side(v, 1) for k, v in value.items()}
    port_type = _TO_PORT_TYPE.get(type(value))
    if port_type is not None:
        return port_type(**{f.name: side(getattr(value, f.name), 1)
                            for f in dataclasses.fields(value)})
    return value


def join(t, p, what="value"):
    """Equal results come back as the twin's; objects as a Pair."""
    if t is p:
        return t
    if isinstance(t, _SCALARS) or isinstance(p, _SCALARS):
        if type(t) is not type(p) or side(t, 1) != p:
            raise AssertionError(f"{what}: twin {t!r} != port {p!r}")
        return t
    if isinstance(t, dict) and isinstance(p, dict):
        if {side(k, 1) for k in t} != set(p):
            raise AssertionError(f"{what}: twin keys {sorted(t)} != port keys {sorted(p)}")
        return {k: join(t[k], p[side(k, 1)], f"{what}[{k!r}]") for k in t}
    if isinstance(t, (list, tuple)) and type(t) is type(p):
        if len(t) != len(p):
            raise AssertionError(f"{what}: twin {t!r} != port {p!r}")
        return type(t)(join(a, b, f"{what}[{n}]") for n, (a, b) in enumerate(zip(t, p)))
    if isinstance(t, (set, frozenset)) and isinstance(p, (set, frozenset)):
        if {side(v, 1) for v in t} != set(p):
            raise AssertionError(f"{what}: twin {t!r} != port {p!r}")
        return t
    if type(t).__name__ != type(p).__name__:
        raise AssertionError(f"{what}: twin {type(t).__name__} != port {type(p).__name__}")
    return Pair(t, p)


def _run(fn, args, kwargs):
    try:
        return fn(*args, **kwargs), None
    except Exception as e:  # noqa: BLE001 - compared across the sides
        return None, e


def call_both(t, p, args, kwargs):
    """Call the twin's and the port's callable with each side's view of
    the arguments; equal results, or the same exception on both."""
    for name in _CLOCKED.get(t, ()):
        kwargs.setdefault(name, LOCKSTEP.monotonic if name == "clock" else LOCKSTEP.time)
    a0, k0 = side(args, 0), side(kwargs, 0)
    a1, k1 = side(args, 1), side(kwargs, 1)
    with LOCKSTEP.frozen():
        if "on_park" in kwargs:
            # A watch parks until its view moves: both sides park at
            # once, and the caller hears of it when both have.
            latch = _Latch(2, kwargs["on_park"])
            k0["on_park"] = k1["on_park"] = latch.hit
            out = [None, None]

            def run(i, fn, a, k):
                out[i] = _run(fn, a, k)

            threads = [threading.Thread(target=run, args=(0, t, a0, k0), daemon=True),
                       threading.Thread(target=run, args=(1, p, a1, k1), daemon=True)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            (rt, et), (rp, ep) = out
        else:
            rt, et = _run(t, a0, k0)
            rp, ep = _run(p, a1, k1)
    name = getattr(t, "__qualname__", type(t).__name__)
    if et is not None or ep is not None:
        if et is None or ep is None or type(et).__name__ != type(ep).__name__:
            raise AssertionError(f"{name}: twin raised {et!r}, port raised {ep!r}")
        raise et
    return join(rt, rp, name)


class _Latch:
    def __init__(self, n, fn):
        self._n = n
        self._fn = fn
        self._lock = threading.Lock()

    def hit(self):
        with self._lock:
            self._n -= 1
            fire = self._n == 0
        if fire:
            self._fn()


class Pair:
    """A twin object and its port counterpart, driven in lockstep."""

    __slots__ = ("_sides",)

    def __init__(self, twin, port):
        object.__setattr__(self, "_sides", (twin, port))

    @property
    def twin(self):
        return self._sides[0]

    def __getattr__(self, name):
        t, p = self._sides
        return join(getattr(t, name), getattr(p, name), name)

    def __setattr__(self, name, value):
        setattr(self._sides[0], name, side(value, 0))
        setattr(self._sides[1], name, side(value, 1))

    def __call__(self, *args, **kwargs):
        return call_both(self._sides[0], self._sides[1], args, kwargs)

    def __getitem__(self, key):
        t, p = self._sides
        return join(t[side(key, 0)], p[side(key, 1)], f"[{key!r}]")

    def __len__(self):
        return join(len(self._sides[0]), len(self._sides[1]), "len")

    def __eq__(self, other):
        return (self._sides[0] == side(other, 0)) and (self._sides[1] == side(other, 1))

    def __ne__(self, other):
        return not self == other

    __hash__ = object.__hash__

    def __repr__(self):
        return f"Pair({self._sides[0]!r}, {self._sides[1]!r})"


class Num:
    """A metric value on each side: compares and computes on both."""

    __hash__ = None

    def __init__(self, twin, port):
        self.pair = (twin, port)

    def _apply(self, other, op):
        o = other.pair if isinstance(other, Num) else (other, other)
        return op(self.pair[0], o[0]), op(self.pair[1], o[1])

    def _num(self, other, op):
        return Num(*self._apply(other, op))

    def __add__(self, o):
        return self._num(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._num(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._num(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._num(o, lambda a, b: b - a)

    def __truediv__(self, o):
        return self._num(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._num(o, lambda a, b: b / a)

    def __eq__(self, o):
        return all(self._apply(o, lambda a, b: a == b))

    def __ne__(self, o):
        return not self == o

    def __lt__(self, o):
        return all(self._apply(o, lambda a, b: a < b))

    def __le__(self, o):
        return all(self._apply(o, lambda a, b: a <= b))

    def __gt__(self, o):
        return all(self._apply(o, lambda a, b: a > b))

    def __ge__(self, o):
        return all(self._apply(o, lambda a, b: a >= b))

    def __repr__(self):
        return f"Num(twin={self.pair[0]!r}, port={self.pair[1]!r})"


class _Metric:
    def __init__(self, twin, port):
        self._t, self._p = twin, port

    def labels(self, **kw):
        return _Metric(self._t.labels(**kw), self._p.labels(**kw))

    def value(self, *args, **kw):
        return Num(self._t.value(*args, **kw), self._p.value(*args, **kw))


class Metrics:
    """``obs.metrics`` of both packages: families answer Num values."""

    def __getattr__(self, name):
        t, p = getattr(twin_metrics, name), getattr(port_metrics, name)
        if name == "REGISTRY":
            return Pair(t, p)
        if hasattr(t, "value"):
            return _Metric(t, p)
        return join(t, p, name)


obs_metrics = Metrics()
fleet = Pair(twin_fleet, port_fleet)
collector = Pair(twin_collector, port_collector)
inventory = Pair(twin_inventory, port_inventory)
query = Pair(twin_query, port_query)
ha = Pair(twin_ha, port_ha)
obs_server = Pair(twin_server, port_server)
cmd_fleet = Pair(twin_cmd_fleet, port_cmd_fleet)
spec = Pair(twin_spec, port_spec)
events = Pair(twin_events, port_events)

# The paired hooks an introspection server may take.
_HOOKS = ("fleet_snapshot", "fleet_query", "peer_snapshot", "peer_notify",
          "notify_subscribe", "probe_request", "peer_fault")


def IntrospectionServer(registry, state, **kwargs):  # noqa: N802 - the twin's name
    """A twin server alone (serving the shared scripted peers), or, when
    a hook is a Pair, a twin and a port server as a Pair whose ports map
    onto each other."""
    if not any(isinstance(kwargs.get(h), Pair) for h in _HOOKS):
        return twin_server.IntrospectionServer(side(registry, 0), side(state, 0),
                                               **side(kwargs, 0))
    t = twin_server.IntrospectionServer(side(registry, 0), side(state, 0), **side(kwargs, 0))
    try:
        p = port_server.IntrospectionServer(side(registry, 1), side(state, 1),
                                            **side(kwargs, 1))
    except BaseException:
        t.close()
        raise
    PORT_TWINS[t.port] = p.port
    return Pair(t, p)


def IntrospectionState(*args, **kwargs):  # noqa: N802 - the twin's name
    return Pair(twin_server.IntrospectionState(*args, **kwargs),
                port_server.IntrospectionState(*args, **kwargs))


def _both_concurrently(fn, twin_args, port_args):
    out = [None, None]

    def run(i, args):
        try:
            out[i] = (fn(*args), None)
        except Exception as e:  # noqa: BLE001 - compared below
            out[i] = (None, e)

    threads = [threading.Thread(target=run, args=(i, a), daemon=True)
               for i, a in enumerate((twin_args, port_args))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    (rt, et), (rp, ep) = out
    if et is not None or ep is not None:
        if et is None or ep is None or type(et).__name__ != type(ep).__name__:
            raise AssertionError(f"twin raised {et!r}, port raised {ep!r}")
        raise et
    return rt, rp


def _url_get(url, headers=None, method="GET"):
    req = urllib.request.Request(url, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_get(url, headers=None, method="GET"):
    """The twin tests' ``http_get``; against a paired server both servers
    answer, concurrently, and status and body must be equal."""
    port = urllib.parse.urlsplit(url).port
    if port not in PORT_TWINS:
        return _url_get(url, headers, method)
    rt, rp = _both_concurrently(_url_get, (url, headers, method),
                                (_port_str(url), headers, method))
    return join(rt, rp, f"GET {url}")


def paired_fleet_get(rig_fleet_get):
    """``fleet_scale.fleet_get`` over both servers of a pair: the same
    (status, body, etag) from each, fetched concurrently (a watch parks
    on both at once)."""

    def fleet_get(port, query="", etag=None, token="", timeout=30):
        if port not in PORT_TWINS:
            return rig_fleet_get(port, query, etag, token, timeout)
        rt, rp = _both_concurrently(rig_fleet_get, (port, query, etag, token, timeout),
                                    (PORT_TWINS[port], query, etag, token, timeout))
        return join(rt, rp, f"fleet_get {query!r}")

    return fleet_get


def http_both(port, fn):
    """``fn(port)`` against the twin server and then the port server of
    a pair: (twin result, port result)."""
    return fn(port), fn(PORT_TWINS[port])


def http_request(port, method, path, headers=None, timeout=5):
    """One request on a fresh connection: (status, headers dict, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()
