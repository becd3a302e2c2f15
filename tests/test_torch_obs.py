"""The PyTorch port's observability plane (obs/) against its JAX twin, on
the CPU: the registry's exposition, the family set, the introspection
state and the server's answers.

- Exposition: the same seeded operations (counter incs, gauge sets,
  histogram observations on labelled children whose values hold ``\\``,
  ``"`` and newlines) through the twin's Registry and the port's render
  the same bytes, and both pass tests/promtool_lite.py. The float sums
  are the same additions in the same order, so no tolerance is needed.
- Families: every port family is the twin's (name, type, label names,
  buckets) and is named in the twin's docs/observability.md; no twin
  family is left out.
- State: one timeline on a fake clock gives the same healthy(),
  ready() and debug_snapshot() on both.
- Server: one request table against a twin and a port server over
  identical registries gives the same status codes, bodies and content
  types, the 500 containment and its error counter included.
"""

import http.client
import json
import socket
import string

import numpy as np
import pytest

from promtool_lite import validate_exposition

from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.obs import registry as twin_registry
from gpu_feature_discovery_tpu.obs import server as twin_server
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.obs import registry
from gpu_feature_discovery_tpu_torch.obs import server
from gpu_feature_discovery_tpu_torch.utils import timing

from pathlib import Path

DOCS = Path(__file__).resolve().parent.parent / "docs" / "observability.md"
TORCH_DOCS = Path(__file__).resolve().parent.parent / "docs" / "torch" / "observability.md"

# The port's own families, with no twin: the span tree (obs/spans.py) and
# the atomic writer's fsync count. Each is documented in the port's docs.
PORT_ONLY = {"tfd_span_duration_seconds", "tfd_probe_gap_seconds", "tfd_fsyncs_total"}

# Twin families whose layers the port does not have yet: none since the
# fleet collector and its --max-inflight-requests gate were ported.
LEFT_OUT: set = set()

# Label values a client or a device name could carry: the escapes of
# the exposition format, unicode, the empty string.
_VALUE_POOL = ["0", "1", "gpu", "a\\b", 'say "hi"', "two\nlines", "\\\"\n", "",
               "é✓", "x" * 40]


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

def _seeded_ops(seed, n_ops=300):
    """Family declarations and operations, all drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    decls = []
    for i in range(int(rng.integers(3, 7))):
        kind = ["counter", "gauge", "histogram"][int(rng.integers(0, 3))]
        n_labels = int(rng.integers(0, 3))
        labelnames = tuple(f"l{j}_{c}" for j, c in zip(
            range(n_labels), rng.choice(list(string.ascii_lowercase), n_labels)))
        help_text = f"family {i}: back\\slash, new\nline, \"quoted\""
        buckets = None
        if kind == "histogram" and rng.random() < 0.5:
            buckets = tuple(sorted({float(b) for b in
                                    np.round(rng.uniform(0, 10, 4), 3)}))
            if rng.random() < 0.5:
                buckets += (float("inf"),)
        decls.append((kind, f"t{seed}_{kind}_{i}", help_text, labelnames, buckets))
    ops = []
    for _ in range(n_ops):
        d = int(rng.integers(0, len(decls)))
        kind, _, _, labelnames, _ = decls[d]
        labels = {ln: _VALUE_POOL[int(rng.integers(0, len(_VALUE_POOL)))]
                  for ln in labelnames}
        if kind == "counter":
            amount = (float(rng.integers(0, 5)) if rng.random() < 0.5
                      else float(rng.exponential(2.0)))
            ops.append((d, "inc", amount, labels))
        elif kind == "gauge":
            if rng.random() < 0.3:
                ops.append((d, "inc", float(rng.normal()), labels))
            else:
                value = rng.choice([float(rng.normal(0, 1e3)), float(rng.integers(-9, 9)),
                                    2.0 ** 60, 0.0])
                ops.append((d, "set", float(value), labels))
        else:
            value = rng.choice([float(rng.exponential(1.0)), 0.0,
                                float(rng.uniform(0, 60)), 1e-7])
            ops.append((d, "observe", float(value), labels))
    return decls, ops


def _apply(reg_cls, decls, ops):
    reg = reg_cls()
    fams = []
    for kind, name, help_text, labelnames, buckets in decls:
        if kind == "histogram":
            fams.append(reg.histogram(name, help_text, labelnames, buckets=buckets))
        else:
            fams.append(getattr(reg, kind)(name, help_text, labelnames))
    for d, op, value, labels in ops:
        fam = fams[d]
        if op == "observe":
            fam.observe(value, **labels)
            continue
        target = fam.labels(**labels) if labels else fam
        getattr(target, op)(value)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_exposition_is_byte_identical_to_the_twins(seed):
    decls, ops = _seeded_ops(seed)
    twin = _apply(twin_registry.Registry, decls, ops).render()
    port = _apply(registry.Registry, decls, ops).render()
    assert port == twin
    assert validate_exposition(port) == validate_exposition(twin)
    assert port.count("\n") > 20


def test_registry_reset_and_naming_rules_match_the_twins():
    for reg_cls in (twin_registry.Registry, registry.Registry):
        reg = reg_cls()
        with pytest.raises(ValueError):
            reg.counter("0bad", "h")
        with pytest.raises(ValueError):
            reg.gauge("ok", "h", labelnames=("__reserved",))
        c = reg.counter("c_total", "h", labelnames=("k",))
        with pytest.raises(ValueError):
            reg.counter("c_total", "h")
        with pytest.raises(ValueError):
            c.labels(other="x")
        with pytest.raises(ValueError):
            c.labels(k="x").inc(-1)
        with pytest.raises(ValueError):
            reg.histogram("h_s", "h", buckets=(1.0, 0.5))
        c.labels(k="x").inc(3)
        reg.reset_values()
    assert twin_registry.DEFAULT_BUCKETS == registry.DEFAULT_BUCKETS
    assert twin_registry.CONTENT_TYPE == registry.CONTENT_TYPE
    assert registry.Registry().render() == twin_registry.Registry().render()


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

def _signature(fam):
    return (fam.kind, fam.labelnames, getattr(fam, "bounds", None))


def test_every_port_family_is_the_twins_and_is_documented():
    port = metrics.REGISTRY.families()
    twin = twin_metrics.REGISTRY.families()
    docs = DOCS.read_text()
    torch_docs = TORCH_DOCS.read_text()
    for name, fam in port.items():
        if name in PORT_ONLY:
            assert name not in twin, f"{name} is a twin family"
            assert f"`{name}`" in torch_docs, f"{name} is not in docs/torch/observability.md"
            continue
        assert name in twin, f"{name} is not a twin family"
        assert _signature(fam) == _signature(twin[name]), name
        assert f"`{name}`" in docs, f"{name} is not in docs/observability.md"
    assert set(port) >= PORT_ONLY
    assert len(port) == 90
    # The span families' buckets: 50 us doubling to about 30 s; the twin's
    # default buckets are untouched.
    for name in ("tfd_span_duration_seconds", "tfd_probe_gap_seconds"):
        bounds = port[name].bounds
        assert bounds[0] == 5e-05 and 20 <= bounds[-1] <= 30
        assert all(abs(b / a - 2) < 1e-9 for a, b in zip(bounds, bounds[1:]))
    assert registry.DEFAULT_BUCKETS == twin_registry.DEFAULT_BUCKETS


def test_the_families_left_out_are_pinned():
    """A family dropped from the port, or a twin family added, fails
    here until this list says where it lands."""
    port = set(metrics.REGISTRY.families())
    twin = set(twin_metrics.REGISTRY.families())
    assert twin - port == LEFT_OUT
    assert port - twin == PORT_ONLY


def test_the_wake_reasons_are_the_twins():
    """Every tfd_reconcile_wakes_total{reason} value of the twin exists in
    the port, peer_delta and peer_notify included."""
    from gpu_feature_discovery_tpu.cmd import events as twin_events
    from gpu_feature_discovery_tpu_torch.cmd import events

    def reasons(module):
        return {v for k, v in vars(module).items() if k.startswith("REASON_")}

    assert reasons(events) == reasons(twin_events)
    assert {"peer_delta", "peer_notify"} <= reasons(events)


def test_stage_store_feeds_the_summary_and_the_histograms():
    metrics.reset_for_tests()
    timing.reset_cycle()
    timing.record("labeler.device", 0.002)
    timing.record("labelgen.total", 0.005)
    timing.record("gpu.acquire", 1.5)
    assert timing.cycle_summary() == (
        "labelgen.total=5.000ms gpu.acquire=1500.000ms labeler.device=2.000ms")
    assert metrics.STAGE_DURATION.value(stage="gpu.acquire") == 1.5
    body = metrics.REGISTRY.render()
    assert 'tfd_labeler_duration_seconds_count{labeler="device"} 1' in body
    assert "tfd_cycle_duration_seconds_count 1" in body
    timing.reset_cycle()
    assert metrics.cycle_stages() == {}
    validate_exposition(body)


# ---------------------------------------------------------------------------
# IntrospectionState
# ---------------------------------------------------------------------------

def _timeline(seed, n=60):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n):
        r = rng.random()
        if r < 0.4:
            steps.append(("advance", float(rng.exponential(8.0))))
        elif r < 0.7:
            steps.append(("cycle", None))
        else:
            labels = {f"nvidia.com/gpu.k{int(i)}": _VALUE_POOL[int(i) % len(_VALUE_POOL)]
                      for i in rng.integers(0, 20, int(rng.integers(0, 5)))}
            sources = {"device": {"status": "fresh",
                                  "duration_ms": round(float(rng.random()), 3)}}
            mode = ["full", "degraded", "reserved", "restored"][int(rng.integers(0, 4))]
            steps.append(("write", (labels, sources, mode)))
    return steps


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("interval", [0.0, 10.0])
def test_state_answers_like_the_twins_on_one_timeline(seed, interval):
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731 - a fake clock
    twin = twin_server.IntrospectionState(interval, clock=clock)
    port = server.IntrospectionState(interval, clock=clock)
    for op, arg in _timeline(seed):
        if op == "advance":
            now[0] += arg
        elif op == "cycle":
            twin.cycle_completed()
            port.cycle_completed()
        else:
            twin.labels_written(*arg)
            port.labels_written(*arg)
        assert port.healthy() == twin.healthy()
        assert port.ready() == twin.ready()
        assert port.debug_snapshot() == twin.debug_snapshot()


# ---------------------------------------------------------------------------
# the server: one request table, both twins
# ---------------------------------------------------------------------------

GET_PATHS = ("/metrics", "/healthz", "/readyz", "/debug/labels", "/nope",
             "/peer/snapshot", "/fleet/snapshot", "/probe", "/metrics/extra", "/")
POSTS = (
    ("/probe", {}),
    ("/probe", {"X-TFD-Probe-Token": "wrong"}),
    ("/probe", {"Authorization": "Bearer wrong"}),
    ("/probe", {"X-TFD-Probe-Token": "sekrit"}),
    ("/probe", {"Authorization": "Bearer sekrit"}),
    ("/nope", {"X-TFD-Probe-Token": "sekrit"}),
    ("/metrics", {}),
    ("/peer/notify", {}),
)


def _request(port, method, path, headers=None, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Content-Type"),
                resp.getheader("Content-Length"), resp.read())
    finally:
        conn.close()


def _table(ports):
    rows = []
    for path in GET_PATHS:
        for method in ("GET", "HEAD"):
            rows.append(((method, path),
                         [_request(p, method, path) for p in ports]))
    for path, headers in POSTS:
        rows.append((("POST", path, tuple(headers.items())),
                     [_request(p, "POST", path, headers, body=b"{}") for p in ports]))
    return rows


@pytest.mark.parametrize("options", [
    {"debug_endpoints": True, "with_hook": True, "probe_token": "sekrit"},
    {"debug_endpoints": False, "with_hook": False, "probe_token": "sekrit"},
    {"debug_endpoints": True, "with_hook": True, "probe_token": ""},
    {"debug_endpoints": True, "with_hook": False, "probe_token": ""},
], ids=["hook+token", "no-debug-no-hook", "hook-no-token", "defaults"])
def test_request_table_answers_like_the_twins(options):
    decls, ops = _seeded_ops(11)
    fired = ([], [])
    kw = {"debug_endpoints": options["debug_endpoints"],
          "probe_token": options["probe_token"]}
    servers = []
    try:
        pair = []
        for side in (0, 1):
            hook = (lambda side=side: fired[side].append(1)) if options["with_hook"] else None
            pair.append(dict(kw, probe_request=hook))
        states = (twin_server.IntrospectionState(60.0), server.IntrospectionState(60.0))
        regs = (_apply(twin_registry.Registry, decls, ops),
                _apply(registry.Registry, decls, ops))
        servers = [
            twin_server.IntrospectionServer(regs[0], states[0], addr="127.0.0.1",
                                            port=0, **pair[0]),
            server.IntrospectionServer(regs[1], states[1], addr="127.0.0.1",
                                       port=0, **pair[1]),
        ]
        for s in servers:
            s.start()
        ports = [s.port for s in servers]
        before = _table(ports)  # nothing written this epoch: /readyz 503
        for st in states:
            st.labels_written({"nvidia.com/gpu.count": "1", "k": 'v"\n'},
                              {"device": {"status": "fresh", "duration_ms": 0.5}})
            st.cycle_completed()
        after = _table(ports)
        for key, (twin_answer, port_answer) in before + after:
            assert port_answer == twin_answer, key
        codes = {key: answers[0][0] for key, answers in after}
        # /debug/spans is the port's own (obs/spans.py): outside the twin's
        # table, answered by the port alone, behind --debug-endpoints.
        port_spans = _request(ports[1], "GET", "/debug/spans")
        twin_spans = _request(ports[0], "GET", "/debug/spans")
        assert twin_spans[0] == 404
        assert port_spans[0] == (200 if options["debug_endpoints"] else 404)
        if options["debug_endpoints"]:
            assert "traceEvents" in json.loads(port_spans[3])
        assert codes[("GET", "/metrics")] == 200
        assert codes[("GET", "/readyz")] == 200
        assert codes[("GET", "/peer/snapshot")] == 404
        assert codes[("GET", "/debug/labels")] == (
            200 if options["debug_endpoints"] else 404)
        right = codes[("POST", "/probe", (("X-TFD-Probe-Token", "sekrit"),))]
        wrong = codes[("POST", "/probe", (("X-TFD-Probe-Token", "wrong"),))]
        missing = codes[("POST", "/probe", ())]
        if not options["with_hook"]:
            assert (missing, wrong, right) == (404, 404, 404)
        elif not options["probe_token"]:
            assert (missing, wrong, right) == (403, 403, 403)
        else:
            assert (missing, wrong, right) == (401, 401, 202)
        assert len(fired[1]) == len(fired[0])
        assert all(a[0][1] in ("text/plain", registry.CONTENT_TYPE, "application/json")
                   for _, a in after)
        # HEAD carries the GET's length and no body.
        for key, answers in after:
            if key[0] == "HEAD":
                assert answers[1][3] == b""
                get = dict(after)[("GET", key[1])][1]
                assert answers[1][2] == str(len(get[3]))
        validate_exposition(dict(after)[("GET", "/metrics")][1][3].decode())
    finally:
        for s in servers:
            s.close()


class _RaisingRegistry:
    def render(self):
        raise KeyError("torn")


def _error_count(module, endpoint):
    return module.HTTP_ERRORS.value(endpoint=endpoint)


def test_raising_handlers_answer_500_and_count_like_the_twins():
    """A handler that raises answers 500 with the error class, counts
    tfd_http_errors_total{endpoint} and leaves the server serving."""
    def broken_hook():
        raise RuntimeError("boom")

    answers = []
    deltas = []
    for srv_mod, met_mod in ((twin_server, twin_metrics), (server, metrics)):
        poisoned = srv_mod.IntrospectionState(60.0)
        # A provenance value json cannot encode: the debug dump raises.
        poisoned.labels_written({"a": "b"}, {"device": {"duration_ms": object()}})
        before = {e: _error_count(met_mod, e)
                  for e in ("/metrics", "/debug/labels", "/probe")}
        s = srv_mod.IntrospectionServer(_RaisingRegistry(), poisoned, addr="127.0.0.1",
                                        port=0, probe_request=broken_hook,
                                        probe_token="sekrit")
        s.start()
        try:
            answers.append([
                _request(s.port, "GET", "/metrics"),
                _request(s.port, "HEAD", "/metrics"),
                _request(s.port, "GET", "/debug/labels"),
                _request(s.port, "POST", "/probe", {"X-TFD-Probe-Token": "sekrit"}),
                _request(s.port, "GET", "/healthz"),
            ])
        finally:
            s.close()
        deltas.append({e: _error_count(met_mod, e) - n for e, n in before.items()})
    assert answers[1] == answers[0]
    assert [a[0] for a in answers[1]] == [500, 500, 500, 500, 200]
    assert answers[1][0][3] == b"KeyError\n"
    assert answers[1][2][3] == b"TypeError\n"
    assert answers[1][3][3] == b"RuntimeError\n"
    assert deltas[1] == deltas[0] == {"/metrics": 2, "/debug/labels": 1, "/probe": 1}


@pytest.mark.parametrize("path", [
    "/metrics", "/healthz", "/readyz", "/debug/labels", "/probe", "/peer/snapshot",
    "/peer/notify", "/fleet/snapshot", "/other", "", "/x" * 100,
    "/metrics/../../etc", "/METRICS", "/metrics?x=1",
])
def test_error_endpoint_label_is_never_client_chosen(path):
    assert server._endpoint_label(path) == twin_server._endpoint_label(path)
    assert server._endpoint_label(path) in server._KNOWN_ENDPOINTS + ("other",)


def test_closed_server_refuses_and_severs_keepalive():
    s = server.IntrospectionServer(registry.Registry(), server.IntrospectionState(1.0),
                                   addr="127.0.0.1", port=0)
    s.start()
    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=5)
    conn.request("GET", "/healthz")
    assert conn.getresponse().read() == b"ok: 0 cycles completed\n"
    s.close()
    with pytest.raises((OSError, http.client.HTTPException)):
        conn.request("GET", "/healthz")
        conn.getresponse()
    conn.close()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", s.port), timeout=0.5)


def test_debug_labels_never_carries_the_token():
    state = server.IntrospectionState(60.0)
    state.labels_written({"nvidia.com/gpu.count": "1"},
                         {"device": {"status": "fresh", "duration_ms": 1.0}})
    s = server.IntrospectionServer(metrics.REGISTRY, state, addr="127.0.0.1", port=0,
                                   probe_token="probe-s3cret")
    s.start()
    try:
        code, ctype, _, body = _request(s.port, "GET", "/debug/labels")
    finally:
        s.close()
    assert (code, ctype) == (200, "application/json")
    assert b"probe-s3cret" not in body
    assert json.loads(body)["labels"] == {"nvidia.com/gpu.count": "1"}


# ---------------------------------------------------------------------------
# the instrumented layers: the same script through both twins records the
# same series
# ---------------------------------------------------------------------------

def _series(module, *names):
    """{(name, labels): value} of the named families in ``module``'s
    registry."""
    out = {}
    for line in module.REGISTRY.render().splitlines():
        if line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        name = key.split("{", 1)[0]
        if name in names:
            out[key] = float(value)
    return out


@pytest.fixture
def both_registries():
    metrics.reset_for_tests()
    twin_metrics.reset_for_tests()
    yield
    metrics.reset_for_tests()
    twin_metrics.reset_for_tests()


def test_label_file_series_match_the_twins(tmp_path, both_registries, capsys):
    from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels

    script = [{"nvidia.com/gpu.count": "1"}, {"nvidia.com/gpu.count": "1"},
              {"nvidia.com/gpu.count": "2", "k": "v"}, {"nvidia.com/gpu.count": "2", "k": "v"}]
    for cls, name in ((TwinLabels, "twin"), (Labels, "port")):
        for labels in script:
            cls(labels).write_to_file(str(tmp_path / name))
        cls({"a": "b"}).write_to_file("")  # stdout counts as a write
    capsys.readouterr()
    families = ("tfd_label_file_writes_total", "tfd_label_file_write_skips_total",
                "tfd_label_file_bytes", "tfd_labels_published",
                "tfd_file_fsync_duration_seconds_count")
    port = _series(metrics, *families)
    assert port == _series(twin_metrics, *families)
    assert port["tfd_label_file_writes_total"] == 3
    assert port["tfd_label_file_write_skips_total"] == 2
    assert port["tfd_file_fsync_duration_seconds_count"] == 2


def test_reconcile_wake_series_match_the_twins(both_registries):
    from gpu_feature_discovery_tpu.cmd import events as twin_events
    from gpu_feature_discovery_tpu_torch.cmd import events

    from test_torch_daemon import _wake_script

    assert _wake_script(events) == _wake_script(twin_events)
    families = ("tfd_reconcile_wakes_total", "tfd_reconcile_coalesced_total")
    port = _series(metrics, *families)
    assert port == _series(twin_metrics, *families)
    assert port['tfd_reconcile_wakes_total{reason="signal"}'] == 3
    assert port["tfd_reconcile_coalesced_total"] >= 3
    assert events.REASON_PROBE_REQUEST == twin_events.REASON_PROBE_REQUEST


def test_supervisor_series_match_the_twins(tmp_path, both_registries):
    from gpu_feature_discovery_tpu.cmd.supervisor import Supervisor as TwinSupervisor
    from gpu_feature_discovery_tpu.config import new_config as twin_new_config
    from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels

    def script(sup_cls, cfg, labels_cls, count_key, state_dir):
        now = [0.0]
        values = {"fail-on-init-error": "false", "init-backoff-max": "2s",
                  "max-consecutive-failures": "9", "state-dir": str(state_dir)}
        sup = sup_cls(cfg(cli_values=values, environ={}), clock=lambda: now[0])

        def broken():
            raise RuntimeError("no device")

        assert sup.acquire_manager(broken) is None       # failure 1
        assert sup.acquire_manager(lambda: "m") is None  # window closed
        now[0] += 10.0
        assert sup.acquire_manager(broken) is None       # failure 2
        now[0] += 10.0
        assert sup.acquire_manager(lambda: "m") == "m"   # recovered
        sup.cycle_failed(RuntimeError("cycle"))
        sup.cycle_failed(RuntimeError("cycle"))
        sup.cycle_succeeded(labels_cls({count_key: "4", "k": "v"}))
        # A restart finds the state and serves it restored.
        again = sup_cls(cfg(cli_values=values, environ={}), clock=lambda: now[0])
        assert again.restore_last_good() is not None
        again.cycle_failed(RuntimeError("cycle"))

    script(TwinSupervisor, twin_new_config, TwinLabels, "google.com/tpu.count",
           tmp_path / "twin")
    script(Supervisor, new_config, Labels, "nvidia.com/gpu.count", tmp_path / "port")
    families = ("tfd_degraded", "tfd_consecutive_cycle_failures",
                "tfd_backend_init_failures_total", "tfd_backend_init_recoveries_total",
                "tfd_cycles_total", "tfd_state_restores_total", "tfd_restored")
    port = _series(metrics, *families)
    assert port == _series(twin_metrics, *families)
    assert port == {
        "tfd_degraded": 0, "tfd_consecutive_cycle_failures": 1,
        "tfd_backend_init_failures_total": 2, "tfd_backend_init_recoveries_total": 1,
        'tfd_cycles_total{outcome="failed"}': 3, "tfd_state_restores_total": 1,
        "tfd_restored": 1,
    }
    # The backoff is jittered on both: only that it was set and cleared.
    assert metrics.BACKEND_INIT_BACKOFF.value() == twin_metrics.BACKEND_INIT_BACKOFF.value() == 0


def test_flap_series_match_the_twins(both_registries):
    from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
    from gpu_feature_discovery_tpu.sandbox.flap import FlapDamper as TwinFlapDamper
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels
    from gpu_feature_discovery_tpu_torch.sandbox.flap import FlapDamper

    seq = [{"k": "1"}, {"k": "2"}, {"k": "1"}, {"k": "2"}, {"k": "2"}, {"k": "2"}, {"k": "3"}]
    seen = {}
    for damper, cls, name in ((TwinFlapDamper(3), TwinLabels, "twin"),
                              (FlapDamper(3), Labels, "port")):
        seen[name] = []
        for labels in seq:
            damper.observe(cls(labels))
            module = twin_metrics if name == "twin" else metrics
            seen[name].append(module.FLAPPING.value())
    assert seen["port"] == seen["twin"] == [0, 1, 0, 1, 1, 0, 1]
    families = ("tfd_flap_suppressed_total", "tfd_flapping")
    assert _series(metrics, *families) == _series(twin_metrics, *families)
    assert metrics.FLAP_SUPPRESSED.value() == 4


def test_engine_series_match_the_twins(both_registries):
    import threading
    import time

    from gpu_feature_discovery_tpu.lm import engine as twin_engine
    from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
    from gpu_feature_discovery_tpu_torch.lm import engine
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels

    provenance = {}
    for mod, cls, name in ((twin_engine, TwinLabels, "twin"), (engine, Labels, "port")):
        release = threading.Event()

        class Slow:
            def labels(self, release=release, cls=cls):
                release.wait(5)
                return cls({"slow": "done"})

        eng = mod.LabelEngine(parallel=True, timeout_s=0.05)
        sources = [mod.LabelSource("slowpoke", lambda: Slow()),
                   mod.LabelSource("quick", lambda: cls({"q": "1"}), offload=False)]
        try:
            eng.generate(sources)
            provenance[name] = [eng.last_provenance["slowpoke"]]
            release.set()
            deadline = time.monotonic() + 5
            while not eng._state["slowpoke"].inflight.done():
                assert time.monotonic() < deadline, "straggler never finished"
                time.sleep(0.005)
            eng.generate(sources)
            provenance[name].append(eng.last_provenance["slowpoke"]["status"])
        finally:
            release.set()
            eng.close()
    assert provenance["port"] == provenance["twin"] == [
        {"status": "stale", "duration_ms": None}, "fresh"]
    families = ("tfd_labeler_deadline_misses_total", "tfd_labeler_stragglers_harvested_total",
                "tfd_stale_sources", "tfd_labeler_duration_seconds_count")
    port = _series(metrics, *families)
    assert port == _series(twin_metrics, *families)
    assert port['tfd_labeler_deadline_misses_total{labeler="slowpoke"}'] == 1
    assert port['tfd_labeler_stragglers_harvested_total{labeler="slowpoke"}'] == 1
    assert port["tfd_stale_sources"] == 0


def test_timing_views_render_like_the_twins(tmp_path, both_registries):
    """The "Cycle timings" line and the --timings-file document render
    the same bytes from the same spans, and feed the same series."""
    from gpu_feature_discovery_tpu.utils import timing as twin_timing

    spans = [("labeler.device", 0.0012344), ("labelgen.total", 0.0025),
             ("gpu.acquire", 5.8818721), ("labeler.health", 2.0185339)]
    for mod, name in ((twin_timing, "twin"), (timing, "port")):
        mod.reset_cycle()
        for stage, elapsed in spans:
            mod.record(stage, elapsed)
        mod.write_timings_file(str(tmp_path / f"{name}.json"))
    assert timing.cycle_summary() == twin_timing.cycle_summary()
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "twin.json").read_bytes()
    families = ("tfd_stage_duration_seconds", "tfd_labeler_duration_seconds_count",
                "tfd_cycle_duration_seconds_sum")
    assert _series(metrics, *families) == _series(twin_metrics, *families)
    for mod in (twin_timing, timing):
        mod.reset_cycle()
    assert timing.cycle_summary() == twin_timing.cycle_summary() == ""
