"""The fuzz tier of the PyTorch port: the twin's ``tests/test_fuzz.py``,
test for test, over the port's parsers of outside data, and differential
wherever the concept carries over: the same drawn input goes to the
twin's function and the port's. Where the twin accepts, they agree on the
value exactly; where the twin rejects with its typed error, the port
rejects with its own.

Where the twin raises an UNTYPED exception (a twin fault: the twin is not
edited), the port keeps the twin's accept/reject but raises its own typed
error. Each fault found here is pinned by an ``@example`` (or a case) that
failed on the tree before its repair:

- fault 10 (the port's): ``config/yaml_subset.py`` recursed without a
  bound, so a deeply nested document raised RecursionError instead of a
  ``YamlSubsetError`` naming its line;
- twin faults 11-15, the port typed: a body nested past the JSON
  decoder's recursion limit escaped ``parse_snapshot`` (11) and the
  inventory parsers (12) as RecursionError; a ``POST /peer/notify`` body
  that is JSON but not an object with a ``name`` and an integral
  ``generation`` raised a TypeError, AttributeError or OverflowError in
  the handler, which the server's safety net answers 500 and counts in
  ``tfd_http_errors_total``, where a junk body answers 400 (13); a
  targets file that is not UTF-8, or nested past pyyaml's recursion,
  escaped ``parse_targets_file`` untyped (14); a broker response frame
  that is JSON but not an object escaped ``request`` as an
  AttributeError and left the worker up (15).

Counterparts that differ from the twin's:

- ``test_parse_tpu_env_never_raises`` and
  ``test_parse_tpu_env_round_trips_wellformed_docs`` fuzz the TPU-VM
  metadata reader, which a GPU node lacks (``hostinfo/tpu_env.py`` ->
  ``hostinfo/gpu_env.py``); the port's text parser of the host
  environment is ``parse_worker_hostnames``, fuzzed in their place.
- ``test_walkers_agree_on_random_config_spaces`` holds the twin's C++
  walker against its Python one. The port has no native walker
  (``native/*.cc`` -> ``native/nvml.py``): here the port's walker is held
  against the twin's bit for bit, and the native-against-plain agreement
  is carried to the card as ``chip_smoke.py``'s seeded sweep of
  ``hbm_stream_sum`` against its plain version.
- ``test_helm_lite_fails_controlled_on_arbitrary_templates`` fuzzes the
  test helper ``tests/helm_lite.py`` with templates built from fragments;
  it renders no chart, the port's included, so it has no counterpart
  here. The port's chart under ``deployments/torch/helm`` is rendered by
  that helper at its values' combinations in
  ``tests/test_torch_deployments.py``.

Already pinned elsewhere and cited, not repeated: the frames crossing
between the packages (``tests/test_torch_broker.py::
test_frames_cross_between_the_packages``) and well-formed config files
against ``yaml.safe_load`` (``tests/test_torch_config_file.py``).
"""

import dataclasses
import http.client
import json
import math
import os
import string
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

# hypothesis is optional: environments installing only the runtime pins
# skip this module at collection rather than failing it.
pytest.importorskip("hypothesis")

import yaml  # noqa: E402
from hypothesis import HealthCheck, example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from test_label_validity import assert_valid_label  # noqa: E402

from gpu_feature_discovery_tpu.config import spec as twin_spec  # noqa: E402
from gpu_feature_discovery_tpu.config.flags import parse_duration as twin_parse_duration  # noqa: E402
from gpu_feature_discovery_tpu.fleet import inventory as twin_inventory  # noqa: E402
from gpu_feature_discovery_tpu.fleet import targets as twin_targets  # noqa: E402
from gpu_feature_discovery_tpu.hostinfo import tpu_env as twin_env  # noqa: E402
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels  # noqa: E402
from gpu_feature_discovery_tpu.obs import registry as twin_registry  # noqa: E402
from gpu_feature_discovery_tpu.obs import server as twin_server  # noqa: E402
from gpu_feature_discovery_tpu.pci import pciutil as twin_pci  # noqa: E402
from gpu_feature_discovery_tpu.peering import snapshot as twin_snapshot  # noqa: E402
from gpu_feature_discovery_tpu.sandbox import broker as twin_broker  # noqa: E402
from gpu_feature_discovery_tpu.utils import faults as twin_faults  # noqa: E402
from gpu_feature_discovery_tpu_torch.config import yaml_subset  # noqa: E402
from gpu_feature_discovery_tpu_torch.config.flags import parse_duration  # noqa: E402
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError  # noqa: E402
from gpu_feature_discovery_tpu_torch.fleet import inventory  # noqa: E402
from gpu_feature_discovery_tpu_torch.fleet import targets  # noqa: E402
from gpu_feature_discovery_tpu_torch.hostinfo import gpu_env  # noqa: E402
from gpu_feature_discovery_tpu_torch.lm.labels import Labels  # noqa: E402
from gpu_feature_discovery_tpu_torch.obs import registry  # noqa: E402
from gpu_feature_discovery_tpu_torch.obs import server  # noqa: E402
from gpu_feature_discovery_tpu_torch.pci import pciutil  # noqa: E402
from gpu_feature_discovery_tpu_torch.peering import snapshot  # noqa: E402
from gpu_feature_discovery_tpu_torch.sandbox import broker  # noqa: E402
from gpu_feature_discovery_tpu_torch.utils import faults  # noqa: E402

# Deeper than the JSON decoder's C recursion limit, well inside every
# body bound (20 KiB).
DEEP_JSON = b"[" * 20000


def _outcome(fn, *args, typed=()):
    """("ok", value), ("typed", None) for one of ``typed``, or
    ("untyped", exception) for anything else."""
    try:
        return "ok", fn(*args)
    except typed:
        return "typed", None
    except Exception as e:  # noqa: BLE001 - the property under test
        return "untyped", e


def _agree(twin, port):
    """The differential contract: the twin's value where it accepts; a
    typed error where the twin rejects, typed or not (a twin fault)."""
    assert port[0] != "untyped", f"the port raised {port[1]!r}"
    if twin[0] == "ok":
        assert port == twin
    else:
        assert port[0] == "typed", (twin, port)


# ---------------------------------------------------------------------------
# host environment parser: WORKER_HOSTNAMES / WORKER_ID must never crash
# ---------------------------------------------------------------------------

@given(st.text(max_size=2000))
@settings(max_examples=200)
def test_parse_worker_hostnames_never_raises(text):
    """Counterpart of the twin's ``test_parse_tpu_env_never_raises``: the
    port's text parser of the host environment, on arbitrary text, returns
    what the twin's returns: stripped, unique, non-empty entries."""
    out = gpu_env.parse_worker_hostnames(text)
    assert out == twin_env.parse_worker_hostnames(text)
    assert all(isinstance(h, str) and h and h == h.strip() for h in out)
    assert len(set(out)) == len(out)


_SHARED_KEYS = ("WORKER_ID", "WORKER_HOSTNAMES")


@given(
    st.dictionaries(
        st.one_of(
            st.sampled_from(_SHARED_KEYS + ("HOST_BOUNDS", "CHIPS_PER_HOST_BOUNDS",
                                            "WRAP", "TOPOLOGY", "ACCELERATOR_TYPE")),
            st.text(alphabet=string.ascii_uppercase + "_", min_size=1, max_size=20),
        ),
        st.text(
            alphabet=string.ascii_letters + string.digits + ",x-. ",
            max_size=30,
        ),
        max_size=10,
    )
)
@settings(max_examples=100)
def test_host_info_from_arbitrary_mapping_never_raises(kv):
    info = gpu_env.host_info_from_mapping(kv)
    assert info.worker_id is None or info.worker_id >= 0
    # On the keys both packages read, the same worker id and host list.
    shared = {k: v for k, v in kv.items() if k in _SHARED_KEYS}
    port = gpu_env.host_info_from_mapping(shared)
    twin = twin_env.host_info_from_mapping(shared)
    assert (port.worker_id, port.worker_hostnames, port.worker_count) == (
        twin.worker_id, twin.worker_hostnames, twin.worker_count)


@given(
    st.lists(st.text(alphabet=string.ascii_lowercase + string.digits + "-.:",
                     min_size=1, max_size=20), max_size=8, unique=True),
    st.integers(min_value=0, max_value=9),
    st.sampled_from(["", " ", "  "]),
)
@settings(max_examples=100)
def test_worker_hostnames_round_trip_wellformed_lists(hosts, worker_id, pad):
    """Counterpart of the twin's ``test_parse_tpu_env_round_trips_wellformed_docs``:
    a well-formed list round trips through the environment in both."""
    kv = {"WORKER_HOSTNAMES": ",".join(pad + h + pad for h in hosts),
          "WORKER_ID": str(worker_id)}
    port = gpu_env.host_info_from_mapping(kv)
    twin = twin_env.host_info_from_mapping(kv)
    assert port.worker_hostnames == twin.worker_hostnames == hosts
    assert port.worker_id == twin.worker_id == worker_id
    assert port.worker_count == twin.worker_count == (len(hosts) or None)


# ---------------------------------------------------------------------------
# TFD_FAULT_SPEC grammar (utils/faults.py)
# ---------------------------------------------------------------------------

_SPEC_ALPHABET = string.ascii_lowercase + string.digits + ":,._- "
_KNOWN_EXCS = ["OSError", "RuntimeError", "ValueError", "TimeoutError",
               "ResourceError"]


def _armed(module, text):
    """{site: (exception name, count)} of a parsed spec."""
    reg = module.parse_fault_spec(text)
    return {site: (f.exc_type.__name__, f.remaining) for site, f in reg._faults.items()}


@given(st.text(alphabet=_SPEC_ALPHABET, max_size=80))
@settings(max_examples=300)
def test_fault_spec_arbitrary_text_arms_cleanly_or_raises_config_error(text):
    twin = _outcome(_armed, twin_faults, text, typed=twin_spec.ConfigError)
    port = _outcome(_armed, faults, text, typed=ConfigError)
    _agree(twin, port)
    if port[0] == "ok":
        # Whatever armed must also COUNT DOWN cleanly.
        reg = faults.parse_fault_spec(text)
        for site in reg.sites:
            assert reg.take(site) in (True, False)


@given(
    st.lists(
        st.tuples(
            st.text(
                alphabet=string.ascii_lowercase + "._-", min_size=1, max_size=12
            ),
            st.one_of(
                st.integers(min_value=1, max_value=99).map(
                    lambda n: ("fail", str(n))
                ),
                st.tuples(
                    st.sampled_from(_KNOWN_EXCS),
                    st.integers(min_value=1, max_value=9),
                ).map(lambda t: ("raise", f"{t[0]}:{t[1]}")),
            ),
        ),
        min_size=1,
        max_size=5,
        unique_by=lambda e: e[0],
    )
)
@settings(max_examples=200)
def test_fault_spec_wellformed_entries_round_trip(entries):
    spec = ",".join(f"{site}:{mode}:{rest}" for site, (mode, rest) in entries)
    armed = _armed(faults, spec)
    assert set(armed) == {site for site, _ in entries}
    assert armed == _armed(twin_faults, spec)


@given(st.text(alphabet=_SPEC_ALPHABET, max_size=60))
@settings(max_examples=200)
def test_fault_spec_maybe_inject_never_crashes_unarmed_sites(text):
    """maybe_inject on a NEVER-armed site is a no-op whatever spec is
    loaded: the instrumented call sites depend on it."""
    never = "site-that-is-never-armed-by-the-alphabet!"
    try:
        faults.load_fault_spec(text)
    except ConfigError:
        faults.reset()
        return
    try:
        faults.maybe_inject(never)
        assert faults.consume(never) is False
    finally:
        faults.reset()


# ---------------------------------------------------------------------------
# duration parser
# ---------------------------------------------------------------------------

@given(st.integers(min_value=0, max_value=10**6))
def test_parse_duration_seconds(n):
    assert parse_duration(f"{n}s") == twin_parse_duration(f"{n}s") == float(n)
    assert parse_duration(str(n)) == twin_parse_duration(str(n)) == float(n)
    assert parse_duration(n) == twin_parse_duration(n) == float(n)


def _seconds(fn, value):
    out = fn(value)
    return "nan" if math.isnan(out) else out


@given(st.one_of(
    st.text(alphabet=string.ascii_letters + "%$#@! ", min_size=1, max_size=10),
    st.text(alphabet=string.digits + ".+-eE_ nsuµmhif", max_size=12),
    st.lists(st.tuples(st.integers(0, 999), st.sampled_from(["ns", "us", "µs", "ms", "s", "m",
                                                              "h", "d", ""])),
             max_size=4).map(lambda ps: "".join(f"{n}{u}" for n, u in ps)),
))
@settings(max_examples=300)
def test_parse_duration_garbage_raises_config_error(text):
    """On arbitrary text the port returns the twin's seconds or both raise
    their ConfigError; what is accepted decomposes into units."""
    twin = _outcome(_seconds, twin_parse_duration, text, typed=twin_spec.ConfigError)
    port = _outcome(_seconds, parse_duration, text, typed=ConfigError)
    _agree(twin, port)
    try:
        float(text)
        return  # plain numbers are valid by design
    except ValueError:
        pass
    if port[0] == "ok":
        assert any(u in text for u in ("ns", "us", "ms", "s", "m", "h"))


# ---------------------------------------------------------------------------
# the capability walker and the record decoder: the twin's, bit for bit
# ---------------------------------------------------------------------------

def _walk(module, config: bytes):
    dev = module.PCIDevice(
        path="", address="0000:00:04.0", vendor="0x10de",
        device_class="0x0302", config=config,
    )
    return dev.get_vendor_specific_capability()


@given(st.binary(min_size=256, max_size=256))
@settings(max_examples=300)
def test_python_walker_never_crashes(config):
    result = _walk(pciutil, config)
    assert result is None or isinstance(result, bytes)


def _with_vendor_capability(config: bytes, pos: int, body: bytes, nxt: int) -> bytes:
    """``config`` with the capability list on and a 0x09 record at ``pos``."""
    out = bytearray(config)
    out[pciutil.PCI_STATUS_BYTE] |= pciutil.PCI_STATUS_CAPABILITY_LIST
    out[pciutil.PCI_CAPABILITY_LIST] = pos
    record = bytes([0x09, nxt, len(body) + 3]) + body
    out[pos:pos + len(record)] = record[:256 - pos]
    return bytes(out[:256])


@given(st.one_of(
    st.binary(min_size=256, max_size=256),
    st.builds(_with_vendor_capability, st.binary(min_size=256, max_size=256),
              st.integers(0x40, 0xF8), st.binary(max_size=48), st.integers(0, 255)),
))
@settings(max_examples=300, deadline=None)
def test_torch_walker_agrees_with_the_twins_on_random_config_spaces(config):
    """The twin holds its C++ walker against its Python one here; the port
    has one walker, held against the twin's bit for bit, on raw config
    spaces and on ones whose list leads to a 0x09 record."""
    cap = _walk(pciutil, config)
    assert cap == _walk(twin_pci, config)
    if cap is not None:
        port, twin = pciutil.decode_vendor_capability(cap), twin_pci.decode_vendor_capability(cap)
        assert (port and dataclasses.asdict(port)) == (twin and dataclasses.asdict(twin))


# Random bytes almost never start with the 0x09 capability id, so fuzz
# BOTH raw bytes (header/guard paths) and header-prefixed bodies (the
# record-id / signature / field-split parsing paths).
@given(
    st.one_of(
        st.binary(max_size=64),
        st.binary(max_size=61).map(
            lambda b: bytes([0x09, 0x00, len(b) + 3]) + b
        ),
    )
)
@settings(max_examples=400)
def test_decode_vendor_capability_never_raises(cap):
    """Arbitrary capability bytes decode to the twin's record, or to None
    as in the twin, with printable-ASCII strings, and never raise."""
    info = pciutil.decode_vendor_capability(cap)
    twin = twin_pci.decode_vendor_capability(cap)
    assert (info and dataclasses.asdict(info)) == (twin and dataclasses.asdict(twin))
    if info is not None:
        assert info.signature and info.signature.isprintable()
        for s in (info.driver_version, info.driver_branch):
            assert s == "" or s.isprintable()


# Printable non-control ASCII only: every generated example must exercise
# the positional property, not vacuously pass a filter.
_FIELD_ALPHABET = string.ascii_letters + string.digits + string.punctuation + " "


@given(st.text(alphabet=_FIELD_ALPHABET, max_size=40),
       st.text(alphabet=_FIELD_ALPHABET, max_size=40))
@settings(max_examples=200)
def test_decode_vendor_capability_positional_fields(version, branch):
    """Any printable-ASCII (version, branch) pair in a record-id-0 body
    decodes back POSITIONALLY: an empty version never promotes the branch
    into the version slot."""
    body = b"NVHOST\x00\x00" + version.encode() + b"\x00" + branch.encode() + b"\x00"
    cap = pciutil.make_capability(0x09, body)
    assert cap == twin_pci.make_capability(0x09, body)
    info = pciutil.decode_vendor_capability(cap)
    assert info is not None
    assert (info.signature, info.driver_version, info.driver_branch) == (
        "NVHOST", version, branch)


# ---------------------------------------------------------------------------
# label file round trip
# ---------------------------------------------------------------------------

_DNS = st.from_regex(r"\A[a-z0-9]([-a-z0-9]{0,10}[a-z0-9])?\Z")
_NAME = st.from_regex(r"\A[A-Za-z0-9]([-A-Za-z0-9_.]{0,20}[A-Za-z0-9])?\Z")
_KEY = st.one_of(
    _NAME,
    st.builds(lambda parts, name: ".".join(parts) + "/" + name,
              st.lists(_DNS, min_size=1, max_size=4), _NAME),
)
_VALUE = st.from_regex(r"\A([A-Za-z0-9]([-A-Za-z0-9_.]{0,30}[A-Za-z0-9])?)?\Z")


@given(st.dictionaries(_KEY, _VALUE, max_size=20))
@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
def test_labels_file_round_trip(tmp_path_factory, kv):
    """Keys and values the k8s grammar admits round trip through the
    port's writer, whose file is the twin's byte for byte."""
    for key, value in kv.items():
        assert_valid_label(key, value)
    d = tmp_path_factory.mktemp("labels")
    Labels(kv).write_to_file(str(d / "port"))
    TwinLabels(kv).write_to_file(str(d / "twin"))
    raw = (d / "port").read_bytes()
    assert raw == (d / "twin").read_bytes()
    written = dict(line.partition("=")[::2] for line in raw.decode().splitlines())
    assert written == kv


# ---------------------------------------------------------------------------
# broker RPC framing (sandbox/broker.py)
# ---------------------------------------------------------------------------
#
# The broker pipe is a trust boundary with a crashed or corrupted worker
# on the other side: whatever bytes arrive, the parent surfaces a clean
# typed error and respawns on next use, never hangs and never crashes.

def _read_all_frames(module, data, deadline_s=0.5):
    """Feed ``data`` into a pipe at EOF and drain ``module``'s reader."""
    r_fd, w_fd = os.pipe()
    try:
        os.write(w_fd, data)
    finally:
        os.close(w_fd)
    reader = module._FrameReader(r_fd)
    frames = []
    try:
        deadline = time.monotonic() + deadline_s
        while True:
            frame = reader.read(deadline)
            if frame is None or frame == b"":
                return frames, frame
            frames.append(frame)
    finally:
        os.close(r_fd)


@given(st.binary(max_size=300))
@settings(max_examples=300, deadline=None)
def test_broker_frame_reader_arbitrary_bytes_never_hang_never_crash(data):
    t0 = time.monotonic()
    port = _outcome(_read_all_frames, broker, data, typed=broker.BrokerCrash)
    # A closed pipe resolves promptly: EOF, not a deadline wait.
    assert time.monotonic() - t0 < 2.0
    _agree(_outcome(_read_all_frames, twin_broker, data, typed=twin_broker.BrokerCrash), port)
    if port[0] == "ok":
        frames, tail = port[1]
        assert tail in (None, b"")
        assert all(isinstance(f, bytes) for f in frames)


@given(
    # min_size=1: the protocol frames JSON documents, never empty bodies,
    # and the drain helper reads b"" as EOF.
    st.lists(st.binary(min_size=1, max_size=64), min_size=1, max_size=5)
)
@settings(max_examples=200, deadline=None)
def test_broker_frame_reader_roundtrips_wellformed_frames(bodies):
    wire = b"".join(struct.pack(">I", len(b)) + b for b in bodies)
    frames, tail = _read_all_frames(broker, wire)
    assert frames == bodies
    assert tail == b""  # exactly consumed, EOF after


def test_broker_frame_reader_truncated_length_prefix_is_eof():
    for module in (broker, twin_broker):
        frames, tail = _read_all_frames(module, b"\x00\x00")
        assert frames == [] and tail == b""


def test_broker_frame_reader_truncated_body_is_eof_not_hang():
    # The prefix promises 100 bytes, 3 arrive before EOF (a worker that
    # died mid-write): EOF, never a deadline-long wait.
    for module in (broker, twin_broker):
        t0 = time.monotonic()
        frames, tail = _read_all_frames(module, struct.pack(">I", 100) + b"abc", deadline_s=5)
        assert frames == [] and tail == b""
        assert time.monotonic() - t0 < 1.0


def test_broker_frame_reader_oversized_prefix_raises_typed_error():
    """At the twin's 0xFFFFFFF0 (``tests/test_torch_broker.py::
    test_corrupt_length_prefix_is_a_typed_error`` pins MAX_FRAME_BYTES + 1):
    rejected off the prefix, with no wait for bytes that never come."""
    t0 = time.monotonic()
    with pytest.raises(broker.BrokerCrash, match="corrupt length prefix"):
        _read_all_frames(broker, struct.pack(">I", 0xFFFFFFF0) + b"x" * 64, deadline_s=5)
    assert time.monotonic() - t0 < 1.0


# Syntactically broken JSON (the twin's case), JSON that is no object
# (twin fault: AttributeError, the worker left up) and JSON nested past
# the decoder's limit (twin fault: RecursionError).
_JUNK_RESPONSES = [b'{"status": ', b"[1]", b'"ok"', b"null", b"7", DEEP_JSON]


@pytest.mark.parametrize("junk", _JUNK_RESPONSES, ids=["truncated", "list", "string", "null",
                                                      "number", "deep"])
def test_broker_junk_json_response_clean_error_then_respawn(tmp_path, monkeypatch, junk):
    """A worker that frames garbage is treated exactly like a crash:
    typed error, worker killed and reaped, and the next request respawns
    a fresh worker. The parent never hangs and never believes the
    garbage."""
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.sandbox import probe

    monkeypatch.delenv(faults.FAULT_SPEC_ENV, raising=False)
    faults.reset()
    config = new_config(
        cli_values={
            "backends": "mock-gpu:2",
            "output-file": str(tmp_path / "tfd"),
            "probe-timeout": "5s",
            "init-backoff-max": "0.02s",
        },
        environ={},
    )
    client = broker.BrokerClient(config)
    # Hand-wire a FAKE worker: a child that never answers (spawned, never
    # forked, as every child of the port), and a response pipe preloaded
    # with the junk.
    req_r, req_w = os.pipe()
    resp_r, resp_w = os.pipe()
    dummy = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"])
    probe._register(dummy.pid)
    os.write(resp_w, struct.pack(">I", len(junk)) + junk)
    with client._pid_lock:
        client._pid = dummy.pid
    client._req_w = req_w
    client._resp_r = resp_r
    client._reader = broker._FrameReader(resp_r)
    client._ever_spawned = True
    try:
        with pytest.raises(broker.BrokerCrash, match="unparseable"):
            client.request("ping")
        assert not client.alive, "the junk response did not retire the worker"
        assert dummy.poll() is not None or _reaped(dummy.pid), "the fake worker survived"
        if junk == _JUNK_RESPONSES[0]:
            # Respawn: the next request spawns a REAL worker and serves.
            assert client.ping() is True
    finally:
        for fd in (req_r, resp_w):
            try:
                os.close(fd)
            except OSError:
                pass
        if dummy.poll() is None:
            dummy.kill()
            dummy.wait()
        client.close()
        broker.close_broker()


def _reaped(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return True
    return False


# ---------------------------------------------------------------------------
# the config file's YAML subset against pyyaml, on arbitrary text
# ---------------------------------------------------------------------------

_YAML_ALPHABET = (
    list("ab01 :-#'\"\n\t[]{},?&*!|>%@`~.\\x=<+_") +
    ["  ", "    ", "- ", ": ", "\n  ", "\n    ", "\n- ", "\n  - ", "a: ", "\nb: ",
     "on", "yes", "1:30", "0x1F", "0o17", "017", "1_000", "null", "~", "---", "...",
     "'a b'", '"\\n"', "1e5", "1e+5", "1.5", ".inf", "-.inf", ".nan", "2001-12-14",
     "<<", "é", "﻿", "# c", " #", "a:b", "[a, b]", "{a: 1}", "\r\n"]
)


def _same(a, b):
    """Equal values of equal types, NaN equal to NaN, mappings in order."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict):
        a, b = list(a.items()), list(b.items())
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _nested(depth, leaf="x"):
    return "".join("  " * i + "- \n" for i in range(depth)) + "  " * depth + leaf + "\n"


@given(st.lists(st.sampled_from(_YAML_ALPHABET), max_size=30).map("".join))
@settings(max_examples=1000, deadline=None)
@example("[" * 2000)          # fault 10: RecursionError before the depth bound
@example("{a: " * 2000)
@example(_nested(1500))
@example("[" * 100 + "]" * 100)
def test_yaml_subset_arbitrary_text_refuses_or_equals_pyyaml(text):
    """The port's parser of the config and targets files on arbitrary
    text: never hangs; raises nothing but a YamlSubsetError (a
    ConfigError) naming a line; where it accepts, its value is
    ``yaml.safe_load``'s, types included; where yaml raises, it raises."""
    t0 = time.monotonic()
    try:
        got = ("ok", yaml_subset.safe_load(text))
    except yaml_subset.YamlSubsetError as e:
        assert isinstance(e, ConfigError)
        assert e.line >= 1 and str(e).startswith(f"line {e.line}: ")
        got = ("refused", None)
    assert time.monotonic() - t0 < 2.0
    if got[0] == "ok":
        try:
            ref = yaml.safe_load(text)
        except Exception as e:  # noqa: BLE001 - pyyaml raised; so must the subset
            raise AssertionError(f"the subset accepted what yaml refuses ({e!r})")
        assert _same(got[1], ref), (got[1], ref)


# ---------------------------------------------------------------------------
# the peer snapshot, its notify body and the fleet inventory
# ---------------------------------------------------------------------------

def _valid_snapshot():
    cohort = snapshot.build_cohort_aggregate(
        1, {4: {"reachable": True, "generation": 3, "sick": 0, "mode": "full"},
            5: {"reachable": False, "generation": None, "sick": None, "mode": None}})
    section = {"schema": 1, "leader": "w0", "healthy_hosts": 3, "total_hosts": 4,
               "degraded": True, "sick_chips": 1}
    return snapshot.build_snapshot(
        2, "w2", {"nvidia.com/gpu.count": "8", "nvidia.com/gpu.chips.healthy": "7",
                  "nvidia.com/gpu.chips.sick": "1"},
        9, "full", cohort=cohort, slice_section=section)


def _valid_inventory():
    entry = {"healthy_hosts": 2, "stale": False, "last_seen_unix": 1700000000}
    return [
        inventory.build_inventory({"s": entry}, 4, False),
        inventory.build_inventory({"region/r/s": entry}, 5, True, regions={"r": {"stale": False}}),
        inventory.build_delta(3, 4, False, {"s": entry}, ["t"]),
        inventory.build_delta(3, 4, False, {"s": entry}, [], regions_changed={"r": {}},
                              regions_tombstones=["q"]),
    ]


_JSON = st.recursive(
    st.none() | st.booleans() | st.integers(-2**70, 2**70) | st.floats(allow_nan=False)
    | st.text(max_size=8),
    lambda inner: st.lists(inner, max_size=3) | st.dictionaries(st.text(max_size=8), inner,
                                                                max_size=3),
    max_leaves=8,
)


@st.composite
def _mutated(draw, doc):
    """``doc`` with one value somewhere replaced by arbitrary JSON, or one
    key dropped."""
    doc = json.loads(json.dumps(doc))
    node = doc
    while True:
        keys = list(node) if isinstance(node, dict) else list(range(len(node)))
        if not keys:
            return doc
        key = draw(st.sampled_from(keys))
        child = node[key]
        if isinstance(child, (dict, list)) and child and draw(st.booleans()):
            node = child
            continue
        if isinstance(node, dict) and draw(st.integers(0, 3)) == 0:
            del node[key]
        else:
            node[key] = draw(_JSON)
        return doc


def _body(doc):
    return json.dumps(doc).encode()


_SNAPSHOT_BODIES = st.one_of(
    st.binary(max_size=300),
    _mutated(_valid_snapshot()).map(_body),
    st.just(_body(_valid_snapshot())),
)


@given(_SNAPSHOT_BODIES)
@settings(max_examples=400, deadline=None)
@example(DEEP_JSON)                      # twin fault: RecursionError
@example(b"[" * 20000 + b"]" * 20000)
def test_parse_snapshot_same_verdict_as_the_twin(body):
    """Arbitrary bytes and mutated valid documents: the twin's document or
    a PeerSnapshotError where the twin rejects; never an untyped error."""
    _agree(_outcome(twin_snapshot.parse_snapshot, body, typed=twin_snapshot.PeerSnapshotError),
           _outcome(snapshot.parse_snapshot, body, typed=snapshot.PeerSnapshotError))


@given(st.one_of(
    st.binary(max_size=300),
    st.sampled_from(_valid_inventory()).flatmap(_mutated).map(_body),
    st.sampled_from(_valid_inventory()).map(_body),
))
@settings(max_examples=400, deadline=None)
@example(DEEP_JSON)                      # twin fault: RecursionError
def test_parse_inventory_same_verdict_as_the_twin(body):
    for name in ("parse_inventory", "parse_inventory_or_delta"):
        _agree(_outcome(getattr(twin_inventory, name), body, typed=ValueError),
               _outcome(getattr(inventory, name), body, typed=ValueError))


@pytest.fixture(scope="module")
def notify_servers():
    """A twin and a port server with ``POST /peer/notify`` behind one
    token; the hook knows one child, "7"."""
    servers = []
    for mod, reg in ((twin_server, twin_registry), (server, registry)):
        s = mod.IntrospectionServer(
            reg.Registry(), mod.IntrospectionState(60.0), addr="127.0.0.1", port=0,
            peer_token="tok", peer_notify=lambda name, generation, etag: name == "7")
        s.start()
        servers.append(s)
    yield servers
    for s in servers:
        s.close()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/peer/notify", data=body, method="POST",
        headers={"X-TFD-Probe-Token": "tok", "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code
    except (OSError, http.client.HTTPException):
        return "dropped"


_NOTIFY_BODIES = st.one_of(
    st.binary(max_size=200),
    _mutated({"name": "7", "generation": 3, "etag": '"e"'}).map(_body),
    _JSON.map(_body),
)


@given(_NOTIFY_BODIES)
@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@example(b"[1]")                         # twin fault: TypeError, answered 500
@example(b'{"name": "7", "generation": null}')
@example(b'{"name": "7", "generation": 1e400}')
@example(b'"7"')
@example(DEEP_JSON)
def test_peer_notify_body_same_status_as_the_twin(notify_servers, body):
    """The status of ``POST /peer/notify`` for arbitrary bodies is the
    twin's; where the twin's handler raised (its server's 500), the port
    answers 400 as for any other invalid body."""
    twin, port = (_post(s.port, body) for s in notify_servers)
    assert port == (400 if twin == 500 else twin)
    assert port in (202, 400, 404)


_TARGETS_TEXT = st.one_of(
    st.lists(st.sampled_from(_YAML_ALPHABET + ["version: v1\n", "slices:\n", "- name: s\n",
                                               "  hosts: [a, b]\n", "  hosts:\n", "  - h\n",
                                               "version: v2\n", "name: ", "hosts: "]),
             max_size=20).map("".join),
    st.lists(st.fixed_dictionaries(
        {"name": st.text(max_size=6), "hosts": st.lists(st.text(max_size=6), max_size=3)}),
        max_size=3).map(lambda s: json.dumps({"version": "v1", "slices": s})),
)


def _targets(module, path):
    return [(t.name, t.hosts) for t in module.parse_targets_file(path)]


@given(st.one_of(_TARGETS_TEXT.map(str.encode), st.binary(max_size=60)))
@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@example(b"slices: \xff\n")               # twin fault: UnicodeDecodeError
@example(b"[" * 2000)                    # twin fault: RecursionError (fault 10 in the port)
def test_targets_file_same_targets_or_same_typed_error(tmp_path_factory, raw):
    """Where the port's subset reads the file, the twin's targets or a
    ConfigError where the twin rejects; where the text is outside the
    subset, a ConfigError naming the line."""
    path = str(tmp_path_factory.mktemp("targets") / "t.yaml")
    with open(path, "wb") as f:
        f.write(raw)
    port = _outcome(_targets, targets, path, typed=ConfigError)
    assert port[0] != "untyped", f"the port raised {port[1]!r}"
    try:
        with open(path) as f:
            yaml_subset.safe_load(f.read())
    except (UnicodeDecodeError, yaml_subset.YamlSubsetError):
        assert port[0] == "typed"
        return
    _agree(_outcome(_targets, twin_targets, path, typed=twin_spec.ConfigError), port)
