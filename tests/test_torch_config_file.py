"""The port's config file (config/yaml_subset.py, config/spec.py
``parse_config_file``, config/flags.py ``new_config``) against the twin,
which reads the same file with ``yaml.safe_load``.

- The parser: documents generated by hypothesis and dumped by
  ``yaml.safe_dump`` in block and flow style, at several widths (so flow
  collections, quoted and plain scalars fold over lines), parse to the
  same object as ``yaml.safe_load`` gives, types included; so do the
  hand-written YAML 1.1 quirks. Inputs outside the subset raise a
  ConfigError that names their line. ``yaml`` is imported by this test
  only: the port never imports it.
- The config: ``tests/config-shared.yaml`` (``google.com/tpu`` translated
  to ``nvidia.com/gpu``) and seeded variants give the twin's Config; for
  seeded CLI, environment and file values the port's ``new_config`` equals
  the twin's field by field, CLI > env > file > default; the twin's error
  texts; a twin key for a flag the port lacks is refused with its slice.

Every comparison is exact: the same text gives the same values.
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import HealthCheck, given, settings, strategies as st

from gpu_feature_discovery_tpu.config import flags as twin_flags
from gpu_feature_discovery_tpu.config import spec as twin_spec
from gpu_feature_discovery_tpu_torch.config import flags, spec
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.config.yaml_subset import YamlSubsetError, safe_load

HERE = Path(__file__).parent


def _same(a, b) -> bool:
    """Equality that tells True from 1 and 1 from 1.0, key types included."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(type(x) is type(y) for x, y in zip(a, b))
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


# ---------------------------------------------------------------------------
# the parser against yaml.safe_load
# ---------------------------------------------------------------------------

# Strings that resolve to another type unquoted, or that need quoting.
_QUIRKS = ["on", "yes", "No", "OFF", "~", "null", "0x1F", "017", "0o17", "1_000",
           "1:30", "60s", "1m30s", "", " ", "2001-12-14", "<<", "=", ".inf",
           "1e5", "1.0e+5", "-", "- x", "a: b", "#x", "x #y", "'", '"', "\\",
           "...", "---", "?", ":x", "tab\tin", "nl\nin", "é✓", "\x07"]
_chars = st.sampled_from(list("abcxyz019 :#-'\"\\\n\t,[]{}?&*!|>%@`.é✓_+"))
_text = st.one_of(
    st.sampled_from(_QUIRKS),
    st.text(_chars, max_size=24),
    # Long enough to fold over lines at the narrow widths.
    st.text(st.sampled_from(list("ab c")), min_size=40, max_size=120),
)
_scalar = st.one_of(st.none(), st.booleans(), st.integers(-2**70, 2**70),
                    st.floats(allow_nan=False), _text)
_key = st.one_of(
    st.sampled_from([q for q in _QUIRKS[:20] if q.strip()]),
    st.text(st.sampled_from(list("abcXYZ_-019. ")), min_size=1, max_size=12)
    .filter(str.strip),
)
_document = st.recursive(
    _scalar,
    lambda inner: st.one_of(st.lists(inner, max_size=5),
                            st.dictionaries(_key, inner, max_size=5)),
    max_leaves=25,
)


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_document, st.sampled_from([False, True, None]), st.sampled_from([20, 80, 4096]),
       st.booleans(), st.sampled_from([2, 4]))
def test_generated_documents_parse_as_pyyaml_parses_them(doc, flow, width, uni, indent):
    text = yaml.safe_dump(doc, default_flow_style=flow, width=width,
                          allow_unicode=uni, indent=indent, sort_keys=False)
    assert _same(safe_load(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("text", [
    # YAML 1.1 scalars as pyyaml resolves them.
    "probeBroker: on", "a: yes", "a: No", "a: OFF", "a: ~", "a: null", "a:",
    "a: 0x1F", "a: 017", "a: 0o17", "a: 1_000", "a: 1:30", "a: 1:30.5", "a: 09",
    "a: 0b101", "a: -0x1F", "a: 60s", "a: 1m30s", "a: '60s'", 'a: "1m30s"',
    "a: 1e5", "a: 1.0e+5", "a: .5", "a: -.inf", "a: .NaN", "a: 1.", "a: +12",
    "a: 'on'", "a: \"0x1F\"", "1: x", "~: x", "on: x\n1: y", "a: b#c",
    # comments, blank lines and the leading marker
    "# c\n---\na: 1 # trailing\n\n  # indented comment\nb: [1, 2] # c\n",
    "a: 1\n...\n",
    # block structure
    "a:\n- 1\n- 2\nb: 3", "- name: x\n  replicas: 4\n- name: y",
    "- - a\n  - b\n- c", "a:\n  b:\n    c: d\n  e: ~\nf: ''", "  a: 1\n  b: 2",
    "a:\n  hello", "a: hello\n  world\nb: x", "- x\n  y",
    # flow collections, across lines
    "a: [1, [2, {b: c}]]", "a: {x: 1, y: , z}", "a: [1,\n2,\n  ]",
    "{\"version\": \"v1\", \"flags\": {\"tfd\": {\"withBurnin\": true}}}",
    '{\n  "a": [\n    1,\n    2.5\n  ],\n  "b": null\n}', "{a:1}", "{a :b}",
    "a: [x # c\n , y]", "a: [x\n\n y]",
    # quoted scalars, escapes and folding
    "a: 'it''s'", 'a: "\\x41\\u00e9\\U0001F600\\t\\n"', "a: 'x\n  y'",
    "a: 'x\n\n  y'", 'a: "x\\\n  \\ y"', "a: '\t x'",
])
def test_quirk_documents_parse_as_pyyaml_parses_them(text):
    assert _same(safe_load(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("text,line", [
    ("a: &x 1", 1), ("a: 1\nb: *x", 2), ("a: !!str 1", 1), ("a: |\n  x", 1),
    ("a: >\n  x", 1), ("%YAML 1.1\n---\na: 1", 1), ("a: 1\n---\nb: 2", 2),
    ("? a\n: b", 1), ("a:\n  [b]: c", 2), ("- [a]: b", 1), ("a: [b: c]", 1),
    ("a:\tb", 1), ("a: 1\n\tb: 2", 2), ("a: 2001-12-14", 1), ("a: <<", 1),
    ("a: b: c", 1), ("a: b\n   c: d", 2), ("a: [1, 2", 1), ("a: 'x", 1),
    ("a:\n    b: 1\n  c: 2", 3), ("a: \"\\q\"", 1), ("a: 1\n...\nb: 2", 2),
    ("--- a", 1), ("a: @x", 1), ("a: 'x\n---\n'", 2), ("a: \x85", 1),
])
def test_out_of_subset_documents_raise_naming_the_line(text, line):
    with pytest.raises(YamlSubsetError, match=rf"^line {line}: "):
        safe_load(text)
    assert issubclass(YamlSubsetError, ConfigError)


# ---------------------------------------------------------------------------
# the config file against the twin's
# ---------------------------------------------------------------------------

def _port_fields(config):
    """{flag name: value} of every flag the port has, and the rest of the
    document."""
    out = {}
    for fd in flags.FLAG_DEFS:
        target = config.flags if fd.on_flags else config.flags.tfd
        out[fd.name] = getattr(target, fd.attr)
    out["version"] = config.version
    out["resources"] = config.resources
    out["sharing"] = dataclasses.asdict(config.sharing)
    return out


def _twin_fields(config):
    getters = {fd.name: fd.getter for fd in twin_flags.FLAG_DEFS}
    out = {fd.name: getters[fd.name](config) for fd in flags.FLAG_DEFS}
    out["version"] = config.version
    out["resources"] = config.resources
    out["sharing"] = dataclasses.asdict(config.sharing)
    return out


def _both(cli=None, env=None, path=None):
    port = flags.new_config(cli_values=dict(cli or {}), environ=dict(env or {}),
                            config_file=str(path) if path else None)
    twin = twin_flags.new_config(cli_values=dict(cli or {}), environ=dict(env or {}),
                                 config_file=str(path) if path else None)
    return _port_fields(port), _twin_fields(twin)


def _shared_yaml() -> str:
    return (HERE / "config-shared.yaml").read_text().replace("google.com/tpu", "nvidia.com/gpu")


def test_shared_config_file_gives_the_twins_config(tmp_path):
    path = tmp_path / "shared.yaml"
    path.write_text(_shared_yaml())
    port, twin = _both(path=path)
    assert _same(port, twin)
    assert port["sharing"]["time_slicing"]["resources"] == [
        {"name": "nvidia.com/gpu", "rename": "", "replicas": 4}]


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sharing_variants_give_the_twins_config(tmp_path, seed):
    rng = np.random.default_rng(seed)
    resources = [
        {"name": str(rng.choice(["nvidia.com/gpu", "node.features/cpu", "other"])),
         "replicas": int(rng.integers(0, 9)),
         **({"rename": "renamed"} if rng.random() < 0.3 else {})}
        for _ in range(int(rng.integers(0, 4)))
    ]
    doc = {"version": "v1", "sharing": {"timeSlicing": {
        "renameByDefault": bool(rng.random() < 0.5),
        "failRequestsGreaterThanOne": str(rng.choice(["true", "false", "on", "0"])),
        "resources": resources}}}
    if rng.random() < 0.5:
        doc["resources"] = {"gpus": [{"pattern": "*", "name": "gpu"}]}
    path = tmp_path / "variant.yaml"
    path.write_text(yaml.safe_dump(doc, default_flow_style=bool(rng.random() < 0.5)))
    port, twin = _both(path=path)
    assert _same(port, twin)
    # The renaming gate, applied by both daemons' load_config.
    port_cfg = flags.new_config(config_file=str(path), environ={})
    twin_cfg = twin_flags.new_config(config_file=str(path), environ={})
    port_log, twin_log = [], []
    flags.disable_resource_renaming(port_cfg, port_log.append)
    twin_flags.disable_resource_renaming(twin_cfg, twin_log.append)
    assert port_log == twin_log
    assert _same(_port_fields(port_cfg), _twin_fields(twin_cfg))


# One value list per port flag: CLI and env values are their strings;
# file values keep their YAML type.
_BOOLS = [True, False, "on", "off"]
_FLAG_VALUES = {
    "tpu-topology-strategy": ["none", "single", "mixed"],
    "native-enumeration": _BOOLS,
    "machine-type-file": ["/etc/dmi", "product"],
    "oneshot": _BOOLS, "no-timestamp": _BOOLS, "with-burnin": _BOOLS,
    "chip-probes": _BOOLS, "fail-on-init-error": _BOOLS,
    "parallel-labelers": _BOOLS, "debug-endpoints": _BOOLS,
    "sleep-interval": ["2s", "150ms", "1m30s", 5, 2.5],
    "output-file": ["/tmp/tfd", "out"],
    "burnin-interval": [1, 3, 7], "straggler-threshold": [0.2, 0.5],
    "backends": ["auto", "mock-gpu:2", "mock-gpu:2,mock-cpu:3", "mock-cpu", "gpu,cpu"],
    "probe-timeout": ["30s", 4, "500ms"],
    "probe-isolation": ["none", "subprocess", "auto"],
    "probe-broker": ["off", "auto"],
    "broker-max-requests": [0, 5],
    "init-retries": [1, 5], "init-backoff-max": ["30s", 0.05],
    "max-consecutive-failures": [2, 5], "labeler-timeout": ["10s", 1],
    "timings-file": ["", "/tmp/t.json"], "compilation-cache-dir": ["auto", "", "/c"],
    "state-dir": ["", "/var/lib/tfd"], "flap-window": [1, 3],
    "heartbeat-file": ["", "/tmp/beat"], "reconcile": ["interval", "event", "auto"],
    "max-staleness": [0, "2m"], "reconcile-debounce": ["0.5s", 0],
    "max-probe-rate": [1, 0.5, 2.5], "metrics-addr": ["0.0.0.0", "127.0.0.1"],
    "metrics-port": [0, 9101, 19000], "probe-token": ["", "sekrit"],
    "slice-coordination": ["on", "off", "auto"], "peer-timeout": ["2s", 0.5, "750ms"],
    "peer-fanout": [0, 1, 4], "cohort-size": ["0", "auto", 2, "64"],
    "peer-token": ["", "tok"], "push-notify": ["on", "off", "auto"],
    "actuation": ["off", "advise", "enforce"], "actuation-window": [1, 2, 4],
    "max-actuated-fraction": [0.25, 0.5, 0.75],
}


def _as_flag_string(value) -> str:
    return str(value).lower() if isinstance(value, bool) else str(value)


def test_every_port_flag_has_values_and_its_own_file_key():
    assert set(_FLAG_VALUES) == {fd.name for fd in flags.FLAG_DEFS}
    keys = [spec.file_key(fd.name) for fd in flags.FLAG_DEFS]
    assert len(set(keys)) == len(keys)
    assert spec.file_key("fail-on-init-error") == ("flags", "failOnInitError")
    assert spec.file_key("with-burnin") == ("tfd", "withBurnin")


@pytest.mark.parametrize("seed", range(12))
def test_cli_env_file_default_precedence_matches_the_twin(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    file_doc = {"version": "v1", "flags": {"tfd": {}}}
    cli, env, layers = {}, {}, {}
    for fd in flags.FLAG_DEFS:
        values = _FLAG_VALUES[fd.name]
        pick = lambda: values[int(rng.integers(len(values)))]  # noqa: E731
        section, key = spec.file_key(fd.name)
        where = file_doc["flags"] if section == "flags" else file_doc["flags"]["tfd"]
        layer = "default"
        if rng.random() < 0.6:
            where[key] = pick()
            layer = "file"
        if rng.random() < 0.3:
            env[fd.env_vars[0]] = _as_flag_string(pick())
            # An empty variable counts as unset, as in the twin.
            layer = "env" if env[fd.env_vars[0]] else layer
        if rng.random() < 0.3:
            cli[fd.name] = _as_flag_string(pick())
            layer = "cli"
        layers[fd.name] = layer
    path = tmp_path / "flags.yaml"
    path.write_text(yaml.safe_dump(file_doc, default_flow_style=bool(seed % 2)))
    port, twin = _both(cli, env, path)
    assert _same(port, twin)
    # The layer that set each flag is the one that wins.
    defaults = {fd.name: fd.default for fd in flags.FLAG_DEFS}
    for fd in flags.FLAG_DEFS:
        if layers[fd.name] == "cli":
            assert _same(port[fd.name], fd.parse(cli[fd.name])), fd.name
        elif layers[fd.name] == "env":
            assert _same(port[fd.name], fd.parse(env[fd.env_vars[0]])), fd.name
        elif layers[fd.name] == "default":
            assert _same(port[fd.name], defaults[fd.name]), fd.name


def test_yaml_11_booleans_reach_the_flags_as_the_twins_do(tmp_path):
    """``probeBroker: on`` is the boolean True, whose str() the twin then
    refuses as a probe-broker mode; ``withBurnin: yes`` is True."""
    path = tmp_path / "quirk.yaml"
    path.write_text("flags:\n  tfd:\n    probeBroker: on\n")
    for new_config in (flags.new_config, twin_flags.new_config):
        with pytest.raises(Exception, match="invalid probe-broker: 'True'"):
            new_config(config_file=str(path), environ={})
    path.write_text("flags:\n  tfd:\n    withBurnin: yes\n    metricsPort: 0x1F\n"
                    "    sleepInterval: 1:30\n    brokerMaxRequests: 017\n")
    port, twin = _both(path=path)
    assert _same(port, twin)
    assert (port["with-burnin"], port["metrics-port"], port["sleep-interval"],
            port["broker-max-requests"]) == (True, 31, 90.0, 15)


@pytest.mark.parametrize("name,text,want", [
    ("missing", None, "error opening config file"),
    ("bad", "flags: [1, 2\n", "unmarshal error"),
    ("v2", "version: v2\n", "unknown version: v2"),
    ("list", "- a\n- b\n", "config file must contain a mapping, got list"),
])
def test_error_texts_are_the_twins(tmp_path, name, text, want):
    path = tmp_path / f"{name}.yaml"
    if text is not None:
        path.write_text(text)
    for parse in (spec.parse_config_file, twin_spec.parse_config_file):
        with pytest.raises(Exception, match=want):
            parse(str(path))


def test_empty_and_json_files_read_as_the_twins_do(tmp_path):
    for name, text in (("empty", ""), ("comments", "# nothing\n"),
                       ("json", json.dumps({"version": "v1", "flags": {"tfd": {
                           "noTimestamp": True, "sleepInterval": "2s",
                           "backends": "mock-gpu:2,mock-cpu:3"}}}, indent=2))):
        path = tmp_path / f"{name}.yaml"
        path.write_text(text)
        port, twin = _both(path=path)
        assert _same(port, twin), name


# A value the twin accepts for each key the port refuses.
_UNPORTED_VALUES = {"libtpuPath": "/lib/libtpu.so", "pjrtCreateOptions": "a=b"}


def test_only_the_actuation_and_tpu_only_keys_are_refused():
    """The slice coordination and actuation keys are read since their
    slices were ported; what stays refused is the two keys that configure
    libtpu."""
    assert set(spec.UNPORTED_FILE_KEYS) == {
        ("flags", "libtpuPath"), ("flags", "pjrtCreateOptions"),
    }
    assert set(_UNPORTED_VALUES) == {key for _, key in spec.UNPORTED_FILE_KEYS}


@pytest.mark.parametrize("key,value", [
    ("actuation", "advise"), ("actuation", "enforce"), ("actuationWindow", 3),
    ("maxActuatedFraction", 0.5), ("maxActuatedFraction", "0.125"),
])
def test_actuation_keys_are_read_as_the_twins(tmp_path, key, value):
    path = tmp_path / "actuation.yaml"
    path.write_text(yaml.safe_dump({"flags": {"tfd": {key: value}}}))
    port, twin = _both(path=path)
    assert _same(port, twin)


@pytest.mark.parametrize("cli", [
    {"actuation": "bogus"}, {"actuation": "ENFORCE"}, {"actuation-window": "0"},
    {"actuation-window": "two"}, {"max-actuated-fraction": "1.5"},
    {"max-actuated-fraction": "0"},
])
def test_actuation_values_are_refused_with_the_twins_texts(cli):
    with pytest.raises(ConfigError) as port:
        flags.new_config(cli_values=cli, environ={})
    with pytest.raises(Exception) as twin:
        twin_flags.new_config(cli_values=cli, environ={})
    assert str(port.value) == str(twin.value)


@pytest.mark.parametrize("key,value", [
    ("sliceCoordination", "off"), ("peerTimeout", "2s"), ("peerFanout", 2),
    ("cohortSize", "auto"), ("peerToken", "tok"), ("pushNotify", "off"),
])
def test_slice_coordination_keys_are_read_as_the_twins(tmp_path, key, value):
    path = tmp_path / "slice.yaml"
    path.write_text(yaml.safe_dump({"flags": {"tfd": {key: value}}}))
    port, twin = _both(path=path)
    assert _same(port, twin)


@pytest.mark.parametrize("cli", [
    {"slice-coordination": "maybe"}, {"push-notify": "sometimes"},
    {"cohort-size": "-1"}, {"cohort-size": "big"}, {"peer-fanout": "-2"},
    {"peer-timeout": "soon"},
])
def test_slice_coordination_values_are_refused_with_the_twins_texts(cli):
    with pytest.raises(ConfigError) as port:
        flags.new_config(cli_values=cli, environ={})
    with pytest.raises(Exception) as twin:
        twin_flags.new_config(cli_values=cli, environ={})
    assert str(port.value) == str(twin.value)


@pytest.mark.parametrize("section,key", sorted(spec.UNPORTED_FILE_KEYS))
def test_twin_keys_of_unported_flags_are_refused_with_their_slice(tmp_path, section, key):
    path = tmp_path / "unported.yaml"
    value = _UNPORTED_VALUES[key]
    doc = {"flags": {key: value}} if section == "flags" else {"flags": {"tfd": {key: value}}}
    path.write_text(yaml.safe_dump(doc))
    with pytest.raises(ConfigError, match=rf"{key} is not ported yet; it comes with "):
        spec.parse_config_file(str(path))
    # The twin reads the key (a null carries nothing, so it passes here).
    twin_spec.parse_config_file(str(path))
    path.write_text(yaml.safe_dump({"flags": {key: None}} if section == "flags"
                                   else {"flags": {"tfd": {key: None}}}))
    assert spec.parse_config_file(str(path)).flags.tfd.backends is None


def test_config_round_trips_through_the_worker_frame(tmp_path):
    path = tmp_path / "shared.yaml"
    path.write_text(_shared_yaml())
    config = flags.new_config(config_file=str(path), environ={})
    wire = json.loads(json.dumps(spec.config_to_dict(config)))
    assert spec.config_from_dict(wire) == config
