"""The twin's mechanical precedence sweep (``tests/test_flag_precedence.py``)
held against the port: CLI > env > file > default for EVERY flag of the
port's ``config/flags.py`` ``FLAG_DEFS``, the file read by
``config/spec.py`` over ``config/yaml_subset.py`` (not pyyaml). Each case
also resolves the same layers through the twin's ``new_config`` and wants
the same parsed value; the twin's two TPU-only flags (``libtpu-path``,
``pjrt-create-options``) have no port flag. ``--backends`` values are
translated (the twin's ``tpu`` family token is the port's ``gpu``)."""

import pytest
import yaml

from gpu_feature_discovery_tpu.config.flags import FLAG_DEFS as TWIN_FLAG_DEFS
from gpu_feature_discovery_tpu.config.flags import new_config as twin_new_config
from gpu_feature_discovery_tpu_torch.config.flags import FLAG_DEFS, new_config
from gpu_feature_discovery_tpu_torch.config.spec import file_key

TWIN = {fd.name: fd for fd in TWIN_FLAG_DEFS}

# flag name -> (config-file section, camelCase key): the twin's map less
# its two TPU-only flags. test_every_flag_is_mapped makes forgetting a
# new flag a failure.
FILE_KEYS = {
    "tpu-topology-strategy": ("flags", "tpuTopologyStrategy"),
    "fail-on-init-error": ("flags", "failOnInitError"),
    "native-enumeration": ("flags", "nativeEnumeration"),
    "oneshot": ("tfd", "oneshot"),
    "no-timestamp": ("tfd", "noTimestamp"),
    "sleep-interval": ("tfd", "sleepInterval"),
    "output-file": ("tfd", "outputFile"),
    "with-burnin": ("tfd", "withBurnin"),
    "burnin-interval": ("tfd", "burninInterval"),
    "machine-type-file": ("tfd", "machineTypeFile"),
    "parallel-labelers": ("tfd", "parallelLabelers"),
    "labeler-timeout": ("tfd", "labelerTimeout"),
    "timings-file": ("tfd", "timingsFile"),
    "init-retries": ("tfd", "initRetries"),
    "init-backoff-max": ("tfd", "initBackoffMax"),
    "max-consecutive-failures": ("tfd", "maxConsecutiveFailures"),
    "heartbeat-file": ("tfd", "heartbeatFile"),
    "metrics-addr": ("tfd", "metricsAddr"),
    "metrics-port": ("tfd", "metricsPort"),
    "debug-endpoints": ("tfd", "debugEndpoints"),
    "probe-timeout": ("tfd", "probeTimeout"),
    "probe-isolation": ("tfd", "probeIsolation"),
    "state-dir": ("tfd", "stateDir"),
    "flap-window": ("tfd", "flapWindow"),
    "probe-broker": ("tfd", "probeBroker"),
    "broker-max-requests": ("tfd", "brokerMaxRequests"),
    "compilation-cache-dir": ("tfd", "compilationCacheDir"),
    "chip-probes": ("tfd", "chipProbes"),
    "straggler-threshold": ("tfd", "stragglerThreshold"),
    "slice-coordination": ("tfd", "sliceCoordination"),
    "peer-timeout": ("tfd", "peerTimeout"),
    "peer-fanout": ("tfd", "peerFanout"),
    "cohort-size": ("tfd", "cohortSize"),
    "backends": ("tfd", "backends"),
    "reconcile": ("tfd", "reconcile"),
    "push-notify": ("tfd", "pushNotify"),
    "max-staleness": ("tfd", "maxStaleness"),
    "reconcile-debounce": ("tfd", "reconcileDebounce"),
    "max-probe-rate": ("tfd", "maxProbeRate"),
    "probe-token": ("tfd", "probeToken"),
    "peer-token": ("tfd", "peerToken"),
    "actuation": ("tfd", "actuation"),
    "actuation-window": ("tfd", "actuationWindow"),
    "max-actuated-fraction": ("tfd", "maxActuatedFraction"),
}

# Two distinct valid raw values per flag (a wins the dominance checks):
# the twin's pairs, ``backends`` in the port's tokens.
VALUE_PAIRS = {
    "tpu-topology-strategy": ("single", "mixed"),
    "sleep-interval": ("30s", "45s"),
    "burnin-interval": ("3", "7"),
    "labeler-timeout": ("2s", "5s"),
    "init-retries": ("3", "7"),
    "init-backoff-max": ("2s", "5s"),
    "max-consecutive-failures": ("2", "4"),
    "metrics-port": ("9200", "9300"),
    "probe-timeout": ("5s", "8s"),
    "probe-isolation": ("none", "subprocess"),
    "flap-window": ("2", "4"),
    "probe-broker": ("on", "off"),
    "broker-max-requests": ("5", "9"),
    "straggler-threshold": ("0.3", "0.7"),
    "slice-coordination": ("on", "off"),
    "peer-timeout": ("1s", "3s"),
    "peer-fanout": ("2", "4"),
    "cohort-size": ("16", "auto"),
    "backends": ("gpu,cpu", "cpu"),
    "reconcile": ("interval", "event"),
    "push-notify": ("on", "off"),
    "max-staleness": ("30s", "45s"),
    "reconcile-debounce": ("0.2s", "0.4s"),
    "max-probe-rate": ("2", "4"),
    "actuation": ("advise", "enforce"),
    "actuation-window": ("3", "5"),
    "max-actuated-fraction": ("0.5", "0.75"),
}


def _twin_raw(name, raw):
    return raw.replace("gpu", "tpu") if name == "backends" else raw


def _get(fd, config):
    return getattr(config.flags if fd.on_flags else config.flags.tfd, fd.attr)


def _pair(fd):
    """(a, b), a != b and a != the default, so no check passes by falling
    through to the default."""
    if fd.name in VALUE_PAIRS:
        a, b = VALUE_PAIRS[fd.name]
    elif fd.parse is str:
        a, b = ("/value-a", "/value-b")
    else:
        a, b = ("false", "true") if fd.default is True else ("true", "false")
    assert fd.parse(a) != fd.default, fd.name
    return a, b


def _file_config(tmp_path, fd, raw, twin=False):
    section, key = FILE_KEYS[fd.name]
    value = yaml.safe_load(raw) if raw in ("true", "false") else raw
    if twin:
        value = _twin_raw(fd.name, value) if isinstance(value, str) else value
    doc = {"version": "v1", "flags": {}}
    if section == "flags":
        doc["flags"][key] = value
    else:
        doc["flags"]["tfd"] = {key: value}
    path = tmp_path / f"{fd.name}{'-twin' if twin else ''}.yaml"
    path.write_text(yaml.safe_dump(doc))
    return str(path)


def _same_as_twin(fd, port_value, **layers):
    """The twin resolves the same layers to the same value (the
    ``--backends`` token translated)."""
    twin_fd = TWIN[fd.name]
    twin_value = twin_fd.getter(twin_new_config(**layers))
    if fd.name == "backends":
        twin_value = twin_value.replace("tpu", "gpu")
    assert port_value == twin_value


def test_every_flag_is_mapped():
    assert {fd.name for fd in FLAG_DEFS} == set(FILE_KEYS)
    assert set(TWIN) - set(FILE_KEYS) == {"libtpu-path", "pjrt-create-options"}
    assert all(file_key(name) == where for name, where in FILE_KEYS.items())


@pytest.mark.parametrize("fd", FLAG_DEFS, ids=lambda fd: fd.name)
def test_cli_beats_env(fd):
    a, b = _pair(fd)
    value = _get(fd, new_config(cli_values={fd.name: a}, environ={fd.env_vars[0]: b}))
    assert value == fd.parse(a)
    twin_env = TWIN[fd.name].env_vars[0]
    _same_as_twin(fd, value, cli_values={fd.name: _twin_raw(fd.name, a)},
                  environ={twin_env: _twin_raw(fd.name, b)})


@pytest.mark.parametrize(
    "fd,alias",
    [(fd, env) for fd in FLAG_DEFS for env in fd.env_vars],
    ids=lambda v: v if isinstance(v, str) else v.name,
)
def test_env_beats_file(fd, alias, tmp_path):
    """Every alias carries the layer on its own."""
    a, b = _pair(fd)
    value = _get(fd, new_config(cli_values={}, environ={alias: a},
                                config_file=_file_config(tmp_path, fd, b)))
    assert value == fd.parse(a)
    twin_alias = alias if alias in TWIN[fd.name].env_vars else TWIN[fd.name].env_vars[0]
    _same_as_twin(fd, value, cli_values={}, environ={twin_alias: _twin_raw(fd.name, a)},
                  config_file=_file_config(tmp_path, fd, b, twin=True))


@pytest.mark.parametrize("fd", FLAG_DEFS, ids=lambda fd: fd.name)
def test_file_beats_default(fd, tmp_path):
    a, _ = _pair(fd)
    value = _get(fd, new_config(cli_values={}, environ={},
                                config_file=_file_config(tmp_path, fd, a)))
    assert value == fd.parse(a)
    _same_as_twin(fd, value, cli_values={}, environ={},
                  config_file=_file_config(tmp_path, fd, a, twin=True))
