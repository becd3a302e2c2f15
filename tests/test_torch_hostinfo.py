"""The host-info half of the port's interconnect labeler
(``hostinfo/gpu_env.py``, ``hostinfo/provider.py``,
``lm/interconnect.py``), held against the twin's ``hostinfo/tpu_env.py``
and ``lm/interconnect.py`` on the CPU.

Seeded mappings of the twin's unprefixed keys (``WORKER_ID``,
``WORKER_HOSTNAMES``, ``ACCELERATOR_TYPE``, ``TOPOLOGY``,
``CHIPS_PER_HOST_BOUNDS``, ``HOST_BOUNDS``, ``WRAP``, ``MACHINE_TYPE``)
go through both parsers, both providers and both labelers; the labels are
equal after the key translation ``google.com/tpu.`` -> ``nvidia.com/gpu.``.
Accelerator strings are never Cloud TPU types, where the twin consults a
table the port does not have (the one difference, pinned below). The
port never reads a ``TPU_*`` key, and ``TFD_HERMETIC`` blanks it.
"""

import logging

import numpy as np
import pytest

from gpu_feature_discovery_tpu.hostinfo import provider as twin_provider
from gpu_feature_discovery_tpu.hostinfo import tpu_env as twin_env
from gpu_feature_discovery_tpu.lm import interconnect as twin_interconnect
from gpu_feature_discovery_tpu_torch.cmd import main as port_main
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.hostinfo import gpu_env, provider
from gpu_feature_discovery_tpu_torch.lm import interconnect
from gpu_feature_discovery_tpu_torch.peering import worker_env

TPU, GPU = "google.com/tpu.", "nvidia.com/gpu."
# Free-form values a GPU deployment could set, sanitizer edge cases
# included; none is a Cloud TPU accelerator string.
_ACCEL = ["nvidia-h100-80gb", "A3-HIGHGPU-8G", "h100 sxm", "gpu/8", "", "  ", "é-100",
          "x" * 80, "b200_nvl"]
_MACHINE = ["a3-highgpu-8g", "PowerEdge XE9680", "", "??", "DGX H100 (custom)"]


def to_port(labels):
    return {(GPU + k[len(TPU):] if k.startswith(TPU) else k): v for k, v in labels.items()}


def _bounds(rng):
    n = int(rng.integers(1, 4))
    sep = "," if rng.random() < 0.7 else "x"
    dims = [str(int(rng.integers(0, 5))) for _ in range(n)]
    if rng.random() < 0.1:
        dims[0] = "two"
    return sep.join(dims)


def _mapping(rng):
    kv = {}
    if rng.random() < 0.8:
        kv["WORKER_ID"] = str(rng.choice(["0", "1", "3", "7", "-1", "x", " 2 "]))
    if rng.random() < 0.7:
        hosts = [f"10.0.0.{int(rng.integers(1, 6))}:{int(rng.integers(9000, 9003))}"
                 for _ in range(int(rng.integers(0, 6)))]
        kv["WORKER_HOSTNAMES"] = ", ".join(hosts) + ("," if rng.random() < 0.3 else "")
    if rng.random() < 0.6:
        kv["ACCELERATOR_TYPE"] = str(rng.choice(_ACCEL))
    if rng.random() < 0.4:
        kv["TOPOLOGY"] = str(rng.choice(["2x2x1", "4X4", "", "8", "1x1x1x1"]))
    if rng.random() < 0.5:
        kv["CHIPS_PER_HOST_BOUNDS"] = _bounds(rng)
    if rng.random() < 0.5:
        kv["HOST_BOUNDS"] = _bounds(rng)
    if rng.random() < 0.5:
        kv["WRAP"] = ",".join(str(rng.choice(["true", "false", "TRUE", " yes"]))
                              for _ in range(int(rng.integers(1, 4))))
    if rng.random() < 0.5:
        kv["MACHINE_TYPE"] = str(rng.choice(_MACHINE))
    if rng.random() < 0.3:
        kv["lowercase_key"] = "ignored"
    return kv


_FIELDS = ("accelerator_type", "topology", "worker_id", "worker_count", "worker_hostnames",
           "chips_per_host_bounds", "wrap")


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _warned(fn, kv):
    """(fn(kv), the warnings it logged on the tfd.hostinfo logger)."""
    handler = _Warnings()
    logger = logging.getLogger("tfd.hostinfo")
    logger.addHandler(handler)
    try:
        return fn(kv), handler.messages
    finally:
        logger.removeHandler(handler)


@pytest.mark.parametrize("seed", range(12))
def test_seeded_mappings_give_the_twins_host_info_and_labels(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        kv = _mapping(rng)
        port, port_warnings = _warned(gpu_env.host_info_from_mapping, kv)
        twin, twin_warnings = _warned(twin_env.host_info_from_mapping, kv)
        assert port_warnings == [w.replace("TPU_WORKER_HOSTNAMES", "WORKER_HOSTNAMES")
                                 for w in twin_warnings], kv
        for name in _FIELDS:
            assert getattr(port, name) == getattr(twin, name), (name, kv)
        assert port.multi_host == twin.multi_host, kv
        assert port.worker_count == twin.resolved_worker_count(), kv
        assert port.topology == twin.resolved_topology(), kv
        assert port.machine_type == twin.raw.get("MACHINE_TYPE", ""), kv
        assert dict(interconnect._host_info_labels(port)) == to_port(
            twin_interconnect._host_info_labels(twin)), kv
        # Through the providers and the labelers, as the daemon builds them.
        port_labels = interconnect.InterconnectLabeler(
            provider=provider.EnvMetadataProvider(kv)).labels()
        twin_labels = twin_interconnect.InterconnectLabeler(
            provider=twin_provider.EnvMetadataProvider(kv)).labels()
        assert dict(port_labels) == to_port(twin_labels), kv


def test_a_slice_member_publishes_the_twins_multihost_labels():
    kv = {"WORKER_HOSTNAMES": "h0:9101,h1:9101,h2:9101,h3:9101", "WORKER_ID": "2",
          "CHIPS_PER_HOST_BOUNDS": "2,2,1", "HOST_BOUNDS": "1,2,2", "WRAP": "true,false,true",
          "ACCELERATOR_TYPE": "nvidia-h100-80gb", "MACHINE_TYPE": "a3-highgpu-8g"}
    labels = dict(interconnect.InterconnectLabeler(
        provider=provider.EnvMetadataProvider(kv)).labels())
    assert labels == to_port(twin_interconnect.InterconnectLabeler(
        provider=twin_provider.EnvMetadataProvider(kv)).labels())
    assert labels == {
        GPU + "slice.accelerator-type": "nvidia-h100-80gb",
        GPU + "slice.topology": "2x4x2",
        GPU + "multihost.present": "true",
        GPU + "multihost.worker-id": "2",
        GPU + "multihost.worker-count": "4",
        GPU + "multihost.chips-per-host": "2x2x1",
        GPU + "ici.wrap.x": "true", GPU + "ici.wrap.y": "false", GPU + "ici.wrap.z": "true",
        GPU + "machine": "a3-highgpu-8g",
    }


def test_pci_and_host_halves_merge_as_in_the_twin():
    from gpu_feature_discovery_tpu_torch.pci.pciutil import MockNvidiaPCI

    kv = {"WORKER_ID": "0", "WORKER_HOSTNAMES": "a,b"}
    labels = interconnect.InterconnectLabeler(
        pci=MockNvidiaPCI(), provider=provider.StaticProvider(
            gpu_env.host_info_from_mapping(kv))).labels()
    assert labels[GPU + "pci.count"] == "2"
    assert labels[GPU + "multihost.worker-count"] == "2"
    assert interconnect.InterconnectLabeler(provider=provider.StaticProvider(None)).labels() == {}


def test_the_provider_needs_a_slice_fact_as_the_twins_does():
    for kv in ({}, {"WORKER_HOSTNAMES": "a,b"}, {"WRAP": "true"}, {"MACHINE_TYPE": "m"},
               {"WORKER_ID": "x"}, {"WORKER_ID": "0"}, {"TOPOLOGY": "2x2"}):
        port = provider.EnvMetadataProvider(kv).host_info()
        twin = twin_provider.EnvMetadataProvider(kv).host_info()
        assert (port is None) == (twin is None), kv


def test_a_cloud_tpu_string_is_not_looked_up():
    """The twin derives the worker count, topology and multi-host from its
    Cloud TPU table; the port has none and publishes the string alone."""
    kv = {"ACCELERATOR_TYPE": "v5p-64"}
    port = dict(interconnect._host_info_labels(gpu_env.host_info_from_mapping(kv)))
    twin = to_port(twin_interconnect._host_info_labels(twin_env.host_info_from_mapping(kv)))
    assert port == {GPU + "slice.accelerator-type": "v5p-64",
                    GPU + "multihost.present": "false"}
    assert twin[GPU + "multihost.present"] == "true" and GPU + "slice.topology" in twin


@pytest.mark.parametrize("seed", range(4))
def test_tpu_keys_are_never_read(seed):
    rng = np.random.default_rng(100 + seed)
    kv = _mapping(rng)
    prefixed = {"TPU_WORKER_ID": "5", "TPU_WORKER_HOSTNAMES": "p,q,r,s,t,u",
                "TPU_ACCELERATOR_TYPE": "v5p-64", "TPU_TOPOLOGY": "4x4x4",
                "TPU_CHIPS_PER_PROCESS_BOUNDS": "2,2,1", "TPU_PROCESS_BOUNDS": "2,2,2",
                "TPU_TOPOLOGY_WRAP": "true,true,true", "TPU_HOST_BOUNDS": "1,1,8",
                "TPU_CHIPS_PER_HOST_BOUNDS": "1,1,1", "AGENT_WORKER_NUMBER": "3"}
    with_tpu = {**prefixed, **kv}
    port = gpu_env.host_info_from_mapping(with_tpu)
    alone = gpu_env.host_info_from_mapping(kv)
    for name in _FIELDS:
        assert getattr(port, name) == getattr(alone, name), name
    assert provider.EnvMetadataProvider(prefixed).host_info() is None
    # The twin reads them.
    assert twin_provider.EnvMetadataProvider(prefixed).host_info() is not None


def test_the_daemons_labeler_reads_the_environment_unless_hermetic(monkeypatch):
    monkeypatch.setenv("WORKER_HOSTNAMES", "127.0.0.1:1,127.0.0.1:2,127.0.0.1:3")
    monkeypatch.setenv("WORKER_ID", "1")
    monkeypatch.setenv("TPU_WORKER_ID", "2")
    monkeypatch.delenv("TFD_MOCK_PCI", raising=False)
    monkeypatch.delenv("TFD_HERMETIC", raising=False)
    config = new_config({}, environ={})
    labels = dict(port_main.new_interconnect_labeler(config).labels())
    assert {k: v for k, v in labels.items() if k.startswith(GPU + "multihost.")} == {
        GPU + "multihost.present": "true", GPU + "multihost.worker-id": "1",
        GPU + "multihost.worker-count": "3"}
    monkeypatch.setenv("TFD_HERMETIC", "1")
    assert not any(k.startswith(GPU + "multihost.")
                   for k in port_main.new_interconnect_labeler(config).labels())
    monkeypatch.setenv("TFD_HERMETIC", "maybe")
    with pytest.raises(ConfigError, match="TFD_HERMETIC"):
        port_main.new_interconnect_labeler(config)


def test_the_peer_list_shares_the_hostname_parser():
    assert worker_env.parse_worker_hostnames is gpu_env.parse_worker_hostnames
    raw = " a:1, b:2 ,,a:1, c:3 "
    assert gpu_env.parse_worker_hostnames(raw) == twin_env.parse_worker_hostnames(raw) == [
        "a:1", "b:2", "c:3"]
    env = {"WORKER_HOSTNAMES": raw, "WORKER_ID": "2"}
    assert worker_env.worker_env_from_mapping(env).worker_hostnames == \
        gpu_env.host_info_from_mapping(env).worker_hostnames
