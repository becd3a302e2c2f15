"""The twin and the port side by side for the health tiers
(``tests/test_torch_health.py``, ``tests/test_torch_chip_health.py``): each
``_Side`` names one package's health module, probe module, config
constructor, mocks, device acquisition hook and metrics, so a case can
run the same cycles in both and compare the translated labels."""

import torch

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm import health as twin_health
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.ops import healthcheck as twin_ops
from gpu_feature_discovery_tpu.resource import testing as twin_testing
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.obs import metrics as port_metrics
from gpu_feature_discovery_tpu_torch.ops import healthcheck as port_ops
from gpu_feature_discovery_tpu_torch.resource import testing as port_testing

# The twin's v5e spec row; a case that reads spec peaks gives both sides
# these, so one report meets one bound.
V5E_PEAKS = (197.0, 819.0)
PROBE_MS = health.HEALTH_PROBE_MS


def translated(labels):
    return {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
            for k, v in dict(labels).items()}


class _Side:
    def __init__(self, name, mod, ops, conf, testing, chip, acquire, devices, metrics):
        self.name, self.mod, self.ops, self.conf = name, mod, ops, conf
        self.testing, self.chip, self.acquire_attr = testing, chip, acquire
        self.devices, self.metrics = devices, metrics

    def cfg(self, **cli):
        return self.conf(cli_values=cli, environ={}, config_file=None)

    def manager(self, n=1, cls=None):
        return (cls or self.testing.MockManager)(chips=[self.chip() for _ in range(n)])

    def labels(self, manager, config):
        """The translated labels; ``health.probe-ms``, a wall time that
        differs run to run, reads "measured" where it is published."""
        labels = translated(self.mod.new_health_labeler(manager, config).labels())
        if PROBE_MS in labels:
            labels[PROBE_MS] = "measured"
        return labels

    def pretend_devices(self, monkeypatch):
        monkeypatch.setattr(self.mod, self.acquire_attr, self.devices)

    def counting_measure(self, monkeypatch, report=None):
        calls = {"n": 0}

        def fake_measure(**kw):
            calls["n"] += 1
            return dict(report or {"healthy": True, "tflops": 10.0, "hbm_gbps": None,
                                   "ici_ok": None})

        monkeypatch.setattr(self.ops, "measure_node_health", fake_measure)
        return calls


SIDES = [
    _Side("twin", twin_health, twin_ops, twin_new_config, twin_testing,
          lambda: twin_testing.MockChip(family="v5e"), "_acquire_tpu_devices",
          lambda: __import__("jax").local_devices(), twin_metrics),
    _Side("port", health, port_ops, new_config, port_testing,
          lambda: port_testing.MockChip(name="NVIDIA H100 80GB HBM3"), "_acquire_devices",
          lambda: [torch.device("cpu")], port_metrics),
]
