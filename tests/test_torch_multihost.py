"""The twin's multi-host consistency tier (``tests/test_multihost.py``)
held against the port: every worker of a slice emits the same
slice-global labels from its own environment alone. The twin reads a
v5p-64 worker's ``tpu-env`` (``TPU_PROCESS_BOUNDS``, ...); the port reads
the unprefixed ``WORKER_*`` family of ``hostinfo/gpu_env.py`` carrying the
same facts, and ``lm/interconnect.py`` must publish the twin's labels key
for key (``google.com/tpu.`` -> ``nvidia.com/gpu.``), value for value."""

import jax
import pytest
import torch

from gpu_feature_discovery_tpu.hostinfo.provider import StaticProvider as TwinStatic
from gpu_feature_discovery_tpu.hostinfo.tpu_env import host_info_from_mapping as twin_info
from gpu_feature_discovery_tpu.hostinfo.tpu_env import parse_tpu_env
from gpu_feature_discovery_tpu.lm.interconnect import InterconnectLabeler as TwinInterconnect
from gpu_feature_discovery_tpu.ops import healthcheck as twin_healthcheck
from gpu_feature_discovery_tpu_torch.hostinfo.gpu_env import host_info_from_mapping
from gpu_feature_discovery_tpu_torch.hostinfo.provider import StaticProvider
from gpu_feature_discovery_tpu_torch.lm.interconnect import WORKER_ID, InterconnectLabeler
from gpu_feature_discovery_tpu_torch.ops import healthcheck

V5P_64_ENV = """\
ACCELERATOR_TYPE: 'v5p-64'
TPU_PROCESS_BOUNDS: '2,2,2'
TPU_CHIPS_PER_PROCESS_BOUNDS: '2,2,1'
TPU_TOPOLOGY_WRAP: 'true,true,true'
WORKER_ID: '{worker}'
"""


def _port_env(worker):
    return {"ACCELERATOR_TYPE": "v5p-64", "HOST_BOUNDS": "2,2,2",
            "CHIPS_PER_HOST_BOUNDS": "2,2,1", "WRAP": "true,true,true",
            "WORKER_ID": str(worker)}


def worker_labels(worker):
    return dict(InterconnectLabeler(
        provider=StaticProvider(host_info_from_mapping(_port_env(worker)))).labels())


def twin_worker_labels(worker):
    info = twin_info(parse_tpu_env(V5P_64_ENV.format(worker=worker)))
    return {k.replace("google.com/tpu.", "nvidia.com/gpu."): v
            for k, v in TwinInterconnect(provider=TwinStatic(info)).labels().items()}


@pytest.mark.parametrize("worker", range(8))
def test_each_worker_publishes_the_twins_labels(worker):
    assert worker_labels(worker) == twin_worker_labels(worker)


def test_all_workers_agree_on_slice_global_labels():
    globals_per_worker = [
        {k: v for k, v in worker_labels(w).items() if k != WORKER_ID} for w in range(8)
    ]
    assert all(g == globals_per_worker[0] for g in globals_per_worker[1:])


def test_worker_ids_are_unique_and_local():
    assert [worker_labels(w)[WORKER_ID] for w in range(8)] == [str(w) for w in range(8)]


def test_slice_topology_derived_from_bounds():
    labels = worker_labels(0)
    assert labels["nvidia.com/gpu.slice.topology"] == "4x4x2"
    assert labels["nvidia.com/gpu.multihost.worker-count"] == "8"
    assert labels["nvidia.com/gpu.multihost.chips-per-host"] == "2x2x1"


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_wrap_labels_all_axes(axis):
    assert worker_labels(0)[f"nvidia.com/gpu.ici.wrap.{axis}"] == "true"


def test_node_health_reports_ici_on_multichip_mesh():
    """The twin rings its 8 CPU devices; the port rings 8 CPU device
    entries with peer copies (on the card, the GPUs of the node)."""
    want = twin_healthcheck.measure_node_health(size=128, depth=2, iters=1, ici=True,
                                                devices=jax.local_devices())
    got = healthcheck.measure_node_health(size=128, depth=2, iters=1, ici=True,
                                          devices=[torch.device("cpu")] * 8)
    assert got["ici_ok"] is want["ici_ok"] is True
    assert got["chips"] == want["chips"] == 8
