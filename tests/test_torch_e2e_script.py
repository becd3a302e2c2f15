"""Tier 4 of the PyTorch port, hermetic: tests/torch-e2e-tests.py against
the twin's fake API server (tests/test_e2e_script.py ``FakeKubeApi``).

    the port's daemon (oneshot, mock backend, subprocess)
        -> features.d/tfd                         (the real product output)
    FakeKubeApi
        -> once the port's DaemonSet or Job is POSTed, folds the features
           file into its Node's labels and emits MODIFIED, as nfd-worker
           and nfd-master do
    tests/torch-e2e-tests.py (subprocess, tests/k8s_stdlib.py)
        -> deploys tests/nfd.yaml and the port's manifest, watches, holds
           the Node's labels to the port's golden

The card machine has no API server and no pyyaml, so this tier runs here
only."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_e2e_script import NODE_NAME, FakeKubeApi, write_kubeconfig

HERE = Path(__file__).parent
REPO = HERE.parent
SCRIPT = HERE / "torch-e2e-tests.py"
STATIC = REPO / "deployments" / "torch" / "static"
WORKLOAD = "gpu-feature-discovery-torch"
# The host keys of two workers of one slice (hostinfo/gpu_env.py).
SLICE_HOSTENV = {"ACCELERATOR_TYPE": "h100-32", "HOST_BOUNDS": "2,1,1",
                 "CHIPS_PER_HOST_BOUNDS": "2,2,2", "WRAP": "true,false,false",
                 "WORKER_HOSTNAMES": "w0,w1"}


class _Created(list):
    """FakeKubeApi's record of created objects, which also marks the
    port's workload deployed: the fake's own mark matches the twin's
    workload name only."""

    def __init__(self, deployed):
        super().__init__()
        self._deployed = deployed

    def append(self, item):
        super().append(item)
        _, kind, name = item
        if kind in ("DaemonSet", "Job") and WORKLOAD in name:
            self._deployed.set()


def fake_api(features):
    api = FakeKubeApi(features)
    api.created = _Created(api.tfd_deployed)
    return api


def port_oneshot(features_file, backend, strategy="none", hostenv=None):
    """The port's daemon, as its DaemonSet's container produces the
    features file: hermetic unless host keys are given, and then over
    synthesized NVIDIA PCI functions, as tests/torch-integration-tests.py
    runs a mock backend."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TFD_")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if hostenv:
        env.update(hostenv, TFD_MOCK_PCI="1")
    else:
        env["TFD_HERMETIC"] = "1"
    subprocess.run(
        [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--oneshot",
         "--backends", backend, "--tpu-topology-strategy", strategy,
         "--output-file", str(features_file)],
        check=True, capture_output=True, timeout=120, env=env)


def run_e2e(kubeconfig, manifest, golden, watch_timeout="10", extra_args=()):
    env = dict(os.environ, KUBECONFIG=kubeconfig, TFD_E2E_WATCH_TIMEOUT_S=watch_timeout)
    return subprocess.run(
        [sys.executable, str(SCRIPT), str(manifest), str(HERE / "nfd.yaml"),
         str(HERE / golden), *extra_args],
        capture_output=True, text=True, timeout=180, env=env)


def job_manifest(tmp_path):
    text = (STATIC / "gpu-feature-discovery-torch-job.yaml.template").read_text()
    path = tmp_path / "gpu-feature-discovery-torch-job.yaml"
    path.write_text(text.replace("NODE_NAME", NODE_NAME))
    return path


NFD_ROUTES = {
    ("/api/v1/namespaces", "Namespace"),
    ("/apis/rbac.authorization.k8s.io/v1/clusterroles", "ClusterRole"),
    ("/apis/rbac.authorization.k8s.io/v1/clusterrolebindings", "ClusterRoleBinding"),
    ("/apis/apps/v1/namespaces/node-feature-discovery/deployments", "Deployment"),
    ("/apis/apiextensions.k8s.io/v1/customresourcedefinitions", "CustomResourceDefinition"),
    ("/apis/rbac.authorization.k8s.io/v1/namespaces/node-feature-discovery/roles", "Role"),
    ("/apis/rbac.authorization.k8s.io/v1/namespaces/node-feature-discovery/rolebindings",
     "RoleBinding"),
}
DAEMONSETS = "/apis/apps/v1/namespaces/node-feature-discovery/daemonsets"
JOBS = "/apis/batch/v1/namespaces/node-feature-discovery/jobs"


@pytest.mark.parametrize(
    "manifest,backend,strategy,golden",
    [
        ("gpu-feature-discovery-torch-daemonset.yaml", "mock-nvml:none", "none",
         "torch-expected-output-h100x2.txt"),
        ("gpu-feature-discovery-torch-daemonset-with-mig-single.yaml", "mock-nvml:single",
         "single", "torch-expected-output-mig-single.txt"),
        ("gpu-feature-discovery-torch-daemonset-with-mig-mixed.yaml", "mock-nvml:mixed",
         "mixed", "torch-expected-output-mig-mixed.txt"),
        ("JOB", "mock-nvml:none", "none", "torch-expected-output-h100x2.txt"),
    ],
    ids=["daemonset", "mig-single", "mig-mixed", "oneshot-job"],
)
def test_e2e_script_deploys_the_port_and_the_node_matches_its_golden(
        tmp_path, manifest, backend, strategy, golden):
    features = tmp_path / "features.d" / "tfd"
    features.parent.mkdir()
    port_oneshot(features, backend, strategy)
    path = job_manifest(tmp_path) if manifest == "JOB" else STATIC / manifest
    api = fake_api(features)
    try:
        result = run_e2e(write_kubeconfig(tmp_path, api.url), path, golden)
        assert result.returncode == 0, f"stdout:\n{result.stdout}\nstderr:\n{result.stderr}"
        assert f"Timestamp label found on {NODE_NAME}" in result.stdout
        assert "E2E tests done" in result.stdout
        posted = {(p, kind) for p, kind, _ in api.created}
        assert NFD_ROUTES <= posted
        port_workloads = [(p, kind) for p, kind, name in api.created if name == WORKLOAD]
        if manifest == "JOB":
            assert port_workloads == [(JOBS, "Job")]
        else:
            assert port_workloads == [(DAEMONSETS, "DaemonSet")]
        # NFD's worker is the one other DaemonSet.
        assert [name for p, kind, name in api.created if kind == "DaemonSet"
                and name != WORKLOAD] == ["nfd-worker"]
        # What the Node carries is the port's own file, line for line.
        lines = {l for l in features.read_text().splitlines() if l}
        node = {f"{k}={v}" for k, v in api.node_labels[NODE_NAME].items()}
        assert lines <= node and node - lines == {f"kubernetes.io/hostname={NODE_NAME}"}
    finally:
        api.shutdown()


def test_e2e_script_fails_when_the_label_never_lands(tmp_path):
    api = fake_api(tmp_path / "never-written")
    try:
        result = run_e2e(write_kubeconfig(tmp_path, api.url),
                         STATIC / "gpu-feature-discovery-torch-daemonset.yaml",
                         "torch-expected-output-h100x2.txt", watch_timeout="3")
        assert result.returncode == 1
        assert "Timestamp label appeared on 0/1 nodes" in result.stderr
    finally:
        api.shutdown()


def test_e2e_script_fails_on_a_label_the_golden_lacks(tmp_path):
    """The MIG node's labels against the plain node's golden: every
    mig-<profile> line is unexpected."""
    features = tmp_path / "features.d" / "tfd"
    features.parent.mkdir()
    port_oneshot(features, "mock-nvml:mixed", "mixed")
    api = fake_api(features)
    try:
        result = run_e2e(write_kubeconfig(tmp_path, api.url),
                         STATIC / "gpu-feature-discovery-torch-daemonset.yaml",
                         "torch-expected-output-h100x2.txt")
        assert result.returncode == 1
        assert "Unexpected label: nvidia.com/mig-3g.40gb.count=2" in result.stderr
        assert f"E2E tests failed on {NODE_NAME}" in result.stderr
    finally:
        api.shutdown()


def _two_workers(tmp_path, worker_ids):
    files = {}
    for i, worker_id in enumerate(worker_ids):
        path = tmp_path / f"node-{i}" / "tfd"
        path.parent.mkdir()
        port_oneshot(path, "mock-gpu:8", hostenv=dict(SLICE_HOSTENV, WORKER_ID=str(worker_id)))
        files[f"gpu-node-{i}"] = path
    return files


def test_e2e_slice_consistency_over_two_port_workers(tmp_path):
    api = fake_api(_two_workers(tmp_path, (0, 1)))
    try:
        result = run_e2e(write_kubeconfig(tmp_path, api.url),
                         STATIC / "gpu-feature-discovery-torch-daemonset.yaml",
                         "torch-expected-output-two-worker.txt",
                         extra_args=("--slice-consistency", "2"))
        assert result.returncode == 0, f"stdout:\n{result.stdout}\nstderr:\n{result.stderr}"
        assert "Slice consistency OK across 2 nodes" in result.stdout
        assert "worker ids ['0', '1']" in result.stdout
        ids = {n: ls["nvidia.com/gpu.multihost.worker-id"] for n, ls in api.node_labels.items()}
        assert ids == {"gpu-node-0": "0", "gpu-node-1": "1"}
    finally:
        api.shutdown()


def test_e2e_slice_consistency_fails_on_a_duplicate_worker_id(tmp_path):
    api = fake_api(_two_workers(tmp_path, (0, 0)))
    try:
        result = run_e2e(write_kubeconfig(tmp_path, api.url),
                         STATIC / "gpu-feature-discovery-torch-daemonset.yaml",
                         "torch-expected-output-two-worker.txt",
                         extra_args=("--slice-consistency", "2"))
        assert result.returncode == 1
        assert "worker-id labels missing or not distinct" in result.stderr
        assert "E2E tests failed" in result.stderr
    finally:
        api.shutdown()


def _load_script():
    spec = importlib.util.spec_from_file_location("torch_e2e_tests", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_check_slice_consistency_logic():
    mod = _load_script()
    w0 = {"nvidia.com/gpu.multihost.worker-id": "0",
          "nvidia.com/gpu.multihost.worker-count": "2",
          "nvidia.com/gpu.slice.topology": "4x2x2",
          "nvidia.com/gpu.ici.wrap.x": "true",
          "google.com/tfd.timestamp": "111"}  # worker-local: may differ
    w1 = dict(w0, **{"nvidia.com/gpu.multihost.worker-id": "1",
                     "google.com/tfd.timestamp": "222"})
    assert mod.check_slice_consistency({"n1": w0, "n2": w1})
    for key, value in (("nvidia.com/gpu.slice.topology", "8x2x2"),
                       ("nvidia.com/gpu.multihost.worker-count", "3"),
                       ("nvidia.com/gpu.ici.wrap.x", "false")):
        assert not mod.check_slice_consistency({"n1": w0, "n2": dict(w1, **{key: value})})
    assert not mod.check_slice_consistency({"n1": w0, "n2": dict(w0)})
    no_id = {k: v for k, v in w1.items() if k != "nvidia.com/gpu.multihost.worker-id"}
    assert not mod.check_slice_consistency({"n1": w0, "n2": no_id})
    # The twin's TPU families are no slice-global view of the port's.
    assert not mod.check_slice_consistency({
        "n1": {"nvidia.com/gpu.multihost.worker-id": "0", "google.com/tpu.slice.chips": "8"},
        "n2": {"nvidia.com/gpu.multihost.worker-id": "1", "google.com/tpu.slice.chips": "8"}})
