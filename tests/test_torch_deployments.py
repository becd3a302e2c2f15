"""The deployment layer of the PyTorch/CUDA port (deployments/torch/): its
image, static manifests and chart, against the port's flag surface, the
JAX package's chart they were translated from, and the way chip_smoke.py
runs them on the card.

The manifests are read with both yaml.safe_load and the port's own
parser (config/yaml_subset.py; the card machine has no pyyaml), the chart
is rendered with tests/helm_lite.py, and the static DaemonSet and Job run
here on the CPU through chip_smoke.py's kubelet stand-in, with mock
devices.
"""

import filecmp
import os
import re
import socket
import sys
import tempfile
import time

import pytest
import yaml

from helm_lite import HelmFail, render_chart

from gpu_feature_discovery_tpu_torch.cmd.fleet import FLEET_FLAG_DEFS
from gpu_feature_discovery_tpu_torch.config import yaml_subset
from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_OUTPUT_FILE, FLAG_DEFS
from gpu_feature_discovery_tpu_torch.info.version import DEFAULT_VERSION

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

DEPLOY = os.path.join(REPO, "deployments", "torch")
STATIC = os.path.join(DEPLOY, "static")
CHART = os.path.join(DEPLOY, "helm", "gpu-feature-discovery-torch")
TWIN_CHART = os.path.join(REPO, "deployments", "helm", "tpu-feature-discovery")
DOCKERFILE = os.path.join(DEPLOY, "container", "Dockerfile")

DAEMONSET = "gpu-feature-discovery-torch-daemonset.yaml"
MIG_VARIANTS = {s: f"gpu-feature-discovery-torch-daemonset-with-mig-{s}.yaml"
                for s in ("single", "mixed")}
JOB = "gpu-feature-discovery-torch-job.yaml.template"
STATIC_FILES = [DAEMONSET, *MIG_VARIANTS.values(), JOB]
DAEMONSETS = [DAEMONSET, *MIG_VARIANTS.values()]

DAEMON_ENV = {e for fd in FLAG_DEFS for e in fd.env_vars}
COLLECTOR_ENV = {e for fd in FLEET_FLAG_DEFS for e in fd.env_vars}
# The NVIDIA container runtime's own variables, which the image or a MIG
# variant sets; the daemon reads none of them.
NVIDIA_RUNTIME_ENV = {"NVIDIA_VISIBLE_DEVICES", "NVIDIA_DRIVER_CAPABILITIES",
                      "NVIDIA_MIG_MONITOR_DEVICES"}
FEATURES_D = os.path.dirname(DEFAULT_OUTPUT_FILE)
GPU_TAINT = "nvidia.com/gpu"
GPU_NODE_KEYS = {"feature.node.kubernetes.io/pci-10de.present", "nvidia.com/gpu.present"}
IMAGE_KERNEL_DIR = chip_smoke.image_env(DOCKERFILE)["TFD_COMPILATION_CACHE_DIR"]


def _static(name):
    with open(os.path.join(STATIC, name)) as f:
        return yaml.safe_load(f)


def _pod_spec(doc):
    return doc["spec"]["template"]["spec"]


def _env(container):
    return {e["name"]: e.get("value") for e in container.get("env", [])}


def _render(overrides=None):
    return render_chart(CHART, values_overrides=overrides)


def _daemonset(docs):
    (ds,) = [d for d in docs if d.get("kind") == "DaemonSet"
             and d["metadata"]["name"].endswith("gpu-feature-discovery-torch")]
    return ds


def _collectors(docs):
    return [d for d in docs if d.get("kind") == "Deployment"
            and d["metadata"]["labels"].get("app.kubernetes.io/component", "").startswith("fleet-")]


def _node_affinity_keys(spec):
    terms = spec["affinity"]["nodeAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"]["nodeSelectorTerms"]
    return {e["key"] for t in terms for e in t["matchExpressions"]}


def _covers(mount_path, path):
    return path == mount_path or path.startswith(mount_path.rstrip("/") + "/")


# -- static manifests --------------------------------------------------------


@pytest.mark.parametrize("name", STATIC_FILES)
def test_static_manifest_is_one_document_of_the_ports_yaml_subset(name):
    with open(os.path.join(STATIC, name)) as f:
        text = f.read()
    assert yaml_subset.safe_load(text) == yaml.safe_load(text)
    assert chip_smoke.load_manifest(os.path.join(STATIC, name)) == yaml.safe_load(text)


@pytest.mark.parametrize("name", STATIC_FILES)
def test_static_env_names_are_port_flags_or_the_nvidia_runtimes(name):
    (ctr,) = _pod_spec(_static(name))["containers"]
    unknown = set(_env(ctr)) - DAEMON_ENV - NVIDIA_RUNTIME_ENV
    assert not unknown, f"{name}: not a flag alias of the port: {unknown}"


@pytest.mark.parametrize("name", STATIC_FILES)
def test_static_manifest_mounts_features_d_and_sys(name):
    spec = _pod_spec(_static(name))
    host_paths = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"] if "hostPath" in v}
    (ctr,) = spec["containers"]
    mounts = {m["name"]: m["mountPath"] for m in ctr["volumeMounts"]}
    assert host_paths["output-dir"] == mounts["output-dir"] == FEATURES_D
    assert host_paths["host-sys"] == mounts["host-sys"] == "/sys"


@pytest.mark.parametrize("name", STATIC_FILES)
def test_static_manifest_tolerates_the_gpu_taint_and_requests_no_gpu(name):
    spec = _pod_spec(_static(name))
    assert any(t.get("key") == GPU_TAINT and t.get("operator") == "Exists"
               for t in spec["tolerations"])
    for ctr in spec["containers"]:
        for section in ("limits", "requests"):
            assert GPU_TAINT not in (ctr.get("resources", {}).get(section) or {})


@pytest.mark.parametrize("name", DAEMONSETS)
def test_static_daemonset_selects_gpu_nodes_and_keeps_http_probes(name):
    spec = _pod_spec(_static(name))
    assert _node_affinity_keys(spec) == GPU_NODE_KEYS
    (ctr,) = spec["containers"]
    env = _env(ctr)
    assert env["TFD_METRICS_PORT"] == "9101" and "TFD_HEARTBEAT_FILE" in env
    assert {p["name"]: p["containerPort"] for p in ctr["ports"]} == {"metrics": 9101}
    assert ctr["livenessProbe"]["httpGet"] == {"path": "/healthz", "port": "metrics"}
    assert ctr["readinessProbe"]["httpGet"] == {"path": "/readyz", "port": "metrics"}


@pytest.mark.parametrize("name", STATIC_FILES)
def test_static_kernel_cache_is_the_images_and_no_volume_covers_it(name):
    """The manifest's TFD_COMPILATION_CACHE_DIR (or the image's, where it
    sets none) is the Dockerfile's prebuilt directory, with no mount on
    it or above it: a hostPath there would hide the prebuilt library."""
    (ctr,) = _pod_spec(_static(name))["containers"]
    assert _env(ctr).get("TFD_COMPILATION_CACHE_DIR", IMAGE_KERNEL_DIR) == IMAGE_KERNEL_DIR
    for mount in ctr["volumeMounts"]:
        assert not _covers(mount["mountPath"], IMAGE_KERNEL_DIR), mount


@pytest.mark.parametrize("strategy", sorted(MIG_VARIANTS))
def test_mig_variants_differ_only_in_strategy_mig_env_and_sys_admin(strategy):
    base = _static(DAEMONSET)
    variant = _static(MIG_VARIANTS[strategy])
    (ctr,) = _pod_spec(variant)["containers"]
    env = ctr["env"]
    assert {"name": "TFD_TPU_TOPOLOGY_STRATEGY", "value": strategy} in env
    assert {"name": "NVIDIA_MIG_MONITOR_DEVICES", "value": "all"} in env
    assert ctr["securityContext"]["capabilities"] == {"add": ["SYS_ADMIN"]}
    ctr["env"] = [e for e in env if e["name"] != "NVIDIA_MIG_MONITOR_DEVICES"]
    for e in ctr["env"]:
        if e["name"] == "TFD_TPU_TOPOLOGY_STRATEGY":
            e["value"] = "none"
    del ctr["securityContext"]["capabilities"]
    assert variant == base


def test_job_template_keeps_node_name_and_runs_oneshot():
    spec = _pod_spec(_static(JOB))
    assert spec["nodeName"] == "NODE_NAME"
    assert spec["restartPolicy"] == "Never"
    (ctr,) = spec["containers"]
    assert ctr["args"] == ["--oneshot"]
    job = chip_smoke.load_manifest(os.path.join(STATIC, JOB), node_name="gpu-node-7")
    assert _pod_spec(job)["nodeName"] == "gpu-node-7"


# -- the chart ---------------------------------------------------------------

CHART_CASES = {
    "defaults": {},
    "withBurnin": {"withBurnin": True},
    "probes.http": {"probes.http": True},
    "fleetCollector.enabled": {"fleetCollector.enabled": True,
                               "fleetCollector.root.enabled": True},
    "strategy-none": {"tpuTopologyStrategy": "none"},
    "strategy-single": {"tpuTopologyStrategy": "single"},
    "strategy-mixed": {"tpuTopologyStrategy": "mixed"},
}


@pytest.mark.parametrize("case", sorted(CHART_CASES))
def test_chart_renders(case):
    overrides = CHART_CASES[case]
    docs = _render(overrides)
    ds = _daemonset(docs)
    spec = _pod_spec(ds)
    (ctr,) = spec["containers"]
    env = _env(ctr)
    assert set(env) - DAEMON_ENV <= NVIDIA_RUNTIME_ENV
    assert env["TFD_COMPILATION_CACHE_DIR"] == IMAGE_KERNEL_DIR
    for mount in ctr["volumeMounts"]:
        assert not _covers(mount["mountPath"], IMAGE_KERNEL_DIR), mount
    assert FEATURES_D in {m["mountPath"] for m in ctr["volumeMounts"]}
    assert _node_affinity_keys(spec) == GPU_NODE_KEYS
    assert any(t.get("key") == GPU_TAINT for t in spec["tolerations"])
    assert GPU_TAINT not in str(ctr.get("resources", {}))
    assert ctr["image"] == f"ghcr.io/example/gpu-feature-discovery-torch:{DEFAULT_VERSION}"

    mig = overrides.get("tpuTopologyStrategy", "none") != "none"
    assert env["TFD_TPU_TOPOLOGY_STRATEGY"] == overrides.get("tpuTopologyStrategy", "none")
    assert ("NVIDIA_MIG_MONITOR_DEVICES" in env) == mig
    assert (ctr["securityContext"].get("capabilities") == {"add": ["SYS_ADMIN"]}) == mig
    assert env["TFD_WITH_BURNIN"] == str(overrides.get("withBurnin", False)).lower()

    if overrides.get("probes.http"):
        assert ctr["livenessProbe"]["httpGet"] == {"path": "/healthz", "port": "metrics"}
        assert ctr["readinessProbe"]["httpGet"] == {"path": "/readyz", "port": "metrics"}
    else:
        command = ctr["livenessProbe"]["exec"]["command"]
        assert command[0] == "python3" and env["TFD_HEARTBEAT_FILE"] in command[-1]
        assert "readinessProbe" not in ctr

    collectors = _collectors(docs)
    assert len(collectors) == (2 if overrides.get("fleetCollector.enabled") else 0)
    for dep in collectors:
        (cctr,) = _pod_spec(dep)["containers"]
        assert cctr["command"] == ["gpu-feature-discovery-torch", "fleet-collector"]
        assert set(_env(cctr)) <= COLLECTOR_ENV
        assert _env(cctr)["TFD_FLEET_TARGETS"].startswith(
            {m["mountPath"] for m in cctr["volumeMounts"]
             if m["name"].endswith("targets")}.pop())


def test_chart_refuses_its_own_capabilities_beside_a_mig_strategy():
    with pytest.raises(HelmFail, match="SYS_ADMIN"):
        _render({"tpuTopologyStrategy": "single",
                 "securityContext": {"privileged": True,
                                     "capabilities": {"add": ["NET_ADMIN"]}}})


def test_burnin_env_of_the_job_run_is_what_the_chart_adds():
    """chip_smoke.py runs the Job template with BURNIN_ENV: exactly the env
    that withBurnin=true changes in the chart's daemon container."""
    base = _env(_pod_spec(_daemonset(_render()))["containers"][0])
    burnin = _env(_pod_spec(_daemonset(_render({"withBurnin": True})))["containers"][0])
    assert {k: v for k, v in burnin.items() if base.get(k) != v} == chip_smoke.BURNIN_ENV


def _key_paths(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_key_paths(v, f"{prefix}{k}."))
        return out or {prefix.rstrip("."): node}
    return {prefix.rstrip("."): node}


def test_values_keep_the_twins_keys_and_defaults_but_the_gpu_ones():
    with open(os.path.join(CHART, "values.yaml")) as f:
        port = _key_paths(yaml.safe_load(f))
    with open(os.path.join(TWIN_CHART, "values.yaml")) as f:
        twin = _key_paths(yaml.safe_load(f))
    assert set(port) == set(twin)
    assert {k for k in port if port[k] != twin[k]} == {
        "affinity.nodeAffinity.requiredDuringSchedulingIgnoredDuringExecution.nodeSelectorTerms",
        "tolerations",
        "compilationCacheDir",
        "image.repository",
        "state.dir", "state.hostPath",
        "fleetCollector.stateDir", "fleetCollector.root.stateDir",
        "nfd.master.extraLabelNs",
        "nfd.worker.tolerations",
        "nfd.worker.config.sources.pci.deviceClassWhitelist",
    }


def test_vendored_nfd_subchart_is_the_twins_byte_for_byte():
    ours = os.path.join(CHART, "charts", "node-feature-discovery")
    twins = os.path.join(TWIN_CHART, "charts", "node-feature-discovery")

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, names in os.walk(root) for n in names)

    assert files(ours) == files(twins)
    _, mismatch, errors = filecmp.cmpfiles(ours, twins, files(ours), shallow=False)
    assert mismatch == [] and errors == []


def test_versions_agree_with_pyproject():
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        (version,) = re.findall(r'^version = "([^"]+)"', f.read(), re.M)
    with open(os.path.join(CHART, "Chart.yaml")) as f:
        chart = yaml.safe_load(f)
    assert DEFAULT_VERSION == version == chart["appVersion"] == chart["version"]
    for name in STATIC_FILES:
        doc = _static(name)
        (ctr,) = _pod_spec(doc)["containers"]
        assert ctr["image"].rsplit(":", 1)[1] == version
        assert doc["metadata"]["labels"]["app.kubernetes.io/version"] == version
    assert f"gpu-feature-discovery-torch:{version}" in open(DOCKERFILE).read()
    assert re.search(r"^ARG TFD_VERSION=(\S+)$", open(DOCKERFILE).read(), re.M).group(1) == version


# -- the image ---------------------------------------------------------------


def test_dockerfile_builds_the_kernels_and_ships_no_toolkit():
    build, runtime = chip_smoke.dockerfile_stages(DOCKERFILE)
    assert re.match(r"FROM nvidia/cuda:\$\{CUDA_VERSION\}-devel-ubuntu24\.04 AS build$", build[0])
    assert re.match(r"FROM nvidia/cuda:\$\{CUDA_VERSION\}-base-ubuntu24\.04$", runtime[0])
    assert re.search(r"^ARG CUDA_VERSION=12\.8\.\d+$", open(DOCKERFILE).read(), re.M)
    prebuild = [i for i in build if "ops.kernel_cache" in i]
    assert prebuild and f"--prebuild {IMAGE_KERNEL_DIR}" in prebuild[0]
    assert "gpu-feature-discovery-torch --version" in prebuild[0]
    assert not any("pytest" in i for i in build)
    for instruction in runtime:
        assert "nvcc" not in instruction and "-devel" not in instruction, instruction
    assert any("--no-deps" in i and ".whl" in i for i in runtime if i.startswith("RUN"))
    assert f"COPY --from=build {IMAGE_KERNEL_DIR} {IMAGE_KERNEL_DIR}" in runtime
    assert chip_smoke.image_env(DOCKERFILE) == {
        "TFD_COMPILATION_CACHE_DIR": IMAGE_KERNEL_DIR,
        "NVIDIA_VISIBLE_DEVICES": "all",
        "NVIDIA_DRIVER_CAPABILITIES": "utility,compute",
    }
    assert runtime[-1] == 'ENTRYPOINT ["gpu-feature-discovery-torch"]'


# -- the manifests run on the CPU, as chip_smoke.py runs them on the card ----

# Mock devices and the plain HBM sum in place of the card.
CPU_ENV = {"TFD_BACKENDS": "mock-gpu:2", "TFD_BURNIN_ALLOW_CPU": "1",
           "TFD_BURNIN_GEOMETRY": "64x1"}


@pytest.fixture
def kernel_dir(tmp_path):
    directory = tmp_path / "image-kernels"
    directory.mkdir()
    (directory / "libprebuilt.so").write_bytes(b"\x7fELF stand-in")
    return str(directory)


def test_static_daemonset_runs_as_its_manifest_states(tmp_path, kernel_dir):
    before = chip_smoke.tree_digest(kernel_dir)
    manifest = chip_smoke.load_manifest(os.path.join(STATIC, DAEMONSET))
    (ctr,) = _pod_spec(manifest)["containers"]
    with socket.socket() as held:  # the manifest's port taken: the pod moves
        held.bind(("", 0))
        taken = held.getsockname()[1]
        ctr["ports"][0]["containerPort"] = taken
        (metrics_port,) = [e for e in ctr["env"] if e["name"] == "TFD_METRICS_PORT"]
        metrics_port["value"] = str(taken)
        pod = chip_smoke.start_pod(manifest, str(tmp_path / "pod"), kernel_dir,
                                   extra_env=CPU_ENV)
    try:
        env = pod["env"]
        assert env["TFD_COMPILATION_CACHE_DIR"] == kernel_dir
        assert env["TFD_STATE_DIR"].startswith(str(tmp_path / "pod"))
        assert env["TFD_METRICS_PORT"] == str(pod["ports"][taken]) != str(taken)
        assert env["CUDA_HOME"] == "/nonexistent"
        assert all(not os.path.exists(os.path.join(d, "nvcc"))
                   for d in env["PATH"].split(os.pathsep))
        assert pod["out"].startswith(str(tmp_path / "pod")) and pod["out"].endswith("/tfd")
        assert pod["grace_s"] == chip_smoke.DEFAULT_GRACE_S
        chip_smoke._wait_for(
            lambda: chip_smoke._read_labels(pod["out"]).get("nvidia.com/gpu.health.ok"),
            60, "health labels")
        samples = chip_smoke._scrape(int(env["TFD_METRICS_PORT"]))
        assert samples[("tfd_compile_cache_enabled", "")] == 1.0
        results = [chip_smoke.run_probe(pod, pod["container"][k])
                   for k in chip_smoke.PROBE_KINDS if k in pod["container"]]
        assert [r["httpGet"] for r in results] == ["/healthz", "/readyz"]
        assert all(r["ok"] for r in results), results
        stopped = chip_smoke.stop_pod(pod)
    finally:
        if pod["proc"].poll() is None:
            pod["proc"].kill()
            pod["proc"].wait()
    assert stopped["rc"] == 0
    assert not os.path.exists(pod["out"])  # a daemon's exit removes its labels
    assert chip_smoke.tree_digest(kernel_dir) == before


def test_exec_probe_runs_in_the_pods_paths(tmp_path):
    """The chart's default heartbeat probe: its /tmp path is the pod's."""
    pod_tmp = tmp_path / "tmp"
    pod_tmp.mkdir()
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python3").symlink_to(sys.executable)
    pod = {"mapped": chip_smoke._mapper({"/tmp": str(pod_tmp)}), "work": str(tmp_path),
           "env": {"PATH": str(bin_dir)}}
    probe = _pod_spec(_daemonset(_render()))["containers"][0]["livenessProbe"]
    probe = {**probe, "timeoutSeconds": 30}
    assert chip_smoke.run_probe(pod, probe)["rc"] == 1
    (pod_tmp / "tfd-heartbeat").touch()
    result = chip_smoke.run_probe(pod, probe)
    assert (result["exec"], result["rc"], result["ok"]) == ("python3", 0, True)


def test_job_runs_as_its_template_states_with_the_burnin_env(tmp_path, kernel_dir):
    manifest = chip_smoke.load_manifest(os.path.join(STATIC, JOB), node_name="n")
    pod = chip_smoke.start_pod(manifest, str(tmp_path / "pod"), kernel_dir,
                               extra_env={**chip_smoke.BURNIN_ENV, **CPU_ENV})
    try:
        assert pod["proc"].wait(timeout=120) == 0
    finally:
        if pod["proc"].poll() is None:
            pod["proc"].kill()
            pod["proc"].wait()
    labels = chip_smoke._read_labels(pod["out"])
    assert labels["nvidia.com/gpu.health.ok"] == "true"
    assert labels["nvidia.com/gpu.count"] == "2"
    # The hook recorded the CLI's process: on the CPU the plain sum runs,
    # so no kernel launched and no library loaded.
    assert chip_smoke.pod_launches(pod) == [{"launches": 0, "library": None}]


def test_path_mapping_rewrites_whole_container_paths_only():
    mapped = chip_smoke._mapper({"/tmp": "/pod/tmp", "/var/lib/x": "/pod/x"})
    assert mapped("/tmp/tfd-heartbeat") == "/pod/tmp/tfd-heartbeat"
    assert mapped("os.stat('/tmp/hb')") == "os.stat('/pod/tmp/hb')"
    assert mapped("/var/lib/x") == "/pod/x"
    assert mapped("/var/lib/xy") == "/var/lib/xy"
    assert mapped("/a/tmp/b") == "/a/tmp/b"
    assert mapped("auto") == "auto"


def test_tree_digest_sees_bytes_and_modes(tmp_path):
    (tmp_path / "a").write_bytes(b"1")
    first = chip_smoke.tree_digest(str(tmp_path))
    (tmp_path / "a").write_bytes(b"2")
    second = chip_smoke.tree_digest(str(tmp_path))
    (tmp_path / "a").chmod(0o444)
    assert len({repr(first), repr(second), repr(chip_smoke.tree_digest(str(tmp_path)))}) == 3


def test_dockerfile_stages_join_continuations_and_drop_comments():
    with tempfile.NamedTemporaryFile("w", suffix="Dockerfile", delete=False) as f:
        f.write("ARG X=1\n# c\nFROM a AS b\nRUN x \\\n    && y\n"
                "FROM c\n# ENV NO=1\nENV A=1\nENV PATH=/p:$PATH\n")
    try:
        assert chip_smoke.dockerfile_stages(f.name) == [
            ["FROM a AS b", "RUN x && y"], ["FROM c", "ENV A=1", "ENV PATH=/p:$PATH"]]
        assert chip_smoke.image_env(f.name) == {"A": "1"}
    finally:
        os.unlink(f.name)


def test_stop_pod_fails_past_the_grace_period(tmp_path):
    import subprocess

    proc = subprocess.Popen([sys.executable, "-c",
                             "import signal, time; signal.signal(signal.SIGTERM, "
                             "signal.SIG_IGN); print('up', flush=True); time.sleep(60)"],
                            stdout=subprocess.PIPE)
    assert proc.stdout.readline() == b"up\n"
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="grace period"):
        chip_smoke.stop_pod({"proc": proc, "grace_s": 0.5})
    assert proc.poll() is not None and time.monotonic() - t0 < 30
    proc.stdout.close()
