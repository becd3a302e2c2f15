"""Tier 3 of the PyTorch port from the unit suite: tests/torch-integration-tests.py
(the real daemon as a subprocess, its whole label file diffed in both
directions against a golden) passes every CPU scenario of the twin's
``make integration`` (Makefile), translated; a golden regex no line
matches, or a line no regex matches, fails it; and each port golden holds
every key of its twin golden under the label rule, but the keys the MIG
table of ROADMAP.md replaces, listed here with their reasons."""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).parent
SCRIPT = HERE / "torch-integration-tests.py"

# WORKER_HOSTNAMES of 8 hosts, this one worker 0, and the other host keys
# hostinfo/gpu_env.py reads: the twin's v5p-64 host fixture
# (Makefile:38) on a GPU node.
INTERCONNECT_HOSTENV = (
    "ACCELERATOR_TYPE=h100-64;HOST_BOUNDS=2,2,2;CHIPS_PER_HOST_BOUNDS=2,2,2;"
    "WRAP=true,true,true;MACHINE_TYPE=a3-highgpu-8g;WORKER_ID=0;"
    "WORKER_HOSTNAMES=w0,w1,w2,w3,w4,w5,w6,w7"
)

# Keys the label rule does not carry over (ROADMAP.md, the MIG table).
NO_SPEC_ROW = ("tensorcores", "sparsecores")  # no GPU family has a spec row
SLICE_ATTRIBUTES = ("slice.chips", "topology.x", "topology.y", "topology.z",
                    "slice.hosts", "ici.links", "slice.memory")  # the MIG device's own instead
FAMILY_ROW = ("family", "generation.major", "generation.minor")  # from the compute capability


def _gpu(*names):
    return {f"nvidia.com/gpu.{n}" for n in names}


def _mig(*names):
    return {f"nvidia.com/mig-<R>.{n}" for n in names}


# name: (script arguments, port golden, twin golden, twin keys not carried over)
SCENARIOS = {
    "mig-single": (
        ["--backend", "mock-nvml:single", "--strategy", "single"],
        "torch-expected-output-mig-single.txt", "expected-output-topology-single.txt",
        _gpu(*NO_SPEC_ROW, *SLICE_ATTRIBUTES)),
    "mig-mixed": (
        ["--backend", "mock-nvml:mixed", "--strategy", "mixed"],
        "torch-expected-output-mig-mixed.txt", "expected-output-topology-mixed.txt",
        _gpu(*NO_SPEC_ROW) | _mig(*NO_SPEC_ROW, *SLICE_ATTRIBUTES)),
    # Strategy single over a node whose MIG devices differ: <model>-MIG-INVALID
    # with no MIG device's attributes, as the twin's -SLICE-INVALID.
    "mig-single-invalid": (
        ["--backend", "mock-nvml:mixed", "--strategy", "single"],
        "torch-expected-output-mig-single-invalid.txt", "expected-output-topology-single.txt",
        _gpu(*NO_SPEC_ROW, *SLICE_ATTRIBUTES)),
    # mock-gpu reports no compute capability, so the family row publishes
    # nothing (the twin's own gpu family, expected-output-gpu-mock.txt,
    # has no family either).
    "interconnect": (
        ["--backend", "mock-gpu:8", "--hostenv", INTERCONNECT_HOSTENV],
        "torch-expected-output-interconnect.txt", "expected-output-interconnect.txt",
        _gpu(*NO_SPEC_ROW, *FAMILY_ROW)),
    "shared": (
        ["--backend", "mock-nvml:none", "--config", str(HERE / "config-shared-torch.yaml")],
        "torch-expected-output-shared.txt", "expected-output-shared.txt",
        _gpu(*NO_SPEC_ROW)),
    "h100x2": (
        ["--backend", "mock-nvml:none"],
        "torch-expected-output-h100x2.txt", "expected-output-v4-8.txt", _gpu(*NO_SPEC_ROW)),
    "recorded": (
        ["--backend", "mock-nvml:recorded"],
        "torch-expected-output-recorded.txt", "expected-output-v5e-8.txt", _gpu(*NO_SPEC_ROW)),
    "l4": (
        ["--backend", "mock-nvml:no-mig"],
        "torch-expected-output-l4.txt", "expected-output-v5p-8.txt", _gpu(*NO_SPEC_ROW)),
}
# The card's scenario, run by chip_smoke.py's golden phase (--backend gpu
# --with-burnin --hostenv LIVE_HOSTENV): strategy none, where the twin's
# live test runs single, so no strategy label either.
LIVE = (None, "torch-expected-output-live-h100.txt", "expected-output-live-burnin.txt",
        _gpu(*NO_SPEC_ROW, *SLICE_ATTRIBUTES, "topology.strategy"))


def run_script(*args, timeout=120):
    return subprocess.run([sys.executable, str(SCRIPT), "--timeout", "45", *args],
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_integration_scenario_matches_its_golden(name):
    args, golden, _, _ = SCENARIOS[name]
    result = run_script(*args, "--golden", str(HERE / golden))
    assert result.returncode == 0, result.stdout + result.stderr
    assert "Integration tests done" in result.stdout


def _golden_lines(golden):
    return [l for l in (HERE / golden).read_text().splitlines() if l.strip()]


def test_a_golden_regex_no_label_matches_fails_the_run(tmp_path):
    args, golden, _, _ = SCENARIOS["h100x2"]
    extra = r"nvidia\.com\/gpu\.never-published=true"
    path = tmp_path / "golden.txt"
    path.write_text("\n".join(_golden_lines(golden) + [extra]) + "\n")
    result = run_script(*args, "--golden", str(path))
    assert result.returncode == 1
    assert f"Missing label matching regex: {extra}" in result.stderr
    assert "Unexpected label" not in result.stderr


def test_a_label_line_the_golden_lacks_fails_the_run(tmp_path):
    args, golden, _, _ = SCENARIOS["mig-mixed"]
    dropped = r"nvidia\.com\/mig-2g\.20gb\.engines\.ofa=[0-9]+"
    lines = _golden_lines(golden)
    lines.remove(dropped)
    path = tmp_path / "golden.txt"
    path.write_text("\n".join(lines) + "\n")
    result = run_script(*args, "--golden", str(path))
    assert result.returncode == 1
    assert "Unexpected label: nvidia.com/mig-2g.20gb.engines.ofa=0" in result.stderr
    assert "Missing label" not in result.stderr


def test_a_daemon_that_fails_fails_the_run():
    result = run_script("--backend", "mock-gpu:zero")
    assert result.returncode == 1
    assert "Daemon exited 1" in result.stderr


def _load_script():
    spec = importlib.util.spec_from_file_location("torch_integration_tests", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_run_reports_both_sides_of_the_diff(tmp_path):
    """run(), which chip_smoke.py's golden phase calls, returns the
    unmatched lines and patterns that main() prints."""
    module = _load_script()
    path = tmp_path / "golden.txt"
    lines = _golden_lines("torch-expected-output-recorded.txt")
    lines.remove(r"nvidia\.com\/gpu\.count=1")
    path.write_text("\n".join(lines + [r"nvidia\.com\/gpu\.count=7"]) + "\n")
    result = module.run(["--backend", "mock-nvml:recorded", "--golden", str(path)])
    assert result["ok"] is False and len(result["labels"]) == len(lines) + 1
    assert result["unexpected"] == ["nvidia.com/gpu.count=1"]
    assert result["missing"] == [r"nvidia\.com\/gpu\.count=7"]
    result = module.run(["--backend", "mock-nvml:recorded", "--golden",
                         str(HERE / "torch-expected-output-recorded.txt")],
                        extra_regexs=[re.compile(r"nvidia\.com\/gpu\.never=1")])
    assert result["missing"] == [r"nvidia\.com\/gpu\.never=1"] and not result["unexpected"]


def test_the_scrub_keeps_the_callers_slice_facts_out(monkeypatch):
    """A GPU node's own WORKER_* and TFD_* facts never reach the daemon
    unless --hostenv names them; the CPU burn-in opt-ins pass."""
    module = _load_script()
    for key, value in (("WORKER_ID", "3"), ("WORKER_HOSTNAMES", "a,b,c,d"),
                       ("TFD_BACKENDS", "mock-gpu:5"), ("TFD_BURNIN_ALLOW_CPU", "1")):
        monkeypatch.setenv(key, value)
    result = module.run(["--backend", "mock-nvml:none", "--golden",
                         str(HERE / "torch-expected-output-h100x2.txt")])
    assert result["ok"], result
    assert module.PASS_THROUGH == ("TFD_BURNIN_",)


def test_the_live_golden_on_the_cpu_differs_only_in_the_devices_rows(monkeypatch):
    """The live scenario's made-up host over the recorded H100 on the CPU:
    every line of the live golden matches but those only a card can give
    (device-clock rates, per-device verdicts joined to NVML by UUID), and
    the mock backend's synthesized PCI functions are the only extra lines."""
    module = _load_script()
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    result = module.run(["--backend", "mock-nvml:recorded", "--with-burnin",
                         "--hostenv", module.LIVE_HOSTENV,
                         "--golden", str(HERE / LIVE[1])])
    assert result["labels"] is not None
    assert sorted(l.split("=", 1)[0] for l in result["unexpected"]) == sorted(
        _gpu("health.timing", "pci.present", "pci.count", "pci.host-interface",
             "pci.host-driver-version", "pci.host-driver-branch"))
    assert "nvidia.com/gpu.health.timing=wall-clock" in result["unexpected"]
    assert sorted(result["missing"]) == sorted(
        p.replace(".", "\\.").replace("/", "\\/") + suffix for p, suffix in (
            ("nvidia.com/gpu.health.matmul-tflops", "=[0-9]+"),
            ("nvidia.com/gpu.health.hbm-gbps", "=[0-9]+"),
            ("nvidia.com/gpu.health.timing", "=device-profiler"),
            ("nvidia.com/gpu.chips.healthy", "=1"),
            ("nvidia.com/gpu.chips.sick", "=0"),
            ("nvidia.com/gpu.chip.0.ok", "=true"),
            ("nvidia.com/gpu.chip.0.tflops", "=[0-9]+"),
            ("nvidia.com/gpu.chip.0.hbm-gbps", "=[0-9]+")))


_RESOURCE = (
    (re.compile(r"^google\.com/tpu-[^.]+\."), "nvidia.com/mig-<R>."),
    (re.compile(r"^nvidia\.com/mig-[0-9]+g\.[0-9]+gb\."), "nvidia.com/mig-<R>."),
)


def golden_keys(golden):
    """The label keys of a golden's regex lines, unescaped, each mixed
    resource's prefix as ``<R>``, translated by the label rule."""
    keys = set()
    for line in _golden_lines(golden):
        key = line.split("=", 1)[0].replace("\\.", ".").replace("\\/", "/")
        key = key.replace("[0-9x]+", "<R>")
        for pattern, repl in _RESOURCE:
            key = pattern.sub(repl, key)
        if key.startswith("google.com/tpu."):
            key = "nvidia.com/gpu." + key[len("google.com/tpu."):]
        keys.add(key)
    return keys


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["live-h100"])
def test_port_golden_holds_every_translated_key_of_its_twin_golden(name):
    _, golden, twin_golden, not_carried = LIVE if name == "live-h100" else SCENARIOS[name]
    port, twin = golden_keys(golden), golden_keys(twin_golden)
    assert not_carried <= twin, f"listed keys the twin golden lacks: {not_carried - twin}"
    missing = twin - not_carried - port
    assert not missing, f"{golden} lacks the twin's {sorted(missing)}"
    assert all(not k.startswith("google.com/tpu") for k in port)


def test_every_mig_replacement_is_published_in_its_place():
    """Where the twin's slice attributes are not carried over, the MIG
    device's own are (ROADMAP.md, the MIG table): under single on the
    node, under mixed per profile."""
    own = ("memory", "multiprocessors", "slices.gi", "slices.ci", "engines.copy",
           "engines.decoder", "engines.encoder", "engines.jpeg", "engines.ofa")
    assert _gpu(*own) <= golden_keys("torch-expected-output-mig-single.txt")
    assert _mig("product", "count", "replicas", *own) <= golden_keys(
        "torch-expected-output-mig-mixed.txt")
    assert not any(k.startswith("nvidia.com/gpu.engines")
                   for k in golden_keys("torch-expected-output-mig-single-invalid.txt"))
