"""The PyTorch port's oneshot label cycle end to end, on the CPU.

``gpu_feature_discovery_tpu_torch.cmd.main.start`` against the JAX
package's golden for the gpu family (tests/expected-output-gpu-mock.txt),
the burn-in cycle under the TFD_BURNIN_ALLOW_CPU opt-in, the slice's
refusals, flag parity with the twin, and the import boundary: nothing
under gpu_feature_discovery_tpu_torch/ (nor chip_smoke.py) imports JAX,
the JAX package or yaml."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu.config import flags as twin_flags
from gpu_feature_discovery_tpu_torch.cmd.main import start
from gpu_feature_discovery_tpu_torch.config import flags
from gpu_feature_discovery_tpu_torch.lm.labels import label_safe_value
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import (
    CudaManager,
    driver_version_string,
)
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError

HERE = Path(__file__).parent
REPO = HERE.parent
PORT = REPO / "gpu_feature_discovery_tpu_torch"

# The burn-in cycle's extra labels on the CPU: the host-clock rate of a
# 128x2 chain is far below the 1 TFLOP/s floor, so no rate label
# publishes; the verdicts do. Kept here rather than as a tests/
# expected-output*.txt file, whose label families docs/labels.md covers.
BURNIN_CPU_GOLDEN = [
    r"nvidia\.com\/gpu\.health\.ok=true",
    r"nvidia\.com\/gpu\.health\.probe-ms=[0-9]+",
    r"nvidia\.com\/gpu\.health\.timing=wall-clock",
    r"nvidia\.com\/gpu\.chips\.healthy=1",
    r"nvidia\.com\/gpu\.chips\.sick=0",
    r"nvidia\.com\/gpu\.chip\.0\.ok=true",
]


def check_result(output_path, golden):
    """Bidirectional regex diff (tests/test_daemon.py check_result): every
    output line must match some golden regex AND every golden regex must
    match some output line."""
    actual = [l for l in Path(output_path).read_text().splitlines() if l.strip()]
    patterns = [re.compile(f"^{g}$") for g in golden]
    unmatched_lines = [
        line for line in actual if not any(p.match(line) for p in patterns)
    ]
    unmatched_patterns = [
        g for g, p in zip(golden, patterns) if not any(p.match(line) for line in actual)
    ]
    assert not unmatched_lines, f"unexpected label lines: {unmatched_lines}"
    assert not unmatched_patterns, f"labels missing for: {unmatched_patterns}"


# The host facts the port publishes beside the twin's gpu family: the
# DMI machine type and MIG capability (mock-gpu has none). Kept here
# rather than in the twin's golden file, which stays as it is.
HOST_FACTS_GOLDEN = [
    r"nvidia\.com\/gpu\.machine=[A-Za-z0-9._-]+",
    r"nvidia\.com\/gpu\.slice\.capable=false",
]


def _gpu_mock_golden():
    return [
        l for l in (HERE / "expected-output-gpu-mock.txt").read_text().splitlines()
        if l.strip()
    ] + HOST_FACTS_GOLDEN


def test_oneshot_mock_gpu_matches_twin_golden(tmp_path):
    out = tmp_path / "tfd"
    assert start(["--oneshot", "--backends", "mock-gpu:2", "--output-file", str(out)]) == 0
    check_result(out, _gpu_mock_golden())
    assert (out.stat().st_mode & 0o777) == 0o644
    assert os.listdir(tmp_path / "tfd-tmp") == []


def test_oneshot_burnin_on_cpu_adds_health_labels(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "128x2")
    out = tmp_path / "tfd"
    rc = start(["--oneshot", "--with-burnin", "--backends", "mock-gpu:2",
                "--output-file", str(out)])
    assert rc == 0
    check_result(out, _gpu_mock_golden() + BURNIN_CPU_GOLDEN)


def test_oneshot_burnin_without_device_publishes_no_health(tmp_path, monkeypatch):
    monkeypatch.delenv("TFD_BURNIN_ALLOW_CPU", raising=False)
    out = tmp_path / "tfd"
    rc = start(["--oneshot", "--with-burnin", "--backends", "mock-gpu:1",
                "--output-file", str(out), "--no-timestamp"])
    assert rc == 0
    assert "health" not in out.read_text()
    assert "tfd.timestamp" not in out.read_text()


@pytest.mark.parametrize(
    "argv",
    [
        ["--oneshot", "--probe-broker", "sometimes", "--backends", "mock-gpu:2"],
        ["--oneshot", "--broker-max-requests", "-1", "--backends", "mock-gpu"],
        ["--oneshot", "--probe-isolation", "sideways"],
        ["--oneshot", "--backends", "gpu,mock-gpu"],
        ["--oneshot", "--backends", "mock-gpu:zero"],
        ["--oneshot", "--backends", "tpu"],
    ],
)
def test_out_of_scope_or_bad_config_exits_nonzero(tmp_path, argv):
    out = tmp_path / "tfd"
    assert start(argv + ["--output-file", str(out)]) == 1
    assert not out.exists()


def test_flags_keep_twin_spelling_aliases_and_defaults():
    twin_defs = {fd.name: fd for fd in twin_flags.FLAG_DEFS}
    for fd in flags.FLAG_DEFS:
        twin_fd = twin_defs[fd.name]
        assert tuple(fd.env_vars) == tuple(twin_fd.env_vars), fd.name
        assert fd.default == twin_fd.default, fd.name
        assert tuple(fd.aliases) == tuple(twin_fd.aliases), fd.name
    config = flags.new_config(environ={"TFD_ONESHOT": "true", "TFD_BURNIN_INTERVAL": "3"})
    assert config.flags.tfd.oneshot is True
    assert config.flags.tfd.burnin_interval == 3
    config = flags.new_config(cli_values={"burnin-interval": "5"},
                              environ={"TFD_BURNIN_INTERVAL": "3"})
    assert config.flags.tfd.burnin_interval == 5


def test_cuda_manager_facts():
    assert driver_version_string(12040) == "12.4"
    assert driver_version_string(13000) == "13.0"
    assert label_safe_value("NVIDIA H100 80GB HBM3".lower()) == "nvidia-h100-80gb-hbm3"


def test_cuda_manager_refuses_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ResourceError):
        CudaManager().init()


def _imported_top_level_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    # yaml too: the card machine has no pyyaml (config/yaml_subset.py).
    forbidden = {"jax", "jaxlib", "gpu_feature_discovery_tpu", "yaml"}
    # The integration script runs on the card too, with the golden diff it
    # imports.
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", HERE / "torch-integration-tests.py", HERE / "golden_utils.py"]
    assert len(files) > 20
    offenders = [
        f"{p.relative_to(REPO)} imports {name}"
        for p in files
        for name in _imported_top_level_names(p)
        if name in forbidden
    ]
    assert not offenders


def test_fleet_collector_sources_import_no_torch():
    """The collector has no device: fleet/ and cmd/fleet.py import
    neither torch nor anything the scan above forbids."""
    files = sorted((PORT / "fleet").rglob("*.py")) + [PORT / "cmd" / "fleet.py"]
    assert len(files) == 7
    offenders = [
        f"{p.relative_to(REPO)} imports {name}"
        for p in files
        for name in _imported_top_level_names(p)
        if name in {"torch", "triton", "jax", "jaxlib", "gpu_feature_discovery_tpu", "yaml"}
    ]
    assert not offenders


def test_import_of_every_module_loads_no_jax_and_no_cuda():
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py"))
        if p.name != "__main__.py"
    ]
    code = (
        "import importlib, sys, torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gpu_feature_discovery_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_integration_script_and_the_shared_config_reader_load_no_jax_and_no_yaml():
    """What runs on the card beside the port: the integration script (as
    chip_smoke.py loads it, by path) and the port's config reader over
    tests/config-shared-torch.yaml."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('t', 'tests/torch-integration-tests.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from gpu_feature_discovery_tpu_torch.config.flags import new_config\n"
        "cfg = new_config(config_file='tests/config-shared-torch.yaml', environ={})\n"
        "(r,) = cfg.sharing.time_slicing.resources\n"
        "assert (r.name, r.replicas) == ('nvidia.com/gpu', 4), r\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gpu_feature_discovery_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_python_dash_m_entry_point(tmp_path):
    out = tmp_path / "tfd"
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--oneshot",
         "--backends", "mock-gpu:2", "--output-file", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    check_result(out, _gpu_mock_golden())


def test_merge_later_labelers_win_like_twin():
    from gpu_feature_discovery_tpu.lm import labeler as twin_labeler
    from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
    from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Merge
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels

    parts = [{"a": "1", "b": "1"}, {}, {"b": "2", "c": "3"}]
    got = Merge(*(Labels(p) if p else Empty() for p in parts)).labels()
    want = twin_labeler.Merge(
        *(TwinLabels(p) if p else twin_labeler.Empty() for p in parts)
    ).labels()
    assert list(got.items()) == list(want.items()) == [
        ("a", "1"), ("b", "2"), ("c", "3")
    ]


def test_remove_output_file_drops_file_and_staging_dir(tmp_path):
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels, remove_output_file

    out = tmp_path / "tfd"
    Labels({"nvidia.com/gpu.count": "1"}).write_to_file(str(out))
    assert out.read_text() == "nvidia.com/gpu.count=1\n"
    remove_output_file(str(out))
    assert not out.exists() and not (tmp_path / "tfd-tmp").exists()
    remove_output_file("")  # stdout output: nothing to remove
