"""The twin's per-generation exact goldens (``tests/test_generation_goldens.py``)
held against the port: where the twin pins every published number of a
v4 / v5e / v5p node, a v5p-64 worker under ``single`` and a v5e node
under ``mixed``, the port pins every number of an H100 80GB HBM3, an
A100-SXM4-80GB and an L4 node, and of an H100 node in MIG mode under
``single`` and ``mixed``. The regex goldens of the integration tier let a
wrong memory size or family pass; these do not. Each oneshot runs
``cmd/main.py:run`` in process over the NVML manager and a fake NVML
(``mock-nvml:<layout>``), with no timestamp and a fixed machine type, and
the label file must equal the golden line for line."""

import queue
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.testing import fake_nvml
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

HERE = Path(__file__).parent


def run_oneshot(tmp_path, layout, strategy):
    machine = tmp_path / "machine-type"
    machine.write_text("Test Node\n")
    out = tmp_path / "tfd"
    config = new_config(cli_values={
        "oneshot": True, "output-file": str(out), "no-timestamp": True,
        "machine-type-file": str(machine), "tpu-topology-strategy": strategy,
    }, environ={})
    assert run(NvmlManager(fake_nvml(layout)), config, queue.SimpleQueue(),
               interconnect=Empty()) is False
    return out


def check_result(out, golden):
    got = sorted(out.read_text().splitlines())
    want = sorted(l for l in (HERE / golden).read_text().splitlines() if l)
    assert got == want


@pytest.mark.parametrize("layout,golden", [
    ("none", "torch-expected-output-exact-h100.txt"),
    ("a100", "torch-expected-output-exact-a100.txt"),
    ("no-mig", "torch-expected-output-exact-l4.txt"),
])
def test_generation_golden(tmp_path, layout, golden):
    check_result(run_oneshot(tmp_path, layout, "none"), golden)


def test_mig_single_strategy_exact_golden(tmp_path):
    """Four 3g.40gb MIG devices on two H100s under ``single``: the count
    is the MIG devices', the memory and engines one device's."""
    check_result(run_oneshot(tmp_path, "single", "single"),
                 "torch-expected-output-exact-h100-mig-single.txt")


def test_mixed_strategy_exact_golden(tmp_path):
    """Five profiles of MIG devices across two H100s under ``mixed``: one
    ``nvidia.com/mig-<profile>`` resource per profile, every number
    pinned."""
    check_result(run_oneshot(tmp_path, "mixed", "mixed"),
                 "torch-expected-output-exact-h100-mig-mixed.txt")
