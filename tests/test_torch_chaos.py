"""The port's chaos matrix on the CPU: every row of the twin's matrix
(``tests/test_chaos.py`` ``CHAOS_SPECS``) runs against the port's daemon,
slices and fleet through ``tests/torch_chaos_run.py``, the port's chaos
driver, within the twin's own budgets (``CHAOS_EXPECTATIONS``, keys
translated ``google.com/tpu.`` -> ``nvidia.com/gpu.``). The contract: the
label file converges to full or degraded labels and is never absent, the
daemon never exits on its own, the faults drain to full labels with the
markers cleared, and SIGTERM still shuts it down cleanly."""

import ast
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import torch_chaos_run as driver
from test_chaos import CHAOS_EXPECTATIONS, CHAOS_SPECS
from torch_slice_fixture import PortSliceHarness
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

HERE = Path(__file__).parent
REPO = HERE.parent


def _translated(value):
    """The twin's expectation value in the port's label namespace."""
    if isinstance(value, str):
        return driver.port_key(value)
    if isinstance(value, list):
        return [_translated(v) for v in value]
    if isinstance(value, dict):
        return {k: _translated(v) for k, v in value.items()}
    return value


@pytest.mark.parametrize("fault_spec", driver.ROWS)
def test_daemon_converges_under_faults(fault_spec, tmp_path):
    result, budget = driver.run_row(fault_spec, str(tmp_path))
    assert result["converged_s"] < budget


def test_rows_are_the_twins():
    """The port's matrix is the twin's, row for row, with the twin's
    budgets and expectations: a row added to the twin fails here."""
    assert driver.ROWS == CHAOS_SPECS
    assert driver.EXPECTATIONS == _translated(CHAOS_EXPECTATIONS)


def test_the_cli_converges_a_marker_row(tmp_path):
    env = dict(os.environ, TFD_FAULT_SPEC="write:raise:OSError:2")
    env.pop("TFD_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, str(HERE / "torch_chaos_run.py"), "--print-labels"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    labels = json.loads(lines[-2])
    assert labels["nvidia.com/gpu.count"] == "4"
    assert labels["nvidia.com/gpu.product"] == "mock-gpu"
    assert not any(k.startswith("nvidia.com/gpu.tfd.") for k in labels), labels
    assert lines[-1].startswith("chaos: spec='write:raise:OSError:2' converged in ")
    assert lines[-1].endswith(f" with {len(labels)} labels")


@pytest.mark.parametrize("spec,probe_timeout,kills", [
    # The CI row's arguments: one hung child SIGKILLed at a 2 s budget.
    ("probe.hang:fail:1", "2", 1),
    # An injected timeout spawns no child, so nothing is killed.
    ("probe.timeout:fail:2", "0.5s", 0),
])
def test_probe_kills_read_from_a_live_scrape(spec, probe_timeout, kills, tmp_path):
    result = driver.run_chaos(spec, str(tmp_path), probe_timeout=probe_timeout,
                              assert_probe_kills=kills)
    assert result["converged_s"] < driver.CONVERGE_TIMEOUT_S


class _HeldLabeler:
    """An interconnect labeler whose first answer waits for ``release``:
    its daemon runs, and its server answers, before its first write."""

    def __init__(self):
        self.release = threading.Event()

    def labels(self):
        self.release.wait(30)
        return {}


def test_wait_for_holds_until_every_running_worker_has_written(tmp_path, monkeypatch):
    """The slice rows' "node-local labels never move" check starts from
    a snapshot that ``wait_for`` returned: a running worker that has not
    written yet must hold it back, or the check starts from an empty
    file (the twin's slice:tier-partition flake)."""
    monkeypatch.delenv("TFD_BACKEND", raising=False)
    harness = PortSliceHarness(tmp_path, workers=2, coordination="off")
    held = harness.workers[1].interconnect = _HeldLabeler()
    with harness:
        count = "nvidia.com/gpu.count"
        with pytest.raises(AssertionError, match="timed out"):
            harness.wait_for(lambda s: count in s[0], timeout=1.0)
        assert harness.workers[1].alive and harness.workers[1].labels() == {}
        held.release.set()
        snapshot = harness.wait_for(lambda s: count in s[0], timeout=30)
        assert all(count in labels for labels in snapshot.values())


def _imported_top_level_names(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_driver_and_harness_import_nothing_of_the_jax_package():
    """The driver runs on the card machine, which has neither JAX nor
    pyyaml; the twin's slice fixture imports the JAX package."""
    forbidden = {"jax", "jaxlib", "gpu_feature_discovery_tpu", "yaml", "slice_fixture"}
    files = [HERE / "torch_chaos_run.py", HERE / "torch_slice_fixture.py"]
    offenders = [f"{p.name} imports {name}" for p in files
                 for name in _imported_top_level_names(p) if name in forbidden]
    assert not offenders
