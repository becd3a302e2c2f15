"""No process a run starts holds JAX or the JAX package, compared by whole
top-level names; the harness reads nothing of the JAX package's bench."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import catalog
import cell

ROOT = catalog.HERE.parent
BOOT = catalog.HERE / "boot"


def _boot_child(tmp_path, code, extra_path=(), check=True):
    """Run ``code`` in a child that loads the bootstrap; its output
    directory."""
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PORTBENCH_OUT=str(out),
               PYTHONPATH=os.pathsep.join([str(BOOT), *map(str, extra_path), str(ROOT)]))
    subprocess.run([sys.executable, "-c", code], env=env, check=check, cwd=str(tmp_path))
    return out


def _forbidden(out):
    (probes,) = out.glob("probes-*.json")
    return json.loads(probes.read_text())["forbidden_modules"]


def _fake_jax(tmp_path):
    fake = tmp_path / "fake"
    (fake / "gpu_feature_discovery_tpu").mkdir(parents=True)
    (fake / "gpu_feature_discovery_tpu" / "__init__.py").write_text("")
    (fake / "jax.py").write_text("")
    return fake


def test_the_port_alone_holds_nothing_forbidden(tmp_path):
    code = "import gpu_feature_discovery_tpu_torch.ops.healthcheck as hc; assert hc.health_pack"
    out = _boot_child(tmp_path, code)
    assert _forbidden(out) == []
    assert cell.collect_records(str(out)) == []


def test_a_forbidden_top_level_name_is_found(tmp_path):
    code = "import jax, gpu_feature_discovery_tpu, os; os._exit(0)"
    out = _boot_child(tmp_path, code, [_fake_jax(tmp_path)])
    assert _forbidden(out) == ["gpu_feature_discovery_tpu", "jax"]
    with pytest.raises(cell.RunError, match="held"):
        cell.collect_records(str(out))


def test_a_process_killed_before_its_record_leaves_no_result(tmp_path):
    code = "import jax, os, signal; os.kill(os.getpid(), signal.SIGKILL)"
    out = _boot_child(tmp_path, code, [_fake_jax(tmp_path)], check=False)
    assert list(out.glob("boot-*.json")) and not list(out.glob("probes-*.json"))
    with pytest.raises(cell.RunError, match="left no record"):
        cell.collect_records(str(out))


def test_every_process_writes_its_record_at_trace_stop(tmp_path):
    """The record the harness waits for before it stops the daemon: a
    process that the stop then kills has already left it."""
    code = ("import jax, os, time\n"
            "open(os.path.join(os.environ['PORTBENCH_OUT'], 'trace-start'), 'w').close()\n"
            "open(os.path.join(os.environ['PORTBENCH_OUT'], 'trace-stop'), 'w').close()\n"
            "time.sleep(30)\n")
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PORTBENCH_OUT=str(out),
               PYTHONPATH=os.pathsep.join([str(BOOT), str(_fake_jax(tmp_path)), str(ROOT)]))
    child = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path))
    try:
        cell._wait_files(str(out / "boot-*.json"), 60)
        cell._wait_records(str(out))
        assert _forbidden(out) == ["jax"]
    finally:
        child.kill()
        child.wait()
    with pytest.raises(cell.RunError, match="held"):
        cell.collect_records(str(out))


def test_the_harness_sources_import_no_jax_and_read_no_jax_bench():
    forbidden = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|gpu_feature_discovery_tpu)\b(?!_)",
                           re.M)
    for path in catalog.HERE.rglob("*.py"):
        if "tests" in path.relative_to(catalog.HERE).parts:
            continue
        text = path.read_text()
        assert not forbidden.search(text), path
        assert not re.search(r"\bbench\.py|(?<!PORT)BENCH_", text), path


def test_a_run_on_the_cpu_starts_no_process_holding_jax():
    config = catalog.config("h100x1-daemonset")
    # The CPU stand-in for the card: the mock backend and the probe's CPU
    # path at a small geometry. Its probes are not captured (the CPU path
    # packs nothing), so only the run's plumbing is held here.
    config["env"].update({"TFD_BACKENDS": "mock-gpu:1", "TFD_BURNIN_ALLOW_CPU": "1",
                          "TFD_BURNIN_GEOMETRY": "64x1"})
    bench = catalog.load_benchmark(ROOT)
    run = cell.run_cell(ROOT, catalog.workload(bench, "x1-broker.soak"), config,
                        catalog.traffic("soak"), 1.0, False, "cpu")
    assert run.cycles > 10
    assert run.labels["nvidia.com/gpu.health.ok"] == "true"
    assert cell.heartbeat_count_gap(run) == 0


def test_no_result_from_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(catalog.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "x1-broker.soak",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
