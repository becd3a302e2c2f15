"""On the card: a short run of each cell is correct, and with the timed
path broken underneath (``PORTBENCH_FAULT`` in the bootstrap) the judge
says not correct: a probe whose answer is altered where it is packed, a
probe that returns its previous state unrun and, over several cards, a
reduced value altered where the program reads it back. On a card a
tenant fills, a busy probe read as a failed one publishes verdicts and
is not correct, and a worker that keeps 256 MiB past its first busy
failure, or 16 MiB more past each (at least 16 failures come before the
readings that count), reads at least 256 MiB more in ``busy_mib_held``.
A cell runs where
the machine holds as many CUDA devices as it asks for, and skips
elsewhere: the daemon probes every card it finds."""

import copy

import pytest

import catalog
import cell
from reference import labels as ref_labels
from reference.nvml import Nvml, smi_query

ROOT = catalog.HERE.parent
CELLS = ["x1-broker.soak", "x1-inproc.soak", "x4-broker.soak", "x1-broker.busy"]
FAULTS = [(name, fault) for name in CELLS[:3] for fault in ("answer", "stale")]
FAULTS += [("x4-broker.soak", "collective"), ("x1-broker.busy", "busy_health")]
BUSY = "x1-broker.busy"
NVML_STEP_MIB = 1 / 16


def _judged(card, name, fault=None):
    """One short run of the cell, its checks and its run."""
    import torch

    bench = catalog.load_benchmark(ROOT)
    w = catalog.workload(bench, name)
    if torch.cuda.device_count() != w["chips"]:
        pytest.skip(f"{name} asks for {w['chips']} CUDA device(s), "
                    f"this machine holds {torch.cuda.device_count()}")
    config = copy.deepcopy(catalog.config(w["config"]))
    if fault:
        config["env"]["PORTBENCH_FAULT"] = fault
    with Nvml() as nvml:
        want = ref_labels.expected(nvml.node(), smi_query("name,driver_version,memory.total"))
    run = cell.run_cell(ROOT, w, config, catalog.traffic(w["traffic"]), 2.0, False, card)
    checks = cell.judge(run, cell.reference_readings(config, w["chips"], "cuda"), want)
    print(name, fault, {k: v["value"] for k, v in checks.items()})
    return checks, run


def _correct(card, name, fault=None):
    return cell.correct(_judged(card, name, fault)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(card, name):
    assert _correct(card, name)


@pytest.fixture(scope="module")
def sound_busy_mib():
    """``busy_mib_held`` of one sound run of the busy cell, once a module."""
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", range(3))
@pytest.mark.parametrize("fault", ["busy_keep", "busy_leak"])
def test_a_worker_that_keeps_memory_past_a_busy_failure_reads_it(card, sound_busy_mib, fault,
                                                                 repeat):
    held = catalog.reader("busy_mib_held")
    if "sound" not in sound_busy_mib:
        checks, run = _judged(card, BUSY)
        assert cell.correct(checks)
        sound_busy_mib["sound"] = held(run)
    checks, run = _judged(card, BUSY, fault)
    print("busy_mib_held", fault, sound_busy_mib["sound"], "->", held(run))
    # NVML's used memory moves by a 64 KiB step from run to run.
    assert held(run) >= sound_busy_mib["sound"] + 256 - NVML_STEP_MIB


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", range(3))
@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_probe_is_not_correct(card, name, fault, repeat):
    assert not _correct(card, name, fault)
