"""On the card: a short run of each cell is correct, and with the timed
path broken underneath (``PORTBENCH_FAULT`` in the bootstrap) the judge
says not correct: a probe whose answer is altered where it is packed, a
probe that returns its previous state unrun and, over several cards, a
reduced value altered where the program reads it back. A cell runs where
the machine holds as many CUDA devices as it asks for, and skips
elsewhere: the daemon probes every card it finds."""

import copy

import pytest

import catalog
import cell
from reference import labels as ref_labels
from reference.nvml import Nvml, smi_query

ROOT = catalog.HERE.parent
CELLS = ["x1-broker.soak", "x1-inproc.soak", "x4-broker.soak"]
FAULTS = [(name, fault) for name in CELLS for fault in ("answer", "stale")]
FAULTS.append(("x4-broker.soak", "collective"))


def _correct(card, name, fault=None):
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
    return cell.correct(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(card, name):
    assert _correct(card, name)


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", range(3))
@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_probe_is_not_correct(card, name, fault, repeat):
    assert not _correct(card, name, fault)
