"""The collectives of a multi-GPU node: their plain reference, the judge's
``collective_gap`` and the labels it holds over several cards, the
readers of the collective layer, and the start-up hook's capture of the
port's own collective functions (on CPU tensors, where ``all_reduce`` is
the host sum and ``ring_shift`` a copy). One card reads as before."""

import copy
import importlib.util

import pytest
import torch

import catalog
import cell
import work
from reference import collectives
from reference import labels as ref_labels
from reference.nvml import Gpu, Node

BOOT = catalog.HERE / "boot" / "sitecustomize.py"
PREFIX = "nvidia.com/gpu"
SMI = ["NVIDIA H100 80GB HBM3", "580.159.03", "81559"]


def _boot():
    spec = importlib.util.spec_from_file_location("portbench_boot", BOOT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _node(n):
    return Node("580.159.03", 13000, (Gpu("NVIDIA H100 80GB HBM3", 81559 << 20, (9, 0), True),) * n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_the_reference_readings(n):
    want = collectives.expected(n, 32)
    assert want["counts"] == [n] * n
    assert want["element"] == float(n)
    assert want["sum"] == float(n) * 32 * 2**20 / 4
    assert want["received"] == [n - 1] + list(range(n - 1))
    assert want["totals"] == [sum(range(n))] * n


def _labels(want, chips):
    labels = dict(want)
    for key in ref_labels.PRESENT + (ref_labels.PRESENT_MULTI if chips > 1 else ()):
        labels[f"{PREFIX}.{key}"] = "1"
    for i in range(chips):
        labels[f"{PREFIX}.chip.{i}.tflops"] = labels[f"{PREFIX}.chip.{i}.hbm-gbps"] = "1"
    return labels


def _run(chips):
    """A sound run of ``chips`` cards: 10 window probes, every reading as
    the reference has it."""
    config = catalog.config("h100x4-daemonset" if chips > 1 else "h100x1-daemonset")
    want = ref_labels.expected(_node(chips), [SMI] * chips)
    ref = {"stream_sum": 1.0e6, "burnin": [{"checksum": 100.0, "rms": 1.0, "norm": 2048.0}] * chips}
    stamps = [1.0 + i * 0.01 for i in range(11)]
    probes = []
    for s in stamps[1:]:
        probe = {"t": s - 0.001, "values": [[100.0, 1.0, 1.0e6]] * chips}
        if chips > 1:
            probe["collective"] = {
                "counts": [[i, chips] for i in range(chips)],
                "allreduce": {"ok": True},
                "totals": [[i, chips * (chips - 1) // 2] for i in range(chips)],
                "sweep": {"links_ok": True},
            }
        probes.append(probe)
    after = {}
    if chips > 1:
        r = collectives.expected(chips, config["probe"]["allreduce_mib"])
        after = {"allreduce": [[r["sum"], r["element"], r["element"]]] * chips,
                 "received": list(r["received"])}
    run = cell.Run(cell={"name": "cell", "chips": chips}, config=config, stamps=stamps,
                   probes=probes, labels=_labels(want, chips), all_stamps=list(stamps),
                   scrape_times=[0.99, 0.995, 1.105, 1.11], after=after,
                   scrape_start={'tfd_cycles_total{outcome="full"}': 5.0},
                   scrape_end={'tfd_cycles_total{outcome="full"}': 15.0})
    return run, ref, want


def _checks(run, ref, want):
    return cell.judge(run, ref, want)


def test_a_sound_four_card_run_is_correct():
    checks = _checks(*_run(4))
    assert checks["collective_gap"] == {"value": 0.0, "limit": 0}
    assert checks["label_mismatches"]["value"] == 0
    assert cell.correct(checks)


def _break(run, fault):
    p = run.probes[4]["collective"]
    if fault == "count-altered":
        p["counts"][2][1] += 1
    elif fault == "count-missing":
        del p["counts"][3]
    elif fault == "allreduce-not-ok":
        p["allreduce"]["ok"] = False
    elif fault == "allreduce-skipped":
        del p["allreduce"]
    elif fault == "sweep-skipped":
        del p["sweep"], p["totals"]
    elif fault == "total-altered":
        p["totals"][1][1] = 7
    elif fault == "element-altered":
        run.after["allreduce"][1] = [run.after["allreduce"][1][0], 4.0, 5.0]
    elif fault == "sum-altered":
        run.after["allreduce"][3] = [run.after["allreduce"][3][0] + 1.0, 4.0, 4.0]
    elif fault == "buffer-dropped":
        run.after["allreduce"][0] = None
    elif fault == "link-rank-wrong":
        run.after["received"][2] = 0
    elif fault == "no-reading-after":
        run.after = {}
    elif fault == "ici-ok-missing":
        del run.labels[f"{PREFIX}.health.ici.ok"]
    elif fault == "ici-ok-false":
        run.labels[f"{PREFIX}.health.ici.ok"] = "false"
    elif fault == "ici-rate-missing":
        del run.labels[f"{PREFIX}.health.ici.allreduce-gbps"]
    elif fault == "straggler":
        run.labels[f"{PREFIX}.straggler-chip"] = "2"


@pytest.mark.parametrize("fault", [
    "count-altered", "count-missing", "allreduce-not-ok", "allreduce-skipped", "sweep-skipped",
    "total-altered", "element-altered", "sum-altered", "buffer-dropped", "link-rank-wrong",
    "no-reading-after", "ici-ok-missing", "ici-ok-false", "ici-rate-missing", "straggler"])
def test_a_four_card_run_fails_each_fault(fault):
    run, ref, want = _run(4)
    run = copy.deepcopy(run)
    _break(run, fault)
    checks = _checks(run, ref, want)
    assert not cell.correct(checks), checks


# The parent's checks and expected labels of a one-card run, names and
# values: the multi-card checks add nothing there.
ONE_CARD_CHECKS = {
    "unprobed_cycles": {"value": 0, "limit": 2},
    "heartbeat_count_gap": {"value": 0.0, "limit": 0},
    "hbm_sum_gap": {"value": 0.0, "limit": 0.0},
    "checksum_gap": {"value": 0.0, "limit": 0.012},
    "rms_gap": {"value": 0.0, "limit": 5e-05},
    "label_mismatches": {"value": 0, "limit": 0},
}
ONE_CARD_LABELS = [
    "count", "product", "memory", "driver.major", "driver.minor", "driver.rev", "runtime.major",
    "runtime.minor", "generation.major", "generation.minor", "slice.capable", "health.ok",
    "health.timing", "chips.healthy", "chips.sick", "family", "chip.0.ok"]


def test_one_card_reads_as_before():
    run, ref, want = _run(1)
    assert list(want) == [f"{PREFIX}.{k}" for k in ONE_CARD_LABELS]
    assert _checks(run, ref, want) == ONE_CARD_CHECKS
    # Neither the ici labels nor a straggler label count on one card.
    run.labels[f"{PREFIX}.straggler-chip"] = "0"
    assert _checks(run, ref, want) == ONE_CARD_CHECKS


def _traced(chips, ops, probe_times=(5.2, 5.5, 6.1)):
    trace = {"t0": 5.0, "t1": 6.0, "ops": ops, "devices": {}}
    run, _, _ = _run(chips)
    run.traces = [trace]
    run.records = [{"t": t} for t in probe_times]
    run.device_kind = "NVIDIA H100 80GB HBM3"
    return run


F32 = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
I32 = "ncclDevKernel_AllReduce_Sum_i32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
OPS = {F32: [0.0016, 8], I32: [0.0001, 8], SPIN: [0.004, 4], "stream_sum(x)": [0.5, 3]}


def test_the_collective_readers_on_a_trace():
    run = _traced(4, OPS)
    # 2 probes in the trace's window; a launch of 200 us against
    # 1.5 * 32 MiB at 450 GB/s.
    assert work.ring_bus_bytes(4, 32) == 1.5 * 32 * 2**20
    want = 100.0 * (1.5 * 32 * 2**20 / 450e9) / 200e-6
    assert catalog.reader("allreduce_roofline")(run) == pytest.approx(want)
    assert 0 < want < 100
    assert catalog.reader("gate_spin_ms")(run) == pytest.approx(2.0)
    assert catalog.reader("collective_card_ms")(run) == pytest.approx(0.85)


def test_the_multi_card_probe_card_ms_reads_as_probe_card_ms():
    run = _traced(4, OPS)
    run.traces[0]["devices"] = {str(i): {"busy_s": 0.011 + i * 1e-3, "span_s": 0.9} for i in range(4)}
    assert catalog.reader("probe_card_ms.multi")(run) == catalog.reader("probe_card_ms")(run)
    assert catalog.reader("probe_card_ms.multi")(run) == pytest.approx((0.044 + 0.006) / 2 * 1e3)


def test_the_collective_readers_read_nothing_on_one_card():
    run = _traced(1, {"stream_sum(x)": [0.5, 3]})
    for name in ("allreduce_roofline", "gate_spin_ms", "collective_card_ms"):
        assert catalog.reader(name)(run) is None
    assert catalog.reader("allreduce_roofline")(_traced(1, OPS)) is None
    # No probe inside the trace: nothing, not 0.
    assert catalog.reader("gate_spin_ms")(_traced(4, OPS, probe_times=(4.0,))) is None


NAMES = ("_measure_node_health_traced", "health_pack", "all_reduce", "ring_shift",
         "sharded_chip_verdicts", "ici_allreduce_probe", "ici_ring_sweep")


@pytest.fixture
def port(monkeypatch):
    """The port's healthcheck module with a stand-in for its CUDA-only
    timed probe (one pack per device, read back by ``.cpu()``); every
    attribute the hook wraps is restored afterwards."""
    import gpu_feature_discovery_tpu_torch.ops.healthcheck as hc

    for name in NAMES:
        monkeypatch.setattr(hc, name, getattr(hc, name))

    def traced(devices, *args, **kwargs):
        one = torch.tensor(1.0)
        return [hc.health_pack(one, one, one).cpu() for _ in devices]

    monkeypatch.setattr(hc, "_measure_node_health_traced", traced)
    return hc


def _probe(hc, n):
    devices = [torch.device("cpu")] * n
    hc._measure_node_health_traced(devices)
    verdicts = hc.sharded_chip_verdicts(devices, 16, 1)
    allr = hc.ici_allreduce_probe(devices) if n > 1 else None
    sweep = hc.ici_ring_sweep(hc.chip_mesh(devices)) if n > 1 else None
    return verdicts, allr, sweep


def test_the_hook_captures_the_ports_collectives(port):
    boot = _boot()
    boot._patch(port)
    verdicts, allr, sweep = _probe(port, 4)
    assert verdicts == ([True] * 4, True) and allr["checksum_ok"] and sweep["links_ok"]
    (record,) = boot._records
    assert record["collective"] == {
        "counts": [[i, 4] for i in range(4)], "allreduce": {"ok": True},
        "totals": [[i, 6] for i in range(4)], "sweep": {"links_ok": True}}
    # The payload on the CPU is 1 MiB a device: 262144 elements of 4.
    after = boot.read_after_window()
    assert after == {"allreduce": [[4.0 * 262144, 4.0, 4.0]] * 4, "received": [3, 0, 1, 2]}
    want = collectives.expected(4, 1)
    assert after["allreduce"][0] == [want["sum"], want["element"], want["element"]]
    assert after["received"] == want["received"]


def test_the_collective_fault_alters_one_cards_count_as_the_program_reads_it(port):
    boot = _boot()
    boot._FAULT = "collective"
    boot._patch(port)
    verdicts, allr, sweep = _probe(port, 4)
    # The program sees the altered count and says its reduction failed.
    assert verdicts == ([True] * 4, False)
    (record,) = boot._records
    assert record["collective"]["counts"] == [[0, 5], [1, 4], [2, 4], [3, 4]]


def test_the_hook_adds_nothing_on_one_device(port):
    boot = _boot()
    boot._patch(port)
    assert _probe(port, 1)[0] == ([True], True)
    (record,) = boot._records
    assert "collective" not in record
    assert boot._kept == {} and boot.read_after_window() == {}


def test_warm_ups_outside_a_probe_are_not_captured(port):
    boot = _boot()
    boot._patch(port)
    devices = [torch.device("cpu")] * 2
    port.sharded_chip_verdicts(devices, 16, 1)
    port.ici_ring_sweep(port.chip_mesh(devices))
    assert boot._records == [] and boot._kept == {}
