"""The yardstick's arithmetic: the window over its cycles, the tail of all
cycles, the roofline work counts, the trace's reduction and the judge."""

import copy
import importlib.util
import statistics
from pathlib import Path

import pytest

import catalog
import cell
import work

BOOT = Path(catalog.HERE) / "boot" / "sitecustomize.py"


def _boot():
    spec = importlib.util.spec_from_file_location("portbench_boot", BOOT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(stamps, **kw):
    return cell.Run(cell={"name": "x1-broker.soak", "chips": 1},
                    config=catalog.config("h100x1-daemonset"), stamps=stamps, **kw)


def test_probe_cycle_ms_is_the_window_over_its_cycles():
    stamps = [10.0, 10.010, 10.030, 10.036]
    assert catalog.reader("probe_cycle_ms")(_run(stamps)) == pytest.approx(36.0 / 3)
    assert catalog.reader("probe_cycle_ms")(_run([10.0])) is None


def test_probe_cycle_p95_ms_is_over_every_cycle():
    gaps = [5.0] * 90 + [50.0] * 10
    stamps = [0.0]
    for g in gaps:
        stamps.append(stamps[-1] + g / 1e3)
    got = catalog.reader("probe_cycle_p95_ms")(_run(stamps))
    ranked = sorted(gaps)
    # Linear interpolation between the order statistics at 0.95 * (n - 1).
    pos = 0.95 * (len(ranked) - 1)
    want = ranked[int(pos)] + (pos - int(pos)) * (ranked[int(pos) + 1] - ranked[int(pos)])
    assert got == pytest.approx(want, rel=1e-9)


def test_card_mib_held_is_the_fullest_cards_rise():
    run = _run([0.0, 1.0], used_base=[100 << 20, 200 << 20], used_end=[1300 << 20, 250 << 20])
    assert catalog.reader("card_mib_held")(run) == 1200.0
    assert catalog.reader("card_mib_held")(_run([0.0, 1.0])) is None


def test_spans_are_means_over_the_windows_edges():
    run = _run([0.0, 1.0],
               scrape_start={"tfd_cycle_duration_seconds_sum": 1.0,
                             "tfd_cycle_duration_seconds_count": 100.0},
               scrape_end={"tfd_cycle_duration_seconds_sum": 1.5,
                           "tfd_cycle_duration_seconds_count": 200.0})
    assert catalog.reader("labelgen_ms")(run) == pytest.approx(5.0)
    assert catalog.reader("broker_rpc_ms")(run) is None


def test_probe_card_ms_is_the_traces_busy_time_over_its_probes():
    trace = {"t0": 5.0, "t1": 6.0, "devices": {"0": {"busy_s": 0.003, "span_s": 0.9}}}
    records = [{"t": t} for t in (4.9, 5.2, 5.5, 6.1)]
    run = _run([0.0, 1.0], traces=[trace], records=records)
    assert catalog.reader("probe_card_ms")(run) == pytest.approx(1.5)
    assert catalog.reader("probe_card_ms")(_run([0.0, 1.0])) is None


def test_host_cpu_ms_is_the_windows_cpu_over_its_cycles():
    assert catalog.reader("host_cpu_ms")(_run([0.0, 0.5, 1.0], cpu_s=0.03)) == pytest.approx(15.0)


def test_roofline_work_counts():
    assert work.burnin_flops(2048, 4) == pytest.approx(68.72e9, rel=1e-3)
    assert work.burnin_bytes(2048, 4) == 5 * 2048 * 2048 * 2
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    assert work.bound_s(work.burnin_flops(2048, 4), work.burnin_bytes(2048, 4), peaks) == \
        pytest.approx(0.0695e-3, rel=1e-3)
    assert work.stream_bytes(256) == 268435456
    assert work.stream_bytes(256) / peaks["hbm_bytes"] == pytest.approx(0.08013e-3, rel=1e-3)


def test_spread_is_the_quartiles_over_the_median():
    values = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert work.spread(values) == (q3 - q1) / med


def test_the_trace_reduction_unions_busy_time_and_counts_replays():
    ops = [("mm", 0, 0, 100, (1, None)), ("sq", 0, 50, 100, (1, None)),
           ("stream_sum(x)", 0, 400, 100, (5, None)), ("mm", 0, 1000, 100, (None, 7))]
    doc = _boot().summarise(ops, {1, 7})
    assert doc["devices"]["0"] == {"busy_s": 350e-9, "span_s": 1100e-9}
    assert doc["graph"] == {"replays": 2, "kernels": 3, "seconds": 300e-9}
    assert doc["gaps"][0] == ("stream_sum(x) -> mm", 500e-9)
    assert work.kernel_time([doc], "stream_sum") == (100e-9, 1)
    run = _run([0.0, 1.0], traces=[dict(doc, host_window_s=1400e-9)])
    assert catalog.reader("device_idle_pct")(run) == pytest.approx(75.0)


def test_the_capture_reads_the_ports_own_readback(monkeypatch):
    """The wrapped probe records each device's pack from the program's
    own ``.cpu()``, the last pack of each device, and adds no readback."""
    import types

    import torch

    boot = _boot()
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *args, **kwargs):
        calls.append(1)
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    hc = types.SimpleNamespace(all_reduce=None, ring_shift=None, sharded_chip_verdicts=None,
                               ici_allreduce_probe=None, ici_ring_sweep=None)
    hc.health_pack = lambda cs, rms, total: torch.stack([cs, rms, total])

    def measure(devices):
        hc.health_pack(torch.tensor(0.0), torch.tensor(0.0), torch.tensor(0.0)).cpu()  # warm-up
        packs = [hc.health_pack(torch.tensor(float(i)), torch.tensor(1.0), torch.tensor(9.0))
                 for i, _ in enumerate(devices)]
        return [p.cpu().tolist() for p in packs]

    hc._measure_node_health_traced = measure
    boot._patch(hc)
    report = hc._measure_node_health_traced(["cuda:0", "cuda:1"])
    assert report == [[0.0, 1.0, 9.0], [1.0, 1.0, 9.0]]
    assert len(calls) == 3
    (record,) = boot._records
    assert [h.tolist() for h in record["values"]] == report


def _sound_run():
    ref = {"stream_sum": 1.0e6, "burnin": [{"checksum": 100.0, "rms": 1.0, "norm": 2048.0}]}
    want = {"nvidia.com/gpu.health.ok": "true"}
    labels = dict(want)
    labels.update({f"nvidia.com/gpu.{k}": "1" for k in (
        "health.matmul-tflops", "health.hbm-gbps", "health.probe-ms",
        "chip.0.tflops", "chip.0.hbm-gbps")})
    stamps = [1.0 + i * 0.01 for i in range(11)]
    probes = [{"t": s - 0.001, "values": [[100.0, 1.0, 1.0e6]]} for s in stamps[1:]]
    run = _run(stamps, probes=probes, labels=labels, all_stamps=list(stamps),
               scrape_times=[0.99, 0.995, 1.105, 1.11],
               scrape_start={'tfd_cycles_total{outcome="full"}': 5.0},
               scrape_end={'tfd_cycles_total{outcome="full"}': 15.0})
    return run, ref, want


def _correct(run, ref, want):
    return cell.correct(cell.judge(run, ref, want))


def test_the_judge_passes_a_sound_run():
    assert _correct(*_sound_run())


@pytest.mark.parametrize("full, gap", [(10.0, 0.0), (5.0, 0.0), (12.0, 0.0), (4.0, 1.0),
                                       (20.0, 8.0)])
def test_the_heartbeat_count_is_bounded_by_the_scrapes(full, gap):
    run, _, _ = _sound_run()
    run.scrape_end = {'tfd_cycles_total{outcome="full"}': 5.0 + full}
    # Stamped by the first scrape's response (plus the lag): 5; by the
    # second's request: 11; so 5..12 full cycles may lie between them.
    assert cell.heartbeat_count_gap(run) == gap


@pytest.mark.parametrize("fault", ["state-unchanged", "answer-altered", "checksum-altered",
                                   "label-altered", "no-probes"])
def test_the_judge_fails_each_fault(fault):
    run, ref, want = _sound_run()
    run = copy.deepcopy(run)
    if fault == "state-unchanged":
        run.probes = run.probes[:1]
    elif fault == "answer-altered":
        run.probes[3]["values"][0][2] += 65536.0
    elif fault == "checksum-altered":
        run.probes[3]["values"][0][0] += 0.05 * 2048
    elif fault == "label-altered":
        run.labels["nvidia.com/gpu.health.ok"] = "false"
    else:
        run.probes = []
    assert not _correct(run, ref, want)


HOST_FACTS = {"nvidia.com/gpu.count": "1", "nvidia.com/gpu.product": "nvidia-h100-80gb-hbm3"}


def _busy_run():
    """A sound run with a tenant: host facts and no verdict at each busy
    heartbeat, then the sound window."""
    run, ref, want = _sound_run()
    want = dict(want, **HOST_FACTS)
    run.labels.update(HOST_FACTS)
    run.tenant = {"held_bytes": [80 << 30]}
    run.busy_labels = [dict(HOST_FACTS, **{"nvidia.com/gpu.slice.capable": "true"})
                       for _ in range(20)]
    return run, ref, want


def test_the_judge_passes_a_sound_busy_run_and_holds_a_soak_to_no_busy_check():
    run, ref, want = _busy_run()
    checks = cell.judge(run, ref, want)
    assert checks["busy_health_labels"] == {"value": 0, "limit": 0}
    assert checks["busy_label_mismatches"] == {"value": 0, "limit": 0}
    assert cell.correct(checks)
    assert not {"busy_health_labels", "busy_label_mismatches"} & set(cell.judge(*_sound_run()))


@pytest.mark.parametrize("key, value", [
    ("nvidia.com/gpu.health.ok", "false"), ("nvidia.com/gpu.health.ok", "true"),
    ("nvidia.com/gpu.health.timing", "wall-clock"), ("nvidia.com/gpu.chips.sick", "1"),
    ("nvidia.com/gpu.chips.healthy", "0"), ("nvidia.com/gpu.chip.0.ok", "false"),
    ("nvidia.com/gpu.chip.12.tflops", "400")])
def test_a_verdict_at_one_busy_heartbeat_is_not_correct(key, value):
    run, ref, want = _busy_run()
    run.busy_labels[7][key] = value
    checks = cell.judge(run, ref, want)
    assert checks["busy_health_labels"]["value"] == 1
    assert not cell.correct(checks)


@pytest.mark.parametrize("fault", ["fact-missing", "fact-altered", "no-busy-heartbeat"])
def test_the_hosts_facts_at_the_busy_phases_end_are_held(fault):
    run, ref, want = _busy_run()
    last = run.busy_labels[-1]
    if fault == "fact-missing":
        del last["nvidia.com/gpu.count"]
    elif fault == "fact-altered":
        last["nvidia.com/gpu.product"] = "nvidia-h100-pcie"
    else:
        run.busy_labels = []
    checks = cell.judge(run, ref, want)
    assert not cell.correct(checks)
    if fault != "no-busy-heartbeat":
        assert checks["busy_label_mismatches"]["value"] == 1
        assert checks["busy_health_labels"]["value"] == 0
    else:
        assert checks["busy_health_labels"]["value"] is None
