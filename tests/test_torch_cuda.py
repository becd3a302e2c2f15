"""On-card tests of the PyTorch port (gpu_feature_discovery_tpu_torch).

Every test here needs a CUDA device: the hand-written kernel has no CPU
mode. They are marked ``cuda`` and skip where there is no device. This
file imports no JAX, so it also runs on a card machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import math
import time

import pytest
import torch

from gpu_feature_discovery_tpu_torch.ops import (
    collectives,
    device_timing,
    hbm,
    healthcheck,
    rms_epilogue,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("chunks", [1, 9, 1024])
def test_kernel_matches_plain_version(dev, chunks):
    rows = chunks * hbm.CHUNK_ROWS
    before = hbm.hbm_stream_sum.launches
    got = hbm.hbm_stream_sum(hbm.stream_pattern(rows, dev))
    assert hbm.hbm_stream_sum.launches == before + 1
    assert got.device == dev and got.shape == (1, 1)
    assert float(got[0, 0]) == hbm.expected_stream_sum(rows)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chunks)
    rnd = torch.rand((rows, hbm.LANES), generator=gen, device=dev)
    got = float(hbm.hbm_stream_sum(rnd)[0, 0])
    want = float(hbm.hbm_stream_sum_reference(rnd)[0, 0])
    # rel 1e-6: per-thread f32 slices against an all-f64 sum.
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("chunks", [1, 9, 1024])
def test_kernel_is_exact_on_the_tile_pattern_and_catches_every_slip(dev, chunks):
    """The chunk pattern's slot twins and the tile pattern's: a slip of
    the 4-stage ring between two tiles of one chunk leaves the chunk
    pattern's sum unchanged, so only the tile pattern can catch it."""
    rows = chunks * hbm.CHUNK_ROWS
    chunk, tile = hbm.CHUNK_ROWS, hbm.TILE_ROWS
    for make, want in ((hbm.stream_pattern, hbm.expected_stream_sum(rows)),
                       (hbm.tile_pattern, hbm.expected_tile_pattern_sum(rows))):
        buf = make(rows, dev)
        assert float(hbm.hbm_stream_sum(buf)[0, 0]) == want
    tiles = hbm.tile_pattern(rows, dev)
    want = hbm.expected_tile_pattern_sum(rows)
    slipped = tiles.clone()
    slipped[:tile] = tiles[4 * tile:5 * tile]
    doubled = tiles.clone()
    doubled[tile:2 * tile] = tiles[:tile]
    for bad in (slipped, doubled):
        assert float(hbm.hbm_stream_sum(bad)[0, 0]) != want
    if chunks > 4:
        pattern = hbm.stream_pattern(rows, dev)
        aliased = pattern.clone()
        aliased[:chunk] = pattern[4 * chunk:5 * chunk]
        assert float(hbm.hbm_stream_sum(aliased)[0, 0]) != hbm.expected_stream_sum(rows)


def test_kernel_is_bitwise_deterministic(dev):
    rows = hbm.probe_rows(256)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rnd = torch.rand((rows, hbm.LANES), generator=gen, device=dev)
    first = hbm.hbm_stream_sum(rnd)
    for _ in range(3):
        assert torch.equal(hbm.hbm_stream_sum(rnd).view(torch.int32),
                           first.view(torch.int32))


def test_kernel_leaves_its_ticket_counter_at_zero_per_stream(dev):
    """One counter per (device, stream), back at 0 after every launch; a
    launch on a side stream takes its own."""
    rows = 9 * hbm.CHUNK_ROWS
    buf = hbm.stream_pattern(rows, dev)
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        got_side = hbm.hbm_stream_sum(buf)
    got_main = hbm.hbm_stream_sum(buf)
    torch.cuda.synchronize(dev)
    assert float(got_side[0, 0]) == float(got_main[0, 0]) == hbm.expected_stream_sum(rows)
    counters = [hbm.launch_scratch(dev, s.cuda_stream)[1] for s in (main, side)]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert [int(c.item()) for c in counters] == [0, 0]


def test_kernel_raises_instead_of_falling_back(dev):
    flat = torch.ones(hbm.CHUNK_ROWS * hbm.LANES + 1, device=dev)
    misaligned = flat[1:].view(hbm.CHUNK_ROWS, hbm.LANES)
    before = hbm.hbm_stream_sum.launches
    with pytest.raises(ValueError, match="aligned"):
        hbm.hbm_stream_sum(misaligned)
    assert hbm.hbm_stream_sum.launches == before


def test_measure_hbm_bandwidth_on_card(dev):
    report = hbm.measure_hbm_bandwidth(total_mib=64, iters=3, device=dev)
    assert report["checksum_ok"] is True
    assert report["interpreted"] is False
    assert report["gbps"] > 0


def test_node_probe_on_card_matches_cpu_report_shape(dev):
    got = healthcheck.measure_node_health(
        size=256, depth=2, iters=2, devices=[dev], per_chip=True
    )
    cpu = healthcheck.measure_node_health(
        size=128, depth=2, iters=1, devices=[torch.device("cpu")], per_chip=True
    )
    assert set(got) == set(cpu)
    assert got["timing"] == "device-profiler"
    assert got["healthy"] is True and got["chips_allreduce_ok"] is True
    assert got["hbm_gbps"] is not None


def test_probe_entries_join_nvml_by_uuid_on_card(dev):
    """Each probed device's UUID (torch's bare hex) is one of NVML's
    GPUs (``GPU-`` prefixed), and the label index the health labeler
    derives from it is that GPU's NVML index."""
    from gpu_feature_discovery_tpu_torch.lm.health import _label_indices
    from gpu_feature_discovery_tpu_torch.native import nvml
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import nvml_chip

    inv = nvml.read_inventory()
    report = healthcheck.measure_node_health(
        size=128, depth=2, iters=1, devices=[dev], per_chip=True,
        inventory_uuids=[d.uuid for d in inv.devices])
    (entry,) = report["per_chip"]
    nvml_uuids = [nvml.normalize_uuid(d.uuid) for d in inv.devices]
    assert entry["uuid"] in nvml_uuids

    class _Inventory:
        def get_chips(self):
            return [nvml_chip(d) for d in inv.devices]

    indices = _label_indices(_Inventory(), report["per_chip"])
    if len(inv.devices) == 1:
        assert indices == [0]
    else:  # CUDA lists one device of several: no per-device label
        assert indices is None


def test_sick_chip_on_card(dev):
    verdicts, allreduce_ok = healthcheck.sharded_chip_verdicts(
        [dev], 128, 2, sick_chips={0}
    )
    assert verdicts == [False] and allreduce_ok is True


def test_warm_runs_once_per_geometry(dev, monkeypatch):
    monkeypatch.setenv(healthcheck.BURNIN_GEOMETRY_ENV, "128x2")
    healthcheck.reset_probe_workspaces()
    assert healthcheck.warm_probe_kernels_for((dev,)) > 0.0
    assert healthcheck.warm_probe_kernels_for((dev,)) == 0.0
    healthcheck.reset_probe_workspaces()


def test_graphed_burnin_matches_eager_and_times_the_device(dev):
    healthcheck.reset_probe_workspaces()
    size, depth = healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH
    x, ws = healthcheck._burnin_workspace(dev, size, depth, healthcheck.PROBE_DTYPE)
    eager_cs, eager_rms = healthcheck.burnin_step(x, ws)
    graph, cs, rms = healthcheck._burnin_graph(dev, size, depth)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert float(cs) == float(eager_cs)
    assert float(rms) == float(eager_rms)

    report = healthcheck.measure_node_health(devices=[dev], per_chip=False)
    reps = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    back_to_back_ms = start.elapsed_time(end) / reps
    # rel 0.15: a single replay's window adds the graph's launch latency
    # on the device, which back-to-back replays hide.
    assert report["phases"]["burnin_device_ms"] == pytest.approx(
        back_to_back_ms, rel=0.15
    )
    healthcheck.reset_probe_workspaces()


def test_daemon_first_probe_runs_off_the_labeling_thread(dev, monkeypatch):
    import threading

    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import CudaManager

    threads = []
    measure = healthcheck.measure_node_health

    def spy(**kwargs):
        threads.append(threading.current_thread().name)
        return measure(**kwargs)

    monkeypatch.setattr(healthcheck, "measure_node_health", spy)
    healthcheck.reset_probe_workspaces()
    health.reset_burnin_schedule()
    manager = CudaManager()
    manager.init()
    config = new_config(
        cli_values={"with-burnin": "true", "burnin-interval": "1"}, environ={}
    )
    labels = {}
    for _ in range(10):  # each cycle waits at most FIRST_PROBE_WAIT_S
        labels = health.new_health_labeler(manager, config).labels()
        if labels:
            break
    assert threads == ["tfd-burnin-first-probe"]
    assert labels[health.HEALTH_OK] == "true"
    assert labels[health.HEALTH_TIMING] == "device-profiler"
    health.new_health_labeler(manager, config).labels()
    assert threads[1] == threading.current_thread().name
    health.reset_burnin_schedule()


def test_broker_worker_probes_the_card_with_the_kernel(dev, tmp_path):
    """The burn-in through the broker worker: a fresh process that holds
    the card, pre-warms, and ships a device-clock report counting its own
    kernel launches; this process launches none."""
    import time

    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.sandbox import BrokerClient

    config = new_config(
        cli_values={"with-burnin": "true", "backends": "gpu",
                    "output-file": str(tmp_path / "tfd")},
        environ={},
    )
    before = hbm.hbm_stream_sum.launches
    client = BrokerClient(config)
    try:
        assert client.snapshot().chips
        deadline = time.monotonic() + 60
        outcome = {"status": "warming"}
        while outcome["status"] == "warming" and time.monotonic() < deadline:
            outcome = client.health(per_chip=True)
    finally:
        client.close()
    assert outcome["status"] == "ok", outcome
    report = outcome["report"]
    assert report["healthy"] is True and report["timing"] == "device-profiler"
    phases = report["phases"]
    assert phases["hbm_stream_sum_launches"] in (3, 4)
    assert phases["hbm_stream_sum_launches_process"] == 4  # warm-up + 3
    assert hbm.hbm_stream_sum.launches == before


def test_cuda_manager_takes_nvmls_gpus_on_card(dev):
    """On the card NVML loads, the CUDA manager's chips are NVML's (one
    per CUDA device with MIG off), and the NVML-only manager enumerates
    the same GPUs with the same memory, capability and versions."""
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import CudaManager
    from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager

    cuda, native = CudaManager(), NvmlManager()
    cuda.init()
    native.init()
    assert cuda.nvml_inventory is not None
    assert len(cuda.get_chips()) == torch.cuda.device_count()
    facts = lambda m: sorted(  # noqa: E731
        (c.get_name(), c.get_total_memory_mb(), c.get_generation(),
         c.is_slice_capable(), c.is_slice_enabled()) for c in m.get_chips())
    assert facts(cuda) == facts(native)
    assert cuda.get_driver_version() == native.get_driver_version()
    assert cuda.get_runtime_version() == native.get_runtime_version()
    assert cuda.get_chips()[0].get_generation() == torch.cuda.get_device_capability(0)


def test_slice_train_step_on_card_matches_cpu(dev):
    """The DP+TP step on a 1x1 mesh on the card against the same step on
    the CPU, at carried weights; f32 with TF32 off on both sides."""
    import numpy as np

    from gpu_feature_discovery_tpu_torch.ops import carry

    rng = np.random.default_rng(0)
    weights = {
        "w1": (rng.standard_normal((128, 256)) / np.sqrt(128)).astype(np.float32),
        "w2": (rng.standard_normal((256, 128)) / np.sqrt(256)).astype(np.float32),
    }
    x = rng.standard_normal((32, 128)).astype(np.float32)
    y = rng.standard_normal((32, 128)).astype(np.float32)
    results = []
    for device in (dev, torch.device("cpu")):
        mesh = healthcheck.build_mesh(1, [device])
        params = carry.slice_params_from_numpy(weights, mesh)
        xs, ys = carry.slice_batch_from_numpy(x, y, mesh)
        step, _ = healthcheck.make_slice_train_step(mesh, params=params, batch_xy=(xs, ys))
        new, loss = step(params, xs, ys)
        assert loss.device == device
        results.append((carry.slice_params_to_numpy(new, mesh), float(loss)))
    (card, card_loss), (cpu, cpu_loss) = results
    # rtol 1e-5, atol 1e-6: only the order of the f32 sums differs.
    assert card_loss == pytest.approx(cpu_loss, rel=1e-5, abs=1e-6)
    for key in ("w1", "w2"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=1e-5, atol=1e-6)


def test_allreduce_probe_and_sweep_on_card(dev):
    report = healthcheck.ici_allreduce_probe([dev], mib_per_chip=32, iters=3)
    assert report["checksum_ok"] is True and report["bytes"] == 32 << 20
    assert report["gbps"] == 0.0 and report["seconds"] > 0  # one rank
    sweep = healthcheck.ici_ring_sweep(healthcheck.chip_mesh([dev]))
    assert sweep == {"links_ok": True, "allreduce_ok": True, "devices": 1}
    with pytest.raises(ValueError, match="only one local device"):
        healthcheck.measure_node_health(devices=[dev], per_chip=True, ici=True)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: the gate holds a multi-card collective")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_timing_gate_opens_once_the_host_has_queued_and_by_its_watchdog(cards):
    """The gate over every local card holds three timed 32 MiB all-reduces
    until the host has queued them, for less than the 1.01 ms the capped
    spin before it took; a host that sleeps 3 ms before opening finds
    every card timed out near the 1 ms watchdog, not at 3 ms."""
    rows = (32 << 20) // (hbm.LANES * 4)
    ones = [torch.ones((rows, hbm.LANES), device=d) for d in cards]
    out = [torch.empty_like(t) for t in ones]
    collectives.all_reduce(ones, out=out)  # the communicator, outside the gate
    gate = device_timing.gated_windows(cards, lambda: collectives.all_reduce(ones, out=out), 3)
    assert gate.held and gate.outcomes == ("released",) * len(cards)
    assert gate.gate_s < 1.01e-3 and len(gate.windows) == 3
    assert all(bool(torch.all(o == float(len(cards)))) for o in out)
    late = device_timing.gated_windows(cards, lambda: time.sleep(3e-3), 1)
    assert not late.held and late.outcomes == ("timed_out",) * len(cards)
    assert 0.95e-3 <= late.gate_s < 1.5e-3


def test_a_probes_cuda_operations_lie_inside_its_device_span(dev):
    """The shared clock: one probe under torch.profiler (CUDA activities),
    its span export's measured offset applied to the program's spans:
    every CUDA operation of the probe lies inside ``probe.device``, within
    50 us at each end."""
    from torch.profiler import ProfilerActivity, profile

    from gpu_feature_discovery_tpu_torch.obs import spans
    from gpu_feature_discovery_tpu_torch.utils import timing

    healthcheck.measure_node_health(devices=[dev], per_chip=True)  # first use
    torch.cuda.synchronize()
    spans.reset()
    timing.begin_cycle()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        healthcheck.measure_node_health(devices=[dev], per_chip=True)
    spans.end_cycle()
    export = spans.chrome_trace()
    offset = export["otherData"]["offsets_ns"][str(spans._pid)]
    window = [s for s in spans.snapshot() if s[3] == "probe.device"]
    assert len(window) == 1
    lo, hi = window[0][4] + offset["offset_ns"], window[0][5] + offset["offset_ns"]
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    assert len(ops) >= 5, ops
    early = [(n, lo - s) for n, s, _ in ops if s < lo - 50_000]
    late = [(n, e - hi) for n, _, e in ops if e > hi + 50_000]
    assert not early and not late, (early, late)
    first = min(s for _, s, _ in ops) - lo
    last = hi - max(e for _, _, e in ops)
    print(f"probe.device {(hi - lo) / 1e3:.1f} us; first op {first / 1e3:.1f} us after "
          f"its start, last op ends {last / 1e3:.1f} us before its end; "
          f"{len(ops)} ops; offset {offset['offset_ns']} ns from {offset['source']}")


# ---------------------------------------------------------------------------
# The burn-in's RMS epilogue (ops/rms_epilogue.py) against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("size, depth", [(2048, 4), (512, 8), (128, 2), (37, 2)])
def test_epilogue_matches_plain_version_layer_by_layer(dev, size, depth, sms):
    """The burn-in chain at the probe's, the CPU's and the verdicts'
    geometries and at one whose layers are no multiple of the 8-float
    vector, on a grid of one SM, of a MIG 1g slice and of the card."""
    import chip_smoke

    sms = min(sms, torch.cuda.get_device_properties(dev).multi_processor_count)
    x, ws = healthcheck._burnin_input_arrays(size, depth, torch.bfloat16, dev)
    carry = x
    for i, w in enumerate(ws):
        y = healthcheck._matmul_f32(carry, w)
        last = i == depth - 1
        before = rms_epilogue.rms_epilogue.launches
        got = rms_epilogue._launch(y, last, sms=sms)
        assert rms_epilogue.rms_epilogue.launches == before + 2
        assert got[0].dtype == torch.bfloat16 and got[0].shape == y.shape
        assert got[1].shape == () and got[1].device == dev
        assert (got[2] is not None) == last
        # chip_smoke.EPILOGUE_LIMITS: rms within rel 1e-6 (only the order
        # of the sum of squares differs), every carry element within one
        # bf16 step and under 0.1% of them off, the checksum within f32
        # summation error of the kernel's own carry.
        agreement = chip_smoke.epilogue_agreement(y, got)
        assert ("checksum_vs_f64_sum" in agreement) == last
        chip_smoke.check_epilogue_agreement(agreement, f"layer {i}")
        carry = got[0]


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")])
def test_epilogue_carries_nan_and_inf_into_rms_and_checksum(dev, value):
    y = torch.randn((256, 256), device=dev)
    y[17, 203] = value
    carry, rms, total = rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True)
    plain_carry, plain_rms, plain_total = rms_epilogue.rms_epilogue_reference(
        y, torch.bfloat16, checksum=True)
    assert not math.isfinite(float(rms)) and not math.isfinite(float(plain_rms))
    assert math.isnan(float(total)) and math.isnan(float(plain_total))


def test_epilogue_is_bitwise_deterministic(dev):
    x, ws = healthcheck._burnin_workspace(dev, 2048, 4, torch.bfloat16)
    y = healthcheck._matmul_f32(x, ws[0])

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    first = rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True)
    for _ in range(3):
        again = rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True)
        for a, b in zip(first, again):
            assert torch.equal(bits(a), bits(b))


def test_epilogue_leaves_its_ticket_counter_at_zero_per_stream(dev):
    """One counter per (device, stream), back at 0 after every launch; a
    launch on a side stream takes its own."""
    y = torch.randn((512, 512), device=dev)
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        got_side = rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True)
    got_main = rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True)
    torch.cuda.synchronize(dev)
    assert float(got_side[1]) == float(got_main[1])
    assert float(got_side[2]) == float(got_main[2])
    counters = [rms_epilogue.launch_scratch(dev, s.cuda_stream)[1] for s in (main, side)]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert [int(c.item()) for c in counters] == [0, 0]


@pytest.mark.parametrize(
    "case", ["float64", "non_contiguous", "one_d", "empty", "float16_carry", "misaligned"])
def test_epilogue_refuses_before_any_launch(dev, case):
    import chip_smoke

    y, dtype, text = chip_smoke.epilogue_rejections(dev)[case]
    before = rms_epilogue.rms_epilogue.launches
    with pytest.raises(ValueError, match=text):
        rms_epilogue.rms_epilogue(y, dtype, checksum=True)
    assert rms_epilogue.rms_epilogue.launches == before


def test_burnin_step_on_card_runs_the_epilogue_kernels(dev):
    """Eager and as the probe's graph: two epilogue kernels a layer, the
    products the only other kernels."""
    from torch.profiler import ProfilerActivity, profile

    healthcheck.reset_probe_workspaces()
    size, depth = healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH
    x, ws = healthcheck._burnin_workspace(dev, size, depth, healthcheck.PROBE_DTYPE)
    before = rms_epilogue.rms_epilogue.launches
    cs, rms = healthcheck.burnin_step(x, ws)
    assert rms_epilogue.rms_epilogue.launches == before + 2 * depth
    assert math.isfinite(float(cs)) and math.isfinite(float(rms))
    graph, _, _ = healthcheck._burnin_graph(dev, size, depth)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    ours = [n for n in names if "rms_sumsq" in n or "rms_scale_cast" in n]
    assert len(ours) == 2 * depth, names
    assert len(names) - len(ours) == depth, names
    healthcheck.reset_probe_workspaces()
