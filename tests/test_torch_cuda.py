"""On-card tests of the PyTorch port (gpu_feature_discovery_tpu_torch).

Every test here needs a CUDA device: the hand-written kernel has no CPU
mode. They are marked ``cuda`` and skip where there is no device. This
file imports no JAX, so it also runs on a card machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck

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
