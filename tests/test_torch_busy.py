"""A busy device in the PyTorch port, on the CPU: a probe that cannot get
device memory reads the device unacquirable, not sick, as the twin reads
a chip it cannot acquire ("a merely-busy chip is not a failed one").

On a GPU the daemon shares the device with the node's workloads, which
may hold almost all of its memory. The port's probe then fails for want
of memory: the CUDA context's creation, an allocation of the burn-in or
the stream buffer, a CUDA stream's creation, cuBLAS's handle, NCCL's
communicator, or the stream kernel's launch.
Held here:

- the classifier (``ops.healthcheck.is_busy_error``), one case per text and
  type that counts as busy and one per error that must stay a failure;
- NCCL's communicator over several devices, whose error names no cause:
  busy before it is built on a device without room for it, or when its
  error comes from a device left without room; a failed probe otherwise;
- one device, whose verdicts need no communicator (the twin's psum over
  one chip): a card with less free than NCCL would take runs its
  verdicts and publishes the twin's health labels, in process and
  through the classic worker;
- the in-process path, the classic broker worker (``_HealthProbe``) and
  the MIG paths over several cycles, against the twin's in-process
  labeler whose ``_acquire_tpu_devices`` returns None on the busy
  cycles: the same labels, cache and failure and straggler streaks;
- a busy MIG device on ``mixed`` and under a valid ``single``: no health
  label, its fault shot given back, and no ``slice.sick-chips`` or
  cordon advice across three coordinated daemons;
- real processes: a classic broker worker whose first probe cannot get
  memory answers ``unacquirable``, stays up and answers the next request
  ``ok``; a pinned one-shot child ships ``busy``.

The failing allocation of the real processes is a start-up hook on
``PYTHONPATH`` (``sitecustomize``) that makes the burn-in inputs'
allocation raise ``torch.OutOfMemoryError`` a given number of times.
"""

import json
import os
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.ops import healthcheck
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.probe_targets import probe_targets
from gpu_feature_discovery_tpu_torch.resource.testing import FakeGpu, FakeNvml, fake_nvml
from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot, SnapshotManager
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging

GPU, TPU = "nvidia.com/gpu.", "google.com/tpu."
PROBE_MS = GPU + "health.probe-ms"
CPU = torch.device("cpu")
# CUDA devices for the probe's NCCL room check, whose every CUDA call the
# test stands in for.
CUDA0 = torch.device("cuda", 0)
CUDA_PAIR = (CUDA0, torch.device("cuda", 1))
NCCL_CUDA_ERROR = "NCCL Error 1: unhandled cuda error (run with NCCL_DEBUG=INFO for details)"
ILLEGAL_ADDRESS = ("CUDA error: an illegal memory access was encountered\n"
                   "CUDA kernel errors might be asynchronously reported at some other "
                   "API call, so the stacktrace below might be incorrect.")


# ---------------------------------------------------------------------------
# The classifier
# ---------------------------------------------------------------------------

def _raised_while_handling(cause, error):
    """``error`` raised while ``cause`` was handled (its __context__)."""
    try:
        try:
            raise cause
        except BaseException:
            raise error
    except BaseException as e:  # noqa: BLE001 - the chained exception
        return e


BUSY = {
    "allocator": torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 256.00 MiB. GPU 0 has a total capacity "
        "of 79.19 GiB of which 61.00 MiB is free."),
    "context": RuntimeError(
        "CUDA error: out of memory\nCUDA kernel errors might be asynchronously reported "
        "at some other API call, so the stacktrace below might be incorrect."),
    "by-name": RuntimeError("cudaErrorMemoryAllocation: out of memory"),
    # torch.cuda.Stream() on a card with no room for a stream.
    "stream": getattr(torch, "AcceleratorError", RuntimeError)(
        "CUDA error: out of memory\nSearch for `cudaErrorMemoryAllocation' in "
        "https://docs.nvidia.com/cuda/cuda-runtime-api/group__CUDART__TYPES.html for "
        "more information."),
    "cublas": RuntimeError(
        "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"),
    "kernel": RuntimeError("hbm_stream_sum kernel launch failed: cudaError 2"),
    "epilogue-kernel": RuntimeError("rms_epilogue kernel launch failed: cudaError 2"),
    "mig-fold": healthcheck.DeviceBusy("MIG device(s) busy: MIG-1: CUDA error: out of memory"),
    "capture-end": _raised_while_handling(
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 MiB."),
        RuntimeError("CUDA error: operation failed due to a previous error during "
                     "capture")),
    # What a probe process ships of one: the text alone.
    "shipped": "CUDA error: out of memory",
}

NOT_BUSY = {
    "illegal-address": RuntimeError(ILLEGAL_ADDRESS),
    "launch-failure": RuntimeError("CUDA error: unspecified launch failure"),
    "kernel-other-code": RuntimeError("hbm_stream_sum kernel launch failed: cudaError 20"),
    "kernel-illegal": RuntimeError("hbm_stream_sum kernel launch failed: cudaError 700"),
    "epilogue-kernel-other-code": RuntimeError(
        "rms_epilogue kernel launch failed: cudaError 20"),
    "cublas-execution": RuntimeError(
        "CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling `cublasGemmEx`"),
    "no-device": RuntimeError("the pinned device is not acquirable"),
    # NCCL's error names no cause: alone it is no busy device (the probe
    # reads the free memory as it is raised, below).
    "nccl-cuda-error": RuntimeError(NCCL_CUDA_ERROR),
    "bad-buffer": ValueError("buffer must be (k*512, 128), got (3, 128)"),
    "nan": FloatingPointError("nan"),
    "nothing": None,
}


@pytest.mark.parametrize("case", sorted(BUSY))
def test_a_busy_error_is_classified_busy(case):
    assert healthcheck.is_busy_error(BUSY[case])


@pytest.mark.parametrize("case", sorted(NOT_BUSY))
def test_any_other_error_is_not_busy(case):
    assert not healthcheck.is_busy_error(NOT_BUSY[case])


def test_every_busy_text_is_listed_once_and_each_has_a_case():
    texts = healthcheck.BUSY_ERROR_TEXTS
    assert len(set(texts)) == len(texts)
    cases = [str(e) for e in BUSY.values()]
    for text in texts:
        assert any(text in c for c in cases), text


# ---------------------------------------------------------------------------
# NCCL's communicator: its error says no cause, so the free memory decides
# ---------------------------------------------------------------------------

class _Card:
    """``torch.cuda.mem_get_info`` of a card whose free MiB the test sets
    (a list: one reading per call, the last repeated), and the probe's
    collectives: the verdicts, which fail with NCCL's error while
    ``nccl_fails``, the all-reduce probe and the ring sweep."""

    def __init__(self, monkeypatch, free_mib, nccl_fails=False):
        self.free_mib = list(free_mib)
        self.nccl_fails = nccl_fails
        self.readings = self.verdicts = self.allreduces = self.sweeps = 0
        monkeypatch.setattr(torch.cuda, "mem_get_info", self.mem_get_info)
        monkeypatch.setattr(healthcheck, "sharded_chip_verdicts", self.sharded_chip_verdicts)
        monkeypatch.setattr(healthcheck, "ici_allreduce_probe", self.ici_allreduce_probe)
        monkeypatch.setattr(healthcheck, "ici_ring_sweep", self.ici_ring_sweep)
        monkeypatch.setattr(healthcheck, "_nccl_built", set())

    def mem_get_info(self, device=None):
        self.readings += 1
        free = self.free_mib.pop(0) if len(self.free_mib) > 1 else self.free_mib[0]
        return int(free * 2**20), 81559 * 2**20

    def sharded_chip_verdicts(self, devices, size, depth, sick_chips=frozenset()):
        self.verdicts += 1
        if self.nccl_fails:
            raise RuntimeError(NCCL_CUDA_ERROR)
        return [True] * len(devices), True

    def ici_allreduce_probe(self, devices, iters=3):
        self.allreduces += 1
        return {"checksum_ok": True, "gbps": 1.0}

    def ici_ring_sweep(self, mesh):
        self.sweeps += 1
        return {"links_ok": True, "allreduce_ok": True, "devices": mesh.size}


def test_no_room_for_nccls_communicator_is_busy_before_it_is_built(monkeypatch):
    """Less free than NCCL's communicator takes on a device of two: busy,
    and NCCL is not called (a build that fails keeps what it had
    allocated)."""
    card = _Card(monkeypatch, [20000, healthcheck.NCCL_COMM_MIB - 1])
    with pytest.raises(healthcheck.DeviceBusy) as err:
        healthcheck._warm_collectives(CUDA_PAIR, 64, 1, True)
    assert card.verdicts == card.allreduces == card.sweeps == 0
    assert healthcheck.is_busy_error(err.value)
    assert "no room for NCCL's communicator" in str(err.value)
    assert "cuda:1" in str(err.value) and "cuda:0" not in str(err.value)


@pytest.mark.parametrize("free_after,busy", [(1, True), (20000, False)])
def test_nccls_cuda_error_is_busy_only_on_a_device_without_room(
        free_after, busy, monkeypatch):
    """NCCL's "unhandled cuda error" over two devices (its text on an H100
    whose free memory a workload took): busy when a device has less than
    the communicator takes as it is raised, a failed probe otherwise."""
    card = _Card(monkeypatch, [20000, 20000, free_after], nccl_fails=True)
    with pytest.raises(RuntimeError) as err:
        healthcheck._warm_collectives(CUDA_PAIR, 64, 1, True)
    assert card.verdicts == 1
    assert healthcheck.is_busy_error(err.value) is busy
    assert isinstance(err.value, healthcheck.DeviceBusy) is busy
    assert NCCL_CUDA_ERROR in (str(err.value.__cause__) if busy else str(err.value))


def test_a_built_communicator_needs_no_room_and_one_device_without_verdicts_no_nccl(
        monkeypatch):
    """Once the communicator over a device tuple is built, a full device
    does not stop the next warm-up; a probe of one device without
    per-device verdicts calls no collective at all."""
    card = _Card(monkeypatch, [20000, 20000, 1])
    healthcheck._warm_collectives(CUDA_PAIR, 64, 1, True)
    healthcheck._warm_collectives(CUDA_PAIR, 64, 1, True)
    assert card.verdicts == card.allreduces == card.sweeps == 2
    fresh = _Card(monkeypatch, [1])
    healthcheck._warm_collectives((CUDA0,), 64, 1, False)
    assert fresh.verdicts == fresh.allreduces == fresh.sweeps == fresh.readings == 0


def test_one_device_without_room_for_nccl_runs_its_verdicts(monkeypatch):
    """Fault 8: one device with less free than NCCL's communicator takes.
    Its verdicts need no communicator (the twin's psum over one chip), so
    the warm-up reads no free memory, raises nothing and runs the
    verdicts once, and no other collective."""
    card = _Card(monkeypatch, [healthcheck.NCCL_COMM_MIB - 1])
    healthcheck._warm_collectives((CUDA0,), 64, 1, True)
    assert card.verdicts == 1
    assert card.allreduces == card.sweeps == card.readings == 0
    assert healthcheck._nccl_built == set()


# ---------------------------------------------------------------------------
# Over several cycles, against the twin's unacquirable reading
# ---------------------------------------------------------------------------

CHIPS = 4
# One label cycle each: a probe that returns (with a straggler candidate,
# chip 3), one that cannot get device memory (the twin: no chip
# acquirable), one whose computation fails (an illegal address), and a
# busy one into which a chip.2.sick shot was loaded.
SCRIPT = ["ok", "busy", "ok", "fail", "busy", "fail", "ok", "busy+shot", "ok"]


def _entries(seed):
    """Four devices' results, seeded, inside a v4's and an H100's
    plausible bands; chip 3 a straggler candidate."""
    rng = np.random.default_rng(seed)
    tflops = rng.uniform(140.0, 180.0, CHIPS)
    tflops[3] = 10.0
    return [{"healthy": True, "tflops": float(t), "tflops_best": float(t) * 1.01,
             "hbm_gbps": float(rng.uniform(700.0, 1000.0))} for t in tflops]


def _report(entries, sick=()):
    entries = [dict(e, healthy=e["healthy"] and i not in sick, id=i)
               for i, e in enumerate(entries)]
    return {"healthy": all(e["healthy"] for e in entries),
            "tflops": min(e["tflops"] for e in entries),
            "hbm_gbps": min(e["hbm_gbps"] for e in entries), "ici_ok": None,
            "chips": len(entries), "per_chip": entries, "timing": "device-profiler",
            "phases": {"compile_ms": 0.0}, "chips_allreduce_ok": True, "ici_gbps": None}


class _Script:
    """Where the cycles stand: the current step, and the measure both
    packages' probes call (a chip.<i>.sick shot marks chip i sick)."""

    def __init__(self, chips=CHIPS):
        self.step = "ok"
        self.seed = 0
        self.chips = chips

    def measure(self, devices=None, sick_chips=(), **_):
        if self.step == "busy":
            raise BUSY["allocator"]
        if self.step == "fail":
            raise RuntimeError(ILLEGAL_ADDRESS)
        return _report(_entries(self.seed)[:self.chips], sick=set(map(int, sick_chips)))


def _load(step):
    """A step's probe outcome (``busy+shot`` is busy)."""
    return step.split("+")[0]


def _twin_cycles(monkeypatch, script, steps=SCRIPT, accelerator="v4-8"):
    """The twin's in-process labeler over SCRIPT on a node of
    ``script.chips`` chips: on a busy step its acquisition returns None,
    as for a chip that another process holds."""
    from gpu_feature_discovery_tpu.config import new_config as twin_new_config
    from gpu_feature_discovery_tpu.lm import health as twin_health
    from gpu_feature_discovery_tpu.ops import healthcheck as twin_healthcheck
    from gpu_feature_discovery_tpu.resource.testing import new_single_host_manager
    from gpu_feature_discovery_tpu.utils import faults as twin_faults

    monkeypatch.setattr(twin_health, "_acquire_tpu_devices",
                        lambda: None if script.step == "busy" else [object()] * script.chips)
    monkeypatch.setattr(twin_healthcheck, "measure_node_health", script.measure)
    manager = new_single_host_manager(accelerator)
    manager.init()
    config = twin_new_config(cli_values={"oneshot": True, "with-burnin": True,
                                         "burnin-interval": "1"}, environ={})
    twin_health.reset_burnin_schedule()
    twin_faults.reset()
    out = []
    try:
        for i, step in enumerate(steps):
            script.step, script.seed = _load(step), i
            if step.endswith("+shot"):
                twin_faults.load_fault_spec("chip.2.sick:fail:1")
            labels = dict(twin_health.new_health_labeler(manager, config).labels())
            sched = twin_health._schedules[manager]
            out.append(_state({k.replace(TPU, GPU, 1): v for k, v in labels.items()}, sched))
    finally:
        twin_health.reset_burnin_schedule()
        twin_faults.reset()
    return out


def _state(labels, sched):
    """One cycle's labels (less probe-ms, a clock reading) and what the
    schedule carries into the next cycle."""
    cached = None if sched.cached is None else {
        k.replace(TPU, GPU, 1): v for k, v in dict(sched.cached).items()}
    return ({k: v for k, v in labels.items() if k != PROBE_MS}, cached,
            sched.consecutive_failures, sched.straggler is None)


class _WorkerClient:
    """The classic broker worker's health RPC served in this process by
    the worker's own ``_HealthProbe``, its outcome crossing JSON."""

    def __init__(self, devices=(CPU,) * CHIPS):
        self.probe = broker_mod._HealthProbe(threading.Lock(), lambda: list(devices))

    def health(self, **request):
        return json.loads(json.dumps(self.probe.request(dict(request, wait_s=30.0))))

    def kill_child(self):
        pass


@pytest.fixture
def clean(monkeypatch):
    faults.reset()
    health.reset_burnin_schedule()
    tfd_logging.reset_warn_once()
    yield
    faults.reset()
    health.reset_burnin_schedule()
    tfd_logging.reset_warn_once()


def _port_cycles(manager, config, script, steps=SCRIPT):
    out = []
    for i, step in enumerate(steps):
        script.step, script.seed = _load(step), i
        if step.endswith("+shot"):
            faults.load_fault_spec("chip.2.sick:fail:1")
        labels = dict(health.new_health_labeler(manager, config).labels())
        out.append(_state(labels, health._schedules[manager]))
    return out


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_a_busy_device_reads_as_the_twins_unacquirable_chip(path, clean, monkeypatch):
    """The classic probe, in process (torch.OutOfMemoryError from the
    probe) and through the worker's ``_HealthProbe`` (which answers
    ``unacquirable`` and drops what the attempt allocated), over the
    cycles of SCRIPT: each cycle's labels, cache and streaks are the
    twin's whose acquisition fails on the busy cycles. A busy gap resets
    the failure streak (two failures either side are not consecutive)
    and the straggler streak (chip 3 is never confirmed), and a chip shot
    taken into a busy cycle comes back for the next."""
    script = _Script()
    want = _twin_cycles(monkeypatch, script)
    monkeypatch.setattr(healthcheck, "measure_node_health", script.measure)
    released = []
    real_release = healthcheck.release_probe_memory
    monkeypatch.setattr(healthcheck, "release_probe_memory",
                        lambda e=None: (released.append(str(e)), real_release(e)))
    manager = StaticCudaManager.mock_gpu(CHIPS)
    manager.init()
    if path == "broker":
        manager.broker = _WorkerClient()
    else:
        monkeypatch.setattr(health, "_acquire_devices", lambda: [CPU] * CHIPS)
    config = new_config(cli_values={"with-burnin": "true", "burnin-interval": "1",
                                    "oneshot": "true" if path == "in-process" else "false",
                                    "machine-type-file": ""}, environ={})
    got = _port_cycles(manager, config, script)
    assert len(got) == len(want) == len(SCRIPT)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, SCRIPT[i])
    busy = [i for i, step in enumerate(SCRIPT) if step.startswith("busy")]
    assert all(got[i][0] == {} and got[i][1] is None for i in busy)
    assert got[SCRIPT.index("fail", 4) + 0][1] is None, "a second failure across a gap is a first"
    assert not any(GPU + "straggler-chip" in g[0] for g in got)
    assert got[-1][0][GPU + "chip.2.ok"] == "false", "the shot came back after the busy cycle"
    assert len(released) == len(busy)


class _OneGpuNode:
    """A node of one GPU whose workload leaves it less free than NCCL's
    communicator takes (the ``_Card``): the real ``measure_node_health``,
    warm-up and collectives' warm-up, with the CUDA-only steps stood in
    for — the inputs, the stream buffer, the graph, the kernel, and the
    timed windows, whose report the script gives."""

    def __init__(self, monkeypatch, script):
        import contextlib
        import functools
        import types

        self.card = _Card(monkeypatch, [healthcheck.NCCL_COMM_MIB - 1])
        stub = types.SimpleNamespace(replay=lambda: None)
        zero = torch.zeros(())
        # Caches, as the real ones are: release_probe_memory clears them.
        monkeypatch.setattr(healthcheck, "_burnin_workspace",
                            functools.lru_cache()(lambda *a: (zero, zero)))
        monkeypatch.setattr(healthcheck, "stream_workspace",
                            functools.lru_cache()(lambda d, rows: None))
        monkeypatch.setattr(healthcheck, "_burnin_graph", lambda d, s, k: (stub, zero, zero))

        def kernel(buf):
            return torch.zeros((1, 1))

        kernel.launches = 0
        monkeypatch.setattr(healthcheck, "hbm_stream_sum", kernel)
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(healthcheck, "device_uuids", lambda devices: [None] * len(devices))

        def traced(devices, size, depth, iters, per_chip):
            healthcheck._warm_probe_kernels(tuple(devices), size, depth, per_chip)
            return script.measure(devices=devices)

        monkeypatch.setattr(healthcheck, "_measure_node_health_traced", traced)
        monkeypatch.setattr(healthcheck, "_warmed_probe_keys", set())


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_one_gpu_without_room_for_nccl_publishes_the_twins_health(path, clean, monkeypatch):
    """Fault 8: one GPU whose workload leaves it less free than NCCL's
    communicator would take. The twin's probe of one chip needs no
    communicator, and neither does the port's: in process and through
    the classic worker's ``_HealthProbe``, every cycle publishes the
    twin labeler's health labels (an earlier tree read the device
    unacquirable at NCCL's room check and published none)."""
    script = _Script(chips=1)
    steps = ["ok"] * 3
    want = _twin_cycles(monkeypatch, script, steps, accelerator="v5litepod-1")
    node = _OneGpuNode(monkeypatch, script)
    manager = StaticCudaManager.mock_gpu(1)
    manager.init()
    if path == "broker":
        manager.broker = _WorkerClient(devices=(CUDA0,))
    else:
        monkeypatch.setattr(health, "_acquire_devices", lambda: [CUDA0])
    config = new_config(cli_values={"with-burnin": "true", "burnin-interval": "1",
                                    "oneshot": "true" if path == "in-process" else "false",
                                    "machine-type-file": ""}, environ={})
    got = _port_cycles(manager, config, script, steps)
    assert got == want
    for labels, _, _, _ in got:
        assert labels[GPU + "health.ok"] == "true" and labels[GPU + "chip.0.ok"] == "true"
    assert node.card.verdicts == 1 + len(steps), "one warm-up, then one per probe"
    assert node.card.readings == node.card.allreduces == node.card.sweeps == 0


def _mig_node(layout):
    """The labeling process's manager of a FakeNvml MIG node, as the
    classic worker's snapshot ships it."""
    nvml_manager = NvmlManager(fake_nvml(layout) if isinstance(layout, str) else layout)
    nvml_manager.init()
    return SnapshotManager(DeviceSnapshot.from_dict(json.loads(json.dumps(
        DeviceSnapshot.from_manager(nvml_manager).to_dict()))))


class _NoPlainGpu:
    """The classic worker of a node whose GPUs are all in MIG mode."""

    def health(self, **_):
        raise AssertionError("no plain GPU: the classic worker probes nothing")

    def kill_child(self):
        pass


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_a_busy_mig_device_reads_as_the_twins_unacquirable_chip(path, clean, monkeypatch):
    """One GPU of four 1g.10gb MIG devices under a valid single: each
    device probed in its child (the seam stands in for it), device 2's
    child unable to get memory on the busy cycles. Over SCRIPT's cycles
    less the failing ones (a MIG child's failure is its own device's
    verdict, which the twin's whole-probe failure is not), the labels,
    cache and streaks are the twin's for four chips."""
    script = _Script()
    steps = [s for s in SCRIPT if s != "fail"]
    want = _twin_cycles(monkeypatch, script, steps)
    manager = _mig_node(FakeNvml([FakeGpu(bus_id=None, mig_mode=nvml.NVML_DEVICE_MIG_ENABLE,
                                          mig=["1g.10gb"] * CHIPS)]))
    targets = probe_targets(manager, "single")
    slot_of = {t.key: t.index for t in targets.mig}

    def child(target, config, request, pid_box=None):
        i = slot_of[target.key]
        if script.step == "busy" and i == 2:
            return {"status": "unacquirable", "error": "CUDA error: out of memory"}
        report = _report(_entries(script.seed), sick={i} if request["sick_chips"] else ())
        entry = dict(report["per_chip"][i], id=0, uuid=None)
        one = dict(report, healthy=entry["healthy"], tflops=entry["tflops"],
                   hbm_gbps=entry["hbm_gbps"], chips=1, per_chip=[entry])
        return json.loads(json.dumps({"status": "ok", "report": one, "probe_ms": 1.0}))

    monkeypatch.setattr(health, "_probe_mig_in_child", child)
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    if path == "broker":
        manager.broker = _NoPlainGpu()
    config = new_config(cli_values={"with-burnin": "true", "burnin-interval": "1",
                                    "tpu-topology-strategy": "single",
                                    "oneshot": "true" if path == "in-process" else "false",
                                    "machine-type-file": ""}, environ={})
    got = _port_cycles(manager, config, script, steps)
    assert len(got) == len(want) == len(steps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, steps[i])
    assert got[-1][0][GPU + "chip.2.ok"] == "false", "the shot came back after the busy round"


@pytest.mark.parametrize("path", ["in-process", "broker"])
@pytest.mark.parametrize("layout,busy", [("mixed", (1, 0)), ("single", (0, 1))])
def test_a_busy_mig_device_publishes_no_health_and_gives_its_shot_back(
        layout, busy, path, clean, monkeypatch):
    """A busy MIG device (the one ``chip.1.*`` names: under mixed GPU 1's
    first, under single the second MIG device) on the MIG fakes of
    tests/torch_mig_fakes.py: no health.*, chips.* or chip.<i>.* label
    while it is busy, though the other devices' probes were fine; its
    chip.1.sick shot comes back, and the next round, once the device is
    free, delivers it."""
    from torch_mig_fakes import MigWorkers

    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    workers = MigWorkers(monkeypatch, busy={busy})
    manager = _mig_node(layout)
    if path == "broker":
        manager.broker = _NoPlainGpu()
    config = new_config(cli_values={"with-burnin": "true", "burnin-interval": "1",
                                    "tpu-topology-strategy": layout,
                                    "oneshot": "true" if path == "in-process" else "false",
                                    "machine-type-file": ""}, environ={})
    faults.load_fault_spec("chip.1.sick:fail:1")
    labels = dict(health.new_health_labeler(manager, config).labels())
    assert labels == {}
    assert workers.asked(busy)[0]["sick_chips"] == [0], "the shot rode the busy probe"
    assert len({w for w, _ in workers.requests}) == len(probe_targets(manager, layout).mig)
    assert health._schedules[manager].cached is None
    workers.busy.clear()
    labels = dict(health.new_health_labeler(manager, config).labels())
    assert labels[GPU + "health.ok"] == "false"
    assert labels[GPU + "chip.1.ok"] == "false" and labels[GPU + "chip.0.ok"] == "true"
    assert labels[GPU + "chips.sick"] == "1"


def test_a_busy_mig_device_reaches_neither_slice_sick_chips_nor_advice(tmp_path, monkeypatch):
    """Three coordinated daemons on ``mixed`` MIG nodes with
    ``--actuation enforce``, GPU 1's first MIG device busy on every node:
    the slice forms, and over many cycles no node publishes a health
    label or chips.sick, the leader's slice.sick-chips stays 0 and no
    node is advised. (With the device sick instead, tests/
    test_torch_actuation.py shows the same daemons advise.)"""
    from test_torch_actuation import _no_advice_for, _wait
    from torch_slice_fixture import PortSliceHarness
    from torch_mig_fakes import MigWorkers

    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    workers = MigWorkers(monkeypatch, busy={(1, 0)})
    cli = {"actuation": "enforce", "actuation-window": "2", "with-burnin": "true",
           "burnin-interval": "1"}
    with PortSliceHarness(tmp_path / "mig", workers=3, backends="mock-nvml:mixed",
                          extra_cli=cli) as mig:
        snap = _wait(mig, lambda s: s[0].get(GPU + "slice.role") == "leader"
                     and s[0].get(GPU + "slice.healthy-hosts") == "3"
                     and all(GPU + "count" in s[w] for w in range(3)),
                     "the slice of three")
        seen = len(workers.requests)
        _no_advice_for(mig, seconds=1.5)
        snap = {w.worker_id: w.labels() for w in mig.workers}
    assert len(workers.requests) > seen + 6, "the nodes kept probing"
    for labels in snap.values():
        assert not [k for k in labels if k.startswith((GPU + "health.", GPU + "chip"))], labels
    assert snap[0].get(GPU + "slice.sick-chips", "0") == "0"
    assert not [k for k in snap[0] if k.endswith(("schedulable", "cordon-advice"))]


# ---------------------------------------------------------------------------
# Real processes: a classic broker worker and a pinned one-shot child
# ---------------------------------------------------------------------------

_HOOK = """\
import os

_left = [int(os.environ.get("TFD_TEST_BUSY_ALLOCATIONS", "0"))]
if _left[0]:
    from gpu_feature_discovery_tpu_torch.ops import healthcheck as _hc
    import torch as _torch

    _real = _hc._burnin_input_arrays

    def _inputs(*args, **kwargs):
        if _left[0]:
            _left[0] -= 1
            raise _torch.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 16.00 MiB. GPU 0 has a total "
                "capacity of 79.19 GiB of which 9.00 MiB is free.")
        return _real(*args, **kwargs)

    _hc._burnin_input_arrays = _inputs
"""


@pytest.fixture
def busy_processes(tmp_path, monkeypatch, clean):
    """Children started from here run the hook: their first N
    allocations of the burn-in inputs cannot get memory."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(textwrap.dedent(_HOOK))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(hook), os.environ.get("PYTHONPATH")) if p))
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    monkeypatch.delenv("TFD_FAULT_SPEC", raising=False)
    return monkeypatch


def test_a_busy_classic_worker_stays_up_and_answers_the_next_request(
        tmp_path, busy_processes):
    """A real classic worker whose first probe cannot get memory: the
    request answers ``unacquirable`` with the allocator's error, the
    worker stays up (same pid), and the next request probes ``ok``; the
    labels of the busy cycle are none, of the next the health labels."""
    busy_processes.setenv("TFD_TEST_BUSY_ALLOCATIONS", "1")
    config = new_config(cli_values={"with-burnin": "true", "burnin-interval": "1",
                                    "backends": "mock-gpu:2", "probe-timeout": "60s",
                                    "chip-probes": "false",
                                    "output-file": str(tmp_path / "tfd")}, environ={})
    client = broker_mod.BrokerClient(config)
    try:
        manager = broker_mod.BrokerManager(client)
        pid = client.pid
        outcomes = []
        deadline = time.monotonic() + 60
        while len(outcomes) < 2 and time.monotonic() < deadline:
            outcome = client.health(per_chip=False)
            if outcome["status"] != "warming":
                outcomes.append(outcome)
        assert [o["status"] for o in outcomes] == ["unacquirable", "ok"], outcomes
        assert "CUDA out of memory" in outcomes[0]["error"]
        assert client.pid == pid and client.alive
        health.reset_burnin_schedule()
        labels = dict(health.new_health_labeler(manager, config).labels())
        while not labels and time.monotonic() < deadline:
            labels = dict(health.new_health_labeler(manager, config).labels())
        assert labels[GPU + "health.ok"] == "true"
    finally:
        client.close()


def test_a_pinned_child_that_cannot_get_memory_ships_busy(busy_processes):
    """The ``health`` op in a one-shot child pinned to a MIG UUID whose
    allocation fails: the child ships ``busy``, which the MIG probe reads
    as the twin's ``unacquirable``, not as a failed device."""
    from gpu_feature_discovery_tpu_torch.resource.probe_targets import MigTarget
    from gpu_feature_discovery_tpu_torch.resource.testing import fake_mig_uuid
    from gpu_feature_discovery_tpu_torch.sandbox.probe import run_probe

    busy_processes.setenv("TFD_TEST_BUSY_ALLOCATIONS", "1")
    config = new_config(cli_values={"with-burnin": "true", "probe-timeout": "60s",
                                    "tpu-topology-strategy": "single"}, environ={})
    uuid = fake_mig_uuid(0, 0)
    result = run_probe("health", config, 60.0, pin=uuid, request={"per_chip": True})
    assert result.status == "busy", result
    assert result.error_type == "OutOfMemoryError" and "CUDA out of memory" in result.error
    outcome = health._probe_mig_in_child(MigTarget(uuid=uuid, gpu=0, slot=0, index=0),
                                         config, {"per_chip": True})
    assert outcome["status"] == "unacquirable" and "CUDA out of memory" in outcome["error"]
    # Without the failing allocation the same child probes its device.
    busy_processes.setenv("TFD_TEST_BUSY_ALLOCATIONS", "0")
    result = run_probe("health", config, 60.0, pin=uuid, request={"per_chip": True})
    assert result.status == "ok" and result.payload["healthy"] is True
