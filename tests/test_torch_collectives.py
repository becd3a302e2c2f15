"""Meshes, collectives and the collective probes: the PyTorch port
(gpu_feature_discovery_tpu_torch/ops/collectives.py and the ICI part of
ops/healthcheck.py) against its JAX twin (gpu_feature_discovery_tpu/ops/
healthcheck.py), on the CPU. The twin runs on the 8 virtual CPU devices
that conftest pins; the port on a list of as many ``torch.device("cpu")``
entries, where each collective is the plain host sum."""

import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm import health as twin_health
from gpu_feature_discovery_tpu.ops import healthcheck as twin
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.ops import collectives, healthcheck

CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_build_mesh_shape_and_axes_match_twin(n):
    mesh = healthcheck.build_mesh(n, [CPU] * 8)
    want = twin.build_mesh(n)
    assert mesh.devices.shape == want.devices.shape
    assert mesh.axis_names == tuple(want.axis_names) == ("data", "model")
    assert mesh.size == want.devices.size == n
    assert mesh.shape == dict(want.shape)


def test_build_mesh_needs_enough_devices(monkeypatch):
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        healthcheck.build_mesh(4, [CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 1 devices, have 0"):
        healthcheck.build_mesh(1)


def test_mesh_needs_one_name_per_axis():
    with pytest.raises(ValueError, match="axis names"):
        collectives.Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2), ("x",))


def test_axis_groups_follow_row_major_order():
    mesh = healthcheck.build_mesh(8, [CPU] * 8)
    assert collectives.axis_groups(mesh, "model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert collectives.axis_groups(mesh, "data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert collectives.axis_groups(healthcheck.chip_mesh([CPU] * 3), "chips") == [[0, 1, 2]]


def test_all_reduce_on_cpu_sums_into_every_entry():
    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    out = collectives.all_reduce(xs)
    for o in out:
        assert torch.equal(o, torch.full((2, 3), 6.0))
    assert [float(x[0, 0]) for x in xs] == [0.0, 1.0, 2.0, 3.0]  # inputs kept
    into = [torch.empty(2, 3) for _ in xs]
    assert collectives.all_reduce(xs, out=into) is not None
    assert all(torch.equal(o, torch.full((2, 3), 6.0)) for o in into)
    ints = collectives.all_reduce([torch.tensor([3], dtype=torch.int32)] * 3)
    assert ints[0].dtype == torch.int32 and int(ints[0]) == 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_all_reduce_over_one_device_is_its_own_value_without_nccl(dtype, monkeypatch):
    """The twin's psum over a one-chip mesh is the identity: one tensor
    is copied into its ``out``, and neither the NCCL check nor NCCL is
    reached."""
    import torch.cuda.nccl as nccl

    def refuse(*_a, **_k):
        raise AssertionError("NCCL reached over one device")

    monkeypatch.setattr(nccl, "all_reduce", refuse)
    monkeypatch.setattr(collectives, "_check_cuda_list", refuse)
    x = torch.arange(6, dtype=dtype).reshape(2, 3)
    kept = x.clone()
    into = [torch.full((2, 3), -1, dtype=dtype)]
    got = collectives.all_reduce([x], out=into)
    assert got[0] is into[0] and torch.equal(into[0], kept)
    assert torch.equal(x, kept)
    fresh = collectives.all_reduce([x])
    assert torch.equal(fresh[0], kept) and fresh[0].data_ptr() != x.data_ptr()


def test_all_reduce_refuses_what_nccl_cannot_take():
    with pytest.raises(ValueError, match="kinds"):
        collectives.all_reduce([torch.ones(1), torch.ones(1, device="meta")])
    with pytest.raises(ValueError, match="one shape"):
        collectives.all_reduce([torch.ones(1), torch.ones(2)])
    with pytest.raises(ValueError, match="empty"):
        collectives.all_reduce([])
    # The same CUDA device twice would make NCCL fail; the check runs
    # before NCCL is touched (objects standing in for CUDA tensors).
    twice = [types.SimpleNamespace(device=torch.device("cuda", 0))] * 2
    with pytest.raises(ValueError, match="one tensor per CUDA device"):
        collectives._check_cuda_list(twice)


def test_ring_shift_delivers_the_left_neighbour():
    got = collectives.ring_shift([torch.tensor([i]) for i in range(4)], [CPU] * 4)
    assert [int(t) for t in got] == [3, 0, 1, 2]


def _twin_1d_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("x",))


@pytest.mark.parametrize("shape", ["4x2", "1d-4", "1"])
def test_ring_sweep_matches_twin(shape):
    if shape == "4x2":
        want = twin.ici_ring_sweep(twin.build_mesh(8))
        got = healthcheck.ici_ring_sweep(healthcheck.build_mesh(8, [CPU] * 8))
    elif shape == "1d-4":
        want = twin.ici_ring_sweep(_twin_1d_mesh(4))
        got = healthcheck.ici_ring_sweep(collectives.Mesh([CPU] * 4, ("x",)))
    else:
        want = twin.ici_ring_sweep(_twin_1d_mesh(1))
        got = healthcheck.ici_ring_sweep(healthcheck.chip_mesh([CPU]))
    assert got == want
    assert got["links_ok"] is True and got["allreduce_ok"] is True


@pytest.mark.parametrize("perm", ["two-steps", "backwards"])
def test_ring_sweep_catches_a_misrouted_ring(monkeypatch, perm):
    step = 2 if perm == "two-steps" else -1
    monkeypatch.setattr(
        collectives, "_ring_perm",
        lambda size: [(i, (i + step) % size) for i in range(size)],
    )
    got = healthcheck.ici_ring_sweep(healthcheck.build_mesh(8, [CPU] * 8))
    assert got == {"links_ok": False, "allreduce_ok": True, "devices": 8}


def test_ring_sweep_catches_a_corrupt_reduction(monkeypatch):
    real = collectives.all_reduce
    monkeypatch.setattr(
        healthcheck, "all_reduce", lambda ts, out=None: [t + 1 for t in real(ts, out)]
    )
    got = healthcheck.ici_ring_sweep(healthcheck.build_mesh(4, [CPU] * 4))
    assert got == {"links_ok": True, "allreduce_ok": False, "devices": 4}


def test_allreduce_probe_matches_twin():
    want = twin.ici_allreduce_probe(jax.local_devices(), mib_per_chip=1, iters=2)
    got = healthcheck.ici_allreduce_probe([CPU] * 8, mib_per_chip=1, iters=2)
    assert set(got) == set(want)
    for key in ("checksum_ok", "devices", "bytes"):
        assert got[key] == want[key], key
    assert got["checksum_ok"] is True and got["bytes"] == 1 << 20
    # Both sides time the host clock: plausibility only.
    assert got["gbps"] > 0 and got["seconds"] > 0


def test_allreduce_probe_defaults_and_single_device():
    got = healthcheck.ici_allreduce_probe([CPU], iters=1)
    assert got["bytes"] == healthcheck.ICI_ALLREDUCE_MIB_DEFAULT << 20
    assert got["gbps"] == 0.0 and got["checksum_ok"] is True
    assert healthcheck.ICI_ALLREDUCE_MIB_CUDA == twin.ICI_ALLREDUCE_MIB_TPU
    assert healthcheck.ICI_ALLREDUCE_ITERS == twin.ICI_ALLREDUCE_ITERS


def test_allreduce_probe_checks_every_device(monkeypatch):
    real = collectives.all_reduce

    def last_device_off(ts, out=None):
        out = real(ts, out)
        out[-1][-1, -1] += 1.0  # one element of the last device's result
        return out

    monkeypatch.setattr(healthcheck, "all_reduce", last_device_off)
    healthcheck.reset_probe_workspaces()
    got = healthcheck.ici_allreduce_probe([CPU] * 4, mib_per_chip=1, iters=1)
    assert got["checksum_ok"] is False
    healthcheck.reset_probe_workspaces()


def test_reset_drops_the_allreduce_payloads():
    healthcheck.ici_allreduce_probe([CPU] * 2, mib_per_chip=1, iters=1)
    assert healthcheck._allreduce_workspace.cache_info().currsize > 0
    healthcheck.reset_probe_workspaces()
    assert healthcheck._allreduce_workspace.cache_info().currsize == 0


def _both_node_reports(**kwargs):
    want = twin.measure_node_health(
        size=64, depth=1, iters=1, devices=jax.local_devices(), per_chip=True, **kwargs
    )
    got = healthcheck.measure_node_health(
        size=64, depth=1, iters=1, devices=[CPU] * 8, per_chip=True, **kwargs
    )
    return want, got


@pytest.mark.parametrize("ici", [True, None])
def test_node_probe_collective_keys_match_twin(ici):
    want, got = _both_node_reports(ici=ici)
    for key in ("ici_ok", "chips_allreduce_ok", "ici_gbps", "healthy", "chips"):
        assert got[key] == want[key], key
    for phase in ("ici_ms", "ici_allreduce_ms"):
        assert (phase in got["phases"]) == (phase in want["phases"]), phase
    if ici:
        assert got["ici_ok"] is True and "ici_ms" in got["phases"]
    else:  # auto: CUDA (twin: TPU) nodes only
        assert got["ici_ok"] is None and "ici_ms" not in got["phases"]
    assert got["ici_gbps"] is None


def test_ici_on_one_device_raises_like_twin():
    with pytest.raises(ValueError, match="only one local device"):
        twin.measure_node_health(
            size=64, depth=1, iters=1, devices=jax.local_devices()[:1], ici=True
        )
    with pytest.raises(ValueError, match="only one local device"):
        healthcheck.measure_node_health(size=64, depth=1, iters=1, devices=[CPU], ici=True)


@pytest.mark.parametrize("ici", [False, True])
def test_verdict_disagreement_forces_ici_ok_false_like_twin(monkeypatch, ici):
    monkeypatch.setattr(twin, "sharded_chip_verdicts", lambda *a, **k: ([True] * 8, False))
    monkeypatch.setattr(
        healthcheck, "sharded_chip_verdicts", lambda *a, **k: ([True] * 8, False)
    )
    want, got = _both_node_reports(ici=ici)
    assert got["chips_allreduce_ok"] is want["chips_allreduce_ok"] is False
    assert got["ici_ok"] is want["ici_ok"] is False


def _fixed_report(n, ici_gbps, allreduce_ok=True, ici_ok=True):
    table = [{"id": i, "healthy": True, "tflops": 600.0 + i, "hbm_gbps": 2000.0 + i}
             for i in range(n)]
    return {
        "healthy": True, "tflops": 600.0, "hbm_gbps": 2000.0,
        "ici_ok": ici_ok if allreduce_ok else False, "chips": n, "per_chip": table,
        "ici_gbps": ici_gbps, "timing": "device-profiler",
        "chips_allreduce_ok": allreduce_ok, "phases": {},
    }


@pytest.mark.parametrize("allreduce_ok", [True, False])
def test_allreduce_rate_label_matches_twin(monkeypatch, allreduce_ok):
    monkeypatch.setattr(twin_health, "_spec_peaks", lambda manager: (989.0, 3350.0))
    monkeypatch.setattr(health, "_spec_peaks", lambda manager: (989.0, 3350.0))
    report = _fixed_report(8, 123.0, allreduce_ok=allreduce_ok)
    want = twin_health._labels_from_probe(
        twin_health._BurninSchedule(), None, twin_new_config(cli_values={}, environ={}),
        dict(report), None, 5.0,
    )
    got = health._labels_from_probe(
        health._BurninSchedule(), None, new_config(cli_values={}, environ={}),
        dict(report), None, 5.0,
    )
    translated = {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
                  for k, v in want.items()}
    assert dict(got) == translated
    assert health.HEALTH_ICI_GBPS == twin_health.HEALTH_ICI_GBPS.replace(
        "google.com/tpu.", "nvidia.com/gpu.", 1)
    if allreduce_ok:
        assert got["nvidia.com/gpu.health.ici.allreduce-gbps"] == "123"
        assert got[health.HEALTH_ICI] == "true"
    else:
        assert health.HEALTH_ICI_GBPS not in got
        assert got[health.HEALTH_ICI] == "false"


def test_allreduce_rate_label_needs_chip_probes(monkeypatch):
    monkeypatch.setattr(health, "_spec_peaks", lambda manager: (989.0, 3350.0))
    got = health._labels_from_probe(
        health._BurninSchedule(), None,
        new_config(cli_values={"chip-probes": "false"}, environ={}),
        _fixed_report(8, 123.0), None, 5.0,
    )
    assert health.HEALTH_ICI_GBPS not in got and got[health.HEALTH_ICI] == "true"


def test_broker_health_request_leaves_ici_to_the_worker(monkeypatch):
    """The worker's probe resolves ``ici`` itself (auto: multi-GPU CUDA
    nodes), as the twin's broker does: the request never pins it."""
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    calls = []

    def fake_measure(**kwargs):
        calls.append(kwargs)
        return {"healthy": True}

    monkeypatch.setattr(healthcheck, "measure_node_health", fake_measure)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_CPU_DEVICES", "8")
    outcome = broker._HealthProbe(threading.Lock()).request(
        {"per_chip": True, "wait_s": 10.0}
    )
    assert outcome["status"] == "ok"
    assert len(calls) == 1 and "ici" not in calls[0]
    assert calls[0]["per_chip"] is True and calls[0]["devices"] == [CPU] * 8


@pytest.mark.parametrize("n,per_chip,want", [
    (2, True, ["allreduce", "sweep"]),
    (2, False, ["sweep"]),
    (1, True, []),
])
def test_prewarm_runs_the_collectives_the_probe_will_run(monkeypatch, n, per_chip, want):
    """The communicators' set-up and the first sweep land in the
    pre-warm (the broker worker's, or the first probe's compile_ms),
    never in a timed probe. The CUDA-only steps are stubbed."""
    import contextlib

    healthcheck.reset_probe_workspaces()
    calls = []
    stub = types.SimpleNamespace(replay=lambda: None)
    monkeypatch.setattr(healthcheck, "_burnin_graph",
                        lambda d, s, k: (stub, torch.zeros(()), torch.zeros(())))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(healthcheck, "stream_workspace", lambda d, rows: None)
    monkeypatch.setattr(healthcheck, "hbm_stream_sum", lambda buf: torch.zeros((1, 1)))
    monkeypatch.setattr(healthcheck, "sharded_chip_verdicts", lambda *a, **k: None)
    monkeypatch.setattr(healthcheck, "ici_allreduce_probe",
                        lambda devices, **k: calls.append("allreduce"))
    monkeypatch.setattr(healthcheck, "ici_ring_sweep", lambda mesh: calls.append("sweep"))
    assert healthcheck._warm_probe_kernels((CPU,) * n, 64, 1, per_chip) > 0.0
    assert calls == want
    assert healthcheck._warm_probe_kernels((CPU,) * n, 64, 1, per_chip) == 0.0
    assert calls == want
    monkeypatch.undo()
    healthcheck.reset_probe_workspaces()
