"""Burn-in and node probe: the PyTorch port
(gpu_feature_discovery_tpu_torch/ops/healthcheck.py) against its JAX twin
(gpu_feature_discovery_tpu/ops/healthcheck.py), both on the CPU at a small
geometry (128 wide, 2 deep)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu.ops import healthcheck as twin
from gpu_feature_discovery_tpu_torch.ops import healthcheck
from gpu_feature_discovery_tpu_torch.ops.carry import burnin_inputs_from_numpy

CPU = torch.device("cpu")
SIZE, DEPTH = 128, 2

# Tolerances. rms: relative, it is of order one. checksum: absolute, in
# units of size^2 — it is a sum of size^2 signed values that may lie near
# zero, while after the RMS normalisation every element is of order 1.
# float32 differs only in summation order: rms rel 1e-4, checksum 1e-4 x
# size^2. bf16 is rounded at different places in the two frameworks (each
# layer's output is cast back to bf16): rms rel 2e-2, checksum 2e-2 x
# size^2.
TOLERANCES = {
    "float32": (jnp.float32, 1e-4),
    "bfloat16": (jnp.bfloat16, 2e-2),
}


@pytest.mark.parametrize("dtype_name", sorted(TOLERANCES))
def test_burnin_step_matches_twin_on_carried_inputs(dtype_name):
    jdtype, tol = TOLERANCES[dtype_name]
    jx, jws = twin._burnin_input_arrays(SIZE, DEPTH, jdtype)
    want_cs, want_rms = (float(v) for v in twin.burnin_step(jx, jws))
    x, ws = burnin_inputs_from_numpy(np.asarray(jx), np.asarray(jws), CPU)
    assert x.dtype == getattr(torch, dtype_name)
    cs, rms = healthcheck.burnin_step(x, ws)
    assert cs.dtype == rms.dtype == torch.float32
    assert float(rms) == pytest.approx(want_rms, rel=tol)
    assert abs(float(cs) - want_cs) <= tol * SIZE**2


def test_carry_keeps_bf16_bits_exactly():
    jx, jws = twin._burnin_input_arrays(SIZE, DEPTH, jnp.bfloat16)
    x, ws = burnin_inputs_from_numpy(np.asarray(jx), np.asarray(jws), CPU)
    np.testing.assert_array_equal(
        x.float().numpy(), np.asarray(jx.astype(jnp.float32))
    )
    np.testing.assert_array_equal(
        ws.float().numpy(), np.asarray(jws.astype(jnp.float32))
    )


def test_burnin_flops_and_geometry_constants_match_twin():
    assert healthcheck.burnin_flops(2048, 4) == twin.burnin_flops(2048, 4)
    assert (healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH) == (
        twin.TPU_PROBE_SIZE, twin.TPU_PROBE_DEPTH
    )
    assert (healthcheck.PROBE_HBM_MIB, healthcheck.PROBE_HBM_ITERS) == (
        twin.PROBE_HBM_MIB, twin.PROBE_HBM_ITERS
    )
    assert (healthcheck.VERDICT_MAX_SIZE, healthcheck.VERDICT_MAX_DEPTH) == (
        twin.VERDICT_MAX_SIZE, twin.VERDICT_MAX_DEPTH
    )


def test_port_inputs_have_twin_distribution():
    x, ws = healthcheck._burnin_input_arrays(SIZE, DEPTH, torch.float32, CPU)
    assert x.shape == (SIZE, SIZE) and ws.shape == (DEPTH, SIZE, SIZE)
    # Standard normals, weights scaled by 1/sqrt(size).
    assert float(x.std()) == pytest.approx(1.0, rel=0.05)
    assert float(ws.std()) == pytest.approx(SIZE**-0.5, rel=0.05)


INPUT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.mark.parametrize("dtype_name", sorted(INPUT_DTYPES))
def test_port_inputs_are_the_same_for_the_same_seed(dtype_name):
    dtype = INPUT_DTYPES[dtype_name]
    x1, ws1 = healthcheck._burnin_input_arrays(SIZE, DEPTH, dtype, CPU)
    x2, ws2 = healthcheck._burnin_input_arrays(SIZE, DEPTH, dtype, CPU)
    assert torch.equal(x1, x2) and torch.equal(ws1, ws2)


@pytest.mark.parametrize("dtype_name", sorted(INPUT_DTYPES))
def test_port_inputs_keep_their_dtype_and_shape(dtype_name):
    dtype = INPUT_DTYPES[dtype_name]
    x, ws = healthcheck._burnin_input_arrays(SIZE, DEPTH, dtype, CPU)
    assert (x.dtype, tuple(x.shape)) == (dtype, (SIZE, SIZE))
    assert (ws.dtype, tuple(ws.shape)) == (dtype, (DEPTH, SIZE, SIZE))
    assert x.is_contiguous() and ws.is_contiguous()


def test_port_inputs_are_the_eager_expression_layer_by_layer():
    """Each layer is the seeded generator's next f32 normals rounded to
    bf16, and the weights are divided by sqrt(size) in bf16, as the eager
    ``randn(...).to(bf16) / scale.to(bf16)`` rounds them."""
    x, ws = healthcheck._burnin_input_arrays(SIZE, DEPTH, torch.bfloat16, CPU)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(0)
    layers = [torch.randn((SIZE, SIZE), generator=gen).to(torch.bfloat16)
              for _ in range(1 + DEPTH)]
    scale = torch.tensor(SIZE**0.5, dtype=torch.float32).to(torch.bfloat16)
    assert torch.equal(x, layers[0])
    assert torch.equal(ws, torch.stack(layers[1:]) / scale)


def _both_reports(**kwargs):
    jax_dev = jax.devices("cpu")[0]
    want = twin.measure_node_health(
        size=SIZE, depth=DEPTH, iters=1, devices=[jax_dev], per_chip=True, **kwargs
    )
    got = healthcheck.measure_node_health(
        size=SIZE, depth=DEPTH, iters=1, devices=[CPU], per_chip=True, **kwargs
    )
    return want, got


def test_measure_node_health_report_matches_twin():
    want, got = _both_reports()
    assert set(got) == set(want)
    for key in ("healthy", "chips", "chips_allreduce_ok", "timing", "hbm_gbps",
                "ici_ok", "ici_gbps"):
        assert got[key] == want[key], key
    # The port's entries also carry the device's UUID, which joins them to
    # NVML's index (None for a CPU device).
    assert set(got["per_chip"][0]) == set(want["per_chip"][0]) | {"uuid"}
    assert got["per_chip"][0]["uuid"] is None
    assert got["healthy"] is True


def test_sick_chip_reported_unhealthy_by_both():
    want, got = _both_reports(sick_chips=frozenset({0}))
    for report in (want, got):
        assert report["healthy"] is False
        assert report["per_chip"][0]["healthy"] is False
        assert report["chips_allreduce_ok"] is True


def test_sharded_verdicts_on_cpu_devices_match_twin():
    jax_devs = jax.devices("cpu")[:3]
    want = twin.sharded_chip_verdicts(jax_devs, SIZE, DEPTH, sick_chips={1})
    got = healthcheck.sharded_chip_verdicts([CPU] * 3, SIZE, DEPTH, sick_chips={1})
    assert got == want == ([True, False, True], True)


def test_slow_chip_scales_rate():
    report = healthcheck.measure_node_health(
        size=SIZE, depth=DEPTH, iters=1, devices=[CPU, CPU], per_chip=True,
        slow_chips=frozenset({1}),
    )
    assert report["tflops"] == report["per_chip"][1]["tflops"]
    assert report["per_chip"][1]["tflops"] < report["per_chip"][0]["tflops"]


def test_geometry_override(monkeypatch):
    monkeypatch.setenv(healthcheck.BURNIN_GEOMETRY_ENV, "64x1")
    assert healthcheck._probe_geometry_override() == (64, 1)
    monkeypatch.setenv(healthcheck.BURNIN_GEOMETRY_ENV, "64by1")
    with pytest.raises(ValueError):
        healthcheck._probe_geometry_override()


def test_default_devices_need_cuda_without_touching_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        healthcheck.measure_node_health(size=SIZE, depth=DEPTH, iters=1)


def test_health_pack_order():
    packed = healthcheck.health_pack(
        torch.tensor(1.5), torch.tensor(2.0), torch.full((1, 1), 3.0)
    )
    assert packed.dtype == torch.float32
    assert packed.tolist() == [1.5, 2.0, 3.0]


def test_warm_is_cuda_only_and_reset_drops_workspaces():
    from gpu_feature_discovery_tpu_torch.ops import hbm

    assert healthcheck.warm_probe_kernels_for((CPU,)) == 0.0
    hbm.stream_workspace(CPU, hbm.CHUNK_ROWS)
    healthcheck._burnin_workspace(CPU, SIZE, DEPTH, torch.float32)
    healthcheck.reset_probe_workspaces()
    assert hbm.stream_workspace.cache_info().currsize == 0
    assert healthcheck._burnin_workspace.cache_info().currsize == 0
