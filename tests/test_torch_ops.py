"""The twin's health-check kernel tier (``tests/test_ops.py``) held against
the port's ``ops/healthcheck.py`` and ``ops/kernel_cache.py``, on the CPU.

The twin runs its jitted programs on 8 virtual CPU devices; the port
runs the same steps on as many ``torch.device("cpu")`` entries, where
each collective is the plain host sum. Each case runs both on the same
geometry and wants the same verdicts, shapes and counts; a rate is held
to being positive only (the parity rule: rates by plausibility gates).

The twin's persistent XLA compilation cache becomes the port's kernel
library directory (``--compilation-cache-dir``): exported per epoch,
usable or not without raising, re-pointed when a usable directory
appears, and keyed by the kernel's source and nvcc flags as the twin's
is keyed by driver version and topology."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu.ops import healthcheck as twin
from gpu_feature_discovery_tpu_torch.ops import collectives, healthcheck, hbm, kernel_cache
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

CPU = torch.device("cpu")


def _inputs(size=128, depth=2):
    return healthcheck._burnin_input_arrays(size, depth, torch.bfloat16, CPU)


def test_burnin_step_finite():
    fn, (x, ws) = twin.make_burnin_step(size=128, depth=2)
    twin_cs, twin_rms = jax.jit(fn)(x, ws)
    checksum, rms = healthcheck.burnin_step(*_inputs())
    assert bool(torch.isfinite(checksum)) and bool(torch.isfinite(rms))
    assert bool(jnp.isfinite(twin_cs)) and bool(jnp.isfinite(twin_rms))
    assert checksum.dtype == rms.dtype == torch.float32 and checksum.shape == ()


def test_burnin_step_deterministic():
    a = healthcheck.burnin_step(*_inputs())
    b = healthcheck.burnin_step(*_inputs())
    assert float(a[0]) == float(b[0]) and float(a[1]) == float(b[1])
    fn, args = twin.make_burnin_step(size=128, depth=2)
    assert float(jax.jit(fn)(*args)[0]) == float(jax.jit(fn)(*args)[0])


@pytest.mark.parametrize("size,depth", [(128, 2), (2048, 4), (512, 8)])
def test_burnin_flops(size, depth):
    assert healthcheck.burnin_flops(size, depth) == twin.burnin_flops(size, depth) \
        == 2 * depth * size**3


def test_measure_chip_health_reports():
    got = healthcheck.measure_chip_health(size=128, depth=2, iters=1, device=CPU)
    want = twin.measure_chip_health(size=128, depth=2, iters=1)
    assert got["healthy"] is want["healthy"] is True
    assert got["tflops"] > 0 and got["seconds"] > 0
    assert set(want) <= set(got) | {"checksum"}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_build_mesh_shapes(n):
    mesh = healthcheck.build_mesh(n, [CPU] * 8)
    assert mesh.devices.size == twin.build_mesh(n).devices.size == n
    assert mesh.axis_names == tuple(twin.build_mesh(n).axis_names) == ("data", "model")


def test_build_mesh_balanced_factoring():
    for n, shape in ((8, (4, 2)), (4, (2, 2))):
        assert healthcheck.build_mesh(n, [CPU] * 8).devices.shape == shape
        assert twin.build_mesh(n).devices.shape == shape


def test_ici_ring_sweep_passes_on_cpu_mesh():
    got = healthcheck.ici_ring_sweep(healthcheck.build_mesh(8, [CPU] * 8))
    assert got == twin.ici_ring_sweep(twin.build_mesh(8)) == {
        "links_ok": True, "allreduce_ok": True, "devices": 8}


def test_ici_ring_sweep_1d():
    from jax.sharding import Mesh as JaxMesh

    grid = np.empty(4, dtype=object)
    grid[:] = [CPU] * 4
    got = healthcheck.ici_ring_sweep(collectives.Mesh(grid, ("x",)))
    want = twin.ici_ring_sweep(JaxMesh(np.array(jax.devices()[:4]), ("x",)))
    assert got["links_ok"] and got["allreduce_ok"]
    assert got == want


def test_slice_train_step_decreases_loss():
    step, (params, x, y) = healthcheck.make_slice_train_step(healthcheck.build_mesh(8, [CPU] * 8))
    p, first = step(params, x, y)
    for _ in range(5):
        p, loss = step(p, x, y)
    assert float(loss) < float(first)


# ---------------------------------------------------------------------------
# the kernel library directory (the twin's compilation cache)
# ---------------------------------------------------------------------------

def test_kernel_cache_enables_from_the_resolved_directory(tmp_path):
    cache = tmp_path / "kernels"
    cache.mkdir()
    assert kernel_cache.configure_kernel_cache(str(cache)) is True
    assert kernel_cache.kernel_cache_dir() == cache
    assert kernel_cache.library_path(kernel_cache.HBM_STREAM_SUM_CU).parent == cache
    # Idempotent: configuring again changes nothing.
    assert kernel_cache.configure_kernel_cache(str(cache)) is True
    assert kernel_cache.kernel_cache_dir() == cache


def test_kernel_cache_without_a_directory_is_the_default(monkeypatch):
    monkeypatch.delenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, raising=False)
    kernel_cache.configure_kernel_cache("")
    assert kernel_cache.kernel_cache_dir() == kernel_cache.DEFAULT_BUILD_DIR
    assert kernel_cache.RESOLVED_CACHE_DIR_ENV not in __import__("os").environ


def test_kernel_cache_failure_is_nonfatal(tmp_path):
    """An unusable directory is reported, never raised: the cache holds
    builds, it is no labeling dependency."""
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file, not dir")
    assert kernel_cache.configure_kernel_cache(str(blocker / "sub")) is False


def test_kernel_cache_retries_when_the_directory_appears(tmp_path):
    blocker = tmp_path / "a-file"
    blocker.write_text("not a dir")
    assert kernel_cache.configure_kernel_cache(str(blocker / "x")) is False
    assert kernel_cache.configure_kernel_cache(str(blocker / "x")) is False
    good = tmp_path / "kernels"
    good.mkdir()
    assert kernel_cache.configure_kernel_cache(str(good)) is True
    assert kernel_cache.kernel_cache_dir() == good


def test_library_name_keys_by_source_and_flags(tmp_path, monkeypatch):
    """The twin's namespace keys the cache by driver version and topology;
    the port's library name by the kernel's source and nvcc flags, so an
    edited source or a new flag set can never load a stale library."""
    kernel_cache.configure_kernel_cache(str(tmp_path))
    source = tmp_path / "k.cu"
    source.write_text("// v1\n")
    first = kernel_cache.library_path(source)
    assert first == kernel_cache.library_path(source), "the name is stable"
    source.write_text("// v2\n")
    assert kernel_cache.library_path(source) != first, "an edited source re-keys"
    edited = kernel_cache.library_path(source)
    monkeypatch.setattr(kernel_cache, "NVCC_FLAGS", kernel_cache.NVCC_FLAGS + ("-G",))
    assert kernel_cache.library_path(source) != edited, "new flags re-key"
    assert kernel_cache.TARGET in first.name and "/" not in first.name


# ---------------------------------------------------------------------------
# probe workspaces and the warm-up
# ---------------------------------------------------------------------------

def test_probe_workspace_lives_on_its_target_device():
    """The twin's workspaces must be committed to their device, or chips
    1..n would never be probed. A torch tensor lives on the device it was
    built on; the pin is that each workspace is built on the device asked
    for and the pass runs there (the CPU; the card's are held by
    ``chip_smoke.py``)."""
    healthcheck.reset_probe_workspaces()
    try:
        x, ws = healthcheck._burnin_workspace(CPU, 128, 2, torch.bfloat16)
        assert x.device == ws.device == CPU
        buf = hbm.stream_workspace(CPU, 512)
        assert buf.device == CPU and buf.shape == (512, hbm.LANES)
        out, _ = healthcheck.burnin_step(*healthcheck._burnin_workspace(CPU, 128, 2,
                                                                       torch.bfloat16))
        assert out.device == CPU
        for d in jax.local_devices()[:2]:
            tx, tws = twin._burnin_workspace(d, 128, 2, jnp.bfloat16)
            assert tx.committed and tx.devices() == {d}
    finally:
        healthcheck.reset_probe_workspaces()


def test_releasing_probe_memory_clears_the_probe_caches():
    """The twin's ``JaxManager.release`` drops the probe caches keyed on a
    client's devices. A torch device outlives any manager, so the port's
    hook is ``release_probe_memory`` (after a probe that could not get
    device memory): every probe cache goes."""
    healthcheck._burnin_workspace(CPU, 128, 2, torch.bfloat16)
    hbm.stream_workspace(CPU, 512)
    healthcheck._warmed_probe_keys.add("sentinel")
    assert healthcheck._burnin_workspace.cache_info().currsize > 0
    healthcheck.release_probe_memory(RuntimeError("CUDA out of memory"))
    assert healthcheck._burnin_workspace.cache_info().currsize == 0
    assert hbm.stream_workspace.cache_info().currsize == 0
    assert not healthcheck._warmed_probe_keys


CUDA = (torch.device("cuda", 0),)


def test_warm_probe_kernels_honors_geometry_override(monkeypatch):
    seen = []
    monkeypatch.setattr(healthcheck, "_warm_probe_kernels",
                        lambda devices, size, depth, per_chip: seen.append((size, depth)) or 1.0)
    monkeypatch.setenv(healthcheck.BURNIN_GEOMETRY_ENV, "128x2")
    assert healthcheck.warm_probe_kernels_for(CUDA) > 0.0
    monkeypatch.delenv(healthcheck.BURNIN_GEOMETRY_ENV)
    healthcheck.warm_probe_kernels_for(CUDA)
    assert seen == [(128, 2), (healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH)]


def test_warm_probe_kernels_for_matches_probe_geometry_and_memoizes(monkeypatch):
    """A cold warm-up reports its cost, a second one is a memoised no-op
    (the twin's contract), with the device work stood in for on the CPU."""
    import contextlib

    class _Graph:
        def replay(self):
            pass

    built = []
    healthcheck.reset_probe_workspaces()
    monkeypatch.setattr(healthcheck, "_burnin_workspace", lambda d, s, dep, t: built.append((s, dep)))
    monkeypatch.setattr(healthcheck, "stream_workspace", lambda d, rows: rows)
    monkeypatch.setattr(healthcheck, "_burnin_graph",
                        lambda d, s, dep: (_Graph(), torch.tensor(1.0), torch.tensor(1.0)))
    monkeypatch.setattr(healthcheck, "_warm_collectives", lambda *a: None)
    monkeypatch.setattr(healthcheck, "hbm_stream_sum", lambda buf: torch.tensor(0.0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    try:
        assert healthcheck.warm_probe_kernels_for(CUDA) > 0.0
        assert healthcheck.warm_probe_kernels_for(CUDA) == 0.0
        assert built == [(healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH)]
        assert healthcheck.warm_probe_kernels_for((CPU,)) == 0.0  # nothing to warm
    finally:
        healthcheck._warmed_probe_keys.clear()
