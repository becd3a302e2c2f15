"""The DP+TP slice train step and the dry run: the PyTorch port
(gpu_feature_discovery_tpu_torch/ops/healthcheck.py make_slice_train_step,
gpu_feature_discovery_tpu_torch/entry.py) against its JAX twin
(gpu_feature_discovery_tpu/ops/healthcheck.py, __graft_entry__.py), on the
CPU. The twin's weights and batch cross as numpy arrays (ops/carry.py)."""

import math

import jax
import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu.ops import healthcheck as twin
from gpu_feature_discovery_tpu_torch import entry
from gpu_feature_discovery_tpu_torch.ops import carry, collectives, healthcheck

CPU = torch.device("cpu")

# f32 on both sides; only the order of the sums differs (XLA's sharded
# program against per-device matmuls and host-summed seams).
RTOL, ATOL = 1e-5, 1e-6


def _carried(n):
    """One twin step on its n-device mesh, and the port's step on the same
    weights and batch: ``(twin_out, port_step, port_inputs, port_mesh)``."""
    jmesh = twin.build_mesh(n)
    jstep, (jp, jx, jy) = twin.make_slice_train_step(jmesh)
    weights = {k: np.asarray(v) for k, v in jp.items()}
    x, y = np.asarray(jx), np.asarray(jy)
    jnew, jloss = jstep(jp, jx, jy)
    mesh = healthcheck.build_mesh(n, [CPU] * n)
    params = carry.slice_params_from_numpy(weights, mesh)
    xs, ys = carry.slice_batch_from_numpy(x, y, mesh)
    step, _ = healthcheck.make_slice_train_step(mesh, params=params, batch_xy=(xs, ys))
    twin_out = ({k: np.asarray(v) for k, v in jnew.items()}, float(jloss))
    return twin_out, step, (params, xs, ys), mesh


@pytest.mark.parametrize("n", [1, 4, 8])
def test_one_step_matches_twin(n):
    (want_p, want_loss), step, (params, xs, ys), mesh = _carried(n)
    new, loss = step(params, xs, ys)
    assert loss.shape == () and loss.device == CPU
    assert float(loss) == pytest.approx(want_loss, rel=RTOL, abs=ATOL)
    got = carry.slice_params_to_numpy(new, mesh)
    for key in ("w1", "w2"):
        np.testing.assert_allclose(got[key], want_p[key], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_five_steps_lower_the_loss(n):
    _, step, (params, xs, ys), _ = _carried(n)
    p, first = step(params, xs, ys)
    for _ in range(5):
        p, loss = step(p, xs, ys)
    assert float(loss) < float(first)


@pytest.mark.parametrize("seam", ["row-parallel", "data-parallel"])
def test_a_wrong_conjugate_is_caught_at_8(monkeypatch, seam):
    """The identity backward of the row-parallel seam and the summed
    backward of the data-parallel one are what make the gradients the
    twin's: swapping either makes them M (or 1/D) times off, which the
    parity check at 4x2 sees."""
    if seam == "row-parallel":
        monkeypatch.setattr(collectives.RowParallelSum, "backward", staticmethod(
            lambda ctx, *g: tuple(collectives.all_reduce([t.contiguous() for t in g]))))
    else:
        monkeypatch.setattr(collectives.DataParallelGrad, "backward",
                            staticmethod(lambda ctx, *g: g))
    (want_p, _), step, (params, xs, ys), mesh = _carried(8)
    new, _ = step(params, xs, ys)
    if seam == "data-parallel":
        # Replicas now disagree: each kept its own shard's gradient.
        with pytest.raises(ValueError, match="replicas differ"):
            carry.slice_params_to_numpy(new, mesh)
        return
    got = carry.slice_params_to_numpy(new, mesh)
    assert not np.allclose(got["w1"], want_p["w1"], rtol=RTOL, atol=ATOL)


def test_default_init_is_seeded_and_scaled():
    mesh = healthcheck.build_mesh(4, [CPU] * 4)
    _, (p1, x1, _) = healthcheck.make_slice_train_step(mesh)
    _, (p2, x2, _) = healthcheck.make_slice_train_step(mesh)
    whole = carry.slice_params_to_numpy(p1, mesh)
    assert whole["w1"].shape == (128, 256) and whole["w2"].shape == (256, 128)
    assert all(torch.equal(a, b) for a, b in zip(p1["w1"], p2["w1"]))
    assert all(torch.equal(a, b) for a, b in zip(x1, x2))
    assert float(whole["w1"].std()) == pytest.approx(128**-0.5, rel=0.1)
    assert float(whole["w2"].std()) == pytest.approx(256**-0.5, rel=0.1)
    other = torch.Generator().manual_seed(8)
    _, (p3, _, _) = healthcheck.make_slice_train_step(mesh, generator=other)
    assert not torch.equal(p1["w1"][0], p3["w1"][0])


def test_shards_follow_the_megatron_layout():
    mesh = healthcheck.build_mesh(8, [CPU] * 8)  # data 4 x model 2
    rng = np.random.default_rng(0)
    w = {"w1": rng.standard_normal((128, 256)).astype(np.float32),
         "w2": rng.standard_normal((256, 128)).astype(np.float32)}
    x = rng.standard_normal((32, 128)).astype(np.float32)
    params = carry.slice_params_from_numpy(w, mesh)
    xs, ys = carry.slice_batch_from_numpy(x, x, mesh)
    assert [tuple(t.shape) for t in params["w1"]] == [(128, 128)] * 8
    assert [tuple(t.shape) for t in params["w2"]] == [(128, 128)] * 8
    assert [tuple(t.shape) for t in xs] == [(8, 128)] * 8
    # Device 3 is (data 1, model 1): W1's right columns, x's second rows.
    np.testing.assert_array_equal(params["w1"][3].numpy(), w["w1"][:, 128:])
    np.testing.assert_array_equal(params["w2"][3].numpy(), w["w2"][128:, :])
    np.testing.assert_array_equal(xs[3].numpy(), x[8:16])
    back = carry.slice_params_to_numpy(params, mesh)
    for key in w:
        np.testing.assert_array_equal(back[key], w[key])


def test_step_refuses_shapes_that_do_not_split():
    mesh = healthcheck.build_mesh(8, [CPU] * 8)
    with pytest.raises(ValueError, match="do not split"):
        healthcheck.make_slice_train_step(mesh, batch=30)
    with pytest.raises(ValueError, match="axes data and model"):
        healthcheck.make_slice_train_step(healthcheck.chip_mesh([CPU] * 2))


def test_step_restores_the_tf32_setting():
    mesh = healthcheck.build_mesh(1, [CPU])
    step, (p, x, y) = healthcheck.make_slice_train_step(mesh)
    before = torch.backends.cuda.matmul.allow_tf32
    step(p, x, y)
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_dryrun_multichip_on_cpu_devices():
    entry.dryrun_multichip(8, devices=[CPU] * 8)
    entry.dryrun_multichip(1, devices=[CPU])
    with pytest.raises(RuntimeError, match="need 8 devices"):
        entry.dryrun_multichip(8, devices=[CPU] * 4)


def test_dryrun_fails_on_a_broken_sweep(monkeypatch):
    monkeypatch.setattr(collectives, "_ring_perm",
                        lambda size: [(i, (i + 2) % size) for i in range(size)])
    with pytest.raises(AssertionError, match="ring sweep failed"):
        entry.dryrun_multichip(8, devices=[CPU] * 8)


def test_entry_burnin_is_finite_and_matches_twin_geometry():
    fn, (x, ws) = entry.entry(CPU)
    jfn, (jx, jws) = twin.make_burnin_step()
    assert tuple(x.shape) == tuple(jx.shape) and tuple(ws.shape) == tuple(jws.shape)
    assert x.dtype == torch.bfloat16 and jx.dtype == jax.numpy.bfloat16
    assert all(math.isfinite(float(v)) for v in fn(x, ws))
