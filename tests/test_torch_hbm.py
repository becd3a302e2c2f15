"""HBM stream-sum probe: the PyTorch port (gpu_feature_discovery_tpu_torch/
ops/hbm.py) against its JAX twin (gpu_feature_discovery_tpu/ops/hbm.py),
the Pallas kernel in interpret mode as tests/test_hbm.py runs it.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against the same plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu.ops import hbm as twin
from gpu_feature_discovery_tpu_torch.ops import hbm
from gpu_feature_discovery_tpu_torch.ops.carry import stream_buffer_from_numpy

CPU = torch.device("cpu")


@pytest.mark.parametrize("chunks", [1, 4, 9])
def test_reference_equals_pallas_kernel_exactly_on_pattern(chunks):
    rows = chunks * hbm.CHUNK_ROWS
    buf = np.asarray(twin.stream_pattern(rows))
    want = float(twin.hbm_stream_sum(jnp.asarray(buf), interpret=True)[0, 0])
    got = hbm.hbm_stream_sum_reference(stream_buffer_from_numpy(buf, CPU))
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert float(got[0, 0]) == want == twin.expected_stream_sum(rows)


@pytest.mark.parametrize("chunks", [1, 4, 9])
def test_reference_matches_pallas_kernel_on_random_buffer(chunks):
    buf = np.random.default_rng(chunks).random(
        (chunks * hbm.CHUNK_ROWS, hbm.LANES), dtype=np.float32
    )
    want = float(twin.hbm_stream_sum(jnp.asarray(buf), interpret=True)[0, 0])
    got = float(hbm.hbm_stream_sum_reference(stream_buffer_from_numpy(buf, CPU))[0, 0])
    # rel 1e-6: the plain version sums in f64, the TPU kernel chunk by
    # chunk in f32, so the two round at different places.
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("chunks", [1, 4, 9])
def test_pattern_helpers_equal_twin(chunks):
    rows = chunks * hbm.CHUNK_ROWS
    np.testing.assert_array_equal(
        hbm.stream_pattern(rows).numpy(), np.asarray(twin.stream_pattern(rows))
    )
    assert hbm.expected_stream_sum(rows) == twin.expected_stream_sum(rows)


@pytest.mark.parametrize("mib", [1, 3, 256, 1000])
def test_probe_rows_equals_twin(mib):
    assert hbm.probe_rows(mib) == twin.probe_rows(mib)
    assert (hbm.LANES, hbm.CHUNK_ROWS, hbm._PATTERN_PERIOD) == (
        twin.LANES, twin.CHUNK_ROWS, twin._PATTERN_PERIOD
    )


def test_stream_sum_rejects_bad_shapes():
    with pytest.raises(ValueError):
        hbm.hbm_stream_sum(torch.ones((hbm.CHUNK_ROWS, 64)))
    with pytest.raises(ValueError):
        hbm.hbm_stream_sum(torch.ones((hbm.CHUNK_ROWS + 1, hbm.LANES)))
    with pytest.raises(ValueError):
        hbm.hbm_stream_sum(torch.ones((0, hbm.LANES)))
    with pytest.raises(ValueError):
        hbm.hbm_stream_sum(torch.ones((hbm.CHUNK_ROWS, hbm.LANES), dtype=torch.float64))
    with pytest.raises(ValueError):
        hbm.hbm_stream_sum(torch.ones((hbm.LANES, hbm.CHUNK_ROWS)).t())


def test_cpu_tensor_runs_plain_version_without_launching():
    rows = 2 * hbm.CHUNK_ROWS
    before = hbm.hbm_stream_sum.launches
    out = hbm.hbm_stream_sum(hbm.stream_pattern(rows))
    assert float(out[0, 0]) == hbm.expected_stream_sum(rows)
    assert hbm.hbm_stream_sum.launches == before


def test_stream_pattern_checksum_detects_slot_misreads():
    """tests/test_hbm.py's slot-misread twins, through the port: the
    per-chunk-distinct pattern catches a chunk read from the wrong place
    or twice, which an all-ones buffer would sum identically."""
    rows = 8 * hbm.CHUNK_ROWS
    chunk = hbm.CHUNK_ROWS
    ring = 4  # the TPU kernel's N_BUFFERS
    buf = hbm.stream_pattern(rows)
    assert float(hbm.hbm_stream_sum(buf)[0, 0]) == hbm.expected_stream_sum(rows)
    aliased = buf.clone()
    aliased[0:chunk] = buf[ring * chunk:(ring + 1) * chunk]
    assert float(hbm.hbm_stream_sum(aliased)[0, 0]) != hbm.expected_stream_sum(rows)
    doubled = buf.clone()
    doubled[chunk:2 * chunk] = buf[0:chunk]
    assert float(hbm.hbm_stream_sum(doubled)[0, 0]) != hbm.expected_stream_sum(rows)


def test_measure_hbm_bandwidth_on_cpu_runs_plain_version():
    report = hbm.measure_hbm_bandwidth(total_mib=1, iters=1, device=CPU)
    twin_report = twin.measure_hbm_bandwidth(total_mib=1, iters=1)
    assert set(report) == set(twin_report)
    assert report["interpreted"] is True
    assert report["checksum_ok"] is True
    assert report["bytes"] == twin_report["bytes"]



@pytest.mark.parametrize("chunks, sms", [(1, 132), (3, 7), (9, 16), (1024, 132), (1024, 1)])
def test_tile_partition_covers_every_tile_once_inside_one_chunk(chunks, sms):
    """The kernel's persistent grid (ops/csrc/hbm_stream_sum.cu computes
    the same ranges): contiguous ranges, balanced to within one tile,
    every tile once, and no tile across a chunk boundary."""
    assert hbm.CHUNK_ROWS % hbm.TILE_ROWS == 0
    assert hbm.TILE_BYTES * hbm.TILES_PER_CHUNK == hbm.CHUNK_ROWS * hbm.LANES * 4
    num_tiles = chunks * hbm.CHUNK_ROWS // hbm.TILE_ROWS
    blocks = hbm.grid_blocks(num_tiles, sms)
    assert blocks == min(num_tiles, hbm.BLOCKS_PER_SM * sms)
    ranges = hbm.tile_ranges(num_tiles, blocks)
    assert len(ranges) == blocks
    assert [t for r in ranges for t in r] == list(range(num_tiles))
    sizes = [len(r) for r in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for t in range(num_tiles):
        first, last = t * hbm.TILE_ROWS, (t + 1) * hbm.TILE_ROWS - 1
        assert first // hbm.CHUNK_ROWS == last // hbm.CHUNK_ROWS


@pytest.mark.parametrize("chunks", [1, 4, 9])
def test_tile_pattern_sum_is_exact_and_catches_tile_slips(chunks):
    """The card checks' tile-granular pattern: the plain version sums it
    exactly, and a tile slip inside one chunk (tile 0 read from the slot
    four tiles on, a 4-deep ring's slip) or a tile read twice changes the
    sum, where the chunk pattern cannot see either."""
    rows = chunks * hbm.CHUNK_ROWS
    tile = hbm.TILE_ROWS
    buf = hbm.tile_pattern(rows)
    want = hbm.expected_tile_pattern_sum(rows)
    assert float(hbm.hbm_stream_sum(buf)[0, 0]) == want
    assert float(buf.double().sum()) == want
    slipped = buf.clone()
    slipped[:tile] = buf[4 * tile:5 * tile]
    doubled = buf.clone()
    doubled[tile:2 * tile] = buf[:tile]
    for bad in (slipped, doubled):
        assert float(hbm.hbm_stream_sum(bad)[0, 0]) != want
    chunk_pattern = hbm.stream_pattern(rows)
    chunk_slipped = chunk_pattern.clone()
    chunk_slipped[:tile] = chunk_pattern[4 * tile:5 * tile]
    assert float(hbm.hbm_stream_sum(chunk_slipped)[0, 0]) == hbm.expected_stream_sum(rows)


# ---------------------------------------------------------------------------
# chip_smoke.py's seeded sweep, rehearsed on the CPU with the plain version
# ---------------------------------------------------------------------------

def test_sweep_draws_cover_every_required_geometry():
    import chip_smoke

    draws = chip_smoke.hbm_sweep_draws(0, 132)
    assert draws == chip_smoke.hbm_sweep_draws(0, 132)  # seeded
    assert len(draws) == chip_smoke.SWEEP_DRAWS >= 200
    chunks = [d["chunks"] for d in draws]
    sms = [d["sms"] for d in draws]
    assert (min(chunks), max(chunks), min(sms), max(sms)) == (1, 2048, 1, 132)
    assert 1024 in chunks
    tiles = hbm.CHUNK_ROWS // hbm.TILE_ROWS
    assert any(d["chunks"] * tiles < d["sms"] for d in draws)  # fewer tiles than blocks
    assert any(k % chip_smoke.SWEEP_RING for k in chunks)
    assert {d["kind"] for d in draws} == set(chip_smoke.SWEEP_KINDS)
    for d in draws:
        assert 1 <= d["chunks"] <= 2048 and 1 <= d["sms"] <= 132
        if d["kind"].endswith("-slip"):
            period = 7 if d["kind"].startswith("chunk") else 13
            assert d["src"] % period != d["dst"] % period


def test_sweep_holds_the_plain_version_and_catches_a_misreading_kernel():
    """The sweep's checks on the CPU: the plain version passes every small
    draw, and a 'kernel' that skips the first chunk fails it."""
    import chip_smoke

    draws = [d for d in chip_smoke.hbm_sweep_draws(0, 132) if d["chunks"] <= 4]
    summary = chip_smoke.run_hbm_sweep(draws, "cpu", lambda buf, sms: hbm.hbm_stream_sum(buf))
    assert summary["draws"] == len(draws)
    assert summary["slips_detected"] == sum("dst" in d for d in draws)

    def skips_chunk_0(buf, sms):
        return hbm.hbm_stream_sum_reference(buf[hbm.CHUNK_ROWS:] if buf.shape[0] > hbm.CHUNK_ROWS
                                            else buf)

    wide = [d for d in draws if d["chunks"] > 1 and d["kind"] in ("chunk", "random")]
    with pytest.raises(SystemExit, match="sweep"):
        chip_smoke.run_hbm_sweep(wide, "cpu", skips_chunk_0)


@pytest.mark.parametrize("case", ["non_contiguous", "float64", "rows_not_whole_chunks"])
def test_sweep_rejections_raise_before_any_launch(case):
    """The refusals the card checks (its misaligned view needs a CUDA
    buffer: on the CPU the plain version takes it)."""
    import chip_smoke

    buf, text = chip_smoke.hbm_rejections("cpu")[case]
    with pytest.raises(ValueError, match=re.escape(text)):
        hbm.hbm_stream_sum(buf)
