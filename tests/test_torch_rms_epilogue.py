"""The burn-in's RMS epilogue (gpu_feature_discovery_tpu_torch/ops/
rms_epilogue.py) on the CPU: the wrapper runs its plain version, which is
the composition ``burnin_step`` ran before the epilogue had kernels, so
the burn-in on the CPU stays what it was to the bit (and the twin parity
of tests/test_torch_ops.py holds). The CUDA kernels are held against the
same plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import re

import pytest
import torch

from gpu_feature_discovery_tpu_torch.ops import healthcheck, rms_epilogue

CPU = torch.device("cpu")


def _composition(y, dtype):
    """The lines burnin_step ran on every product before this module."""
    rms = torch.sqrt(torch.mean(torch.square(y)) + 1e-6)
    carry = (y / rms).to(dtype)
    return carry, rms


def _old_burnin_step(x, ws):
    carry = x
    rms = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in ws:
        carry, rms = _composition(healthcheck._matmul_f32(carry, w), x.dtype)
    return carry.float().sum(), rms


def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


@pytest.mark.parametrize("shape", [(128, 128), (512, 512), (37, 29), (1, 1)])
@pytest.mark.parametrize("checksum", [False, True])
def test_reference_equals_the_old_composition_bitwise(shape, checksum):
    y = torch.randn(shape, generator=torch.Generator().manual_seed(shape[0])) * 3.0
    carry, rms, total = rms_epilogue.rms_epilogue_reference(y, torch.bfloat16, checksum)
    want_carry, want_rms = _composition(y, torch.bfloat16)
    assert torch.equal(_bits(carry), _bits(want_carry))
    assert torch.equal(_bits(rms), _bits(want_rms))
    if checksum:
        assert torch.equal(_bits(total), _bits(want_carry.float().sum()))
    else:
        assert total is None


@pytest.mark.parametrize("size, depth", [(128, 2), (512, 8), (37, 2), (64, 1), (64, 0)])
def test_burnin_step_on_cpu_is_the_old_pass_without_launching(size, depth):
    x, ws = healthcheck._burnin_input_arrays(size, depth, torch.bfloat16, CPU)
    before = rms_epilogue.rms_epilogue.launches
    checksum, rms = healthcheck.burnin_step(x, ws)
    assert rms_epilogue.rms_epilogue.launches == before
    want_checksum, want_rms = _old_burnin_step(x, ws)
    assert torch.equal(_bits(checksum), _bits(want_checksum))
    assert torch.equal(_bits(rms), _bits(want_rms))
    assert checksum.shape == rms.shape == ()


def test_wrapper_on_cpu_runs_the_plain_version_in_any_dtype():
    y = torch.randn((64, 64), generator=torch.Generator().manual_seed(3))
    before = rms_epilogue.rms_epilogue.launches
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        got = rms_epilogue.rms_epilogue(y, dtype, checksum=True)
        want = rms_epilogue.rms_epilogue_reference(y, dtype, checksum=True)
        assert got[0].dtype == dtype
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert rms_epilogue.rms_epilogue.launches == before


@pytest.mark.parametrize("case", ["float64", "non_contiguous", "one_d", "empty"])
def test_wrapper_refuses_before_any_launch(case):
    """The refusals the card checks too (chip_smoke.py); its bf16-only
    carry and its alignment need a CUDA tensor: on the CPU the plain
    version takes any dtype."""
    import chip_smoke

    y, dtype, text = chip_smoke.epilogue_rejections("cpu")[case]
    before = rms_epilogue.rms_epilogue.launches
    with pytest.raises(ValueError, match=re.escape(text)):
        rms_epilogue.rms_epilogue(y, dtype, checksum=True)
    assert rms_epilogue.rms_epilogue.launches == before


def test_a_device_neither_cuda_nor_cpu_is_refused():
    y = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        rms_epilogue.rms_epilogue(y, torch.bfloat16)


@pytest.mark.parametrize("numel, sms, blocks", [
    (2048 * 2048, 132, 264),  # the probe's layer: two blocks on every SM
    (2048 * 2048, 16, 32),    # on a MIG 1g slice
    (2048 * 2048, 1, 2),
    (512 * 512, 132, 64),     # a thread per vector
    (128 * 128, 132, 4),      # the verdicts' layer
    (37 * 29, 132, 1),        # 134 vectors and a tail of 1
    (7, 132, 1),              # a tail alone still takes a block
])
def test_grid_is_persistent_and_never_wider_than_the_work(numel, sms, blocks):
    assert rms_epilogue.grid_blocks(numel, sms) == blocks
    threads = blocks * rms_epilogue.THREADS
    vectors = numel // rms_epilogue.VECTOR
    # Every vector has a thread until the grid is full; the grid never
    # holds a block without a vector, but for a lone tail.
    assert threads >= min(vectors, rms_epilogue.BLOCKS_PER_SM * sms * rms_epilogue.THREADS)
    assert blocks == 1 or (blocks - 1) * rms_epilogue.THREADS < vectors


def test_reset_probe_workspaces_drops_the_epilogue_scratch(monkeypatch):
    monkeypatch.setitem(rms_epilogue._scratch, (CPU, 0), ("partials", "counter"))
    healthcheck.reset_probe_workspaces()
    assert rms_epilogue._scratch == {}


# ---------------------------------------------------------------------------
# chip_smoke.py's agreement checks, rehearsed on the CPU with the plain version
# ---------------------------------------------------------------------------

def test_agreement_of_the_plain_version_with_itself_is_exact():
    import chip_smoke

    y = torch.randn((96, 80), generator=torch.Generator().manual_seed(5)) * 7.0
    got = chip_smoke.epilogue_agreement(
        y, rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True))
    assert got["rms_rel"] == got["carry_max_ulps"] == got["carry_differ_share"] == 0
    assert got["checksum_vs_f32_sum"] == 0
    assert got["checksum_vs_f64_sum"] <= chip_smoke.EPILOGUE_LIMITS["checksum_vs_f64_sum"]
    chip_smoke.check_epilogue_agreement(got, "plain")


@pytest.mark.parametrize("fault", ["rms", "carry", "checksum"])
def test_agreement_catches_a_kernel_that_is_off(fault):
    """A 'kernel' whose rms is 1e-5 off, whose carry is two bf16 steps
    off in one element, or whose checksum drops an element, fails."""
    import chip_smoke

    def off(t):
        carry, rms, total = rms_epilogue.rms_epilogue_reference(t, torch.bfloat16, True)
        if fault == "rms":
            rms = rms * (1 + 1e-5)
        elif fault == "carry":
            carry = carry.clone()
            carry.view(torch.int16)[3, 4] += 2
        else:
            total = total - carry.float()[0, 0] - 1.0
        return carry, rms, total

    y = torch.randn((96, 80), generator=torch.Generator().manual_seed(6)) * 7.0
    with pytest.raises(SystemExit, match="epilogue"):
        chip_smoke.check_epilogue_agreement(chip_smoke.epilogue_agreement(y, off(y)), fault)


def test_agreement_of_a_layer_without_checksum_skips_the_checksum():
    import chip_smoke

    y = torch.randn((32, 48), generator=torch.Generator().manual_seed(7))
    got = chip_smoke.epilogue_agreement(y, rms_epilogue.rms_epilogue(y, torch.bfloat16))
    assert "checksum_vs_f32_sum" not in got and got["carry_max_ulps"] == 0
    chip_smoke.check_epilogue_agreement(got, "no checksum")


def test_bf16_ulps_counts_steps_across_zero():
    import chip_smoke

    a = torch.tensor([1.0, -1.0, 0.0, -0.0, 2.0], dtype=torch.bfloat16)
    b = a.clone()
    b.view(torch.int16)[0] += 1  # the next bf16 above 1
    b.view(torch.int16)[1] += 1  # the next one below -1
    got = chip_smoke.bf16_ulps(a, b).tolist()
    assert got == [1, 1, 0, 0, 0]
    tiny = torch.tensor([0.0], dtype=torch.bfloat16)
    neg_tiny = tiny.clone()
    neg_tiny.view(torch.int16)[0] = -0x7FFF  # -(smallest subnormal): 0x8001
    assert chip_smoke.bf16_ulps(tiny, neg_tiny).tolist() == [1]
