"""The plain reference against closed forms at tiny sizes, its control at
the cells' own geometry, and the labels it expects."""

import math
import subprocess
import sys

import pytest
import torch

import catalog
import control
from reference import burnin, stream
from reference import labels as ref_labels
from reference.nvml import Gpu, Node


@pytest.mark.parametrize("hbm_mib", [1, 3, 256])
def test_the_stream_sum_is_the_patterns_sum(hbm_mib):
    rows = stream.rows_for(hbm_mib)
    chunk = torch.arange(rows) // stream.CHUNK_ROWS
    buf = (1 + chunk % stream.PERIOD).double().reshape(rows, 1).expand(rows, stream.LANES)
    assert stream.buffer_sum(hbm_mib) == float(buf.sum())


def test_the_stream_sum_closed_form():
    chunks = stream.rows_for(256) // stream.CHUNK_ROWS
    assert chunks == 1024
    full, part = divmod(chunks, 7)
    assert stream.buffer_sum(256) == (full * 28 + sum(range(1, part + 1))) * 512 * 128


def test_the_chain_on_an_identity():
    x = torch.ones((2, 2), dtype=torch.bfloat16)
    ws = torch.eye(2, dtype=torch.bfloat16).reshape(1, 2, 2).repeat(3, 1, 1)
    out = burnin.run(x, ws)
    rms = math.sqrt(1 + burnin.EPS)
    carry = float(torch.tensor(1 / rms).to(torch.bfloat16))
    assert out["rms"] == pytest.approx(rms, rel=1e-7)
    assert out["checksum"] == pytest.approx(4 * carry, rel=1e-7)
    assert out["norm"] == pytest.approx(2 * carry, rel=1e-7)
    assert burnin.gaps(out["checksum"], out["rms"], out) == {"checksum_gap": 0.0, "rms_gap": 0.0}


def test_the_inputs_are_the_stated_draw():
    x, ws = burnin.inputs(16, 2, "cpu")
    gen = torch.Generator().manual_seed(0)
    first = torch.empty((16, 16)).normal_(generator=gen).to(torch.bfloat16)
    assert torch.equal(x, first)
    assert ws.shape == (2, 16, 16) and ws.dtype == torch.bfloat16


@pytest.mark.parametrize("config", ["h100x1-daemonset", "h100x1-inprocess", "h100x4-daemonset"])
def test_the_control_fails_at_the_cells_geometry(config):
    out = control.readings(catalog.config(config), "cpu")
    assert out["fails"], out


def test_the_control_fails_on_the_card_at_the_cells_geometry(card):
    for config in ("h100x1-daemonset", "h100x1-inprocess", "h100x4-daemonset"):
        out = control.readings(catalog.config(config), "cuda")
        assert out["fails"], out


def _node(n=1):
    gpu = Gpu("NVIDIA H100 80GB HBM3", 81559 << 20, (9, 0), True)
    return Node("580.159.03", 13000, (gpu,) * n)


def test_the_expected_labels():
    want = ref_labels.expected(_node(), [["NVIDIA H100 80GB HBM3", "580.159.03", "81559"]])
    assert want["nvidia.com/gpu.product"] == "nvidia-h100-80gb-hbm3"
    assert want["nvidia.com/gpu.memory"] == "81559"
    assert want["nvidia.com/gpu.runtime.major"] == "13"
    assert want["nvidia.com/gpu.driver.rev"] == "03"
    assert want["nvidia.com/gpu.family"] == "hopper"
    assert want["nvidia.com/gpu.chip.0.ok"] == "true"
    with pytest.raises(ValueError):
        ref_labels.expected(_node(), [["NVIDIA H100 80GB HBM3", "580.159.04", "81559"]])


def test_a_label_file_is_held_to_them():
    want = ref_labels.expected(_node(2), [["NVIDIA H100 80GB HBM3", "580.159.03", "81559"]] * 2)
    labels = dict(want)
    for key in ref_labels.PRESENT + ref_labels.PRESENT_MULTI:
        labels[f"nvidia.com/gpu.{key}"] = "1"
    for i in range(2):
        labels[f"nvidia.com/gpu.chip.{i}.tflops"] = labels[f"nvidia.com/gpu.chip.{i}.hbm-gbps"] = "1"
    text = "\n".join(f"{k}={v}" for k, v in labels.items())
    assert ref_labels.mismatches(ref_labels.parse(text), want, 2) == []
    del labels["nvidia.com/gpu.chip.1.hbm-gbps"]
    labels["nvidia.com/gpu.chips.sick"] = "1"
    assert len(ref_labels.mismatches(labels, want, 2)) == 2


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.burnin, reference.stream, reference.labels, reference.nvml, "
            "reference.collectives; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gpu_feature_discovery_tpu', "
            "'gpu_feature_discovery_tpu_torch'}))") % str(catalog.HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
