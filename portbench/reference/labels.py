"""The labels a healthy node's daemon must publish, worked out from the
benchmark's own reading of the card (``reference/nvml.py``) and the
label grammar of NVIDIA's gpu-feature-discovery, and the comparison of a
written label file against them. Imports nothing of the program."""

import re
from typing import Dict, List

from .nvml import Node

PREFIX = "nvidia.com/gpu"
# Compute capability major -> the family label, for the families a cell runs on.
FAMILIES = {9: "hopper"}


def product(name: str) -> str:
    """"NVIDIA H100 80GB HBM3" -> "nvidia-h100-80gb-hbm3"."""
    value = re.sub(r"[^A-Za-z0-9._-]", "-", name.lower())
    return value[:63].strip("_.-")


def expected(node: Node, smi_rows: List[List[str]]) -> Dict[str, str]:
    """Host facts and verdicts of a node whose every GPU is healthy.
    ``smi_rows`` is ``nvidia-smi --query-gpu=name,driver_version,
    memory.total`` per GPU: the driver and the name are held against both
    witnesses, the memory against NVML's (nvidia-smi's MiB is the same
    number)."""
    gpu = node.gpus[0]
    smi_name, smi_driver, smi_mib = smi_rows[0]
    if smi_name != gpu.name or smi_driver != node.driver_version:
        raise ValueError(f"NVML and nvidia-smi disagree: {gpu.name!r}/{node.driver_version!r} "
                         f"against {smi_name!r}/{smi_driver!r}")
    if int(smi_mib) != gpu.memory_total_bytes >> 20:
        raise ValueError(f"memory: NVML {gpu.memory_total_bytes >> 20} MiB, nvidia-smi {smi_mib}")
    driver = node.driver_version.split(".")
    n = len(node.gpus)
    want = {
        f"{PREFIX}.count": str(n),
        f"{PREFIX}.product": product(gpu.name),
        f"{PREFIX}.memory": str(gpu.memory_total_bytes >> 20),
        f"{PREFIX}.driver.major": driver[0],
        f"{PREFIX}.driver.minor": driver[1],
        f"{PREFIX}.driver.rev": driver[2] if len(driver) > 2 else "",
        f"{PREFIX}.runtime.major": str(node.cuda_driver_version // 1000),
        f"{PREFIX}.runtime.minor": str(node.cuda_driver_version % 1000 // 10),
        f"{PREFIX}.generation.major": str(gpu.compute_capability[0]),
        f"{PREFIX}.generation.minor": str(gpu.compute_capability[1]),
        f"{PREFIX}.slice.capable": str(any(g.mig_capable for g in node.gpus)).lower(),
        f"{PREFIX}.health.ok": "true",
        f"{PREFIX}.health.timing": "device-profiler",
        f"{PREFIX}.chips.healthy": str(n),
        f"{PREFIX}.chips.sick": "0",
    }
    family = FAMILIES.get(gpu.compute_capability[0])
    if family is not None:
        want[f"{PREFIX}.family"] = family
    for i in range(n):
        want[f"{PREFIX}.chip.{i}.ok"] = "true"
    if n > 1:
        # The ring sweep and the NCCL verdicts; one device has no ring.
        want[f"{PREFIX}.health.ici.ok"] = "true"
    return want


# Rates a healthy probe publishes; their values are the program's own
# measurements, so only their presence is held (a probe whose stream sum
# was wrong publishes no HBM rate).
PRESENT = ("health.matmul-tflops", "health.hbm-gbps", "health.probe-ms")
# Over several cards, the timed all-reduce's rate; and no card named a
# straggler on a healthy node.
PRESENT_MULTI = ("health.ici.allreduce-gbps",)
ABSENT_MULTI = ("straggler-chip",)


# A verdict of the probe: a health label, a count of healthy or sick chips,
# or a chip's own; every other expected label is a fact of the host.
VERDICT = re.compile(rf"^{re.escape(PREFIX)}\.(health\.|chips\.|chip\.\d+\.)")


def verdicts(labels: Dict[str, str]) -> List[str]:
    return [k for k in labels if VERDICT.match(k)]


def fact_mismatches(labels: Dict[str, str], want: Dict[str, str]) -> List[str]:
    """Every fact of the host in ``want`` that ``labels`` lacks or gets
    wrong: what a node publishes whether or not the probe could run."""
    return [f"{k}: {labels.get(k)!r} != {v!r}" for k, v in want.items()
            if not VERDICT.match(k) and labels.get(k) != v]


def parse(text: str) -> Dict[str, str]:
    labels = {}
    for line in text.splitlines():
        if "=" in line:
            key, value = line.split("=", 1)
            labels[key.strip()] = value.strip()
    return labels


def mismatches(labels: Dict[str, str], want: Dict[str, str], chips: int) -> List[str]:
    """Every expected label missing or different, every rate missing and,
    over several cards, every label a healthy node does not publish."""
    out = [f"{k}: {labels.get(k)!r} != {v!r}" for k, v in want.items() if labels.get(k) != v]
    present = [f"{PREFIX}.{k}" for k in PRESENT]
    present += [f"{PREFIX}.chip.{i}.{k}" for i in range(chips) for k in ("tflops", "hbm-gbps")]
    absent = []
    if chips > 1:
        present += [f"{PREFIX}.{k}" for k in PRESENT_MULTI]
        absent += [f"{PREFIX}.{k}" for k in ABSENT_MULTI]
    out += [f"{k}: missing" for k in present if k not in labels]
    out += [f"{k}: {labels[k]!r} on a healthy node" for k in absent if k in labels]
    return out
