"""Per-card spec table (twin: ``gpu_feature_discovery_tpu/models/chips.py``).

The rows carry published peak rates, read by the burn-in health labeler
(lm/health.py ``_spec_peaks``) as PLAUSIBILITY BOUNDS: no card sustains
above its data-sheet peak, so a measured rate well past it is a timing
artifact, not hardware. A row matches when its ``family`` occurs in the
lower-cased CUDA device name ("nvidia h100 80gb hbm3" matches "h100").

H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3. The PCIe
and NVL parts have lower compute peaks and at most 3.9 TB/s, inside the
1.5x plausibility margin of this row, so one row bounds every H100.

``family_for_generation`` names the architecture of a CUDA compute
capability, as the reference's ``getArchFamily`` does (the twin maps a
TPU generation through its spec table instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ChipSpec:
    """Static description of one card model."""

    family: str                    # "h100" — matched in the device name
    peak_bf16_tflops: float = 0.0  # dense bf16 matmul peak, TFLOP/s
    peak_hbm_gbps: float = 0.0     # HBM bandwidth peak, GB/s


CHIP_SPECS: Dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", peak_bf16_tflops=989.0, peak_hbm_gbps=3350.0),
}


def spec_for(device_name: str) -> Optional[ChipSpec]:
    """The spec row whose family occurs in ``device_name``; None when
    unknown (no plausibility bound is applied then)."""
    key = device_name.strip().lower()
    for spec in CHIP_SPECS.values():
        if spec.family in key:
            return spec
    return None


def family_for_generation(major: int, minor: int) -> str:
    """Architecture family of compute capability (major, minor): the
    reference's getArchFamily (internal/lm/resource.go:261-284)."""
    if major == 7:
        return "turing" if minor >= 5 else "volta"
    if major == 8:
        return "ada-lovelace" if minor >= 9 else "ampere"
    return {
        1: "tesla",
        2: "fermi",
        3: "kepler",
        5: "maxwell",
        6: "pascal",
        9: "hopper",
        10: "blackwell",
    }.get(major, "undefined")
