"""Driver/runtime version and slice-capability labelers (twin:
``gpu_feature_discovery_tpu/lm/versions.py``).

Reference: internal/lm/nvml.go:75-137: the driver labels take the kernel
driver's version (NVML's ``nvmlSystemGetDriverVersion``, "580.159.03"),
the runtime labels the CUDA driver API's version (13.0). Without NVML the
CUDA manager knows no kernel driver (resource/cuda_backend.py) and
reports "": the driver labels are then left out, never filled with the
CUDA version. ``slice.capable`` is the reference's ``mig.capable``.
"""

from __future__ import annotations

from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Labeler
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.resource.types import Manager

SLICE_CAPABLE = "nvidia.com/gpu.slice.capable"


def version_labels_for(manager: Manager, resource: str) -> Labels:
    """driver "X.Y[.Z]" → <resource>.driver.major/minor/rev (none for an
    unknown driver, ""); runtime (major, minor) →
    <resource>.runtime.major/minor."""
    driver_version = manager.get_driver_version()
    labels = Labels()
    if driver_version:
        parts = driver_version.split(".")
        if len(parts) < 2 or len(parts) > 3:
            raise ValueError(
                f'error getting driver version: version "{driver_version}" does not '
                'match format "X.Y[.Z]"'
            )
        labels[f"{resource}.driver.major"] = parts[0]
        labels[f"{resource}.driver.minor"] = parts[1]
        labels[f"{resource}.driver.rev"] = parts[2] if len(parts) > 2 else ""
    runtime_major, runtime_minor = manager.get_runtime_version()
    labels[f"{resource}.runtime.major"] = str(runtime_major)
    labels[f"{resource}.runtime.minor"] = str(runtime_minor)
    return labels


def new_version_labeler(manager: Manager) -> Labels:
    """The nvidia.com/gpu instance."""
    return version_labels_for(manager, "nvidia.com/gpu")


def new_slice_capability_labeler(manager: Manager) -> Labeler:
    """slice.capable mirrors mig.capable (nvml.go:110-137): true iff any
    GPU on the node supports MIG; empty with no GPUs."""
    chips = manager.get_chips()
    if not chips:
        return Empty()
    capable = any(chip.is_slice_capable() for chip in chips)
    return Labels({SLICE_CAPABLE: str(capable).lower()})
