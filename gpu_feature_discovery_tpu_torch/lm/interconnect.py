"""Host-interconnect labeler, PCI half (twin:
``gpu_feature_discovery_tpu/lm/interconnect.py``).

Reference: internal/lm/vgpu.go:32-55 probes lazily inside Labels() and
publishes nothing when no device is found. Here: NVIDIA display functions
on the PCI bus (pci/pciutil.py) as ``nvidia.com/gpu.pci.present`` and
``pci.count``, and the host interface named by the first decodable
vendor-specific capability record. The twin's other half (multi-host
slice facts from the TPU VM metadata, ``hostinfo/``) has no GPU
counterpart in this port yet.
"""

from __future__ import annotations

import logging
import re
from typing import Optional

from gpu_feature_discovery_tpu_torch.lm.labels import Labels, label_safe_value
from gpu_feature_discovery_tpu_torch.pci.pciutil import (
    NvidiaPCI,
    PCIError,
    decode_vendor_capability,
)

log = logging.getLogger("tfd.lm")

PCI_PRESENT = "nvidia.com/gpu.pci.present"
PCI_COUNT = "nvidia.com/gpu.pci.count"
HOST_INTERFACE = "nvidia.com/gpu.pci.host-interface"
HOST_DRIVER_VERSION = "nvidia.com/gpu.pci.host-driver-version"
HOST_DRIVER_BRANCH = "nvidia.com/gpu.pci.host-driver-branch"

# A record's signature is a name. A GPU's own vendor capability is
# binary (version and offset fields), and a stray printable byte before
# a NUL there must not become a label.
_SIGNATURE = re.compile(r"[A-Za-z][A-Za-z0-9_.-]{2,}")


class InterconnectLabeler:
    """Lazy labeler over a PCI scanner, which may be None (vgpuLabeler
    struct)."""

    def __init__(self, pci: Optional[NvidiaPCI] = None):
        self._pci = pci

    def labels(self) -> Labels:
        labels = Labels()
        if self._pci is not None:
            devices = self._pci.devices()
            if devices:
                labels[PCI_PRESENT] = "true"
                labels[PCI_COUNT] = str(len(devices))
                labels.update(_host_interface_labels(devices))
        return labels


def _host_interface_labels(devices) -> Labels:
    """Labels from the first decodable vendor-specific capability record
    (vgpu.go:108-153 feeding lm/vgpu.go:41-52). A short config read (an
    unprivileged container sees 64 bytes) warns and skips that device."""
    labels = Labels()
    for dev in devices:
        try:
            cap = dev.get_vendor_specific_capability()
        except PCIError as e:
            log.warning("skipping PCI capability read for %s: %s", dev.address, e)
            continue
        if cap is None:
            continue
        info = decode_vendor_capability(cap)
        if info is None or not _SIGNATURE.fullmatch(info.signature):
            continue
        # Record strings are device-supplied printable ASCII, a wider
        # charset than label values: sanitize, and a string that
        # sanitizes to nothing stays absent.
        labels[HOST_INTERFACE] = label_safe_value(info.signature, fallback="")
        version = label_safe_value(info.driver_version, fallback="")
        if version:
            labels[HOST_DRIVER_VERSION] = version
        branch = label_safe_value(info.driver_branch, fallback="")
        if branch:
            labels[HOST_DRIVER_BRANCH] = branch
        break
    return labels
