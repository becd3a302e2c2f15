"""Host-interconnect labeler (twin:
``gpu_feature_discovery_tpu/lm/interconnect.py``).

Reference: internal/lm/vgpu.go:32-55 probes lazily inside Labels() and
publishes nothing when no device is found. Two halves, as in the twin:

- NVIDIA display functions on the PCI bus (pci/pciutil.py) as
  ``nvidia.com/gpu.pci.present`` and ``pci.count``, and the host
  interface named by the first decodable vendor-specific capability
  record;
- the host's place in its slice from its environment (hostinfo/):
  ``multihost.present``, ``multihost.worker-id``, ``worker-count``,
  ``chips-per-host``, ``slice.accelerator-type``, ``slice.topology``,
  ``ici.wrap.<axis>`` and the precise ``gpu.machine``, where the twin
  publishes them. The wrap labels keep the twin's ``ici.`` name: they
  state what the deployment says of its topology, not a device query.
"""

from __future__ import annotations

import logging
import re
from typing import Optional

from gpu_feature_discovery_tpu_torch.hostinfo.gpu_env import HostInfo
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
ACCEL_TYPE = "nvidia.com/gpu.slice.accelerator-type"
SLICE_TOPOLOGY = "nvidia.com/gpu.slice.topology"
MULTIHOST_PRESENT = "nvidia.com/gpu.multihost.present"
WORKER_ID = "nvidia.com/gpu.multihost.worker-id"
WORKER_COUNT = "nvidia.com/gpu.multihost.worker-count"
CHIPS_PER_HOST = "nvidia.com/gpu.multihost.chips-per-host"
WRAP_PREFIX = "nvidia.com/gpu.ici.wrap"
MACHINE = "nvidia.com/gpu.machine"

# A record's signature is a name. A GPU's own vendor capability is
# binary (version and offset fields), and a stray printable byte before
# a NUL there must not become a label.
_SIGNATURE = re.compile(r"[A-Za-z][A-Za-z0-9_.-]{2,}")


class InterconnectLabeler:
    """Lazy labeler over a PCI scanner and a HostInfo provider; either
    may be None (vgpuLabeler struct)."""

    def __init__(self, pci: Optional[NvidiaPCI] = None, provider=None):
        self._pci = pci
        self._provider = provider

    def labels(self) -> Labels:
        labels = Labels()
        if self._pci is not None:
            devices = self._pci.devices()
            if devices:
                labels[PCI_PRESENT] = "true"
                labels[PCI_COUNT] = str(len(devices))
                labels.update(_host_interface_labels(devices))
        info: Optional[HostInfo] = (
            self._provider.host_info() if self._provider is not None else None
        )
        if info is not None:
            labels.update(_host_info_labels(info))
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


def _host_info_labels(info: HostInfo) -> Labels:
    """The host's slice facts. Every string here is free-form host input,
    sanitized like the PCI record's; a string that sanitizes to nothing
    stays absent rather than becoming "unknown"."""
    labels = Labels()
    accel = label_safe_value(info.accelerator_type or "", fallback="")
    if accel:
        labels[ACCEL_TYPE] = accel
    topology = label_safe_value(info.topology, fallback="")
    if topology:
        labels[SLICE_TOPOLOGY] = topology

    multi = info.multi_host
    labels[MULTIHOST_PRESENT] = str(multi).lower()
    if multi:
        if info.worker_id is not None:
            labels[WORKER_ID] = str(info.worker_id)
        if info.worker_count is not None:
            labels[WORKER_COUNT] = str(info.worker_count)
        cph = label_safe_value(
            (info.chips_per_host_bounds or "").replace(",", "x"), fallback=""
        )
        if cph:
            labels[CHIPS_PER_HOST] = cph

    for axis, wrapped in zip("xyz", info.wrap):
        labels[f"{WRAP_PREFIX}.{axis}"] = str(wrapped).lower()

    # The precise machine type beats the DMI product name when known (the
    # interconnect merges after the device labeler), unless it sanitizes
    # to nothing.
    machine = label_safe_value(info.machine_type, fallback="")
    if machine:
        labels[MACHINE] = machine
    return labels
