"""pci (twin: ``gpu_feature_discovery_tpu/pci/``): sysfs scan of NVIDIA
display functions and the PCI capability walker. The twin's Google PCI
names become their NVIDIA counterparts."""

from gpu_feature_discovery_tpu_torch.pci.pciutil import (
    NVIDIA_PCI_VENDOR_ID,
    MockNvidiaPCI,
    NvidiaPCI,
    PCIDevice,
    SysfsNvidiaPCI,
)

__all__ = [
    "NVIDIA_PCI_VENDOR_ID",
    "NvidiaPCI",
    "MockNvidiaPCI",
    "PCIDevice",
    "SysfsNvidiaPCI",
]
