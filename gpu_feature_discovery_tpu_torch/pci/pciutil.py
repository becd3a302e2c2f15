"""PCI sysfs probing for NVIDIA GPUs (twin:
``gpu_feature_discovery_tpu/pci/pciutil.py``).

The reference's NVIDIA PCI scanner and config-space capability walker
(internal/vgpu/pciutil.go:70-177): scan ``/sys/bus/pci/devices``, read
vendor, class and config, and walk the PCI capability list (status bit
0x10 at byte 0x06, first-capability pointer at byte 0x34, vendor-specific
capability id 0x09) with loop and 0xff-break detection. The scanner keeps
NVIDIA's vendor id ``0x10de`` and display-class functions only: it counts
GPUs, not the NVSwitch, bridge and audio functions an HGX node also
exposes under that vendor id. The walker and the record decoder are the
twin's, unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Protocol

PCI_DEVICES_ROOT = "/sys/bus/pci/devices"
NVIDIA_PCI_VENDOR_ID = "0x10de"
# PCI base class 0x03: display controllers (VGA 0x0300, 3D 0x0302). An
# HGX node also exposes NVSwitch bridges (0x0680) and audio functions
# under the NVIDIA vendor id; those are not GPUs.
DISPLAY_CLASS_PREFIX = "0x03"

PCI_STATUS_BYTE = 0x06
PCI_STATUS_CAPABILITY_LIST = 0x10
PCI_CAPABILITY_LIST = 0x34
PCI_CAPABILITY_LIST_ID = 0
PCI_CAPABILITY_LIST_NEXT = 1
PCI_CAPABILITY_LENGTH = 2
PCI_CAPABILITY_VENDOR_SPECIFIC_ID = 0x09


class PCIError(Exception):
    pass


@dataclass
class PCIDevice:
    """One PCI function (PCIDevice struct, pciutil.go:33-40)."""

    path: str
    address: str
    vendor: str
    device_class: str
    config: bytes = field(repr=False, default=b"")

    def get_vendor_specific_capability(self) -> Optional[bytes]:
        """Walk the capability list and return the vendor-specific capability
        record, or None (GetVendorSpecificCapability, pciutil.go:115-151).
        Needs the full 256-byte config space, which sysfs only exposes to
        privileged readers."""
        if len(self.config) < 256:
            raise PCIError(
                f"entire PCI configuration is not read for device {self.address}. "
                "Run with privileged mode to read complete PCI configuration data"
            )
        if self.config[PCI_STATUS_BYTE] & PCI_STATUS_CAPABILITY_LIST == 0:
            return None

        visited = set()
        pos = self.config[PCI_CAPABILITY_LIST]
        while pos != 0:
            if pos + PCI_CAPABILITY_LENGTH >= len(self.config):
                break  # corrupt pointer past the config space
            cap_id = self.config[pos + PCI_CAPABILITY_LIST_ID]
            nxt = self.config[pos + PCI_CAPABILITY_LIST_NEXT]
            if pos in visited:  # chain looped
                break
            if cap_id == 0xFF:  # chain broken
                break
            if cap_id == PCI_CAPABILITY_VENDOR_SPECIFIC_ID:
                # Byte 2 is a length field only for vendor-specific caps
                # (for standard caps it is capability data), so it is read
                # and validated only here.
                length = self.config[pos + PCI_CAPABILITY_LENGTH]
                if length < 3:  # record shorter than its own header: corrupt
                    break
                return self.config[pos : pos + length]
            visited.add(pos)
            pos = nxt
        return None


@dataclass(frozen=True)
class HostInterfaceInfo:
    """Decoded vendor-specific capability record (Device.GetInfo analog,
    vgpu.go:108-153), in the twin's self-describing format: a
    NUL-terminated ASCII signature naming the host interface, a one-byte
    record id (0 = host-driver info, the reference's record id 0), then
    NUL-terminated strings: driver version, then an optional branch. A
    GPU's own vendor capability is not in this format; it decodes to
    nothing a label takes (lm/interconnect.py)."""

    signature: str
    driver_version: str = ""
    driver_branch: str = ""


def decode_vendor_capability(cap: bytes) -> Optional[HostInterfaceInfo]:
    """Decode the record returned by get_vendor_specific_capability, or
    None when it is absent/malformed. Malformed records are a normal
    hardware condition (a future device revision, a truncated read), so
    this never raises — warn-don't-fail lives with the caller."""
    if not cap or len(cap) < 4 or cap[0] != PCI_CAPABILITY_VENDOR_SPECIFIC_ID:
        return None
    body = cap[3 : cap[PCI_CAPABILITY_LENGTH]]
    sig_end = body.find(0)
    if sig_end <= 0:
        return None
    try:
        signature = body[:sig_end].decode("ascii")
    except UnicodeDecodeError:
        return None
    if not signature.isprintable():
        return None
    rest = body[sig_end + 1 :]
    if not rest or rest[0] != 0:  # unknown record id: signature-only
        return HostInterfaceInfo(signature=signature)
    # The fields are POSITIONAL (version, then branch — the reference's
    # record is two fixed 10-byte slots, vgpu.go:108-153): an empty first
    # field means "no version", it must not promote the branch into the
    # version slot.
    fields = rest[1:].split(b"\x00")
    strings = []
    for raw in fields[:2]:
        try:
            s = raw.decode("ascii")
        except UnicodeDecodeError:
            break  # garbage after the good strings: keep what parsed
        if not s.isprintable():
            break
        strings.append(s)
    return HostInterfaceInfo(
        signature=signature,
        driver_version=strings[0] if strings else "",
        driver_branch=strings[1] if len(strings) > 1 else "",
    )


class NvidiaPCI(Protocol):
    """Scanner interface (NvidiaPCI, pciutil.go:28-30)."""

    def devices(self) -> List[PCIDevice]: ...


class SysfsNvidiaPCI:
    """Sysfs-backed scanner (NvidiaPCILib.Devices, pciutil.go:70-113),
    filtered to the NVIDIA vendor id and to display-class functions."""

    def __init__(self, root: str = PCI_DEVICES_ROOT, vendor_id: str = NVIDIA_PCI_VENDOR_ID):
        self.root = root
        self.vendor_id = vendor_id

    def devices(self) -> List[PCIDevice]:
        try:
            entries = sorted(os.listdir(self.root))
        except OSError as e:
            raise PCIError(f"unable to read PCI bus devices: {e}") from e

        found: List[PCIDevice] = []
        for address in entries:
            device_path = os.path.join(self.root, address)
            try:
                vendor = _read_text(os.path.join(device_path, "vendor"))
            except OSError as e:
                raise PCIError(
                    f"unable to read PCI device vendor id for {address}: {e}"
                ) from e
            if vendor != self.vendor_id:
                continue

            try:
                device_class = _read_text(os.path.join(device_path, "class"))
            except OSError as e:
                raise PCIError(
                    f"unable to read PCI device class for {address}: {e}"
                ) from e
            if not device_class.startswith(DISPLAY_CLASS_PREFIX):
                continue
            try:
                config = _read_bytes(os.path.join(device_path, "config"))
            except OSError as e:
                raise PCIError(
                    f"unable to read PCI device data for {address}: {e}"
                ) from e

            found.append(
                PCIDevice(
                    path=device_path,
                    address=address,
                    vendor=vendor,
                    device_class=device_class[:6],
                    config=config,
                )
            )
        return found


class MockNvidiaPCI:
    """Fixture scanner (NewMockNvidiaPCI, pciutil.go:180-204) built from
    synthesized config spaces rather than captured blobs."""

    def __init__(self, devices: Optional[List[PCIDevice]] = None):
        self._devices = devices if devices is not None else default_mock_devices()

    def devices(self) -> List[PCIDevice]:
        return list(self._devices)


def build_config_space(
    vendor: int = 0x10DE,
    device: int = 0x2330,
    capabilities: Optional[List[bytes]] = None,
    size: int = 256,
) -> bytes:
    """Synthesize a PCI config space with a well-formed capability chain —
    the golden-blob generator for tier-1 walker tests (the reference checks
    in two captured 256-byte arrays; generating keeps the binary format
    executable documentation instead)."""
    cfg = bytearray(size)
    cfg[0:2] = vendor.to_bytes(2, "little")
    cfg[2:4] = device.to_bytes(2, "little")
    caps = capabilities or []
    if caps:
        cfg[PCI_STATUS_BYTE] |= PCI_STATUS_CAPABILITY_LIST
        pos = 0x40
        cfg[PCI_CAPABILITY_LIST] = pos
        for i, cap in enumerate(caps):
            end = pos + len(cap)
            if end > size:
                raise ValueError("capabilities overflow config space")
            cfg[pos:end] = cap
            nxt = 0 if i == len(caps) - 1 else (end + 3) & ~3
            cfg[pos + PCI_CAPABILITY_LIST_NEXT] = nxt
            pos = nxt if nxt else pos
    return bytes(cfg)


def make_capability(cap_id: int, body: bytes) -> bytes:
    """id, next (patched by build_config_space), length, body."""
    length = 3 + len(body)
    return bytes([cap_id, 0, length]) + body


def default_mock_devices() -> List[PCIDevice]:
    """Two synthetic GPU functions: one with a vendor-specific capability
    record in the twin's format and one without any capability chain."""
    with_cap = build_config_space(
        capabilities=[
            make_capability(0x01, b"\x00\x00"),  # power management
            make_capability(
                PCI_CAPABILITY_VENDOR_SPECIFIC_ID,
                b"NVHOST\x00\x00580.95.05\x00r580\x00",
            ),
        ]
    )
    without_cap = build_config_space()
    return [
        PCIDevice(
            path="", address="0000:19:00.0", vendor=NVIDIA_PCI_VENDOR_ID,
            device_class="0x0302", config=with_cap,
        ),
        PCIDevice(
            path="", address="0000:39:00.0", vendor=NVIDIA_PCI_VENDOR_ID,
            device_class="0x0302", config=without_cap,
        ),
    ]


def _read_text(path: str) -> str:
    with open(path) as f:
        return f.read().strip()


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
