"""PCI scanning of the PyTorch port (pci/pciutil.py) against its JAX twin,
on the CPU.

The capability walker and the record decoder are the twin's: the same
synthesized config spaces (chains that loop, a 0xff id, a pointer past
the end, a short unprivileged read) must give the same answer in both.
The sysfs scanner differs on purpose: it keeps NVIDIA's vendor id and
display-class functions only, so an HGX node's NVSwitch, bridge and audio
functions do not count as GPUs."""

import os

import pytest

from gpu_feature_discovery_tpu.pci import pciutil as twin
from gpu_feature_discovery_tpu_torch.pci import pciutil as port

VS = port.PCI_CAPABILITY_VENDOR_SPECIFIC_ID
RECORD = b"NVHOST\x00\x00580.95.05\x00r580\x00"


def _config(mod, caps, size=256, vendor=0x10DE):
    return mod.build_config_space(
        vendor=vendor, device=0x2330,
        capabilities=[mod.make_capability(i, body) for i, body in caps], size=size)


def _looped():
    cfg = bytearray(_config(port, [(0x01, b"\x00\x00"), (0x05, b"\x00" * 4)]))
    cfg[0x40 + 1] = 0x44  # PM -> MSI
    cfg[0x44 + 1] = 0x40  # MSI -> PM: a loop
    return bytes(cfg)


def _ff_id():
    cfg = bytearray(_config(port, [(0x01, b"\x00\x00"), (VS, RECORD)]))
    cfg[0x44] = 0xFF
    return bytes(cfg)


def _past_the_end():
    cfg = bytearray(_config(port, [(0x01, b"\x00\x00")]))
    cfg[0x41] = 0xFE
    return bytes(cfg)


def _short_vendor_cap():
    cfg = bytearray(_config(port, [(VS, b"")]))
    cfg[0x42] = 2  # shorter than its own header
    return bytes(cfg)


def _no_status_bit():
    cfg = bytearray(_config(port, [(VS, RECORD)]))
    cfg[port.PCI_STATUS_BYTE] = 0
    return bytes(cfg)


CONFIGS = {
    "no_capabilities": lambda: _config(port, []),
    "record_after_power_management": lambda: _config(
        port, [(0x01, b"\x00\x00"), (VS, RECORD)]),
    "record_first": lambda: _config(port, [(VS, RECORD), (0x10, b"\x00" * 8)]),
    "chain_loops": _looped,
    "chain_broken_by_ff": _ff_id,
    "pointer_past_the_end": _past_the_end,
    "vendor_cap_shorter_than_header": _short_vendor_cap,
    "status_bit_clear": _no_status_bit,
    "unprivileged_64_byte_read": lambda: _config(port, [(VS, RECORD)])[:64],
    "gpu_like_binary_vendor_cap": lambda: _config(
        port, [(0x01, b"\x00\x00"), (VS, b"\x01\x00\x28\x00\x00\x00\x10\x00\x00")]),
}


def _walk(mod, config):
    dev = mod.PCIDevice(path="", address="0000:19:00.0", vendor="0x10de",
                        device_class="0x0302", config=config)
    try:
        return ("cap", dev.get_vendor_specific_capability())
    except mod.PCIError:
        return ("error", None)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_walker_matches_twin(case):
    config = CONFIGS[case]()
    got = _walk(port, config)
    assert got == _walk(twin, config)
    if case == "unprivileged_64_byte_read":
        assert got == ("error", None)
    if case.startswith("record_"):
        # Byte 1 is the next pointer the builder patched in.
        want = port.make_capability(VS, RECORD)
        assert got[1][0] == VS and got[1][2:] == want[2:]


@pytest.mark.parametrize("record", [
    RECORD,
    b"TPUICI\x00\x001.9.0\x00prod\x00",
    b"NVHOST\x00",                      # signature only
    b"NVHOST\x00\x07580\x00",           # unknown record id
    b"NVHOST\x00\x00\x00r580\x00",      # no version: the branch stays second
    b"\x01\x00\x28\x00\x00\x00",        # binary, not a record
    b"NV\xffHOST\x00\x00580\x00",       # not ASCII
    b"",
])
def test_record_decoder_matches_twin(record):
    cap = port.make_capability(VS, record)
    got, want = port.decode_vendor_capability(cap), twin.decode_vendor_capability(cap)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.signature, got.driver_version, got.driver_branch) == (
            want.signature, want.driver_version, want.driver_branch)


def test_config_space_builders_match_twin():
    caps = [(0x01, b"\x00\x00"), (0x05, b"\x00" * 6), (VS, RECORD)]
    assert _config(port, caps) == _config(twin, caps)
    assert port.build_config_space()[:4] == b"\xde\x10\x30\x23"
    with pytest.raises(ValueError):
        port.build_config_space(capabilities=[port.make_capability(VS, b"x" * 250)])


def _function(root, address, vendor, cls, config=b"\x00" * 64):
    d = root / address
    d.mkdir()
    (d / "vendor").write_text(vendor + "\n")
    (d / "class").write_text(cls + "\n")
    (d / "config").write_bytes(config)


def test_sysfs_scan_counts_nvidia_display_functions_only(tmp_path):
    """An HGX-like bus: two H100s (3D controller 0x0302), an NVSwitch
    (bridge 0x0680), an NVIDIA audio function (0x0403), a host VGA of
    another vendor and a virtio device."""
    _function(tmp_path, "0000:19:00.0", "0x10de", "0x030200", _config(port, [(VS, RECORD)]))
    _function(tmp_path, "0000:05:00.0", "0x10de", "0x068000")
    _function(tmp_path, "0000:19:00.1", "0x10de", "0x040300")
    _function(tmp_path, "0000:00:02.0", "0x1234", "0x030000")
    _function(tmp_path, "0000:00:03.0", "0x1af4", "0x020000")
    _function(tmp_path, "0000:39:00.0", "0x10de", "0x030200")
    devices = port.SysfsNvidiaPCI(root=str(tmp_path)).devices()
    assert [d.address for d in devices] == ["0000:19:00.0", "0000:39:00.0"]
    assert all(d.device_class == "0x0302" and d.vendor == "0x10de" for d in devices)
    assert devices[0].get_vendor_specific_capability() == port.make_capability(VS, RECORD)
    # The twin's walker, pointed at NVIDIA's vendor id, counts every function.
    assert len(twin.SysfsGooglePCI(root=str(tmp_path), vendor_id="0x10de").devices()) == 4


def test_sysfs_scan_errors_like_twin(tmp_path):
    with pytest.raises(port.PCIError):
        port.SysfsNvidiaPCI(root=str(tmp_path / "missing")).devices()
    (tmp_path / "0000:19:00.0").mkdir()
    with pytest.raises(port.PCIError):
        port.SysfsNvidiaPCI(root=str(tmp_path)).devices()  # no vendor file
    with pytest.raises(twin.PCIError):
        twin.SysfsGooglePCI(root=str(tmp_path)).devices()


def test_mock_scanner_serves_two_gpu_functions():
    devices = port.MockNvidiaPCI().devices()
    assert [d.vendor for d in devices] == [port.NVIDIA_PCI_VENDOR_ID] * 2
    assert port.decode_vendor_capability(
        devices[0].get_vendor_specific_capability()).signature == "NVHOST"
    assert devices[1].get_vendor_specific_capability() is None
    assert os.path.basename(port.PCI_DEVICES_ROOT) == "devices"
