"""The twin's factory auto-detection chain (``tests/test_factory_chain.py``)
held against the port's ``resource/factory.py``: the reference's
hasNVML -> isTegra -> null order, which the twin reads as PJRT -> hostinfo
-> null and the port as CUDA -> NVML-only (``--native-enumeration``) ->
null. Each case drives the twin's chain and the port's with the same
detection answer and the same backend failures, and wants the same
position of the chain: the first backend, the second, or null."""

import logging

import pytest

from gpu_feature_discovery_tpu.config.flags import new_config as twin_new_config
from gpu_feature_discovery_tpu.hostinfo.tpu_env import host_info_from_mapping
from gpu_feature_discovery_tpu.resource import factory as twin_factory
from gpu_feature_discovery_tpu.resource.fallback import FallbackToNullOnInitError as TwinFallback
from gpu_feature_discovery_tpu.resource.hostinfo_backend import HostinfoManager
from gpu_feature_discovery_tpu.resource.null import NullManager as TwinNull
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.pci import pciutil
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.resource.fallback import FallbackToNullOnInitError
from gpu_feature_discovery_tpu_torch.resource.null import NullManager
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.testing import fake_nvml


def cfg(**cli):
    return new_config(cli_values=cli, environ={}, config_file=None)


def twin_cfg(**cli):
    return twin_new_config(cli_values=cli, environ={}, config_file=None)


class _Cuda:
    """The CUDA manager's stand-in: ``broken`` fails its init as a CUDA
    node whose runtime will not start."""

    broken = False

    def init(self):
        if self.broken:
            raise RuntimeError("CUDA wedged")


class _BrokenCuda(_Cuda):
    broken = True


def patch_port(monkeypatch, has_gpu, cuda, nvml_ok):
    monkeypatch.setattr(factory, "detect_gpu_platform", lambda: (has_gpu, "patched"))
    monkeypatch.setattr(factory, "CudaManager", cuda)
    monkeypatch.setattr(factory, "_try_nvml_manager",
                        lambda config: NvmlManager(fake_nvml("none")) if nvml_ok else None)
    monkeypatch.delenv(factory.BACKEND_ENV, raising=False)


def patch_twin(monkeypatch, has_tpu, jax_mgr, hostinfo_ok):
    info = host_info_from_mapping({"TPU_ACCELERATOR_TYPE": "v4-8"})
    monkeypatch.setattr(twin_factory, "_detect_tpu_platform", lambda config: (has_tpu, "patched"))
    monkeypatch.setattr(twin_factory, "_try_jax_manager", lambda config, eager=False: jax_mgr)
    monkeypatch.setattr(twin_factory, "_try_hostinfo_manager",
                        lambda config: HostinfoManager(config, info=info) if hostinfo_ok else None)
    monkeypatch.delenv(twin_factory.BACKEND_ENV, raising=False)


def _port_position(manager):
    if isinstance(manager, FallbackToNullOnInitError):
        manager = manager._wraps
    if isinstance(manager, _Cuda):
        return "first"
    if isinstance(manager, NvmlManager):
        return "second"
    return "null" if isinstance(manager, NullManager) else repr(manager)


def _twin_position(manager, first):
    if manager is first:
        return "first"
    if isinstance(manager, HostinfoManager):
        return "second"
    return "null" if isinstance(manager, TwinNull) else repr(manager)


def test_prefers_cuda_when_available(monkeypatch):
    sentinel = object()
    patch_twin(monkeypatch, True, sentinel, False)
    patch_port(monkeypatch, True, _Cuda, False)
    assert _twin_position(twin_factory._get_manager(twin_cfg()), sentinel) == "first"
    assert _port_position(factory.select_manager(cfg())) == "first"


def test_falls_back_to_nvml_without_cuda(monkeypatch):
    """The twin's hostinfo fallback: its second backend, taken when the
    first is unusable. The port's is the NVML-only manager, opt-in by
    ``--native-enumeration``, taken when CUDA will not init."""
    patch_twin(monkeypatch, True, None, True)
    patch_port(monkeypatch, True, _BrokenCuda, True)
    assert _twin_position(twin_factory._get_manager(twin_cfg()), None) == "second"
    manager = factory.select_manager(cfg(**{"native-enumeration": "true"}))
    assert _port_position(manager) == "second"


def test_null_when_no_backend_usable(monkeypatch):
    patch_twin(monkeypatch, True, None, False)
    patch_port(monkeypatch, True, _BrokenCuda, False)
    assert _twin_position(twin_factory._get_manager(twin_cfg()), None) == "null"
    manager = factory.select_manager(cfg(**{"native-enumeration": "true"}),
                                     fallback_to_null=True)
    assert _port_position(manager) == "null"


def test_null_off_gpu_without_probing_backends(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("backends must not be probed off-GPU")

    monkeypatch.setattr(twin_factory, "_detect_tpu_platform", lambda config: (False, "patched"))
    monkeypatch.setattr(twin_factory, "_try_jax_manager", boom)
    monkeypatch.setattr(twin_factory, "_try_hostinfo_manager", boom)
    monkeypatch.delenv(twin_factory.BACKEND_ENV, raising=False)
    monkeypatch.setattr(factory, "detect_gpu_platform", lambda: (False, "patched"))
    monkeypatch.setattr(factory, "CudaManager", boom)
    monkeypatch.setattr(factory, "_try_nvml_manager", boom)
    monkeypatch.delenv(factory.BACKEND_ENV, raising=False)
    assert isinstance(twin_factory._get_manager(twin_cfg()), TwinNull)
    assert isinstance(factory.select_manager(cfg()), NullManager)


def test_auto_chain_falls_through_on_cuda_init_failure(monkeypatch):
    """Under ``--fail-on-init-error=false`` the chain verifies the first
    backend eagerly and degrades to the second; with it true the first
    stays lazy, so its init error exits loudly where it is initialised.
    The port's second backend is opt-in: ``--native-enumeration`` alone
    also verifies CUDA eagerly (there is somewhere to fall through to), so
    the loud case runs without it, where the twin's hostinfo fallback
    exists unasked."""
    patch_port(monkeypatch, True, _BrokenCuda, True)
    degraded = factory.new_manager(cfg(**{"fail-on-init-error": "false",
                                          "native-enumeration": "true"}))
    assert isinstance(degraded, FallbackToNullOnInitError)
    assert _port_position(degraded) == "second"
    loud = factory.new_manager(cfg(**{"fail-on-init-error": "true"}))
    assert isinstance(loud, _BrokenCuda)
    with pytest.raises(RuntimeError, match="CUDA wedged"):
        loud.init()


def test_fallback_wrapper_applied_iff_not_fail_on_init(monkeypatch):
    patch_twin(monkeypatch, True, None, False)
    patch_port(monkeypatch, True, _BrokenCuda, False)
    for flag in ("false", "true"):
        twin_wrapped = isinstance(
            twin_factory.new_manager(twin_cfg(**{"fail-on-init-error": flag})), TwinFallback)
        port_wrapped = isinstance(
            factory.new_manager(cfg(**{"fail-on-init-error": flag})), FallbackToNullOnInitError)
        assert port_wrapped == twin_wrapped == (flag == "false")


class _BrokenPCI:
    def devices(self):
        raise PermissionError("sysfs scan denied")


def _malformed_sysfs(root):
    """A sysfs tree whose one function's vendor file is not text."""
    device = root / "0000:00:01.0"
    device.mkdir(parents=True)
    (device / "vendor").write_bytes(b"\xff\xfe\n")
    return str(root)


@pytest.mark.parametrize("scanner", ["permission-denied", "vendor-not-text"])
def test_pci_probe_failure_logged_at_debug(monkeypatch, caplog, tmp_path, scanner):
    """Fault 16: the port's ``detect_gpu_platform`` caught ``PCIError``
    only, so a vendor file that is not text escaped as
    ``UnicodeDecodeError`` (and any other scan error as itself) where the
    twin answers "no accelerator" and logs the error at debug."""
    from gpu_feature_discovery_tpu.native import shim
    from gpu_feature_discovery_tpu.pci import pciutil as twin_pciutil

    class _Probed:
        found = False
        source = ""

    if scanner == "permission-denied":
        twin_scanner = port_scanner = _BrokenPCI
        detail = "sysfs scan denied"
    else:
        root = _malformed_sysfs(tmp_path / "sys")
        twin_class = twin_pciutil.SysfsGooglePCI
        twin_scanner = lambda *a, **k: twin_class(root=root)  # noqa: E731
        port_scanner = lambda: pciutil.SysfsNvidiaPCI(root=root)  # noqa: E731
        detail = "codec can't decode"
    monkeypatch.setattr(shim, "probe_libtpu", lambda path=None: _Probed())
    monkeypatch.setattr(twin_pciutil, "SysfsGooglePCI", twin_scanner)
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    monkeypatch.setattr(nvml, "load_library", lambda *a, **k: None)
    monkeypatch.setattr(factory, "SysfsNvidiaPCI", port_scanner)
    with caplog.at_level(logging.DEBUG, logger="tfd.resource"):
        has_tpu, _ = twin_factory._detect_tpu_platform(twin_cfg())
        has_gpu, _ = factory.detect_gpu_platform()
    assert has_gpu is has_tpu is False
    assert "GPU PCI platform probe unavailable" in caplog.text
    assert "TPU PCI platform probe unavailable" in caplog.text
    assert caplog.text.count(detail) == 2
