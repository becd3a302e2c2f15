"""Backend factory and platform autodetect (twin:
``gpu_feature_discovery_tpu/resource/factory.py``).

Selection dispatches through the backend registry (resource/registry.py).
This module is the classic single-manager path, the gpu family's: it
builds the manager of ``TFD_BACKEND`` when that is set (the twin's forced
override; an unknown or cpu-family token warns and falls through to
autodetect, as in the twin), else of the one gpu-family token of
``--backends``:

- ``auto`` (the default): the autodetect chain, the twin's
  ``autodetect_manager`` (reference: factory.go:54-73). NVML loadable, or
  NVIDIA display functions on the PCI bus, means a GPU node: the CUDA
  manager, then (opt-in, ``--native-enumeration``) the NVML-only manager
  where torch or CUDA cannot init. On a node without GPUs, the Null
  manager (no device labels). On a GPU node where neither backend inits,
  the Null manager only for oneshot under ``--fail-on-init-error=false``;
  everywhere else CUDA's init error surfaces, so the supervised daemon
  goes degraded and retries;
- ``gpu`` → CudaManager; ``native`` → NvmlManager (forced, no torch, no
  CUDA context); ``null`` → NullManager;
- ``mock-gpu[:<n>]`` → StaticCudaManager with n devices (default 1);
- ``mock-nvml:<layout>`` → NvmlManager over a FakeNvml with one of
  ``resource/testing.py:LAYOUTS`` (MIG layouts on the CPU).

A list with the cpu family (``--backends gpu,cpu``) runs the registry
cycle instead, one backend per family (cmd/main.run).

``validate_backends`` checks the whole ``--backends`` list without any
detection or library load: the labeling process of a brokered daemon
validates with it and never loads NVML (an ``nvmlInit`` against a wedged
GPU can hang), while ``select_manager`` (detection, and construction)
runs where the acquisition runs: in process, or in the probe child or
broker worker. ``new_manager`` adds the ``pjrt_init`` fault site and,
unless ``wrap_fallback=False`` or ``--fail-on-init-error``, the
fallback-to-null wrapper (the twin's factory.go:27-39) and the chain's
fall-through to null; oneshot takes both, the supervised daemon neither:
it gets raw errors.

``build_manager`` is the supervised daemon's acquisition unit (the
twin's ``cmd/main.py:_build_manager``): selection and an eager
``init()`` as ONE retryable step, in a killable child under
``--probe-isolation=subprocess`` (through the persistent broker worker
when the broker is on), raising the raw error for the supervisor
(cmd/supervisor.py), whose degraded mode replaces any silent fallback.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import Config, ConfigError
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.pci.pciutil import PCIError, SysfsNvidiaPCI
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import CudaManager
from gpu_feature_discovery_tpu_torch.resource.fallback import FallbackToNullOnInitError
from gpu_feature_discovery_tpu_torch.resource import registry
from gpu_feature_discovery_tpu_torch.resource.null import NullManager
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.types import Manager

log = logging.getLogger("tfd.resource")

BACKEND_ENV = registry.BACKEND_ENV


def _gpu_token(config: Config) -> Optional[str]:
    for token in registry.parse_backends_value(config.flags.tfd.backends or "auto"):
        if registry.provider_for(token).family == registry.FAMILY_GPU:
            return token
    return None


def validate_backends(config: Config) -> Tuple[str, str]:
    """Every ``--backends`` token checked (known, valid argument, one per
    family), with no detection and no library load; returns (kind,
    argument) of its gpu-family token, ('', '') when it names none."""
    token = _gpu_token(config)
    if token is None:
        return "", ""
    return registry.provider_for(token).name.rstrip(":"), token.partition(":")[2]


def _classic_token(config: Config) -> str:
    """The gpu-family token the classic path builds: ``TFD_BACKEND`` when
    set (unknown or another family's token falls through to ``auto``,
    with a warning), else the one of ``--backends``."""
    forced = os.environ.get(BACKEND_ENV, "").strip().lower()
    if forced:
        provider = registry.provider_for(forced)
        if provider is None:
            log.warning("unrecognized %s=%r; falling through to autodetect",
                        BACKEND_ENV, forced)
            return "auto"
        if provider.family != registry.FAMILY_GPU:
            log.warning(
                "%s=%r names a %s-family backend; %s forces a single "
                "gpu-family backend — use TFD_BACKENDS/--backends for the %s "
                "family. Falling through to autodetect.",
                BACKEND_ENV, forced, provider.family, BACKEND_ENV, provider.family,
            )
            return "auto"
        return forced
    token = _gpu_token(config)
    if token is None:
        raise ConfigError(
            f"--backends {config.flags.tfd.backends!r} names no gpu-family "
            "backend; the single-manager path labels the gpu family"
        )
    return token


def new_manager(config: Config, wrap_fallback: bool = True) -> Manager:
    """The backend the config names, with the ``pjrt_init`` fault site and
    the fallback-to-null wrapper (NewManager, factory.go:27-30). Every
    call counts one ``tfd_backend_init_attempts_total``, healthy or not."""
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

    obs_metrics.BACKEND_INIT_ATTEMPTS.inc()
    maybe_inject("pjrt_init")
    fallback = wrap_fallback and not config.flags.tfd.fail_on_init_error
    manager = select_manager(config, fallback_to_null=fallback)
    if not wrap_fallback:
        return manager
    return with_config(manager, config)


def with_config(manager: Manager, config: Config) -> Manager:
    """WithConfig (factory.go:33-39)."""
    if config.flags.tfd.fail_on_init_error:
        return manager
    return FallbackToNullOnInitError(manager)


def select_manager(config: Config, fallback_to_null: bool = False) -> Manager:
    """Backend selection WITHOUT the fault site or the wrapper: a probe
    child and the broker worker select here, after the parent fired the
    site. ``fallback_to_null``: a GPU node whose backends will not init
    gets the Null manager instead of the init error (oneshot only)."""
    token = _classic_token(config)
    if token == "auto":
        return autodetect_manager(config, fallback_to_null)
    return registry.select_backend_manager(config, token)


def autodetect_manager(config: Config, fallback_to_null: bool = False) -> Manager:
    """CUDA first, NVML-only second (opt-in), null last: the twin's chain
    (factory.go:54-73) with GPU probes. On a GPU node the chain reaches
    null only with ``fallback_to_null``; else CUDA's init error stands."""
    has_gpu, reason = detect_gpu_platform()
    log.info("Detected %sGPU platform: %s", "" if has_gpu else "non-", reason)
    if has_gpu:
        manager = CudaManager()
        if not (fallback_to_null or config.flags.native_enumeration):
            # Nothing to fall through to: the CUDA manager stays lazy and
            # its init error surfaces where the caller inits it.
            log.info("Using CUDA manager")
            return manager
        try:
            manager.init()
            log.info("Using CUDA manager")
            return manager
        except Exception as e:  # noqa: BLE001 - the chain goes on
            cuda_error = e
            log.warning("CUDA backend unavailable: %s", e)
        manager = _try_nvml_manager(config)
        if manager is not None:
            log.info("Using NVML-only manager; CUDA unusable")
            return manager
        if not fallback_to_null:
            raise cuda_error
        log.warning("GPU detected but no backend usable; using null manager")
    log.warning("No valid resources detected; using empty manager.")
    return NullManager()


def detect_gpu_platform() -> Tuple[bool, str]:
    """hasNvml probe (factory.go:54-57): NVML dlopen-able, then NVIDIA
    display functions on the PCI bus. Loads NVML; calls nothing in it."""
    if nvml.load_library() is not None:
        return True, f"NVML loadable ({nvml.NVML_LIBRARY})"
    try:
        if SysfsNvidiaPCI().devices():
            return True, "NVIDIA display functions present on /sys/bus/pci"
    except PCIError as e:  # no sysfs is a non-GPU signal
        log.debug("GPU PCI platform probe unavailable: %s", e)
    return False, "no NVML, no NVIDIA display functions on the PCI bus"


def _try_nvml_manager(config: Config) -> Optional[Manager]:
    """NvmlManager, opt-in (--native-enumeration); verified eagerly so
    the chain can fall through to null."""
    if not config.flags.native_enumeration:
        return None
    manager = NvmlManager()
    try:
        manager.init()
    except Exception as e:  # noqa: BLE001 - backend optional by design
        log.warning("NVML backend unavailable: %s", e)
        return None
    return manager


def build_manager(config: Config) -> Manager:
    """Selection + eager init as one step. Under
    ``--probe-isolation=subprocess`` (the daemon default) it runs in a
    child under the ``--probe-timeout`` SIGKILL budget: through the
    persistent broker worker when the broker is on (the first
    acquisition spawns it, later ones are one snapshot RPC), else one
    probe child per acquisition. A hang or crash there is a retryable
    init failure (ProbeTimeout / ProbeCrash are ResourceErrors). In
    process, init() is idempotent, so the per-cycle init() inside
    lm/labelers.new_label_sources stays a cheap re-check."""
    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_PROBE_TIMEOUT

    if sandbox.isolation_mode(config) == "subprocess":
        if sandbox.broker_enabled(config):
            return sandbox.acquire_broker_manager(config)
        tfd = config.flags.tfd
        timeout = (
            tfd.probe_timeout if tfd.probe_timeout is not None else DEFAULT_PROBE_TIMEOUT
        )
        return sandbox.acquire_snapshot_manager(config, timeout)
    manager = new_manager(config, wrap_fallback=False)
    manager.init()
    return manager
