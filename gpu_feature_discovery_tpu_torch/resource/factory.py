"""Backend factory (twin: ``gpu_feature_discovery_tpu/resource/factory.py``
with the registry tokens of ``resource/registry.py``).

``--backends`` takes one token:

- ``gpu`` (and ``auto``, the twin's default spelling, which resolves to
  ``gpu`` — the CUDA devices are this port's autodetect) → CudaManager;
- ``mock-gpu[:<n>]`` → StaticCudaManager with n devices (default 1).

Every other token, and any list of tokens, is rejected: the port has one
device family so far, and the twin's registry grammar stays its to keep.

``build_manager`` is the supervised daemon's acquisition unit (the
twin's ``cmd/main.py:_build_manager``, in-process branch): the factory
and an eager ``init()`` as ONE retryable step, raising the raw init
error for the supervisor (cmd/supervisor.py), whose degraded mode
replaces any silent fallback.
"""

from __future__ import annotations

from gpu_feature_discovery_tpu_torch.config.spec import Config, ConfigError
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import (
    CudaManager,
    StaticCudaManager,
)
from gpu_feature_discovery_tpu_torch.resource.types import Manager


def new_manager(config: Config) -> Manager:
    token = (config.flags.tfd.backends or "auto").strip().lower()
    if token in ("auto", "gpu"):
        return CudaManager()
    if token == "mock-gpu" or token.startswith("mock-gpu:"):
        arg = token.partition(":")[2] or "1"
        if not arg.isdigit() or int(arg) < 1:
            raise ConfigError(f"backend {token!r}: want mock-gpu[:<n>], n >= 1")
        return StaticCudaManager.mock_gpu(int(arg))
    raise ConfigError(
        f"unsupported backend {token!r}: this port labels one device "
        "family; use 'gpu' or 'mock-gpu[:<n>]'"
    )


def build_manager(config: Config) -> Manager:
    """Factory + eager init; init() is idempotent, so the per-cycle
    init() inside lm/labelers.new_label_sources stays a cheap re-check."""
    manager = new_manager(config)
    manager.init()
    return manager
