"""Backend factory (twin: ``gpu_feature_discovery_tpu/resource/factory.py``
with the registry tokens of ``resource/registry.py``).

``--backends`` takes one token:

- ``gpu`` (and ``auto``, the twin's default spelling, which resolves to
  ``gpu`` — the CUDA devices are this port's autodetect) → CudaManager;
- ``mock-gpu[:<n>]`` → StaticCudaManager with n devices (default 1).

Every other token, and any list of tokens, is rejected: the port has one
device family so far, and the twin's registry grammar stays its to keep.

``select_manager`` is the token lookup alone; ``new_manager`` adds the
``pjrt_init`` fault site (utils/faults.py), which fires where the
acquisition is driven: here in process, in the parent for a probe child
or a broker spawn (sandbox/), which select in the child.

``build_manager`` is the supervised daemon's acquisition unit (the
twin's ``cmd/main.py:_build_manager``): selection and an eager
``init()`` as ONE retryable step, in a killable child under
``--probe-isolation=subprocess`` (through the persistent broker worker
when the broker is on), raising the raw error for the supervisor
(cmd/supervisor.py), whose degraded mode replaces any silent fallback.
"""

from __future__ import annotations

from gpu_feature_discovery_tpu_torch.config.spec import Config, ConfigError
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import (
    CudaManager,
    StaticCudaManager,
)
from gpu_feature_discovery_tpu_torch.resource.types import Manager


def new_manager(config: Config) -> Manager:
    """The backend the config names, with the ``pjrt_init`` fault site."""
    from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

    maybe_inject("pjrt_init")
    return select_manager(config)


def select_manager(config: Config) -> Manager:
    """Backend selection WITHOUT the fault site: a probe child and the
    broker worker select here, after the parent fired the site."""
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
    manager = new_manager(config)
    manager.init()
    return manager
