"""Multi-backend registry: one backend per label family (twin:
``gpu_feature_discovery_tpu/resource/registry.py``).

The port has two label families:

- ``gpu`` (``nvidia.com/gpu.*``), the classic device-backed list, the
  twin's ``tpu`` family: ``auto`` (the autodetect chain), ``gpu`` (CUDA
  devices), ``native`` (NVML only), ``null``, and the fixtures
  ``mock-gpu[:<n>]`` and ``mock-nvml:<layout>``;
- ``cpu`` (``node.features/cpu.*``): ``cpu`` (the host, one device, its
  versions from the installed torch distribution) and the fixture
  ``mock-cpu[:<n>]`` (resource/cpu_backend.py).

The twin's TPU-only providers (``jax``/``pjrt``, ``hostinfo``/``metadata``,
``tpu``, ``mock:``, ``mock-slice:``, ``mock-worker:``, ``mock-mixed:``)
have no counterpart and are unknown tokens here: there is no JAX and no
libtpu on a CUDA node, and the GPU counterpart of ``hostinfo`` waits for
its own slice (ROADMAP.md queue 1, item 9).

:func:`multi_backend_tokens` resolves what the daemon runs. ``TFD_BACKEND``
(the forced override) wins and keeps the classic single-manager path, as
in the twin. So does a list that names the gpu family alone: the twin's
classic path is ``auto`` alone, and this port's classic path has taken
any one gpu-family token since it began, so ``--backends gpu`` and
``--backends mock-gpu:2`` keep their output and their supervision byte
for byte. A list with the cpu family runs the registry cycle
(cmd/main.run): each enabled backend gets its own init retries under
capped jittered backoff (``BackendRuntime``), its own ``pjrt_init.<family>``
fault site, its own ``tfd_backend_up{backend}`` and
``tfd_backend_inits_total{backend,outcome}`` series, and its own probe
child or broker worker (keyed by token, sandbox/); one sick backend
degrades only its own family's labels.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from gpu_feature_discovery_tpu_torch.config.spec import Config, ConfigError
from gpu_feature_discovery_tpu_torch.resource.types import Manager

log = logging.getLogger("tfd.resource")

BACKEND_ENV = "TFD_BACKEND"

FAMILY_GPU = "gpu"
FAMILY_CPU = "cpu"


@dataclass(frozen=True)
class BackendProvider:
    """One registered backend: how to build its Manager and which label
    family it feeds. A ``prefix`` provider matches ``<name>`` and
    ``<name>:<arg>`` (``<name><arg>`` when its name ends in ':'); an exact
    provider matches the token alone."""

    name: str
    family: str
    build: Callable[[Config, str], Manager]  # (config, full token) -> Manager
    prefix: bool = False
    # Parse-time validation (ConfigError), so a typo fails at config load.
    validate: Optional[Callable[[str], None]] = None


def provider_for(token: str) -> Optional[BackendProvider]:
    """The provider of one backend token; None when nothing matches."""
    token = token.strip().lower()
    p = _PROVIDERS.get(token)
    if p is not None and not p.prefix:
        return p
    for p in _PROVIDERS.values():
        if not p.prefix:
            continue
        if p.name.endswith(":"):
            if token.startswith(p.name):
                return p
        elif token == p.name or token.startswith(p.name + ":"):
            # mock-gpux is an unknown token, not one device.
            return p
    return None


def backend_spec_tokens() -> List[str]:
    return [p.name for p in _PROVIDERS.values()]


# ---------------------------------------------------------------------------
# provider builders
# ---------------------------------------------------------------------------

def _arg(token: str) -> str:
    return token.split(":", 1)[1] if ":" in token else ""


def _mock_count(token: str, default: int = 1) -> int:
    arg = _arg(token)
    if not arg:
        return default
    try:
        n = int(arg)
    except ValueError as e:
        raise ConfigError(f"invalid mock device count in {token!r}") from e
    if n < 1:
        raise ConfigError(f"mock device count must be >= 1 in {token!r}")
    return n


def _nvml_layout(token: str) -> str:
    from gpu_feature_discovery_tpu_torch.resource.testing import LAYOUTS

    layout = _arg(token)
    if layout not in LAYOUTS:
        raise ConfigError(
            f"backend {token!r}: want mock-nvml:<layout>, layout one of "
            f"{sorted(LAYOUTS)}"
        )
    return layout


def _build_auto(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource import factory

    return factory.autodetect_manager(config)


def _build_gpu(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import CudaManager

    return CudaManager()


def _build_native(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager

    # Naming the backend is the opt-in; no --native-enumeration needed.
    return NvmlManager()


def _build_null(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.null import NullManager

    return NullManager()


def _build_mock_gpu(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager

    return StaticCudaManager.mock_gpu(_mock_count(token))


def _build_mock_nvml(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
    from gpu_feature_discovery_tpu_torch.resource.testing import fake_nvml

    return NvmlManager(fake_nvml(_nvml_layout(token)))


def _build_cpu(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.cpu_backend import CpuManager

    log.info("Using the host cpu manager")
    return CpuManager()


def _build_mock_cpu(config: Config, token: str) -> Manager:
    from gpu_feature_discovery_tpu_torch.resource.cpu_backend import StaticCpuManager

    count = _mock_count(token)
    log.info("Using mock cpu manager (%d devices)", count)
    return StaticCpuManager.mock_cpu(count)


_PROVIDERS: Dict[str, BackendProvider] = {p.name: p for p in (
    # The gpu family: the classic device list.
    BackendProvider("auto", FAMILY_GPU, _build_auto),
    BackendProvider("gpu", FAMILY_GPU, _build_gpu),
    BackendProvider("native", FAMILY_GPU, _build_native),
    BackendProvider("null", FAMILY_GPU, _build_null),
    BackendProvider("mock-gpu", FAMILY_GPU, _build_mock_gpu, prefix=True,
                    validate=lambda token: _mock_count(token) and None),
    BackendProvider("mock-nvml:", FAMILY_GPU, _build_mock_nvml, prefix=True,
                    validate=lambda token: _nvml_layout(token) and None),
    # The cpu family.
    BackendProvider("cpu", FAMILY_CPU, _build_cpu),
    BackendProvider("mock-cpu", FAMILY_CPU, _build_mock_cpu, prefix=True,
                    validate=lambda token: _mock_count(token) and None),
)}


# ---------------------------------------------------------------------------
# selection entry points
# ---------------------------------------------------------------------------

def select_backend_manager(config: Config, token: str) -> Manager:
    """The Manager of one backend token WITHOUT the fault site or the
    init-attempt metric: a probe child and a broker worker build here,
    after the parent fired both."""
    provider = provider_for(token)
    if provider is None:
        raise ConfigError(f"unknown backend {token!r}")
    return provider.build(config, token.strip().lower())


def new_backend_manager(config: Config, token: str) -> Manager:
    """The in-process acquisition of one token, with the ``pjrt_init``
    site and the init-attempt metric (``factory.new_manager`` without the
    fallback wrapper)."""
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

    obs_metrics.BACKEND_INIT_ATTEMPTS.inc()
    maybe_inject("pjrt_init")
    return select_backend_manager(config, token)


# ---------------------------------------------------------------------------
# --backends resolution
# ---------------------------------------------------------------------------

def parse_backends_value(raw: str) -> List[str]:
    """One ``--backends`` value as an ordered token list: comma-separated,
    deduplicated in order, every token known, at most one per label
    family. ``auto`` counts as the gpu family."""
    tokens: List[str] = []
    for part in str(raw).split(","):
        token = part.strip().lower()
        if token and token not in tokens:
            tokens.append(token)
    if not tokens:
        raise ConfigError("empty --backends value")
    seen_families: Dict[str, str] = {}
    for token in tokens:
        provider = provider_for(token)
        if provider is None:
            raise ConfigError(
                f"unknown backend {token!r} in --backends "
                f"(known: {', '.join(backend_spec_tokens())})"
            )
        if provider.validate is not None:
            provider.validate(token)
        other = seen_families.get(provider.family)
        if other is not None:
            raise ConfigError(
                f"--backends names two {provider.family}-family backends "
                f"({other!r}, {token!r}); one backend per label family"
            )
        seen_families[provider.family] = token
    return tokens


def multi_backend_tokens(
    config: Config, environ: Optional[Dict[str, str]] = None
) -> Optional[List[str]]:
    """The tokens the registry cycle runs, or None for the classic path:
    ``TFD_BACKEND`` set (the forced override), or a list naming the gpu
    family alone."""
    env = environ if environ is not None else os.environ
    if env.get(BACKEND_ENV, "").strip():
        return None
    tokens = parse_backends_value(config.flags.tfd.backends or "auto")
    if len(tokens) == 1 and provider_for(tokens[0]).family == FAMILY_GPU:
        return None
    return tokens


# ---------------------------------------------------------------------------
# per-backend supervision (the registry cycle's acquisition state)
# ---------------------------------------------------------------------------

class BackendRuntime:
    """One enabled backend's cross-cycle state: the held manager, the init
    retry and backoff, the per-family metrics. Its retry mirrors
    Supervisor.acquire_manager (cmd/supervisor.py: the same BackoffPolicy,
    window check and attempt clamp) with per-family observability and no
    claim on the un-labelled backoff gauge; a failure degrades only this
    backend's family."""

    def __init__(self, token: str, config: Config,
                 clock: Callable[[], float] = time.monotonic):
        from gpu_feature_discovery_tpu_torch.cmd.supervisor import BACKOFF_BASE_S
        from gpu_feature_discovery_tpu_torch.config.flags import (
            DEFAULT_INIT_BACKOFF_MAX,
            DEFAULT_INIT_RETRIES,
        )
        from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
        from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

        provider = provider_for(token)
        if provider is None:
            raise ConfigError(f"unknown backend {token!r}")
        self.token = token
        self.family = provider.family
        self._config = config
        self._clock = clock
        tfd = config.flags.tfd
        self._init_retries = (
            tfd.init_retries if tfd.init_retries is not None else DEFAULT_INIT_RETRIES
        )
        backoff_cap = (
            tfd.init_backoff_max
            if tfd.init_backoff_max is not None
            else DEFAULT_INIT_BACKOFF_MAX
        )
        self._policy = BackoffPolicy(base=min(BACKOFF_BASE_S, backoff_cap), cap=backoff_cap)
        self.manager: Optional[Manager] = None
        self.failures = 0
        self._next_attempt = 0.0
        # Armed but not yet probed reads 0, not an absent series.
        obs_metrics.BACKEND_UP.labels(backend=self.family).set(0)

    @property
    def down(self) -> bool:
        return self.manager is None and self.failures > 0

    @property
    def exhausted(self) -> bool:
        return self.failures >= self._init_retries

    def attempt_due(self) -> bool:
        """The next acquire() would try to build: no held manager and the
        backoff window open."""
        return self.manager is None and (
            not self.failures or self._clock() >= self._next_attempt
        )

    def acquire(self, strict: bool = False) -> Optional[Manager]:
        """One bounded acquisition attempt (a no-op while a manager is held
        or the backoff window is closed). ``strict`` (oneshot) raises the
        failure instead of degrading."""
        from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
        from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

        if self.manager is not None:
            return self.manager
        now = self._clock()
        if not strict and self.failures and now < self._next_attempt:
            return None
        try:
            maybe_inject(f"pjrt_init.{self.family}")
            manager = self._build()
        except Exception as e:  # noqa: BLE001 - per-backend supervision boundary
            if strict:
                raise
            self.failures += 1
            # The un-labelled classic counter counts in registry mode too,
            # so an alert on it sees a per-family outage.
            obs_metrics.BACKEND_INIT_FAILURES.inc()
            obs_metrics.BACKEND_INITS.labels(backend=self.family, outcome="error").inc()
            obs_metrics.BACKEND_UP.labels(backend=self.family).set(0)
            delay = self._policy.delay(min(self.failures - 1, 63))
            self._next_attempt = now + delay
            log.warning(
                "backend %s (%s family) init attempt %d failed: %s; next "
                "attempt in %.3fs — only the %s label family is degraded",
                self.token, self.family, self.failures, e, delay, self.family,
            )
            log.debug("backend %s init traceback:", self.token, exc_info=True)
            return None
        if self.failures:
            obs_metrics.BACKEND_INIT_RECOVERIES.inc()
            log.info("backend %s (%s family) recovered after %d failed attempts",
                     self.token, self.family, self.failures)
        self.failures = 0
        self._next_attempt = 0.0
        obs_metrics.BACKEND_INITS.labels(backend=self.family, outcome="ok").inc()
        obs_metrics.BACKEND_UP.labels(backend=self.family).set(1)
        self.manager = manager
        return manager

    def _build(self) -> Manager:
        """This backend's acquisition unit, the classic
        ``factory.build_manager`` keyed by token: its own broker worker or
        probe child, so a hang in one family never takes another's
        acquisition with it."""
        from gpu_feature_discovery_tpu_torch import sandbox
        from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_PROBE_TIMEOUT

        config = self._config
        if sandbox.isolation_mode(config) == "subprocess":
            if sandbox.broker_enabled(config):
                return sandbox.acquire_broker_manager(config, backend=self.token)
            tfd = config.flags.tfd
            timeout = (
                tfd.probe_timeout if tfd.probe_timeout is not None
                else DEFAULT_PROBE_TIMEOUT
            )
            return sandbox.acquire_snapshot_manager(config, timeout, backend=self.token)
        manager = new_backend_manager(config, self.token)
        manager.init()
        return manager

    def release(self) -> None:
        """Drop the held manager; the next cycle re-acquires."""
        if self.manager is None:
            return
        try:
            self.manager.shutdown()
        except Exception:  # noqa: BLE001 - already on the failure path
            log.debug("shutdown of backend %s:", self.token, exc_info=True)
        self.manager = None


class BackendSet:
    """The registry cycle's roster: one BackendRuntime per ``--backends``
    token, in flag order."""

    def __init__(self, tokens: List[str], config: Config,
                 clock: Callable[[], float] = time.monotonic):
        self._config = config
        self.runtimes = [BackendRuntime(t, config, clock=clock) for t in tokens]

    def has_family(self, family: str) -> bool:
        return any(rt.family == family for rt in self.runtimes)

    def acquire_all(self, strict: bool = False) -> None:
        """One acquisition pass over every backend whose attempt is due,
        fanned out on a bounded pool (utils/fanout.py), so a hung family's
        init (bounded by its own --probe-timeout when sandboxed) overlaps
        the others' instead of holding them up. ``strict`` (oneshot)
        raises the first failure in flag order after the pass."""
        from gpu_feature_discovery_tpu_torch.utils.fanout import BoundedPool, ErrorSink

        pending = [
            rt for rt in self.runtimes
            if rt.manager is None and (strict or rt.attempt_due())
        ]
        if not pending:
            return
        errors = ErrorSink()

        def acquire_task(rt: BackendRuntime):
            def run() -> None:
                try:
                    rt.acquire(strict=strict)
                except Exception as e:  # noqa: BLE001 - strict mode only
                    errors.put(rt.token, e)

            return run

        if len(pending) == 1:
            acquire_task(pending[0])()
        else:
            # One thread per family: at most one token per family.
            pool = BoundedPool(len(pending), name="tfd-backend-init")
            try:
                pool.run([acquire_task(rt) for rt in pending])
            finally:
                pool.shutdown(wait=True)
        for rt in self.runtimes:
            if rt.token in errors.errors:
                raise errors.errors[rt.token]

    def check_escalation(self) -> None:
        """InitRetriesExhausted only when EVERY backend is down past its
        retry budget under --fail-on-init-error=true: one sick family must
        never take the node's healthy families with it."""
        from gpu_feature_discovery_tpu_torch.cmd.supervisor import InitRetriesExhausted

        if not bool(self._config.flags.tfd.fail_on_init_error):
            return
        if all(rt.down and rt.exhausted for rt in self.runtimes):
            raise InitRetriesExhausted(
                "every enabled backend failed init past --init-retries: "
                + ", ".join(f"{rt.token}({rt.failures} failures)" for rt in self.runtimes)
            )

    def release_all(self) -> None:
        for rt in self.runtimes:
            rt.release()

    def close(self) -> None:
        """The epoch's end: release every backend and read each family as
        down, since its worker is retired with the epoch (the twin leaves
        the last value, which a reload that drops the family would leave
        reading 1)."""
        from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

        self.release_all()
        for rt in self.runtimes:
            obs_metrics.BACKEND_UP.labels(backend=rt.family).set(0)
