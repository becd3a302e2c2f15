"""Flag table + CLI > env > config file > default precedence (twin:
``gpu_feature_discovery_tpu/config/flags.py``).

Each flag keeps its twin's spelling, its ``TFD_*`` environment alias and
its default. Only the flags of the burn-in cycle, the supervised daemon
loop, the probe sandbox, the host facts, the introspection server and
the multi-backend registry are here; the config file
(``--config-file`` / ``TFD_CONFIG_FILE``, config/spec.py) sets the same
flags under their camelCase keys.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from gpu_feature_discovery_tpu_torch.config.spec import (
    PROBE_BROKER_AUTO,
    PROBE_BROKER_MODES,
    PROBE_ISOLATION_AUTO,
    PROBE_ISOLATION_MODES,
    RECONCILE_AUTO,
    RECONCILE_MODES,
    TOPOLOGY_STRATEGIES,
    TOPOLOGY_STRATEGY_NONE,
    Config,
    ConfigError,
    parse_bool as _parse_bool,
    parse_config_file,
    parse_fraction as _parse_fraction,
    parse_nonneg_int as _parse_nonneg_int,
    parse_positive_float as _parse_positive_float,
    parse_positive_int as _parse_positive_int,
)

DEFAULT_OUTPUT_FILE = "/etc/kubernetes/node-feature-discovery/features.d/tfd"
DEFAULT_MACHINE_TYPE_FILE = "/sys/class/dmi/id/product_name"
DEFAULT_SLEEP_INTERVAL = 60.0
# Supervisor defaults (cmd/supervisor.py): 5 init attempts with backoff
# capped at 30 s ride out a boot race before fail-fast; 5 contained cycle
# failures before escalation bound how long a broken cycle re-serves
# stale labels.
DEFAULT_INIT_RETRIES = 5
DEFAULT_INIT_BACKOFF_MAX = 30.0
DEFAULT_MAX_CONSECUTIVE_FAILURES = 5
# Introspection server (obs/server.py; daemon mode only, oneshot never
# opens a socket): every interface, since the scraper reaches the pod
# over the pod network.
DEFAULT_METRICS_ADDR = "0.0.0.0"
DEFAULT_METRICS_PORT = 9101
# Per-labeler deadline (lm/engine.py): generous against every source's
# worst case (the health labeler's bounded first-probe wait is 2 s), so
# staleness marks genuine degradation, not routine variance.
DEFAULT_LABELER_TIMEOUT = 10.0
# Anti-flap hysteresis window: 1 = publish every cycle unchanged.
DEFAULT_FLAP_WINDOW = 1
# Event-driven reconcile loop (cmd/events.py): the staleness bound
# defaults to the sleep interval (0 = track --sleep-interval), the
# debounce window collapses an event burst into one cycle, and the token
# bucket caps event-driven cycles per second.
DEFAULT_MAX_STALENESS = 0.0
DEFAULT_RECONCILE_DEBOUNCE = 0.5
DEFAULT_MAX_PROBE_RATE = 1.0
# Sandbox (sandbox/probe.py, sandbox/broker.py): the budget of a probe
# child, a broker spawn and each broker request, and the broker's recycle
# cap (0 = never).
DEFAULT_PROBE_TIMEOUT = 30.0
DEFAULT_BROKER_MAX_REQUESTS = 0
# --config-file itself (env TFD_CONFIG_FILE / CONFIG_FILE) is resolved by
# the caller before new_config, as in the twin.
CONFIG_FILE_ENV_VARS = ("TFD_CONFIG_FILE", "CONFIG_FILE")
# Kernel-build cache (ops/kernel_cache.py): 'auto' follows --state-dir.
DEFAULT_COMPILATION_CACHE_DIR = "auto"
KERNEL_CACHE_SUBDIR = "kernel-cache"
# Straggler detection (lm/health.py): a healthy device whose throughput
# falls below this fraction of the healthy-device median on two
# consecutive probes is published as gpu.straggler-chip.
DEFAULT_STRAGGLER_THRESHOLD = 0.2


def env_flag(name: str) -> bool:
    """Value-aware env toggle with the flags' boolean grammar; unset or
    empty is off, an unparseable value is a ConfigError."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return False
    try:
        return _parse_bool(raw)
    except ConfigError as e:
        raise ConfigError(f"{name}={raw!r} is not a boolean: {e}") from e


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
}


def parse_duration(value: Any) -> float:
    """Parse a Go-style duration ("60s", "1m30s", "100ms") or a bare number
    of seconds into float seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        raise ConfigError("empty duration")
    try:
        return float(s)
    except ValueError:
        pass
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ConfigError(f"invalid duration: {value!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s) or pos == 0:
        raise ConfigError(f"invalid duration: {value!r}")
    return total


@dataclass(frozen=True)
class FlagDef:
    """One CLI flag: name, env aliases, type, default, and where it lands
    in the Config."""

    name: str
    env_vars: Sequence[str]
    parse: Callable[[Any], Any]
    default: Any
    help: str
    attr: str  # field of TfdFlags, or of Flags when ``on_flags``
    aliases: Sequence[str] = ()
    on_flags: bool = False  # the twin keeps it on Flags, not Flags.tfd


FLAG_DEFS: List[FlagDef] = [
    FlagDef("tpu-topology-strategy",
            ("TFD_TPU_TOPOLOGY_STRATEGY", "TPU_TOPOLOGY_STRATEGY"), str,
            TOPOLOGY_STRATEGY_NONE,
            "how MIG partitions are published: 'none' (full GPUs only), "
            "'single' (nvidia.com/gpu.* carries the node's one MIG profile) "
            "or 'mixed' (one nvidia.com/mig-<profile> resource per profile)",
            "tpu_topology_strategy", on_flags=True),
    FlagDef("native-enumeration", ("TFD_NATIVE_ENUMERATION",), _parse_bool,
            False,
            "let the autodetect chain fall back to the NVML-only manager "
            "(no torch, no CUDA context) when torch or CUDA cannot init",
            "native_enumeration", on_flags=True),
    FlagDef("machine-type-file", ("TFD_MACHINE_TYPE_FILE",), str,
            DEFAULT_MACHINE_TYPE_FILE,
            "path to a file containing the DMI (SMBIOS) machine type of the "
            "node", "machine_type_file"),
    FlagDef("oneshot", ("TFD_ONESHOT",), _parse_bool, False,
            "label once and exit", "oneshot"),
    FlagDef("no-timestamp", ("TFD_NO_TIMESTAMP",), _parse_bool, False,
            "do not add the timestamp to the labels", "no_timestamp"),
    FlagDef("sleep-interval", ("TFD_SLEEP_INTERVAL",), parse_duration,
            DEFAULT_SLEEP_INTERVAL,
            "time to sleep between labeling (Go duration, e.g. 60s)",
            "sleep_interval"),
    FlagDef("output-file", ("TFD_OUTPUT_FILE",), str, DEFAULT_OUTPUT_FILE,
            "path to the NFD feature file to write", "output_file",
            aliases=("output", "o")),
    FlagDef("with-burnin", ("TFD_WITH_BURNIN",), _parse_bool, False,
            "run a short on-device burn-in and emit gpu.health.* labels",
            "with_burnin"),
    FlagDef("burnin-interval", ("TFD_BURNIN_INTERVAL",), _parse_positive_int,
            10, "with --with-burnin, probe every Nth labeling cycle and "
            "reuse cached health labels in between (1 = every cycle)",
            "burnin_interval"),
    FlagDef("chip-probes", ("TFD_CHIP_PROBES",), _parse_bool, True,
            "with --with-burnin, probe every device individually and "
            "publish per-device fault-localization labels "
            "(nvidia.com/gpu.chip.<i>.ok, chips.healthy/sick, "
            "straggler-chip)", "chip_probes"),
    FlagDef("straggler-threshold", ("TFD_STRAGGLER_THRESHOLD",),
            _parse_fraction, DEFAULT_STRAGGLER_THRESHOLD,
            "fraction in (0, 1): a healthy device below this fraction of "
            "the healthy-device median on 2 consecutive probes is "
            "published as nvidia.com/gpu.straggler-chip",
            "straggler_threshold"),
    FlagDef("backends", ("TFD_BACKENDS",), str, "auto",
            "comma-separated backend tokens, one per label family "
            "(resource/registry.py). The gpu family (nvidia.com/gpu.*): "
            "'auto' (default: CUDA devices when NVML loads or NVIDIA display "
            "functions are on the PCI bus, else none), 'gpu' (CUDA devices), "
            "'native' (NVML only, no CUDA context), 'null' (no devices), "
            "'mock-gpu[:<n>]' (n static devices) or 'mock-nvml:<layout>' (a "
            "recorded H100 inventory); the cpu family (node.features/cpu.*): "
            "'cpu' or 'mock-cpu[:<n>]'. One gpu-family token alone is the "
            "single-backend path; a list with the cpu family runs each family "
            "with its own init retries, broker worker and degraded marker. "
            "TFD_BACKEND (singular) forces one gpu-family backend instead",
            "backends"),
    FlagDef("probe-timeout", ("TFD_PROBE_TIMEOUT",), parse_duration,
            DEFAULT_PROBE_TIMEOUT,
            "hard wall-clock budget (Go duration, e.g. 30s) of a probe "
            "child, a broker worker's spawn (interpreter, torch import, "
            "CUDA set-up, first enumeration) and each broker request; past "
            "it the process is SIGKILLed and the failure is retried as a "
            "degraded backend init, so a wedged CUDA call kills only the "
            "child, never the daemon", "probe_timeout"),
    FlagDef("probe-isolation", ("TFD_PROBE_ISOLATION",), str,
            PROBE_ISOLATION_AUTO,
            "where backend enumeration runs: 'subprocess' in a killable "
            "child process (--probe-timeout bounds it), 'none' in process; "
            "'auto' (default) is subprocess for the supervised daemon and "
            "none for oneshot, and none under --with-burnin when the "
            "broker is off", "probe_isolation"),
    FlagDef("probe-broker", ("TFD_PROBE_BROKER",), str, PROBE_BROKER_AUTO,
            "persistent probe broker: 'on' routes backend acquisition and "
            "the burn-in through ONE long-lived worker process that holds "
            "the CUDA devices and serves snapshot/health requests over a "
            "pipe; 'off' forks a probe child per acquisition; 'auto' "
            "(default) is on for the supervised daemon and off for oneshot",
            "probe_broker"),
    FlagDef("broker-max-requests", ("TFD_BROKER_MAX_REQUESTS",),
            _parse_nonneg_int, DEFAULT_BROKER_MAX_REQUESTS,
            "with the probe broker on, gracefully recycle the worker after "
            "this many served requests (a hedge against slow native "
            "leaks); 0 (default) keeps it for the config epoch",
            "broker_max_requests"),
    FlagDef("fail-on-init-error", ("TFD_FAIL_ON_INIT_ERROR", "FAIL_ON_INIT_ERROR"),
            _parse_bool, True,
            "daemon mode: exit once --init-retries backend-init attempts "
            "failed in a row; false stays degraded and keeps retrying. "
            "Oneshot: exit 1 when the backend will not init; false writes "
            "no device labels and exits 0",
            "fail_on_init_error"),
    FlagDef("init-retries", ("TFD_INIT_RETRIES",), _parse_positive_int,
            DEFAULT_INIT_RETRIES,
            "daemon mode: consecutive backend-init attempts (one per "
            "labeling cycle, spaced by exponential backoff) tolerated before "
            "the supervisor escalates; while the backend is down, degraded "
            "labels are published with nvidia.com/gpu.tfd.degraded=true",
            "init_retries"),
    FlagDef("init-backoff-max", ("TFD_INIT_BACKOFF_MAX",), parse_duration,
            DEFAULT_INIT_BACKOFF_MAX,
            "cap (Go duration) on the exponential backoff between "
            "backend-init re-attempts and between failed-cycle retries "
            "(jittered; base 1s, doubling)", "init_backoff_max"),
    FlagDef("max-consecutive-failures", ("TFD_MAX_CONSECUTIVE_FAILURES",),
            _parse_positive_int, DEFAULT_MAX_CONSECUTIVE_FAILURES,
            "daemon mode: labeling cycles may fail this many times in a row "
            "(each contained: last-good labels re-served with the "
            "nvidia.com/gpu.tfd.unhealthy-cycles counter) before the "
            "supervisor escalates to a nonzero exit",
            "max_consecutive_failures"),
    FlagDef("parallel-labelers", ("TFD_PARALLEL_LABELERS",), _parse_bool, True,
            "run the blocking labelers on a pool with per-labeler deadlines; "
            "false runs every labeler inline, in order", "parallel_labelers"),
    FlagDef("labeler-timeout", ("TFD_LABELER_TIMEOUT",), parse_duration,
            DEFAULT_LABELER_TIMEOUT,
            "with --parallel-labelers, per-cycle deadline for each labeler "
            "(Go duration); a labeler exceeding it is served from its "
            "last-good cache and named in nvidia.com/gpu.tfd.stale-sources",
            "labeler_timeout"),
    FlagDef("timings-file", ("TFD_TIMINGS_FILE",), str, "",
            "path to write a JSON per-labeler timing summary after every "
            "labeling cycle (empty = disabled)", "timings_file"),
    FlagDef("compilation-cache-dir", ("TFD_COMPILATION_CACHE_DIR",), str,
            DEFAULT_COMPILATION_CACHE_DIR,
            "directory of the built CUDA kernel libraries, keyed by target "
            "and a digest of source and nvcc flags: a library found there "
            "loads without nvcc (an image without the CUDA toolkit copies "
            "its prebuilt libraries there), a missing one is built there at "
            "first use; 'auto' (default) resolves to "
            f"<state-dir>/{KERNEL_CACHE_SUBDIR} when --state-dir is set; "
            "unresolved or empty, libraries go to build/torch_kernels/ at "
            "the repo root", "compilation_cache_dir"),
    FlagDef("state-dir", ("TFD_STATE_DIR",), str, "",
            "directory where the last successful cycle's labels are "
            "persisted; a restart re-serves them with "
            "nvidia.com/gpu.tfd.restored=true until the first live cycle "
            "(empty = disabled)", "state_dir"),
    FlagDef("flap-window", ("TFD_FLAP_WINDOW",), _parse_positive_int,
            DEFAULT_FLAP_WINDOW,
            "daemon mode: a change to the published labels must hold for "
            "this many consecutive cycles before the file changes; while "
            "suppressed the previous labels are re-served with "
            "nvidia.com/gpu.tfd.flapping=true (1 = publish every cycle)",
            "flap_window"),
    FlagDef("heartbeat-file", ("TFD_HEARTBEAT_FILE",), str, "",
            "path whose mtime the daemon touches after every completed "
            "labeling cycle, for an exec livenessProbe (empty = disabled)",
            "heartbeat_file"),
    FlagDef("reconcile", ("TFD_RECONCILE",), str, RECONCILE_AUTO,
            "daemon loop shape: 'event' waits on an event queue (signals, "
            "health deltas) with --max-staleness as the bound; 'interval' "
            "sleeps --sleep-interval between cycles; 'auto' (default) is "
            "event for the daemon and interval for oneshot", "reconcile"),
    FlagDef("max-staleness", ("TFD_MAX_STALENESS",), parse_duration,
            DEFAULT_MAX_STALENESS,
            "with --reconcile=event, the longest the daemon may go without "
            "a labeling cycle (Go duration); 0 (default) tracks "
            "--sleep-interval", "max_staleness"),
    FlagDef("reconcile-debounce", ("TFD_RECONCILE_DEBOUNCE",), parse_duration,
            DEFAULT_RECONCILE_DEBOUNCE,
            "with --reconcile=event, how long a wake waits for the rest of "
            "an event burst before running the cycle (Go duration)",
            "reconcile_debounce"),
    FlagDef("max-probe-rate", ("TFD_MAX_PROBE_RATE",), _parse_positive_float,
            DEFAULT_MAX_PROBE_RATE,
            "with --reconcile=event, token-bucket cap on event-driven "
            "labeling cycles per second", "max_probe_rate"),
    FlagDef("metrics-addr", ("TFD_METRICS_ADDR",), str, DEFAULT_METRICS_ADDR,
            "bind address for the HTTP introspection server (/metrics, "
            "/healthz, /readyz, /debug/labels)", "metrics_addr"),
    FlagDef("metrics-port", ("TFD_METRICS_PORT",), _parse_nonneg_int,
            DEFAULT_METRICS_PORT,
            "port for the HTTP introspection server; 0 disables it (no "
            "socket). Served in daemon mode only: oneshot never opens a "
            "socket", "metrics_port"),
    FlagDef("debug-endpoints", ("TFD_DEBUG_ENDPOINTS",), _parse_bool, True,
            "serve /debug/labels (the last written labels with per-source "
            "provenance, as JSON) on the introspection server",
            "debug_endpoints"),
    FlagDef("probe-token", ("TFD_PROBE_TOKEN",), str, "",
            "with --reconcile=event, shared secret authenticating POST "
            "/probe on the introspection server (an on-demand labeling "
            "cycle); empty (default) answers 403: the endpoint never works "
            "unauthenticated", "probe_token"),
]


def new_config(
    cli_values: Optional[Dict[str, Any]] = None,
    environ: Optional[Dict[str, str]] = None,
    config_file: Optional[str] = None,
) -> Config:
    """Build the Config with (1) CLI > (2) env > (3) config file > (4)
    default precedence (config.go:40-57 + flags.go:29-40). ``cli_values``
    holds only flags the user explicitly passed; values arrive pre-parsed
    or as raw strings."""
    cli_values = cli_values or {}
    environ = environ if environ is not None else {}
    config = parse_config_file(config_file) if config_file else Config()
    tfd = config.flags.tfd
    for fd in FLAG_DEFS:
        target = config.flags if fd.on_flags else tfd
        if fd.name in cli_values:
            setattr(target, fd.attr, fd.parse(cli_values[fd.name]))
            continue
        env_val = next(
            (environ[e] for e in fd.env_vars if environ.get(e) not in (None, "")),
            None,
        )
        if env_val is not None:
            setattr(target, fd.attr, fd.parse(env_val))
        elif getattr(target, fd.attr) is None:
            setattr(target, fd.attr, fd.default)
    strategy = config.flags.tpu_topology_strategy
    if strategy not in TOPOLOGY_STRATEGIES:
        raise ConfigError(
            f"invalid tpu-topology-strategy: {strategy!r} "
            f"(want one of {TOPOLOGY_STRATEGIES})"
        )
    for attr, modes in (
        ("probe_isolation", PROBE_ISOLATION_MODES),
        ("probe_broker", PROBE_BROKER_MODES),
        ("reconcile", RECONCILE_MODES),
    ):
        if getattr(tfd, attr) not in modes:
            raise ConfigError(
                f"invalid {attr.replace('_', '-')}: {getattr(tfd, attr)!r} "
                f"(want one of {modes})"
            )
    # Deferred: the registry (resource/) sits above the config layer.
    from gpu_feature_discovery_tpu_torch.resource.registry import parse_backends_value

    parse_backends_value(tfd.backends or "auto")
    return config


def disable_resource_renaming(config: Config, log: Callable[[str], None]) -> None:
    """Feature-gate resource renaming, as disableResourceRenamingInConfig
    (main.go:236-270) does: warn and zero the unsupported fields."""
    if config.resources:
        log("Customizing the 'resources' field is not yet supported in the config. Ignoring...")
        config.resources = {}
    rename_by_default = config.sharing.time_slicing.rename_by_default
    sets_non_default_rename = False
    for r in config.sharing.time_slicing.resources:
        if not rename_by_default and r.rename:
            sets_non_default_rename = True
            r.rename = ""
        if rename_by_default and r.rename != r.name + ".shared":
            sets_non_default_rename = True
            r.rename = r.name + ".shared"
    if sets_non_default_rename:
        log(
            "Setting the 'rename' field in sharing.timeSlicing.resources is not yet "
            "supported in the config. Ignoring..."
        )


def resolve_compilation_cache_dir(config: Config) -> str:
    """The kernel cache directory for this config: '' = unresolved (the
    default build directory, ops/kernel_cache.py), else a path. 'auto'
    (the default) follows ``--state-dir``, as the twin's
    ``<state-dir>/xla-cache`` does: the cache wants the durability the
    label state already has."""
    raw = (config.flags.tfd.compilation_cache_dir or "").strip()
    if raw != DEFAULT_COMPILATION_CACHE_DIR:
        return raw
    state_dir = (config.flags.tfd.state_dir or "").strip()
    if not state_dir:
        return ""
    return os.path.join(state_dir, KERNEL_CACHE_SUBDIR)
