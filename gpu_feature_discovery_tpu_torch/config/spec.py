"""Configuration spec (twin: ``gpu_feature_discovery_tpu/config/spec.py``).

The versioned config document ``{version, flags, resources, sharing}``,
trimmed to the flags this port has. Every flag starts as ``None`` ("not
set anywhere yet"); the flag layer (config/flags.py) fills CLI >
environment > config file > default. ``parse_config_file`` reads the
twin's YAML (or JSON) config file through the port's own parser of the
YAML subset it uses (config/yaml_subset.py): the ``flags`` and
``flags.tfd`` keys of every flag here, and the ``sharing.timeSlicing``
section, the only place a time-slicing contract (replicas per GPU, the
``-SHARED`` product) can come from.

A flag's key is its name in camelCase (``file_key``); a key the twin
reads for a flag this port does not have is refused with the reason,
never dropped (``UNPORTED_FILE_KEYS``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

VERSION = "v1"

# MIG exposure strategies, spelled as the twin's topology strategies
# (reference: internal/lm/mig-strategy.go:29-33): ``none`` publishes
# full-GPU labels only, ``single`` overloads nvidia.com/gpu.* with the
# node's one MIG profile, ``mixed`` publishes one nvidia.com/mig-<profile>
# resource per profile.
TOPOLOGY_STRATEGY_NONE = "none"
TOPOLOGY_STRATEGY_SINGLE = "single"
TOPOLOGY_STRATEGY_MIXED = "mixed"
TOPOLOGY_STRATEGIES = (
    TOPOLOGY_STRATEGY_NONE,
    TOPOLOGY_STRATEGY_SINGLE,
    TOPOLOGY_STRATEGY_MIXED,
)

# Probe-isolation and probe-broker modes, spelled and resolved as the
# twin resolves them (sandbox/probe.py isolation_mode, sandbox/broker.py
# broker_mode): the supervised daemon runs its device probing in the
# persistent broker worker; oneshot, and --with-burnin with the broker
# off, probe in process.
PROBE_ISOLATION_NONE = "none"
PROBE_ISOLATION_SUBPROCESS = "subprocess"
PROBE_ISOLATION_AUTO = "auto"
PROBE_ISOLATION_MODES = (
    PROBE_ISOLATION_NONE,
    PROBE_ISOLATION_SUBPROCESS,
    PROBE_ISOLATION_AUTO,
)
PROBE_BROKER_ON = "on"
PROBE_BROKER_OFF = "off"
PROBE_BROKER_AUTO = "auto"
PROBE_BROKER_MODES = (PROBE_BROKER_ON, PROBE_BROKER_OFF, PROBE_BROKER_AUTO)

# Reconcile-loop modes (cmd/events.py): `event` blocks the daemon loop on
# a typed event queue with the staleness bound as its timeout; `interval`
# is the fixed generate -> write -> sleep loop; `auto` is event for the
# supervised daemon and interval for oneshot.
RECONCILE_INTERVAL = "interval"
RECONCILE_EVENT = "event"
RECONCILE_AUTO = "auto"
RECONCILE_MODES = (RECONCILE_INTERVAL, RECONCILE_EVENT, RECONCILE_AUTO)

# Cross-host slice coordination modes (peering/): `on` serves the peer
# snapshot endpoint and publishes slice-scoped labels; `off` reproduces
# the strictly node-local label output byte for byte; `auto` (the
# default) is on exactly when WORKER_HOSTNAMES names >= 2 workers and the
# daemon serves the introspection endpoint.
SLICE_COORDINATION_ON = "on"
SLICE_COORDINATION_OFF = "off"
SLICE_COORDINATION_AUTO = "auto"
SLICE_COORDINATION_MODES = (
    SLICE_COORDINATION_ON,
    SLICE_COORDINATION_OFF,
    SLICE_COORDINATION_AUTO,
)

# Push-on-delta notification modes (peering/notify.py): `on` makes a
# child whose served snapshot moves POST an authenticated /peer/notify
# hint upward, so the parent's next round polls only dirty children (the
# full sweep on the --max-staleness cadence stays the only correctness
# mechanism); `off` is the pull-everything round byte for byte; `auto`
# (the default) is on exactly when --peer-token is configured.
PUSH_NOTIFY_ON = "on"
PUSH_NOTIFY_OFF = "off"
PUSH_NOTIFY_AUTO = "auto"
PUSH_NOTIFY_MODES = (PUSH_NOTIFY_ON, PUSH_NOTIFY_OFF, PUSH_NOTIFY_AUTO)

# Fleet collector upstream modes (fleet/, cmd/fleet.py --upstream-mode):
# `slices` scrapes each targets-file entry as a slice's worker list over
# /peer/snapshot (the default); `collectors` treats each entry as a REGION
# whose hosts are that region's fleet collectors, scraped over
# /fleet/snapshot and merged under region/<name>/<slice> keys (the
# federation tier, which nests: a root is a valid upstream for a higher
# root).
UPSTREAM_SLICES = "slices"
UPSTREAM_COLLECTORS = "collectors"
UPSTREAM_MODES = (UPSTREAM_SLICES, UPSTREAM_COLLECTORS)

# Verdict actuation modes (actuation/engine.py): `off` (the default) builds
# none of the actuation machinery, so the label output stays byte for byte
# the daemon's without it; `advise` is the dry run, writing only
# tfd.would-cordon=<reason> and the lease; `enforce` writes the advice
# family (nvidia.com/gpu.schedulable=false, tfd.cordon-advice,
# tfd.drain-advice). Roll out in that order: off -> advise -> enforce.
ACTUATION_OFF = "off"
ACTUATION_ADVISE = "advise"
ACTUATION_ENFORCE = "enforce"
ACTUATION_MODES = (ACTUATION_OFF, ACTUATION_ADVISE, ACTUATION_ENFORCE)


@dataclass
class ReplicatedResource:
    """One time-sliced resource (replicas.go:37-43); only name, rename and
    replicas are honoured, as in the twin."""

    name: str = ""
    rename: str = ""
    replicas: int = 0


@dataclass
class TimeSlicing:
    """Sharing settings (replicas.go:29-34)."""

    rename_by_default: bool = False
    fail_requests_greater_than_one: bool = False
    resources: List[ReplicatedResource] = field(default_factory=list)


@dataclass
class Sharing:
    time_slicing: TimeSlicing = field(default_factory=TimeSlicing)

    def replication_info(self, resource_name: str) -> Optional[ReplicatedResource]:
        """The replication entry for a resource name (lm/resource.go:213-226
        replicationInfo)."""
        for r in self.time_slicing.resources:
            if r.name == resource_name:
                return r
        return None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Sharing":
        """Inverse of ``asdict`` on a Sharing."""
        ts = dict(d.get("time_slicing") or {})
        ts["resources"] = [ReplicatedResource(**r) for r in ts.get("resources") or []]
        return Sharing(time_slicing=TimeSlicing(**ts))


@dataclass
class TfdFlags:
    """Daemon flags: the label cycle, the burn-in, and supervision."""

    oneshot: Optional[bool] = None
    no_timestamp: Optional[bool] = None
    sleep_interval: Optional[float] = None  # seconds
    output_file: Optional[str] = None
    machine_type_file: Optional[str] = None
    with_burnin: Optional[bool] = None
    burnin_interval: Optional[int] = None  # probe every Nth cycle
    chip_probes: Optional[bool] = None
    straggler_threshold: Optional[float] = None  # fraction of median, (0,1)
    # Backend tokens, one per label family (resource/registry.py).
    backends: Optional[str] = None  # e.g. "gpu,cpu" | "auto"
    probe_isolation: Optional[str] = None  # none | subprocess | auto
    probe_broker: Optional[str] = None  # on | off | auto
    # Hard wall-clock budget of a probe child, a broker spawn and each
    # broker request (sandbox/).
    probe_timeout: Optional[float] = None  # seconds
    # Recycle the broker worker after this many served requests (0 = never).
    broker_max_requests: Optional[int] = None
    # Supervision (cmd/supervisor.py). The twin keeps fail_on_init_error
    # on Flags, beside its device-plugin flags; this port has only tfd.
    fail_on_init_error: Optional[bool] = None
    init_retries: Optional[int] = None
    init_backoff_max: Optional[float] = None  # seconds
    max_consecutive_failures: Optional[int] = None
    state_dir: Optional[str] = None
    # Kernel-build cache (ops/kernel_cache.py): 'auto' | '' | a path.
    compilation_cache_dir: Optional[str] = None
    flap_window: Optional[int] = None
    heartbeat_file: Optional[str] = None
    # Label engine (lm/engine.py) and per-cycle timings.
    parallel_labelers: Optional[bool] = None
    labeler_timeout: Optional[float] = None  # seconds
    timings_file: Optional[str] = None
    # Reconcile loop (cmd/events.py).
    reconcile: Optional[str] = None
    max_staleness: Optional[float] = None  # seconds; 0 = --sleep-interval
    reconcile_debounce: Optional[float] = None  # seconds
    max_probe_rate: Optional[float] = None  # event-driven cycles per second
    # Introspection server (obs/server.py, cmd/main.py).
    metrics_addr: Optional[str] = None
    metrics_port: Optional[int] = None  # 0 = disabled
    debug_endpoints: Optional[bool] = None
    probe_token: Optional[str] = None  # "" = POST /probe disabled
    # Cross-host slice coordination (peering/): every daemon serves its
    # label snapshot at /peer/snapshot; the lowest reachable worker id
    # aggregates and publishes the nvidia.com/gpu.slice.* family.
    slice_coordination: Optional[str] = None  # auto | on | off
    peer_timeout: Optional[float] = None  # seconds, per-peer connect/read
    peer_fanout: Optional[int] = None  # 0 = auto (min(8, peers))
    cohort_size: Optional[str] = None  # "0" | "auto" | positive int
    peer_token: Optional[str] = None  # "" = /peer/snapshot open
    push_notify: Optional[str] = None  # auto | on | off
    # Verdict actuation (actuation/engine.py): confirmed health verdicts
    # projected into advice labels under a confirmation window, a
    # slice-wide budget and a lease.
    actuation: Optional[str] = None  # off | advise | enforce
    actuation_window: Optional[int] = None  # consecutive confirming cycles
    max_actuated_fraction: Optional[float] = None  # (0, 1) exclusive


@dataclass
class Flags:
    """Flags the twin keeps beside its daemon flags (its device-plugin
    shared flags): the MIG strategy and the opt-in NVML-only backend."""

    tfd: TfdFlags = field(default_factory=TfdFlags)
    tpu_topology_strategy: Optional[str] = None  # none | single | mixed
    native_enumeration: Optional[bool] = None  # opt-in: NVML-only manager


@dataclass
class Config:
    flags: Flags = field(default_factory=Flags)
    sharing: Sharing = field(default_factory=Sharing)
    version: str = VERSION
    # Feature-gated off, as in the twin: load_config warns and empties it
    # (config/flags.py disable_resource_renaming).
    resources: Dict[str, Any] = field(default_factory=dict)


class ConfigError(Exception):
    pass


def config_to_dict(config: Config) -> dict:
    """The Config as plain JSON-safe values: what a probe child or the
    broker worker receives as its first frame (sandbox/)."""
    return asdict(config)


def config_from_dict(d: dict) -> Config:
    """Inverse of config_to_dict."""
    flags = dict(d["flags"])
    flags["tfd"] = TfdFlags(**flags["tfd"])
    return Config(
        flags=Flags(**flags),
        sharing=Sharing.from_dict(d.get("sharing") or {}),
        version=d.get("version") or VERSION,
        resources=d.get("resources") or {},
    )


def parse_bool(value: Any) -> bool:
    """Strict boolean parsing shared by CLI and env inputs."""
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s in ("1", "t", "true", "yes", "y", "on"):
        return True
    if s in ("0", "f", "false", "no", "n", "off"):
        return False
    raise ConfigError(f"invalid boolean: {value!r}")


def parse_positive_int(value: Any) -> int:
    try:
        n = int(str(value).strip())
    except ValueError as e:
        raise ConfigError(f"invalid integer: {value!r}") from e
    if n < 1:
        raise ConfigError(f"value must be >= 1: {value!r}")
    return n


def parse_nonneg_int(value: Any) -> int:
    """Strict non-negative integer: 0 is meaningful (--broker-max-requests
    0 = never recycle)."""
    try:
        n = int(str(value).strip())
    except ValueError as e:
        raise ConfigError(f"invalid integer: {value!r}") from e
    if n < 0:
        raise ConfigError(f"value must be >= 0: {value!r}")
    return n


# How many generations back a /fleet/snapshot?since= delta can reach: one
# full-body ETag per generation in the lineage history (a few hundred
# bytes each), so 1024 bound it to about 100 KiB.
DEFAULT_FLEET_DELTA_WINDOW = 1024


def parse_delta_window(value: Any) -> int:
    """Strict ``--delta-window``: an integer >= 0, the generations of ETag
    lineage kept for ``?since=`` deltas; 0 disables delta serving (every
    ``?since`` answers the full body)."""
    return parse_nonneg_int(value)


# The fleet query surface (fleet/query.py): rendered filtered views kept
# (LRU), the ceiling on one ?watch= park, the parked watchers admitted at
# once (each holds a handler thread), and the introspection server's
# inflight-request cap (0 = unbounded).
DEFAULT_FILTER_CACHE_SIZE = 64
DEFAULT_WATCH_TIMEOUT_S = 30.0
DEFAULT_MAX_WATCHERS = 64
DEFAULT_MAX_INFLIGHT = 0


def parse_upstream_mode(value: Any) -> str:
    """Strict ``--upstream-mode``: ``slices`` | ``collectors``; a typo
    fails the collector's start, never scrapes the wrong surface."""
    s = str(value).strip().lower()
    if s not in UPSTREAM_MODES:
        raise ConfigError(
            f"invalid upstream-mode {value!r} "
            f"(want one of {', '.join(UPSTREAM_MODES)})"
        )
    return s


def parse_fraction(value: Any) -> float:
    """Strict open-interval fraction: (0, 1) exclusive."""
    try:
        f = float(str(value).strip())
    except ValueError as e:
        raise ConfigError(f"invalid fraction: {value!r}") from e
    if not 0.0 < f < 1.0:
        raise ConfigError(f"value must be in (0, 1) exclusive: {value!r}")
    return f


def parse_positive_float(value: Any) -> float:
    """Strict positive float (the token-bucket refill rate: 0 would never
    grant a token, so it is a config error)."""
    try:
        f = float(str(value).strip())
    except ValueError as e:
        raise ConfigError(f"invalid number: {value!r}") from e
    if f <= 0.0:
        raise ConfigError(f"value must be > 0: {value!r}")
    return f


def parse_cohort_size(value: Any) -> str:
    """Strict ``--cohort-size`` grammar: ``auto`` | an integer >= 0 (0 =
    flat single-tier coordination). Returns the canonical string form:
    resolving ``auto`` needs the slice's host count, which only the
    peering layer has (peering/cohort.resolve_cohort_size)."""
    s = str(value).strip().lower()
    if s == "auto":
        return "auto"
    try:
        n = int(s)
    except ValueError as e:
        raise ConfigError(
            f"invalid cohort-size {value!r} (want 'auto' or an integer >= 0)"
        ) from e
    if n < 0:
        raise ConfigError(f"cohort-size must be >= 0: {value!r}")
    return str(n)


# -- the config file (twin config/spec.py parse_config_file) -----------------

def file_key(flag_name: str) -> Tuple[str, str]:
    """(section, key) of a flag in the config file: its name in camelCase
    (``with-burnin`` → ``withBurnin``) under ``flags.tfd``, or under
    ``flags`` for the twin's common flags. The twin keeps
    failOnInitError on Flags; this port keeps it on Flags.tfd."""
    first, *rest = flag_name.split("-")
    key = first + "".join(part.capitalize() for part in rest)
    common = ("tpu-topology-strategy", "native-enumeration", "fail-on-init-error")
    return ("flags" if flag_name in common else "tfd"), key


# Keys the twin reads for flags this port does not have, and why
# (ROADMAP.md queue 1).
_TPU_ONLY = ("no slice: it configures libtpu's PJRT client, which a CUDA node "
             "does not have")
UNPORTED_FILE_KEYS: Dict[Tuple[str, str], str] = {
    ("flags", "libtpuPath"): _TPU_ONLY,
    ("flags", "pjrtCreateOptions"): _TPU_ONLY,
}


def _mapping(value: Any, where: str) -> Dict[Any, Any]:
    """A section of the file: a mapping, or empty for null (the twin's
    ``x or {}``)."""
    if not value:
        return {}
    if not isinstance(value, dict):
        raise ConfigError(f"{where} must be a mapping, got {type(value).__name__}")
    return value


def sharing_from_file(d: Any) -> Sharing:
    """The file's ``sharing`` section (camelCase keys), read as the
    twin's ``Sharing.from_dict`` reads it."""
    ts = _mapping(_mapping(d, "sharing").get("timeSlicing"), "sharing.timeSlicing")
    resources = []
    for r in ts.get("resources", []) or []:
        r = _mapping(r, "sharing.timeSlicing.resources[]")
        try:
            replicas = int(r.get("replicas", 0))
        except (TypeError, ValueError) as e:
            raise ConfigError(f"invalid replicas: {r.get('replicas')!r}") from e
        resources.append(ReplicatedResource(
            name=str(r.get("name", "")), rename=str(r.get("rename", "")),
            replicas=replicas,
        ))
    return Sharing(time_slicing=TimeSlicing(
        rename_by_default=parse_bool(ts.get("renameByDefault", False)),
        fail_requests_greater_than_one=parse_bool(
            ts.get("failRequestsGreaterThanOne", False)),
        resources=resources,
    ))


def parse_config_file(path: str) -> Config:
    """The YAML/JSON config file with its version check (config.go:60-99),
    with the twin's error texts."""
    from gpu_feature_discovery_tpu_torch.config.yaml_subset import safe_load

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise ConfigError(f"error opening config file: {e}") from e
    except UnicodeDecodeError as e:
        raise ConfigError(f"unmarshal error: {e}") from e
    try:
        raw = safe_load(text) or {}
    except ConfigError as e:
        raise ConfigError(f"unmarshal error: {e}") from e
    if not isinstance(raw, dict):
        raise ConfigError(f"config file must contain a mapping, got {type(raw).__name__}")
    version = raw.get("version") or VERSION
    if version != VERSION:
        raise ConfigError(f"unknown version: {version}")

    # Deferred: config/flags.py imports this module.
    from gpu_feature_discovery_tpu_torch.config.flags import FLAG_DEFS

    config = Config(version=version)
    sections = {"flags": _mapping(raw.get("flags", {}), "flags")}
    sections["tfd"] = _mapping(sections["flags"].get("tfd", {}), "flags.tfd")
    for (section, key), slice_name in UNPORTED_FILE_KEYS.items():
        if sections[section].get(key) is not None:
            raise ConfigError(
                f"config file key {'flags.' if section == 'flags' else 'flags.tfd.'}"
                f"{key} is not ported yet; it comes with {slice_name}"
            )
    # A null value is unset; any other goes through the flag's own parser,
    # as the twin's reading of the same key does.
    for fd in FLAG_DEFS:
        section, key = file_key(fd.name)
        value = sections[section].get(key)
        if value is not None:
            setattr(config.flags if fd.on_flags else config.flags.tfd, fd.attr, fd.parse(value))
    config.resources = raw.get("resources", {}) or {}
    config.sharing = sharing_from_file(raw.get("sharing", {}) or {})
    return config
