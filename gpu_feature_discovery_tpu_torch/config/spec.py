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
reads for a flag this port does not have yet is refused with the slice
that will bring it, never dropped (``UNPORTED_FILE_KEYS``).
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


# Keys the twin reads for flags this port does not have, and where each
# comes from (ROADMAP.md queue 1).
_PEERING = "the slice and peer coordination slice (ROADMAP.md queue 1, item 6)"
_ACTUATION = "the actuation slice (ROADMAP.md queue 1, item 7)"
_TPU_ONLY = ("no slice: it configures libtpu's PJRT client, which a CUDA node "
             "does not have")
UNPORTED_FILE_KEYS: Dict[Tuple[str, str], str] = {
    ("flags", "libtpuPath"): _TPU_ONLY,
    ("flags", "pjrtCreateOptions"): _TPU_ONLY,
    ("tfd", "sliceCoordination"): _PEERING,
    ("tfd", "peerTimeout"): _PEERING,
    ("tfd", "peerFanout"): _PEERING,
    ("tfd", "cohortSize"): _PEERING,
    ("tfd", "peerToken"): _PEERING,
    ("tfd", "pushNotify"): _PEERING,
    ("tfd", "actuation"): _ACTUATION,
    ("tfd", "actuationWindow"): _ACTUATION,
    ("tfd", "maxActuatedFraction"): _ACTUATION,
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
