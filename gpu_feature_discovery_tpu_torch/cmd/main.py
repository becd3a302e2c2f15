"""CLI entry point and daemon loop (twin:
``gpu_feature_discovery_tpu/cmd/main.py``).

``start(argv)`` parses the flags (each with its ``TFD_*`` alias), installs
the OS signal watcher and runs the config-reload loop: every SIGHUP
starts a new epoch with a fresh config (CLI > env > ``--config-file`` >
default), burn-in schedule, engine and supervisor. Under
``--reconcile=event`` (the daemon's default) each epoch also watches the
config file and reloads when it changes, as a ConfigMap remount changes
it; under ``--reconcile=interval`` the file is reloaded on SIGHUP only.
``run()`` is one epoch: generate → atomic write → wait, until a signal.
SIGTERM/SIGINT end the process with exit 0 and remove the output file;
``--oneshot`` runs one cycle and leaves the file for NFD.

The daemon is supervised (cmd/supervisor.py): degraded labels while the
backend will not init, last-good re-serve when a cycle fails, escalation
at the bounds. It waits on the event queue of cmd/events.py
(``--reconcile=event``, the default) or sleeps ``--sleep-interval``.
At its defaults it acquires the backend through the persistent broker
worker (sandbox/broker.py), which holds the CUDA devices and runs the
burn-in; this process never initialises CUDA then. Each epoch
pre-spawns the worker, watches it for an uncommanded death, and closes
it at the end. Each epoch also exports the resolved
``--compilation-cache-dir`` (ops/kernel_cache.py) to the worker it
spawns.

The host-interconnect labeler (a sysfs PCI scan and the host's slice
facts from ``WORKER_HOSTNAMES``/``WORKER_ID`` and their siblings,
lm/interconnect.py over hostinfo/) is built once per epoch here, as the
twin builds it; its ``TFD_MOCK_PCI`` fixture stands synthesized NVIDIA
functions in for the bus, and ``TFD_HERMETIC`` blanks the host facts.
Oneshot wraps its manager in the fallback-to-null decorator under
``--fail-on-init-error=false``; the daemon keeps raw init errors for its
supervisor.

Each daemon epoch binds the introspection server (obs/server.py:
``/metrics``, ``/healthz``, ``/readyz``, ``/debug/labels``, ``POST
/probe``) on ``--metrics-addr``:``--metrics-port``, retries a failed
bind once per cycle, and closes it at the epoch's end, so a SIGHUP
reload rebinds the same port; oneshot never opens a socket. The loop
records the cycle outcomes, the label writes it tells the server about,
``tfd_restart_to_labels_seconds`` (once per process) and
``tfd_wake_to_labels_seconds``.

With a ``--backends`` list that names the cpu family (``gpu,cpu``) the
cycle runs the multi-backend registry (resource/registry.py): each
family is acquired, through its own broker worker under the daemon, with
its own retries, and a family that will not init publishes only its own
``<family>.tfd.degraded`` marker while the other stays fresh.

Each daemon epoch whose labels include the gpu family also builds one
slice coordinator (peering/coordinator.py) when ``--slice-coordination``
resolves on (``auto``: ``WORKER_HOSTNAMES`` names 2+ workers and the
introspection server serves): it serves ``/peer/snapshot`` and ``POST
/peer/notify`` on the epoch's server, runs as the offloaded ``slice``
source beside the node's sources, is told of every label write, and
wakes the event loop on a membership change (``peer_delta``) or a
child's notification (``peer_notify``). It is closed at the epoch's end,
so a SIGHUP reload rebuilds it from the new config.

Each daemon epoch builds one actuation engine (actuation/engine.py) from
``--actuation`` and the epoch's coordinator, whose peer snapshots bound
the slice-wide budget; it projects the confirmed verdicts into advice
labels after the flap damper and before the write. At ``--actuation
off`` (the default) there is none, and the label path is unchanged.
"""

from __future__ import annotations

import argparse
import faulthandler
import logging
import os
import queue
import signal
import sys
import time
from typing import Callable, Optional, Union

from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.actuation import new_actuation_engine
from gpu_feature_discovery_tpu_torch.cmd import events as reconcile_events
from gpu_feature_discovery_tpu_torch.cmd.supervisor import (
    DEGRADED_LABEL,
    RESTORED_LABEL,
    InitRetriesExhausted,
    Supervisor,
    TooManyConsecutiveFailures,
)
from gpu_feature_discovery_tpu_torch.config.flags import (
    CONFIG_FILE_ENV_VARS,
    DEFAULT_FLAP_WINDOW,
    DEFAULT_MAX_PROBE_RATE,
    DEFAULT_RECONCILE_DEBOUNCE,
    FLAG_DEFS,
    disable_resource_renaming,
    env_flag,
    new_config,
    resolve_compilation_cache_dir,
)
from gpu_feature_discovery_tpu_torch.config.spec import Config, ConfigError
from gpu_feature_discovery_tpu_torch.info.version import get_version_string
from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL, new_label_engine
from gpu_feature_discovery_tpu_torch.lm.health import reset_burnin_schedule
from gpu_feature_discovery_tpu_torch.lm.interconnect import InterconnectLabeler
from gpu_feature_discovery_tpu_torch.lm.labeler import Labeler
from gpu_feature_discovery_tpu_torch.lm.labelers import (
    degraded_label_sources,
    multi_backend_label_sources,
    new_label_sources,
)
from gpu_feature_discovery_tpu_torch.lm.labels import remove_output_file
from gpu_feature_discovery_tpu_torch.lm.pjrt_family import FAMILY_DEGRADED_LABELS
from gpu_feature_discovery_tpu_torch.lm.slice_labeler import new_slice_label_source
from gpu_feature_discovery_tpu_torch.lm.timestamp import new_timestamp_labeler
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.ops import kernel_cache
from gpu_feature_discovery_tpu_torch.pci.pciutil import MockNvidiaPCI, SysfsNvidiaPCI
from gpu_feature_discovery_tpu_torch.resource import factory, registry
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.sandbox.flap import FlapDamper
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging
from gpu_feature_discovery_tpu_torch.utils import timing
from gpu_feature_discovery_tpu_torch.utils.timing import timed

log = logging.getLogger("tfd")

WATCHED_SIGNALS = (signal.SIGHUP, signal.SIGINT, signal.SIGTERM, signal.SIGQUIT)

# Cold-start accounting (tfd_restart_to_labels_seconds): this module's
# import is the closest observable to process start from inside it.
_PROCESS_START = time.monotonic()
_restart_to_labels_recorded = False


def _record_restart_to_labels() -> None:
    """Set tfd_restart_to_labels_seconds at the process's FIRST full live
    label write; a SIGHUP reload's next full cycle is not a restart."""
    global _restart_to_labels_recorded
    if _restart_to_labels_recorded:
        return
    _restart_to_labels_recorded = True
    obs_metrics.RESTART_TO_LABELS.set(time.monotonic() - _PROCESS_START)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gpu-feature-discovery-torch",
        description="generate NFD labels for NVIDIA GPUs (PyTorch/CUDA port)",
    )
    parser.add_argument("--version", action="version", version=get_version_string())
    for fd in FLAG_DEFS:
        names = [f"--{fd.name}"] + [
            (f"--{a}" if len(a) > 1 else f"-{a}") for a in fd.aliases
        ]
        # Every flag takes a value (booleans accept true/false) so unset
        # flags are distinguishable; a bare boolean flag means true.
        if fd.parse is str:
            parser.add_argument(*names, dest=fd.name, default=None, help=fd.help)
        else:
            parser.add_argument(
                *names, dest=fd.name, default=None, nargs="?", const="true",
                help=fd.help,
            )
    parser.add_argument(
        "--config-file", dest="config-file", default=None,
        help="path to a YAML or JSON config file (version v1): flags under "
        "flags / flags.tfd (camelCase, e.g. withBurnin, sleepInterval, "
        "backends) and the sharing.timeSlicing section (replicas per GPU); "
        "CLI flags and TFD_* environment variables win over it. Also "
        "TFD_CONFIG_FILE or CONFIG_FILE. Under --reconcile=event the daemon "
        "reloads when the file changes",
    )
    parser.add_argument("--debug", action="store_true", help="enable debug logging")
    return parser


def new_os_watcher() -> "queue.SimpleQueue[int]":
    """Buffered signal channel. SimpleQueue, NOT queue.Queue: the handler
    runs on the main thread at an arbitrary bytecode boundary, possibly
    inside the queue's own ``get``; queue.Queue.put takes the mutex ``get``
    holds and would deadlock, while SimpleQueue.put is reentrant by
    contract."""
    sigs: "queue.SimpleQueue[int]" = queue.SimpleQueue()
    for s in WATCHED_SIGNALS:
        signal.signal(s, lambda signum, _frame: sigs.put(signum))
    return sigs


def load_config(cli_values: dict, config_file: Optional[str]) -> Config:
    """loadConfig (main.go:96-107): build and validate, then zero the
    feature-gated sections."""
    config = new_config(
        cli_values=cli_values, environ=dict(os.environ), config_file=config_file
    )
    disable_resource_renaming(config, log.warning)
    return config


def start(argv: Optional[list] = None) -> int:
    """OS watcher + config-reload loop; the process exit code."""
    ns = vars(build_arg_parser().parse_args(argv))
    tfd_logging.setup(debug=ns.pop("debug", False))
    faulthandler.enable()
    config_file = ns.pop("config-file", None) or next(
        (os.environ[e] for e in CONFIG_FILE_ENV_VARS if os.environ.get(e)), None
    )
    cli_values = {k: v for k, v in ns.items() if v is not None}
    log.info("Starting OS watcher.")
    previous = {s: signal.getsignal(s) for s in WATCHED_SIGNALS}
    sigs = new_os_watcher()
    # Cross-epoch memory: a SIGHUP reload of a process that already
    # served live labels must not re-enter the restored regime.
    process_state: dict = {"live_full_served": False}
    try:
        while True:
            log.info("Loading configuration.")
            try:
                config = load_config(cli_values, config_file)
            except ConfigError as e:
                log.error("unable to load config: %s", e)
                return 1
            # New epoch: no health measured under the old config is
            # republished, and every stable condition may warn once again.
            reset_burnin_schedule()
            tfd_logging.reset_warn_once()
            log.info("Start running")
            try:
                if config.flags.tfd.oneshot:
                    # The twin's oneshot: the fallback-to-null wrapper
                    # under --fail-on-init-error=false, else strict
                    # error-to-exit, so a one-off Job fails loudly. A
                    # registry list acquires inside run(), strictly.
                    manager = (
                        None if registry.multi_backend_tokens(config)
                        else factory.new_manager(config)
                    )
                    restart = run(manager, config, sigs)
                else:
                    restart = run(
                        lambda: factory.build_manager(config),
                        config,
                        sigs,
                        supervisor=Supervisor(config),
                        process_state=process_state,
                        config_file=config_file,
                    )
            except Exception as e:  # noqa: BLE001 - error-to-exit, like the twin
                log.error("Error: %s", e)
                log.debug("Traceback:", exc_info=True)
                return 1
            if not restart:
                return 0
    finally:
        # The twin's process ends here; an embedding caller (a test, the
        # smoke script) gets its own handlers back.
        for s, handler in previous.items():
            signal.signal(s, handler)


def start_introspection_server(
    config: Config,
    quiet: bool = False,
    probe_request=None,
    peer_snapshot=None,
    peer_fault=None,
    peer_notify=None,
    notify_subscribe=None,
):
    """Bind the introspection server for a daemon epoch: ``(server,
    state)``, or ``(None, None)``. Oneshot never serves and
    ``--metrics-port 0`` disables it. A bind failure degrades to no
    server with a warning (``quiet`` silences the repeats); the run loop
    retries the bind each cycle, so a port race at boot heals itself.
    The ``peer_*`` and ``notify_subscribe`` hooks are the epoch's slice
    coordinator's (None without one: ``/peer/*`` answer 404)."""
    tfd = config.flags.tfd
    if tfd.oneshot or not tfd.metrics_port:
        return None, None
    from gpu_feature_discovery_tpu_torch.obs.server import (
        IntrospectionServer,
        IntrospectionState,
    )

    state = IntrospectionState(tfd.sleep_interval)
    try:
        server = IntrospectionServer(
            obs_metrics.REGISTRY,
            state,
            addr=tfd.metrics_addr,
            port=tfd.metrics_port,
            debug_endpoints=bool(tfd.debug_endpoints),
            probe_request=probe_request,
            probe_token=tfd.probe_token or "",
            peer_snapshot=peer_snapshot,
            peer_fault=peer_fault,
            # --peer-token gates /peer/snapshot; the coordinator's own
            # poller sends it too.
            peer_token=tfd.peer_token or "",
            peer_notify=peer_notify,
            notify_subscribe=notify_subscribe,
        )
    except OSError as e:
        if not quiet:
            log.warning(
                "cannot bind introspection server on %s:%s: %s "
                "(will keep retrying each cycle)",
                tfd.metrics_addr, tfd.metrics_port, e,
            )
        return None, None
    server.start()
    log.info("Introspection server listening on %s:%d", tfd.metrics_addr, server.port)
    return server, state


def new_interconnect_labeler(config: Config) -> Labeler:
    """vgpu.NewVGPULib(NewNvidiaPCILib()) (main.go:134): the sysfs PCI
    scanner and the host's slice facts from its environment
    (hostinfo/provider.py); ``TFD_MOCK_PCI=1`` substitutes synthesized
    NVIDIA functions (a test fixture for hosts without GPUs), and
    ``TFD_HERMETIC=1`` blanks the environment provider, as in the twin."""
    del config  # reserved for future flags, as in the twin
    from gpu_feature_discovery_tpu_torch.hostinfo.provider import new_host_info_provider

    pci = MockNvidiaPCI() if env_flag("TFD_MOCK_PCI") else _TolerantPCI()
    return InterconnectLabeler(pci=pci, provider=new_host_info_provider())


class _TolerantPCI:
    """Sysfs scan that degrades to 'no devices' where there is no
    /sys/bus/pci (development hosts); the reference propagates sysfs
    errors because it always runs privileged on Linux."""

    def __init__(self):
        self._scanner = SysfsNvidiaPCI()

    def devices(self):
        try:
            return self._scanner.devices()
        except Exception as e:  # noqa: BLE001
            log.debug("PCI scan unavailable: %s", e)
            return []


def _check_signal(
    sigs: "queue.SimpleQueue[int]", timeout: Optional[float] = None
) -> Optional[str]:
    """One signal-queue read: "restart" (SIGHUP), "shutdown", or None.
    ``timeout=None`` polls without blocking."""
    try:
        if timeout is None:
            signum = sigs.get_nowait()
        else:
            signum = sigs.get(timeout=timeout)
    except queue.Empty:
        return None
    if signum == signal.SIGHUP:
        log.info("Received SIGHUP, restarting.")
        return "restart"
    log.info("Received signal %s, shutting down.", signum)
    return "shutdown"


def _wait_for_signal(sigs: "queue.SimpleQueue[int]", duration: float) -> Optional[str]:
    """Sleep up to ``duration`` seconds, waking for signals: the first
    decision, or None when the wait ran out."""
    deadline = time.monotonic() + duration
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        decision = _check_signal(sigs, timeout=remaining)
        if decision is not None:
            return decision


def run(
    manager_or_factory: Union[Manager, Callable[[], Manager], None],
    config: Config,
    sigs: "queue.SimpleQueue[int]",
    supervisor: Optional[Supervisor] = None,
    process_state: Optional[dict] = None,
    interconnect: Optional[Labeler] = None,
    config_file: Optional[str] = None,
    coordinator=None,
) -> bool:
    """One config epoch. Returns True to request a reload (SIGHUP), False
    for a clean exit.

    ``manager_or_factory`` is a ready Manager (oneshot, tests) or a
    zero-arg factory (the supervised daemon, which (re)builds the backend
    inside the cycle loop so init failures become degraded cycles). The
    daemon runs supervised: a failing cycle re-serves last-good labels
    with the unhealthy-cycles counter and retries after a capped backoff;
    only InitRetriesExhausted / TooManyConsecutiveFailures escape. Oneshot
    propagates the first error.

    ``process_state`` is start()'s cross-epoch memory: once an epoch has
    served a live full cycle, later reload epochs skip the --state-dir
    restore, which is for process (re)starts.

    ``interconnect`` defaults to the epoch's own PCI labeler
    (``new_interconnect_labeler``).

    With a registry list (``--backends gpu,cpu``) ``manager_or_factory``
    is ignored (oneshot callers may pass None): each backend is acquired
    per cycle by its BackendRuntime, and a family that will not init
    degrades alone.

    ``config_file`` is the path the config was loaded from; under
    ``--reconcile=event`` a stat watcher on it posts CONFIG_CHANGED, and
    the epoch ends for a reload as on SIGHUP.

    ``coordinator`` is an injected peering.SliceCoordinator: an
    in-process harness runs N daemon loops in one process, whose shared
    environment cannot carry per-worker slice identity. None builds one
    from the config and ``WORKER_HOSTNAMES``/``WORKER_ID`` per epoch (or
    none, and the node-local cycle)."""
    tfd = config.flags.tfd
    # The kernel cache (--compilation-cache-dir), resolved per config
    # epoch and exported through the environment, so the broker worker
    # and this process build into and load from one directory.
    cache_usable = kernel_cache.configure_kernel_cache(
        resolve_compilation_cache_dir(config)
    )
    obs_metrics.COMPILE_CACHE_ENABLED.set(1 if cache_usable else 0)
    if interconnect is None:
        interconnect = new_interconnect_labeler(config)
    output_file = tfd.output_file
    oneshot = tfd.oneshot
    sleep_interval = tfd.sleep_interval
    make_manager = manager_or_factory if callable(manager_or_factory) else None
    current: Optional[Manager] = None if make_manager is not None else manager_or_factory
    supervised = not oneshot
    if supervised and supervisor is None:
        supervisor = Supervisor(config)
    # The registry cycle: every --backends family through one engine pass.
    backend_tokens = registry.multi_backend_tokens(config)
    backend_set = (
        registry.BackendSet(backend_tokens, config) if backend_tokens else None
    )
    # A failure before this epoch's first write must not clobber a
    # previous epoch's still-valid file; once this epoch owns the file its
    # markers stay current.
    wrote_this_epoch = False
    # Restored last-good state is served FIRST, before any backend init,
    # so a restart during an outage never strips the node.
    restored_served = None
    if supervised and not (process_state or {}).get("live_full_served"):
        restored = supervisor.restore_last_good()
        if restored is not None:
            restored[RESTORED_LABEL] = "true"
            try:
                restored.write_to_file(output_file)
            except Exception as e:  # noqa: BLE001 - restore is best-effort
                log.warning("could not serve restored labels: %s", e)
            else:
                wrote_this_epoch = True
                restored_served = restored
                log.info("serving %d restored labels until the first live "
                         "cycle completes", len(restored))
    # One engine per epoch: its cache and stragglers die with the epoch.
    engine = new_label_engine(config)
    # Slice coordination: daemon epochs only, one coordinator per epoch
    # (its reachability state must not survive a reload's hostname-list
    # change). The slice family is a gpu-family fact: a daemon labeling
    # only the cpu family claims no slice membership.
    if coordinator is None and supervised and (
        backend_set is None or backend_set.has_family("gpu")
    ):
        from gpu_feature_discovery_tpu_torch.peering import new_slice_coordinator

        coordinator = new_slice_coordinator(config)
    peer_snapshot = coordinator.snapshot_response if coordinator is not None else None
    # The two-tier fault sites' gate, consulted per /peer/snapshot request.
    peer_fault = coordinator.serving_fault if coordinator is not None else None
    event_loop = None
    events_q = None
    forwarder = None
    config_watcher = None
    delta_tracker = None
    probe_request = None
    if supervised and (
        reconcile_events.resolve_reconcile_mode(config)
        == reconcile_events.RECONCILE_EVENT
    ):
        events_q = reconcile_events.EventQueue()
        event_loop = reconcile_events.ReconcileLoop(
            events_q,
            # 0 (the default) demotes --sleep-interval to the bound.
            max_staleness=tfd.max_staleness or sleep_interval,
            debounce=(
                tfd.reconcile_debounce
                if tfd.reconcile_debounce is not None
                else DEFAULT_RECONCILE_DEBOUNCE
            ),
            max_probe_rate=tfd.max_probe_rate or DEFAULT_MAX_PROBE_RATE,
        )
        delta_tracker = reconcile_events.DeltaTracker(events_q)
        # The signal watcher becomes one producer among several.
        forwarder = reconcile_events.SignalForwarder(sigs, events_q).start()
        if config_file:
            config_watcher = reconcile_events.ConfigFileWatcher(
                config_file, events_q
            ).start()

        def probe_request():
            events_q.post(reconcile_events.Event(reconcile_events.REASON_PROBE_REQUEST))

    # Push-on-delta receive side: a child peer's authenticated POST
    # /peer/notify marks it dirty (its name checked against the peer set)
    # and, in event mode, wakes the loop, which debounces and rate-guards
    # it like any wake. Interval mode still takes the dirty mark.
    peer_notify = None
    notify_subscribe = None
    if coordinator is not None and coordinator.push_notify:
        def peer_notify(name, generation, etag):
            if not coordinator.mark_dirty(name, generation, etag):
                return False
            if events_q is not None:
                events_q.post(reconcile_events.Event(
                    reconcile_events.REASON_PEER_NOTIFY, detail=name,
                ))
            return True

        notify_subscribe = coordinator.notify_subscriptions.observe_poll

    if supervised:
        # Broker-worker death watch (sandbox/broker.py), in both reconcile
        # modes: a dead worker is marked dead at death time, so the next
        # acquisition respawns instead of failing a cycle on a dead pipe;
        # event mode also wakes the loop with WORKER_DIED.
        listener = None
        if event_loop is not None:
            def listener(signame):
                events_q.post(reconcile_events.Event(
                    reconcile_events.REASON_WORKER_DIED, detail=signame,
                ))
        sandbox.set_broker_death_watch(True, listener=listener)
        # Cold-start overlap: the worker's spawn (interpreter, torch's
        # import, CUDA's set-up, the kernel pre-warm) starts NOW, beside
        # the restored labels; the first cycle finds it up or queues
        # behind it. Stood down under fault injection: a pre-spawn would
        # consume an injected shot outside the supervisor's accounting.
        if (
            backend_set is None
            and make_manager is not None
            and sandbox.broker_enabled(config)
            and not faults.active()
        ):
            sandbox.prespawn_broker(config)
    # Introspection server: daemon epochs only, rebound per epoch so a
    # reload picks up new --metrics-* flags.
    peer_hooks = dict(
        probe_request=probe_request,
        peer_snapshot=peer_snapshot,
        peer_fault=peer_fault,
        peer_notify=peer_notify,
        notify_subscribe=notify_subscribe,
    )
    obs_server, obs_state = start_introspection_server(config, **peer_hooks)
    if obs_server is not None and coordinator is not None:
        # The BOUND port rides the poller's subscribe headers, so children
        # know where to POST their notifications.
        coordinator.set_notify_port(obs_server.port)
    # Anti-flap hysteresis: daemon only; oneshot publishes what it measured.
    flap = None
    # Verdict actuation: daemon epochs only, one engine per epoch, so a
    # reload's mode or window change applies cleanly. None at --actuation
    # off (the default): the projection below is its only touch point.
    actuation = None
    if supervised:
        flap = FlapDamper(
            tfd.flap_window if tfd.flap_window is not None else DEFAULT_FLAP_WINDOW
        )
        actuation = new_actuation_engine(config, coordinator)
    try:
        timestamp_labeler = new_timestamp_labeler(config)
        if restored_served is not None:
            # The restore->live transition is damped like any other.
            flap.observe(restored_served)
            if obs_state is not None:
                obs_state.labels_written(restored_served, {}, mode="restored")
            if coordinator is not None:
                coordinator.publish_local(restored_served, "restored")
        # The post time of the event that woke the cycle about to run,
        # for tfd_wake_to_labels_seconds.
        wake_first_ts: Optional[float] = None
        while True:
            # The span tree's root: this loop top to the end of the wait.
            timing.begin_cycle()
            with timing.span("cycle.prepare"):
                timing.reset_cycle()
                if obs_server is None:
                    # A bind that failed (a port race) is retried each cycle.
                    obs_server, obs_state = start_introspection_server(
                        config, quiet=True, **peer_hooks
                    )
                    if obs_server is not None and coordinator is not None:
                        coordinator.set_notify_port(obs_server.port)
                cycle_mode = "full"
            try:
                with timed("labelgen.total"):
                    if backend_set is not None:
                        # Per-backend acquisition: a backend that will not
                        # init contributes no source and only its family's
                        # degraded marker; the others publish fresh.
                        sources, down_families = multi_backend_label_sources(
                            backend_set, config, timestamp=timestamp_labeler,
                            interconnect=interconnect, strict=not supervised,
                        )
                        if supervised:
                            # Fail-fast only with nothing left to publish.
                            backend_set.check_escalation()
                        if coordinator is not None:
                            sources.append(new_slice_label_source(coordinator))
                        try:
                            labels = engine.generate(sources)
                        finally:
                            for rt in backend_set.runtimes:
                                if rt.manager is not None:
                                    with timed(f"{rt.family}.shutdown"):
                                        rt.manager.shutdown()
                        for family in down_families:
                            labels[FAMILY_DEGRADED_LABELS[family]] = "true"
                        obs_metrics.DEGRADED.set(1 if down_families else 0)
                        if down_families:
                            cycle_mode = "degraded"
                    else:
                        if current is None and make_manager is not None:
                            # The backend's first init pays torch's import
                            # and CUDA's set-up: in this process, or in the
                            # spawn of the broker worker.
                            with timed("gpu.acquire"):
                                current = (
                                    supervisor.acquire_manager(make_manager)
                                    if supervised
                                    else make_manager()
                                )
                        if current is None:
                            # Backend down: the non-device facts plus
                            # the degraded marker, never nothing.
                            cycle_mode = "degraded"
                            sources = degraded_label_sources(
                                config, timestamp=timestamp_labeler,
                                interconnect=interconnect,
                            )
                            if coordinator is not None:
                                # The slice view is about host
                                # reachability: a daemon whose backend is
                                # down keeps polling and serving (its
                                # snapshot's mode says so).
                                sources.append(new_slice_label_source(coordinator))
                            labels = engine.generate(sources)
                            labels[DEGRADED_LABEL] = "true"
                        else:
                            # init() runs inside new_label_sources; its
                            # errors propagate before shutdown is owed.
                            sources = new_label_sources(
                                current, config, timestamp=timestamp_labeler,
                                interconnect=interconnect,
                            )
                            if coordinator is not None:
                                # Merged LAST: the slice family is derived
                                # from peers and never overrides a
                                # node-local fact.
                                sources.append(new_slice_label_source(coordinator))
                            try:
                                labels = engine.generate(sources)
                            finally:
                                with timed("gpu.shutdown"):
                                    current.shutdown()

                # Everything the cycle does with its labels up to the
                # state save: the overlays, the write, the obs state and
                # the slice coordinator.
                with timing.span("cycle.publish"):
                    if len(labels) <= 1:
                        log.warning("no labels generated from any source")
                    log.info("Cycle timings: %s", timing.cycle_summary())
                    timing.write_timings_file(tfd.timings_file or "")
                    if supervised and supervisor.restored and (
                        cycle_mode == "degraded" or STALE_SOURCES_LABEL in labels
                    ):
                        # Not trustworthy live inventory: overlay the fresh
                        # facts onto the restored inventory.
                        labels = supervisor.with_restored(labels)
                    if flap is not None:
                        labels = flap.observe(labels)
                    if actuation is not None:
                        # After the damper (the advice family has its own
                        # hysteresis) and before the write. A changed advice
                        # set is a new object: the damper's baseline is never
                        # mutated.
                        labels = actuation.project(labels, cycle_mode)
                    log.info("Writing labels to output file %s", output_file or "<stdout>")
                    with timing.span("labels.write"):
                        labels.write_to_file(output_file)
                    wrote_this_epoch = True
                    obs_metrics.CYCLES_TOTAL.labels(outcome=cycle_mode).inc()
                    if event_loop is not None:
                        if wake_first_ts is not None:
                            obs_metrics.WAKE_TO_LABELS.observe(
                                time.monotonic() - wake_first_ts
                            )
                            wake_first_ts = None
                        # A moved health verdict or slice membership wakes a
                        # prompt follow-up.
                        delta_tracker.observe_labels(labels)
                        if coordinator is not None:
                            delta_tracker.observe_peers(coordinator.membership_token())
                    if obs_state is not None:
                        obs_state.labels_written(
                            labels, engine.last_provenance, mode=cycle_mode
                        )
                    if coordinator is not None:
                        # Peers see what the node published, markers and the
                        # slice family stripped (peering/snapshot.py).
                        coordinator.publish_local(labels, cycle_mode)
            except (InitRetriesExhausted, TooManyConsecutiveFailures):
                raise  # supervision verdicts, not containable faults
            except Exception as e:  # noqa: BLE001 - supervision boundary
                if not supervised:
                    raise
                delay = supervisor.cycle_failed(e)  # raises at the bound
                if backend_set is not None:
                    # Any enabled backend may be the broken part.
                    backend_set.release_all()
                if make_manager is not None:
                    # The backend may be the broken part: release it and go
                    # back through acquisition next cycle.
                    if current is not None:
                        try:
                            current.shutdown()
                        except Exception:  # noqa: BLE001 - already failed
                            log.debug("shutdown of failed backend:", exc_info=True)
                    current = None
                if (
                    not supervisor.has_last_good
                    and not wrote_this_epoch
                    and output_file
                    and os.path.exists(output_file)
                ):
                    # Full labels from a previous epoch beat a counter-only
                    # file now; the loop is alive, so heartbeat anyway.
                    log.info("cycle failed before this epoch's first write; "
                             "keeping the existing label file untouched")
                    supervisor.touch_heartbeat()
                    if obs_state is not None:
                        obs_state.cycle_completed()
                else:
                    reserve = supervisor.reserve_labels()
                    try:
                        with timing.span("labels.write"):
                            reserve.write_to_file(output_file)
                    except Exception as we:  # noqa: BLE001 - already degraded
                        log.warning("could not re-serve last-good labels: %s", we)
                    else:
                        wrote_this_epoch = True
                        log.info("re-served last-good labels (unhealthy-cycles=%d)",
                                 supervisor.consecutive_failures)
                        supervisor.touch_heartbeat()
                        obs_metrics.RESERVES_TOTAL.inc()
                        if obs_state is not None:
                            obs_state.labels_written(reserve, {}, mode="reserved")
                            obs_state.cycle_completed()
                        if coordinator is not None:
                            coordinator.publish_local(reserve, "reserved")
                # The backoff replaces the sleep interval for a failed
                # cycle; a signal during it is serviced at once.
                log.info("retrying failed cycle in %.3fs", delay)
                with timing.span("cycle.wait"):
                    if event_loop is None:
                        decision = _wait_for_signal(sigs, delay)
                    else:
                        decision = event_loop.wait_backoff(delay)
                if decision == "restart":
                    return True
                if decision == "shutdown":
                    return False
                # The retry is backoff-paced, not event-triggered.
                wake_first_ts = None
                continue
            else:
                if supervised:
                    with timing.span("state.save"):
                        supervisor.cycle_succeeded(labels, mode=cycle_mode)
                    with timing.span("heartbeat"):
                        supervisor.touch_heartbeat()
                    if cycle_mode == "full" and not supervisor.restored:
                        # Live inventory is back: the restart clock stops
                        # (restored and degraded writes do not count).
                        _record_restart_to_labels()
                        if process_state is not None:
                            process_state["live_full_served"] = True
                elif cycle_mode == "full":
                    _record_restart_to_labels()
                if obs_state is not None:
                    obs_state.cycle_completed()

            if oneshot:
                return False

            with timing.span("cycle.wait"):
                if event_loop is None:
                    # A signal that arrived during a long cycle is honored now.
                    decision = _check_signal(sigs)
                    if decision is None:
                        log.info("Sleeping for %ss", sleep_interval)
                        decision = _wait_for_signal(sigs, sleep_interval)
                else:
                    wake = event_loop.wait_for_wake()
                    decision = wake.decision
                    if decision is None:
                        wake_first_ts = wake.first_ts
                        log.info(
                            "reconcile wake: %s%s",
                            "+".join(wake.reasons),
                            f" ({wake.coalesced} coalesced)" if wake.coalesced else "",
                        )
            if decision == "restart":
                return True
            if decision == "shutdown":
                return False
    finally:
        timing.end_cycle()
        # Signals forwarded but not serviced go back on ``sigs`` for the
        # next epoch's reader.
        if forwarder is not None:
            forwarder.stop()
        if config_watcher is not None:
            config_watcher.stop()
        if backend_set is not None:
            backend_set.close()
        sandbox.set_broker_death_watch(False)
        engine.close()
        # The broker worker is epoch-scoped: closed GRACEFULLY (shutdown
        # request, SIGKILL fallback) before the stray sweep, whose
        # exemption covers the live worker in between; then no probe
        # child outlives its epoch.
        sandbox.close_broker()
        sandbox.kill_stray_children()
        if obs_server is not None:
            # Synchronous: the port is free before a reload rebinds it.
            obs_server.close()
        if coordinator is not None:
            # Zero the per-peer gauges: a reload may bring another
            # hostname list, and a departed peer must not stay latched.
            coordinator.close()
        # A daemon exit removes the label file so stale labels do not
        # outlive the pod; oneshot leaves it for NFD.
        if not oneshot and output_file:
            try:
                remove_output_file(output_file)
            except OSError as e:
                log.warning("Error removing output file: %s", e)


def main() -> None:
    # The one entry of the console script and ``python -m``, so both take
    # the subcommand; the collector imports no torch.
    if len(sys.argv) > 1 and sys.argv[1] == "fleet-collector":
        from gpu_feature_discovery_tpu_torch.cmd.fleet import main as fleet_main

        sys.exit(fleet_main(sys.argv[2:]))
    sys.exit(start())


if __name__ == "__main__":
    main()
