"""The port's hermetic N-daemon slice harness (``PortSliceHarness``), the
counterpart of the twin's ``tests/slice_fixture.py`` ``SliceHarness``.

``PortSliceHarness`` runs N real supervised daemon loops of the port
(``cmd/main.run``) in this process, each labeling two mock GPUs
(``mock-gpu:2``), serving ``/peer/snapshot`` on 127.0.0.1 and polling the
others over real HTTP, with slice identity injected as a built
SliceCoordinator: os.environ is shared between the in-process daemons and
cannot carry per-worker facts. "Killing" a worker is its real shutdown
path: SIGTERM on its signal queue closes its obs server, so survivors see
the connection refusal a dead host produces.

Process-wide state the harness holds still: the obs metrics registry and
the fault registry are shared by all N daemons, so per-worker faults are
armed through the coordinators' own hooks (``slow_workers``,
``tier_partitioned_workers``); the broker stays off and the probe runs in
process, because ``close_broker()`` and the stray-child sweep at one
daemon's epoch end are process-wide and would reach a sibling.

Used by the port's slice, actuation and busy-device tests and by the
chaos driver (``tests/torch_chaos_run.py``). It imports nothing of the
JAX package: the chaos driver loads it on machines without JAX.
"""

import os
import queue
import random
import signal
import socket
import threading
import time

from gpu_feature_discovery_tpu_torch.cmd import main as port_main
from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.slice_labeler import SLICE_COORD_LABELS, is_cohort_label
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.ops.kernel_cache import RESOLVED_CACHE_DIR_ENV
from gpu_feature_discovery_tpu_torch.peering import SliceCoordinator
from gpu_feature_discovery_tpu_torch.resource import factory


# Ports are taken below the kernel's ephemeral range: a port let go here
# and bound later (a daemon's server, a collector restarted on its port
# after a SIGKILL) cannot meanwhile be handed to another process's bind to
# port 0, as the tests running beside these ones do.
PORT_SPAN = 12000


def _ephemeral_low():
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port():
    return free_ports(1)[0]


def free_ports(n):
    """n distinct free ports on 127.0.0.1, below the ephemeral range: all
    bound at once, then let go for the daemons to bind."""
    high = _ephemeral_low()
    low = max(1024, high - PORT_SPAN)
    pick = random.SystemRandom()
    socks = []
    try:
        while len(socks) < n:
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", pick.randrange(low, high)))
            except OSError:
                s.close()
                continue
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def is_coord(key):
    """A key of the slice coordination family: the only labels the peer
    layer may move."""
    return key in SLICE_COORD_LABELS or is_cohort_label(key)


def non_coord_lines(raw):
    """A label file's node-local lines: all but the coordination family.
    The slice tests and the chaos driver judge "node labels untouched"
    through this one filter."""
    return [line for line in (raw or "").splitlines()
            if line and not is_coord(line.split("=", 1)[0])]


def _slowed(hook, delay_s):
    def slow_hook():
        time.sleep(delay_s)
        return hook()

    return slow_hook


class _PortSickOverlay:
    """Wraps a worker's interconnect labeler with a confirmed chips.sick
    verdict, as the twin's harness does (``sick_workers``): the verdict
    rides the real engine merge, peer snapshot and actuation path.
    ``sick`` is mutable mid-scenario (heal by setting 0)."""

    def __init__(self, inner, sick=1):
        self._inner = inner
        self.sick = sick

    def labels(self):
        from gpu_feature_discovery_tpu_torch.lm.health import CHIPS_HEALTHY, CHIPS_SICK

        labels = self._inner.labels()
        if self.sick:
            labels[CHIPS_SICK] = str(self.sick)
            labels[CHIPS_HEALTHY] = labels.get(CHIPS_HEALTHY, "0")
        return labels


class PortWorker:
    def __init__(self, worker_id, config, coordinator, port, interconnect=None):
        self.worker_id = worker_id
        self.config = config
        self.coordinator = coordinator
        self.port = port
        self.interconnect = interconnect
        self.output_file = config.flags.tfd.output_file
        self.sigs = None
        self.thread = None
        self.result = {}

    @property
    def alive(self):
        return self.thread is not None and self.thread.is_alive()

    def labels(self):
        try:
            with open(self.output_file) as f:
                return dict(line.rstrip("\n").split("=", 1) for line in f if "=" in line)
        except OSError:
            return {}

    def raw_output(self):
        try:
            with open(self.output_file) as f:
                return f.read()
        except OSError:
            return None


class PortSliceHarness:
    """N supervised port daemon loops as one slice in this process: the
    port's counterpart of the twin's SliceHarness (its surface and its
    stop-is-SIGTERM rule), over ``mock-gpu:2`` backends."""

    def __init__(self, tmp_path, workers=4, coordination="on", sleep_interval="0.05s",
                 peer_timeout="0.5s", cohort_size=0, peer_token="", labeler_timeout="10s",
                 round_budget=None, peer_fanout=None, slow_workers=(), slow_delay_s=0.0,
                 backends="mock-gpu:2", inject=True, extra_cli=None, sick_workers=(),
                 tier_partitioned_workers=()):
        """``slow_workers`` stall their /peer/snapshot answers by
        ``slow_delay_s`` (the peer.slow behaviour, scoped to a worker: the
        fault registry is process-wide here); ``tier_partitioned_workers``
        drop slice-tier leadership polls at the wire (the
        peer.tier-partition behaviour, scoped the same way; heal by
        setting ``workers[i].coordinator.force_tier_partition`` False);
        ``round_budget`` and ``peer_fanout`` go to every coordinator.
        ``inject=False`` builds no coordinator here: each daemon then
        builds its own from the config and the process's
        ``WORKER_HOSTNAMES``/``WORKER_ID``. ``sick_workers`` overlay a
        confirmed chips.sick verdict on the named workers' interconnect
        labelers (``_PortSickOverlay``)."""
        obs_metrics.reset_for_tests()
        self.workers = []
        self._kernel_cache_env = None
        self._started = False
        ports = free_ports(workers)
        hostnames = [f"127.0.0.1:{p}" for p in ports]
        for i in range(workers):
            workdir = os.path.join(str(tmp_path), f"port-worker-{i}")
            os.makedirs(workdir, exist_ok=True)
            machine = os.path.join(workdir, "machine-type")
            with open(machine, "w") as f:
                f.write("Mock GPU Node\n")
            config = new_config(cli_values={
                "oneshot": False,
                "backends": backends,
                "output-file": os.path.join(workdir, "tfd"),
                "machine-type-file": machine,
                "sleep-interval": sleep_interval,
                "init-backoff-max": "0.02s",
                "init-retries": "50",
                "max-consecutive-failures": "50",
                "metrics-addr": "127.0.0.1",
                "metrics-port": str(ports[i]),
                "state-dir": os.path.join(workdir, "state"),
                "probe-isolation": "none",
                "probe-broker": "off",
                "slice-coordination": coordination,
                "peer-timeout": peer_timeout,
                "cohort-size": str(cohort_size),
                "peer-token": peer_token,
                "labeler-timeout": labeler_timeout,
                **(extra_cli or {}),
            }, environ={})
            coordinator = None
            if coordination == "on" and inject:
                coordinator = SliceCoordinator(
                    worker_id=i, hostnames=hostnames, default_port=ports[i],
                    peer_timeout=float(peer_timeout.rstrip("s")),
                    cohort_size=cohort_size, peer_token=peer_token,
                    round_budget=round_budget, fanout=peer_fanout)
                if i in slow_workers:
                    coordinator.snapshot_response = _slowed(
                        coordinator.snapshot_response, slow_delay_s)
                if i in tier_partitioned_workers:
                    coordinator.force_tier_partition = True
            interconnect = None
            if i in sick_workers:
                interconnect = _PortSickOverlay(port_main.new_interconnect_labeler(config))
            self.workers.append(PortWorker(i, config, coordinator, ports[i], interconnect))

    def start(self):
        # The daemons export their resolved kernel cache into this
        # process's environment (cmd/main.run); it must not outlive them.
        if not self._started:
            self._kernel_cache_env = os.environ.get(RESOLVED_CACHE_DIR_ENV)
            self._started = True
        for worker in self.workers:
            self.start_worker(worker.worker_id)
        return self

    def start_worker(self, worker_id):
        worker = self.workers[worker_id]
        worker.sigs = queue.Queue()
        worker.result = {}

        def target():
            try:
                worker.result["restart"] = port_main.run(
                    lambda: factory.build_manager(worker.config), worker.config,
                    worker.sigs, supervisor=Supervisor(worker.config),
                    interconnect=worker.interconnect, coordinator=worker.coordinator)
            except BaseException as e:  # noqa: BLE001 - reported by the tests
                worker.result["error"] = e

        worker.thread = threading.Thread(target=target, name=f"port-slice-worker-{worker_id}",
                                         daemon=True)
        worker.thread.start()
        return worker

    def stop_worker(self, worker_id, timeout=10):
        """SIGTERM on the worker's queue: its real shutdown path, which
        closes its server, so its peers see connections refused."""
        worker = self.workers[worker_id]
        if worker.sigs is not None:
            worker.sigs.put(signal.SIGTERM)
        if worker.thread is not None:
            worker.thread.join(timeout=timeout)
            assert not worker.thread.is_alive(), f"worker {worker_id} ignored SIGTERM"
        assert "error" not in worker.result, worker.result.get("error")

    def stop(self):
        try:
            for worker in self.workers:
                if worker.alive:
                    self.stop_worker(worker.worker_id)
        finally:
            if self._started:
                self._started = False
                if self._kernel_cache_env is None:
                    os.environ.pop(RESOLVED_CACHE_DIR_ENV, None)
                else:
                    os.environ[RESOLVED_CACHE_DIR_ENV] = self._kernel_cache_env

    def snapshot(self):
        return {w.worker_id: w.labels() for w in self.workers}

    def wait_for(self, predicate, timeout=20, what="condition"):
        """Poll every worker's label file until every running worker has
        written one and ``predicate(labels_by_id)`` holds; returns the
        satisfying snapshot or fails.

        A peer counts a worker healthy once its server answers, which can
        be before that worker's first label write: a predicate on the
        leader's labels alone can hold while a member's file is still
        absent, and a "node-local labels never move" check would then
        start from an empty file."""
        deadline = time.monotonic() + timeout
        snapshot = {}
        while time.monotonic() < deadline:
            snapshot = self.snapshot()
            written = all(snapshot[w.worker_id] for w in self.workers if w.alive)
            if written and predicate(snapshot):
                return snapshot
            for worker in self.workers:
                assert "error" not in worker.result, (
                    f"worker {worker.worker_id} crashed: {worker.result['error']!r}")
            time.sleep(0.01)
        raise AssertionError(
            f"timed out after {timeout}s waiting for {what}; last label files: {snapshot}")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
