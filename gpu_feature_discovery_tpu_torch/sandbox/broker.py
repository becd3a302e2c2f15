"""Persistent probe broker: one long-lived worker process that holds the
CUDA devices (twin: ``gpu_feature_discovery_tpu/sandbox/broker.py``).

- ONE worker per config epoch selects and initialises the backend ONCE
  (in the worker: torch's import, CUDA's set-up, the enumeration), holds
  the devices, and serves requests over length-prefixed JSON frames on a
  pipe: ``snapshot`` (a fresh enumeration off the held backend),
  ``health`` (the burn-in probe, including the hand-written
  ``hbm_stream_sum`` kernel), ``ping`` and ``shutdown``. The labeling
  process never initialises CUDA.
- Every request runs under a hard wall-clock deadline
  (``--probe-timeout``) enforced by SIGKILL: a request wedged in native
  code kills only the worker.
- A dead worker (crash, hang-kill, EOF, junk frame) is respawned on the
  next use under a capped backoff; a healthy worker is recycled after
  ``--broker-max-requests`` served requests (0 = never).
- A supervisor backend rebuild after a failed cycle REUSES the live
  worker: acquisition through a running broker is one ``snapshot`` RPC.

The worker is a fresh interpreter (sandbox/probe.py ``spawn_child``; the
twin forks, which a CUDA context does not survive), started with the
config as its first frame. Its pid is registered in the probe-child
registry (kills go through ``kill_if_live``) but exempt from
``kill_stray_children``'s sweep: ``close_broker`` in ``run()``'s
teardown retires it gracefully. The classic path has one worker per
epoch; the registry cycle (``--backends gpu,cpu``, resource/registry.py)
has one per backend token, as the twin keys them, so a hang-kill or a
crash-respawn in one family's worker never touches another's. Only a
gpu-family worker imports the probe, pre-warms and runs the burn-in and
``hbm_stream_sum``; the cpu family's never imports torch and never
creates a CUDA context.

On a node with GPUs in MIG mode the classic worker probes only the
plain GPUs; each MIG device is probed in a one-shot child pinned to it
(lm/health.py ``_probe_mig_in_child``), which holds nothing of the
device between probes.

A probe that could not get device memory (a workload holds the device,
``ops.healthcheck.is_busy_error``) answers ``unacquirable``, the twin's
outcome for a chip it could not acquire, and drops what the attempt
allocated; the worker stays up.

Fault sites (``TFD_FAULT_SPEC``): a spawn fires ``pjrt_init`` and
consumes ``probe.timeout``/``probe.hang``/``probe.segv`` (a spawn IS an
acquisition); requests consume ``broker.hang`` / ``broker.crash``. All
consumed in the PARENT and enacted in the worker.

Metrics are recorded here, in the labeling process, the one that serves
``/metrics`` (obs/): ``tfd_backend_init_attempts_total`` and
``tfd_probe_duration_seconds`` per spawn, ``tfd_broker_requests_total``
and ``tfd_broker_request_duration_seconds`` per request,
``tfd_broker_respawns_total`` for every spawn after this client's first
(after a crash, a kill, an EOF or a recycle; a new epoch's client starts
from none, so a commanded close at SIGHUP is not followed by a respawn),
``tfd_broker_up``, and ``tfd_probe_kills_total`` /
``tfd_probe_crashes_total`` for a worker this process SIGKILLed (spawn or
request past ``--probe-timeout``, a deadline-escalation cancel) or one
that died to a signal of its own. The twin counts the last two only
around its spawn and its death watch; a request killed at its deadline
is the same containment event, so the port counts it too.
"""

from __future__ import annotations

import json
import logging
import os
import select
import signal
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.config.spec import config_to_dict
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource import registry
from gpu_feature_discovery_tpu_torch.resource.types import Manager, ResourceError
from gpu_feature_discovery_tpu_torch.sandbox import probe
from gpu_feature_discovery_tpu_torch.sandbox.probe import (
    _LEN,
    MAX_FRAME_BYTES,
    ProbeCrash,
    ProbeError,
    ProbeTimeout,
    _child_read_request,
    _stderr_tail,
    _write_frame,
)
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import (
    DeviceSnapshot,
    SnapshotChip,
    SnapshotManager,
)

log = logging.getLogger("tfd.sandbox")

# How long a graceful close waits for the worker to honour the shutdown
# request before escalating to SIGKILL.
GRACEFUL_CLOSE_S = 2.0

# ---------------------------------------------------------------------------
# worker death watch (the daemon loop's reaper-side producer)
# ---------------------------------------------------------------------------
# With the watch on (cmd/main.run enables it for every supervised epoch),
# a thread blocks in waitid(WNOWAIT) on the live worker and, the moment
# it exits uncommanded, marks the client dead AT DEATH TIME: the next
# acquisition respawns and serves instead of failing a cycle on a dead
# pipe first. The optional listener is the event loop's WORKER_DIED
# producer (cmd/events.py). Off for direct BrokerClient users (tests):
# the proactive reap changes how a death surfaces.

_watch_lock = threading.Lock()
_watch_enabled = False
_death_listener = None


def set_broker_death_watch(enabled, listener=None):
    """Enable/disable the death watch for workers spawned from now on.
    ``listener(signame)`` is called, outside every broker lock, after a
    death was observed and the client marked dead."""
    global _watch_enabled, _death_listener
    with _watch_lock:
        _watch_enabled = bool(enabled)
        _death_listener = listener if enabled else None


def _death_watch_state():
    with _watch_lock:
        return _watch_enabled, _death_listener


class BrokerError(ProbeError):
    """The broker could not serve the request (worker dead/unspawnable)."""


class BrokerTimeout(ProbeTimeout):
    """A broker request exceeded the deadline; the worker was SIGKILLed."""


class BrokerCrash(ProbeCrash):
    """The broker worker died (signal, EOF, or an unparseable frame)."""


class _FrameReader:
    """Buffered length-prefixed frame reader over a pipe fd; leftover
    bytes persist between frames (the pipe carries many)."""

    def __init__(self, fd: int):
        self._fd = fd
        self._buf = b""

    def read(self, deadline: float) -> Optional[bytes]:
        """One frame body by ``deadline``: bytes on success, ``b""`` on
        EOF before a frame, ``None`` when the deadline expired. A length
        prefix past MAX_FRAME_BYTES raises BrokerCrash at once."""
        want: Optional[int] = None
        while True:
            if want is None and len(self._buf) >= _LEN.size:
                want = _LEN.unpack_from(self._buf)[0]
                if want > MAX_FRAME_BYTES:
                    self._buf = b""
                    raise BrokerCrash(
                        f"broker frame length {want} exceeds "
                        f"{MAX_FRAME_BYTES} bytes (corrupt length prefix)"
                    )
            if want is not None and len(self._buf) >= _LEN.size + want:
                frame = self._buf[_LEN.size:_LEN.size + want]
                self._buf = self._buf[_LEN.size + want:]
                return frame
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                ready, _, _ = select.select([self._fd], [], [], remaining)
            except InterruptedError:
                continue
            except OSError:
                return b""
            if not ready:
                return None
            try:
                chunk = os.read(self._fd, 65536)
            except OSError:
                return b""
            if not chunk:
                return b""
            self._buf += chunk


def _load_doc(frame: bytes) -> dict:
    """A frame's JSON object; ValueError for anything else. JSON that is
    not an object, or nested past the decoder's limit, is garbage like a
    broken frame (the twin lets both escape untyped, the worker up)."""
    try:
        doc = json.loads(frame.decode())
    except RecursionError as e:
        raise ValueError(f"frame nested too deeply: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError(f"frame is a {type(doc).__name__}, not an object")
    return doc


# ---------------------------------------------------------------------------
# the worker (child) side
# ---------------------------------------------------------------------------

# How long a health request waits for the probe before answering
# "warming" and letting a later request collect the result: steady
# probes finish far inside it, while first use (cuBLAS, NCCL, the graph
# capture, seconds on a worker thread) must never hold the RPC past the
# engine's labeler deadline, which would SIGKILL the worker every cycle.
# The parent's value rides each health request: a forked worker would
# inherit the parent's module state, an exec'd one must be told.
HEALTH_WAIT_S = 2.0


def health_options(req: dict) -> dict:
    """``measure_node_health``'s per-chip options from a ``health``
    request: ``per_chip`` (--chip-probes), the ``chip.<i>.sick`` /
    ``chip.<i>.slow`` indices and the ``inventory_uuids`` they index."""
    opts: dict = {}
    if "per_chip" in req:
        opts["per_chip"] = bool(req["per_chip"])
    if req.get("sick_chips"):
        opts["sick_chips"] = frozenset(int(i) for i in req["sick_chips"])
    if req.get("slow_chips"):
        opts["slow_chips"] = frozenset(int(i) for i in req["slow_chips"])
    if req.get("inventory_uuids"):
        opts["inventory_uuids"] = [str(u) for u in req["inventory_uuids"]]
    return opts


class _HealthProbe:
    """Worker-side async burn-in: one probe thread at a time; requests
    collect the outcome when ready and get ``warming`` in between.
    ``acquire`` returns the devices to probe, or None (default: every
    device the probe can acquire)."""

    def __init__(self, chip_lock: threading.Lock, acquire=None):
        self._chip_lock = chip_lock
        self._acquire = acquire
        self._thread: Optional[threading.Thread] = None
        self._outcome: Optional[dict] = None
        # The pre-warm's ms: it paid first use, so the probes after it
        # report compile_ms 0. Shipped once, with the first ok outcome.
        self.prewarm_ms: Optional[float] = None
        # Each CUDA device's used bytes (total - free) as the pre-warm
        # first saw this worker's context, before its first allocation.
        self.context_used: Optional[list] = None

    def _run(self, devices, opts: dict) -> None:
        from gpu_feature_discovery_tpu_torch.ops.healthcheck import (
            is_busy_error,
            measure_node_health,
            release_probe_memory,
        )

        t0 = time.perf_counter()
        error = None
        with self._chip_lock:
            try:
                report = measure_node_health(devices=devices, **opts)
            except Exception as e:  # noqa: BLE001 - shipped to the parent
                error = e
            busy = error is not None and is_busy_error(error)
            if busy:
                release_probe_memory(error)
        if error is not None:
            self._outcome = {
                # A busy device is not a sick one: no verdict this time.
                "status": "unacquirable" if busy else "probe-failed",
                "error": str(error),
                "probe_ms": (time.perf_counter() - t0) * 1e3,
            }
            return
        self._outcome = {
            "status": "ok",
            "report": report,
            "probe_ms": (time.perf_counter() - t0) * 1e3,
        }

    def request(self, req: Optional[dict] = None) -> dict:
        """One ``health`` RPC. Outcomes: ``unacquirable`` (no device, or
        the probe could not get device memory, with its ``error``: says
        nothing about device health), ``probe-failed`` (devices acquired,
        the computation failed: health.ok=false), ``ok`` with the report, and
        ``warming`` while the probe (or the pre-warm holding the chip
        lock) still runs.

        ``req`` carries the parent-consumed per-chip options
        (``health_options``), bound into the probe THREAD at its start;
        and ``wait_s``, the bounded wait."""
        req = req or {}
        if self._thread is None:
            from gpu_feature_discovery_tpu_torch.lm import health

            devices = (self._acquire or health._acquire_devices)()
            if devices is None:
                return {"status": "unacquirable"}
            self._thread = threading.Thread(
                target=self._run, args=(devices, health_options(req)),
                name="tfd-broker-health", daemon=True,
            )
            self._thread.start()
        self._thread.join(float(req.get("wait_s", HEALTH_WAIT_S)))
        if self._thread.is_alive():
            return {"status": "warming"}
        self._thread = None
        outcome, self._outcome = self._outcome, None
        if outcome and outcome.get("status") == "ok" and self.prewarm_ms is not None:
            outcome["prewarm_ms"], self.prewarm_ms = self.prewarm_ms, None
        return outcome or {"status": "probe-failed", "error": "probe thread died"}


def _child_prewarm(health_probe: _HealthProbe, per_chip: bool = True,
                   acquire=None) -> None:
    """Warm-start: build the kernel, capture the burn-in graph and run
    every probe once right after init, OFF the label-serving path (a
    background thread: ``snapshot`` requests serve meanwhile), so the
    first health cycle does not pay first use. It launches
    ``hbm_stream_sum`` once, and its ms ride the first ok health outcome
    (``prewarm_ms``). ``acquire`` gives the devices the worker probes
    (None: the probe's default). Best-effort: on failure the first health
    request warms up itself; a pre-warm that could not get device memory
    first drops what it allocated."""
    try:
        from gpu_feature_discovery_tpu_torch.lm.health import _acquire_devices

        devices = (acquire or _acquire_devices)()
        if not devices:
            return
        from gpu_feature_discovery_tpu_torch.ops.healthcheck import (
            is_busy_error,
            release_probe_memory,
            warm_probe_kernels_for,
        )

        with health_probe._chip_lock:
            try:
                health_probe.context_used = _context_used(devices)
                warm_ms = warm_probe_kernels_for(tuple(devices), per_chip=per_chip)
            except Exception as e:  # noqa: BLE001 - the device may be busy
                if not is_busy_error(e):
                    raise
                release_probe_memory(e)
                log.info("broker worker pre-warm skipped: a device is busy: %s", e)
                return
            # Under the lock: no probe can finish before it is recorded.
            health_probe.prewarm_ms = warm_ms
        log.info("broker worker pre-warmed probe kernels in %.0f ms", warm_ms)
    except Exception:  # noqa: BLE001 - warm-start is best-effort
        log.debug("broker kernel pre-warm failed:", exc_info=True)


def _context_used(devices) -> list:
    """Each CUDA device's used bytes (total - free) once this process has
    its context there: the card's other processes plus this context."""
    import torch

    used = []
    for device in devices:
        if device.type == "cuda":
            free, total = torch.cuda.mem_get_info(device)
            used.append(total - free)
    return used


def _worker_memory(health_probe: "_HealthProbe") -> dict:
    """The ``memory`` op: this worker's pid, the device memory its
    context's first sight found used, and per CUDA device the caching
    allocator's reserve and allocation. Never initialises CUDA."""
    torch = sys.modules.get("torch")
    devices = []
    if torch is not None and torch.cuda.is_initialized():
        devices = [{"index": i, "reserved_bytes": torch.cuda.memory_reserved(i),
                    "allocated_bytes": torch.cuda.memory_allocated(i)}
                   for i in range(torch.cuda.device_count())]
    return {"pid": os.getpid(), "context_used_bytes": health_probe.context_used,
            "devices": devices}


def _classic_devices(manager):
    """The devices a classic worker probes: every device CUDA lists, or,
    with a GPU in MIG mode, only those that are plain GPUs of the
    worker's inventory, None when there are none (each MIG device is
    probed in a pinned child of its own)."""
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.resource.probe_targets import probe_targets

    def acquire():
        devices = health._acquire_devices()
        targets = probe_targets(manager)
        if devices is None or targets is None:
            return devices
        return health.only_devices(devices, targets.plain_uuids) or None

    return acquire


def _child_main(req_r: int, resp_w: int, config, buf: bytes = b"",
                backend: Optional[str] = None) -> None:
    """The worker body: select + init the backend ONCE, report ready,
    then serve requests until EOF or a shutdown request. Never returns;
    every path leaves through os._exit. ``buf`` holds request bytes read
    past the first (config) frame. ``backend`` keys the worker to one
    registry token, whose provider it builds instead of the classic
    selection; only a gpu-family worker runs the burn-in."""
    from gpu_feature_discovery_tpu_torch.resource import factory, registry

    gpu_worker = backend is None or (
        registry.provider_for(backend).family == registry.FAMILY_GPU
    )
    acquire = None
    try:
        if backend is None:
            manager = factory.select_manager(config)
        else:
            manager = registry.select_backend_manager(config, backend)
        manager.init()
        if gpu_worker:
            acquire = _classic_devices(manager)
        if config.flags.tfd.with_burnin and gpu_worker:
            # The probe's imports (torch) belong to the spawn, under its
            # budget, not to the first health request's bounded wait.
            import gpu_feature_discovery_tpu_torch.ops.healthcheck  # noqa: F401
    except BaseException as e:  # noqa: BLE001 - shipped to the parent
        try:
            _write_frame(resp_w, {
                "status": "error", "error_type": type(e).__name__, "error": str(e),
            })
        except OSError:
            pass
        os._exit(1)
    _write_frame(resp_w, {"status": "ready"})

    # Serialises the devices between the pre-warm and health requests.
    chip_lock = threading.Lock()
    health_probe = _HealthProbe(chip_lock, acquire)
    if config.flags.tfd.with_burnin and gpu_worker:
        from gpu_feature_discovery_tpu_torch.lm.health import _chip_probe_opts

        threading.Thread(
            target=_child_prewarm,
            # The parent's resolution: --chip-probes=off must not warm the
            # per-device verdict pass.
            args=(health_probe, _chip_probe_opts(config)[0], acquire),
            name="tfd-broker-prewarm",
            daemon=True,
        ).start()

    while True:
        frame, buf = _child_read_request(req_r, buf)
        if frame is None:
            os._exit(0)  # the parent closed the pipe (or sent garbage)
        try:
            req = json.loads(frame.decode())
        except ValueError:
            os._exit(1)
        if req.get("hang"):
            # broker.hang: a wedged native call mid-request; only the
            # parent's SIGKILL at the deadline ends this.
            while True:
                time.sleep(3600)
        if req.get("crash"):
            # broker.crash: a real signal death mid-request, default
            # action first so the death is instant.
            signal.signal(signal.SIGSEGV, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGSEGV)
        op = req.get("op")
        try:
            if op == "ping":
                resp = {"status": "ok"}
            elif op == "snapshot":
                resp = {
                    "status": "ok",
                    "snapshot": DeviceSnapshot.from_manager(manager).to_dict(),
                }
            elif op == "health" and gpu_worker:
                resp = health_probe.request(req)
            elif op == "memory":
                resp = {"status": "ok", "memory": _worker_memory(health_probe)}
            elif op == "shutdown":
                try:
                    _write_frame(resp_w, {"status": "ok"})
                except OSError:
                    pass
                os._exit(0)
            else:
                resp = {
                    "status": "error",
                    "error_type": "BrokerError",
                    "error": f"unknown op {op!r}",
                }
        except BaseException as e:  # noqa: BLE001 - a transient op failure
            # must not kill the held backend; the parent decides whether
            # to degrade the cycle or recycle the worker.
            resp = {"status": "error", "error_type": type(e).__name__, "error": str(e)}
        try:
            _write_frame(resp_w, resp)
        except OSError:
            os._exit(0)


# ---------------------------------------------------------------------------
# the client (parent) side
# ---------------------------------------------------------------------------

class BrokerClient:
    """Parent-side handle on the broker worker. Requests are serialised
    under one lock (the engine's health thread and the run loop's
    snapshot refresh may overlap); ``kill_child`` takes only the pid lock
    so a deadline-escalation cancel can fire while a request is blocked
    mid-read."""

    def __init__(self, config, backend: Optional[str] = None):
        from gpu_feature_discovery_tpu_torch.config.flags import (
            DEFAULT_INIT_BACKOFF_MAX,
            DEFAULT_PROBE_TIMEOUT,
        )
        from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

        tfd = config.flags.tfd
        self._config = config
        self._backend = backend
        self._timeout_s = (
            tfd.probe_timeout if tfd.probe_timeout is not None else DEFAULT_PROBE_TIMEOUT
        )
        self._max_requests = tfd.broker_max_requests or 0
        backoff_cap = (
            tfd.init_backoff_max
            if tfd.init_backoff_max is not None
            else DEFAULT_INIT_BACKOFF_MAX
        )
        # Respawn pacing at HALF the supervisor's schedule, jitter off: a
        # supervisor-paced retry (jittered, at least 0.9x the raw delay)
        # always finds this window open, while an unpaced hot loop is
        # refused.
        self._policy = BackoffPolicy(
            base=min(1.0, backoff_cap) / 2.0, cap=backoff_cap / 2.0, jitter=0.0
        )
        self._lock = threading.Lock()       # serialises requests/spawn
        self._pid_lock = threading.Lock()   # pid + inflight flag only
        self._pid: Optional[int] = None
        # A worker mid-spawn (READY not seen yet): kill_child reaches it
        # too, since CUDA's set-up is a hang-prone step.
        self._spawning: Optional[int] = None
        self._req_w: Optional[int] = None
        self._reader: Optional[_FrameReader] = None
        self._resp_r: Optional[int] = None
        self._stderr_path: Optional[str] = None
        self._inflight = False
        self._served = 0
        self._spawn_failures = 0
        self._next_spawn = 0.0
        self._ever_spawned = False
        # The pid _kill SIGKILLed: its death is a kill, not a crash.
        self._cancel_killed: Optional[int] = None
        # Set by close(): a pre-spawn that loses the race against epoch
        # teardown must not start a worker nobody will close.
        self._closed = False

    # -- lifecycle --------------------------------------------------------

    @property
    def alive(self) -> bool:
        with self._pid_lock:
            return self._pid is not None

    @property
    def pid(self) -> Optional[int]:
        with self._pid_lock:
            return self._pid

    def _ensure_running(self) -> None:
        """Spawn the worker if none is live. Caller holds ``_lock``."""
        with self._pid_lock:
            if self._pid is not None:
                return
        self._spawn()

    def _spawn(self) -> None:
        from gpu_feature_discovery_tpu_torch.utils import faults

        now = time.monotonic()
        if now < self._next_spawn:
            raise BrokerError(
                f"broker respawn backing off for another "
                f"{self._next_spawn - now:.3f}s after "
                f"{self._spawn_failures} consecutive failure(s)"
            )
        # The spawn IS the backend acquisition: the pjrt_init site fires
        # here, once per worker lifetime; a rebuild that reuses the live
        # worker fires nothing.
        obs_metrics.BACKEND_INIT_ATTEMPTS.inc()
        try:
            faults.maybe_inject("pjrt_init")
            if faults.consume("probe.timeout"):
                raise BrokerTimeout(
                    f"injected fault at 'probe.timeout' "
                    f"({faults.FAULT_SPEC_ENV}): broker spawn treated as "
                    f"exceeding its {self._timeout_s:.1f}s budget"
                )
        except BaseException:
            self._spawn_failed(now)
            raise
        hang = faults.consume("probe.hang")
        segv = False if hang else faults.consume("probe.segv")

        stderr_file = tempfile.NamedTemporaryFile(
            prefix="tfd-broker-stderr-", delete=False
        )
        stderr_file.close()
        start = time.monotonic()
        pid, req_w, resp_r = probe.spawn_child("broker", stderr_file.name)
        # Registered like any probe child (kills go through the registry)
        # but exempt from the epoch-close sweep.
        probe._register(pid)
        probe.exempt_from_sweep(pid)
        with self._pid_lock:
            self._spawning = pid
        try:
            _write_frame(req_w, {
                "config": config_to_dict(self._config), "backend": self._backend,
                "hang": hang, "segv": segv,
                "providers": registry.child_provider_docs(),
            })
        except OSError:
            pass  # died already: the READY read sees EOF
        reader = _FrameReader(resp_r)
        try:
            frame = reader.read(start + self._timeout_s)
        except BrokerCrash:
            frame = b""
        finally:
            with self._pid_lock:
                self._spawning = None
        duration = time.monotonic() - start
        obs_metrics.PROBE_DURATION.observe(duration)

        def _fail_cleanup():
            os.close(req_w)
            os.close(resp_r)
            try:
                os.unlink(stderr_file.name)
            except OSError:
                pass
            self._spawn_failed(time.monotonic())

        if frame is None:
            # Deadline with no READY: hard-kill; waitpid decides whether it
            # had died to its own signal first.
            probe.kill_if_live(pid)
            status = self._reap(pid)
            tail = _stderr_tail(stderr_file.name)
            _fail_cleanup()
            if status is not None and os.WIFSIGNALED(status) and (
                os.WTERMSIG(status) != signal.SIGKILL
            ):
                obs_metrics.PROBE_CRASHES.inc()
                signame = signal.Signals(os.WTERMSIG(status)).name
                raise BrokerCrash(
                    f"broker worker died to {signame} during init after "
                    f"{duration:.2f}s"
                    + (f"; worker stderr tail:\n{tail}" if tail else "")
                )
            obs_metrics.PROBE_KILLS.inc()
            raise BrokerTimeout(
                f"broker worker init exceeded its {self._timeout_s:.1f}s "
                f"budget and was SIGKILLed after {duration:.1f}s"
                + (f"; worker stderr tail:\n{tail}" if tail else "")
            )
        if frame == b"":
            probe.kill_if_live(pid)
            status = self._reap(pid)
            tail = _stderr_tail(stderr_file.name)
            _fail_cleanup()
            if status is not None and os.WIFSIGNALED(status):
                self._count_signal_death(pid)
                signame = signal.Signals(os.WTERMSIG(status)).name
                raise BrokerCrash(
                    f"broker worker died to {signame} during init after "
                    f"{duration:.2f}s"
                    + (f"; worker stderr tail:\n{tail}" if tail else "")
                )
            raise BrokerError(
                "broker worker exited during init without reporting"
                + (f"; worker stderr tail:\n{tail}" if tail else "")
            )
        try:
            doc = _load_doc(frame)
        except ValueError:
            probe.kill_if_live(pid)
            self._reap(pid)
            _fail_cleanup()
            raise BrokerCrash("broker worker sent an unparseable ready frame")
        if doc.get("status") != "ready":
            self._reap(pid)
            _fail_cleanup()
            raise ResourceError(
                f"broker worker init failed: "
                f"{doc.get('error_type', 'Exception')}: {doc.get('error', '')}"
            )
        respawn = self._ever_spawned
        self._ever_spawned = True
        if respawn:
            obs_metrics.BROKER_RESPAWNS.inc()
        self._spawn_failures = 0
        self._next_spawn = 0.0
        self._served = 0
        with self._pid_lock:
            self._pid = pid
        self._req_w = req_w
        self._resp_r = resp_r
        self._reader = reader
        self._stderr_path = stderr_file.name
        obs_metrics.BROKER_UP.set(1)
        log.info(
            "broker worker %d ready in %.0f ms%s%s",
            pid,
            duration * 1e3,
            f" for backend {self._backend}" if self._backend else "",
            " (respawn)" if respawn else "",
        )
        watch_enabled, _ = _death_watch_state()
        if watch_enabled:
            threading.Thread(
                target=self._watch_worker,
                args=(pid,),
                name="tfd-broker-death-watch",
                daemon=True,
            ).start()

    def _count_signal_death(self, pid: int) -> None:
        """Count a worker that died to a signal: a kill when this process
        sent the SIGKILL (kill_child), a crash otherwise."""
        if pid == self._cancel_killed:
            return  # counted as a kill where it was sent
        obs_metrics.PROBE_CRASHES.inc()

    def _spawn_failed(self, now: float) -> None:
        self._spawn_failures += 1
        delay = self._policy.delay(min(self._spawn_failures - 1, 63))
        self._next_spawn = now + delay

    def _reap(self, pid: int) -> Optional[int]:
        """Discard-then-reap, the registry invariant: a pid leaves the
        kill-eligible set BEFORE waitpid can recycle it."""
        probe.unexempt_from_sweep(pid)
        probe._discard(pid)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                done, status = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                return None
            if done == pid:
                return status
            time.sleep(0.005)
        return None

    def _mark_dead(self) -> None:
        """Forget the worker after its death was observed (killed and
        reaped by the caller); closes the parent-side fds."""
        with self._pid_lock:
            self._pid = None
            self._inflight = False
        for fd in (self._req_w, self._resp_r):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._req_w = self._resp_r = None
        self._reader = None
        if self._stderr_path:
            try:
                os.unlink(self._stderr_path)
            except OSError:
                pass
        self._stderr_path = None
        obs_metrics.BROKER_UP.set(0)

    # -- death watch -------------------------------------------------------

    def _watch_worker(self, pid: int) -> None:
        """Block until the worker exits, leaving it reapable (WNOWAIT: the
        observing path keeps the reap and its status), then notice it."""
        try:
            os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT)
        except (ChildProcessError, OSError):
            pass
        self._notice_death(pid)

    def _notice_death(self, pid: int) -> None:
        """A worker exited UNCOMMANDED between requests: kill/reap through
        the registry, mark the client dead, so the respawn clock starts at
        death time. Serialised under the request lock: a death a request
        is observing concurrently (or a graceful close or recycle) wins,
        and this is a no-op."""
        with self._lock:
            with self._pid_lock:
                if self._pid != pid:
                    return
            probe.kill_if_live(pid)
            status = self._reap(pid)
            self._mark_dead()
            signame = ""
            if status is not None and os.WIFSIGNALED(status):
                self._count_signal_death(pid)
                signame = signal.Signals(os.WTERMSIG(status)).name
        log.warning(
            "broker worker %d died%s between requests; marked dead "
            "(respawn on next acquisition)",
            pid,
            f" to {signame}" if signame else "",
        )
        _, listener = _death_watch_state()
        if listener is not None:
            # Outside every broker lock: the listener posts into the
            # reconcile queue and must never deadlock a request.
            listener(signame)

    # -- the RPC ----------------------------------------------------------

    def request(
        self,
        op: str,
        timeout_s: Optional[float] = None,
        extra: Optional[dict] = None,
    ) -> dict:
        """One request/response round trip under the SIGKILL deadline.
        Raises BrokerTimeout (worker killed), BrokerCrash (worker died or
        framed garbage), or ResourceError (the op failed in the worker,
        which stays up)."""
        from gpu_feature_discovery_tpu_torch.utils import faults

        budget = timeout_s if timeout_s is not None else self._timeout_s
        with self._lock:
            self._ensure_running()
            payload = {"op": op}
            if extra:
                payload.update(extra)
            if faults.consume("broker.hang"):
                payload["hang"] = True
            elif faults.consume("broker.crash"):
                payload["crash"] = True
            pid = self.pid
            stderr_path = self._stderr_path
            start = time.monotonic()
            with self._pid_lock:
                self._inflight = True
            try:
                try:
                    _write_frame(self._req_w, payload)
                except OSError:
                    # EPIPE: the worker died between requests (a SIGTERM
                    # addressed to it); reap and report how.
                    probe.kill_if_live(pid)
                    status = self._reap(pid)
                    self._mark_dead()
                    if status is not None and os.WIFSIGNALED(status):
                        self._count_signal_death(pid)
                        signame = signal.Signals(os.WTERMSIG(status)).name
                        raise BrokerCrash(
                            f"broker worker died to {signame} before the "
                            f"{op!r} request"
                        )
                    raise BrokerCrash("broker worker pipe closed before the request")
                try:
                    frame = self._reader.read(start + budget)
                except BrokerCrash:
                    obs_metrics.BROKER_REQUEST_DURATION.observe(
                        time.monotonic() - start
                    )
                    probe.kill_if_live(pid)
                    self._reap(pid)
                    self._mark_dead()
                    raise
                duration = time.monotonic() - start
                # Every outcome that reached the worker lands in the
                # histogram, the deadline kills included.
                obs_metrics.BROKER_REQUEST_DURATION.observe(duration)
                if frame is None:
                    # Deadline: the request wedged. waitpid still decides:
                    # a worker that died to its OWN signal just before the
                    # deadline reports as a crash.
                    probe.kill_if_live(pid)
                    status = self._reap(pid)
                    tail = _stderr_tail(stderr_path or "")
                    self._mark_dead()
                    if status is not None and os.WIFSIGNALED(status) and (
                        os.WTERMSIG(status) != signal.SIGKILL
                    ):
                        obs_metrics.PROBE_CRASHES.inc()
                        signame = signal.Signals(os.WTERMSIG(status)).name
                        raise BrokerCrash(
                            f"broker worker died to {signame} during "
                            f"{op!r} after {duration:.2f}s"
                            + (f"; worker stderr tail:\n{tail}" if tail else "")
                        )
                    obs_metrics.PROBE_KILLS.inc()
                    raise BrokerTimeout(
                        f"broker {op!r} request exceeded its {budget:.1f}s "
                        f"budget; worker SIGKILLed after {duration:.1f}s"
                        + (f"; worker stderr tail:\n{tail}" if tail else "")
                    )
                if frame == b"":
                    # EOF: the worker exited (kill first so the reap is
                    # bounded).
                    probe.kill_if_live(pid)
                    status = self._reap(pid)
                    tail = _stderr_tail(stderr_path or "")
                    self._mark_dead()
                    if status is not None and os.WIFSIGNALED(status):
                        self._count_signal_death(pid)
                        signame = signal.Signals(os.WTERMSIG(status)).name
                        raise BrokerCrash(
                            f"broker worker died to {signame} during "
                            f"{op!r} after {duration:.2f}s"
                            + (f"; worker stderr tail:\n{tail}" if tail else "")
                        )
                    raise BrokerCrash(
                        f"broker worker closed the pipe during {op!r}"
                        + (f"; worker stderr tail:\n{tail}" if tail else "")
                    )
                try:
                    doc = _load_doc(frame)
                except ValueError:
                    probe.kill_if_live(pid)
                    self._reap(pid)
                    self._mark_dead()
                    raise BrokerCrash(
                        f"broker worker returned an unparseable {op!r} "
                        "response frame"
                    )
            finally:
                with self._pid_lock:
                    self._inflight = False
            obs_metrics.BROKER_REQUESTS.inc()
            self._served += 1
            if self._max_requests and self._served >= self._max_requests:
                # Proactive recycle OFF the failure path: close the aged
                # worker now; the next request respawns fresh.
                log.info(
                    "broker worker %s served %d requests "
                    "(--broker-max-requests); recycling",
                    pid,
                    self._served,
                )
                self._close_worker_locked()
            if doc.get("status") == "error":
                raise ResourceError(
                    f"broker {op!r} failed in worker: "
                    f"{doc.get('error_type', 'Exception')}: "
                    f"{doc.get('error', '')}"
                )
            return doc

    def snapshot(self) -> DeviceSnapshot:
        doc = self.request("snapshot")
        return DeviceSnapshot.from_dict(doc.get("snapshot") or {})

    def health(self, per_chip: bool = True, sick_chips=(), slow_chips=(),
               inventory_uuids=()) -> dict:
        """The burn-in probe, run in the worker; its outcome document
        (status ok | warming | unacquirable | probe-failed). The chip fault
        indices are consumed by the CALLER (the parent owns the fault
        registry) and ride the request, with the inventory's GPU UUIDs
        that say which device each index names."""
        extra: dict = {"per_chip": bool(per_chip), "wait_s": HEALTH_WAIT_S}
        if sick_chips:
            extra["sick_chips"] = [int(i) for i in sick_chips]
        if slow_chips:
            extra["slow_chips"] = [int(i) for i in slow_chips]
        if inventory_uuids:
            extra["inventory_uuids"] = [str(u) for u in inventory_uuids]
        return self.request("health", extra=extra)

    def ping(self) -> bool:
        return self.request("ping").get("status") == "ok"

    def memory(self) -> dict:
        """The worker's own memory report (``_worker_memory``)."""
        return self.request("memory").get("memory") or {}

    def kill_child(self) -> None:
        """The engine's cancel→kill hook (LabelSource.cancel): SIGKILL the
        worker when a broker-routed labeler misses its deadline. Fires
        only while a request is in flight (or a spawn is), so a cancel
        racing a completed request never kills a healthy idle worker.
        Takes only the pid lock."""
        with self._pid_lock:
            pid = self._pid if self._inflight else None
            if pid is None:
                pid = self._spawning
        if pid is None:
            return
        if self._kill(pid):
            log.warning("SIGKILLed broker worker %d (deadline escalation)", pid)

    def _kill(self, pid: int) -> bool:
        """SIGKILL a worker on this process's own decision (a cancel, an
        epoch close mid-spawn) and count it as a kill. The pid is noted
        first, so the path that reaps it does not also count a crash."""
        self._cancel_killed = pid
        if not probe.kill_if_live(pid):
            return False
        obs_metrics.PROBE_KILLS.inc()
        return True

    def _close_worker_locked(self) -> None:
        """Graceful worker shutdown; caller holds ``_lock``: the shutdown
        op, a short wait, then SIGKILL."""
        with self._pid_lock:
            pid = self._pid
        if pid is None:
            return
        try:
            _write_frame(self._req_w, {"op": "shutdown"})
            self._reader.read(time.monotonic() + GRACEFUL_CLOSE_S)
        except (OSError, BrokerCrash):
            pass
        try:
            os.close(self._req_w)  # EOF as well
        except OSError:
            pass
        self._req_w = None
        # Out of the registry BEFORE the reap. From here close is the
        # pid's only owner (it holds the request lock, kill_child is
        # gated off), so the direct SIGKILL below cannot hit a recycled
        # pid: the pid stays ours until we waitpid it.
        probe._discard(pid)
        probe.unexempt_from_sweep(pid)
        deadline = time.monotonic() + GRACEFUL_CLOSE_S
        reaped = False
        while time.monotonic() < deadline:
            try:
                done, _status = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                reaped = True
                break
            if done == pid:
                reaped = True
                break
            time.sleep(0.005)
        if not reaped:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass
        self._mark_dead()

    def prespawn(self) -> None:
        """Start the worker without a request, so epoch start-up overlaps
        the spawn (torch's import, CUDA's set-up, the pre-warm) with
        serving the restored labels. Failures are swallowed: the first
        cycle's acquisition retries under the supervisor."""
        try:
            with self._lock:
                if self._closed:
                    return
                self._ensure_running()
        except BaseException:  # noqa: BLE001 - supervision owns failures
            log.debug("broker pre-spawn failed (the first cycle retries "
                      "under supervision):", exc_info=True)

    def close(self) -> None:
        """Retire the broker: graceful shutdown, SIGKILL fallback, reap.
        Idempotent. A worker still MID-SPAWN is SIGKILLed first, so
        teardown never waits out the whole spawn budget behind a wedged
        CUDA set-up; an in-flight REQUEST is waited for."""
        with self._pid_lock:
            spawning = self._spawning
        if spawning is not None:
            self._kill(spawning)
        with self._lock:
            self._closed = True
            self._close_worker_locked()


class BrokerManager(SnapshotManager):
    """The Manager the daemon labels through with the broker on: the
    SnapshotManager contract, except that ``init()`` (called at the top
    of every cycle by new_label_sources) refreshes the snapshot with one
    ``snapshot`` RPC, so every cycle labels a fresh enumeration."""

    def __init__(self, client: BrokerClient):
        self.broker = client
        super().__init__(client.snapshot())

    def init(self) -> None:
        snapshot = self.broker.snapshot()
        self._snapshot = snapshot
        self._chips = [SnapshotChip(c) for c in snapshot.chips]

    def shutdown(self) -> None:
        pass  # the worker holds the backend; close_broker retires it


# ---------------------------------------------------------------------------
# mode resolution + the per-epoch active broker
# ---------------------------------------------------------------------------

def broker_mode(config) -> str:
    """Resolve ``--probe-broker`` to on|off: ``auto`` (the default) is on
    for the supervised daemon and off for oneshot."""
    tfd = config.flags.tfd
    mode = tfd.probe_broker or "auto"
    if mode != "auto":
        return mode
    return "off" if tfd.oneshot else "on"


def broker_enabled(config) -> bool:
    """True when acquisitions go through the broker: broker mode on AND
    the sandbox active (``isolation_mode`` == subprocess)."""
    from gpu_feature_discovery_tpu_torch.sandbox.probe import isolation_mode

    return broker_mode(config) == "on" and isolation_mode(config) == "subprocess"


_active_lock = threading.Lock()
# The classic path's client, one per config epoch.
_active: Optional[BrokerClient] = None
# The registry cycle's clients, one per backend token and epoch.
_keyed: Dict[str, BrokerClient] = {}


def get_broker(config, backend: Optional[str] = None) -> BrokerClient:
    """The process's active broker client for one backend key (None: the
    classic path's), created on first use; close_broker retires them all
    at the epoch's end."""
    global _active
    with _active_lock:
        if backend is None:
            if _active is None:
                _active = BrokerClient(config)
            return _active
        client = _keyed.get(backend)
        if client is None:
            client = _keyed[backend] = BrokerClient(config, backend=backend)
        return client


def close_broker() -> None:
    """Epoch teardown: gracefully retire every active broker, if any. Runs
    BEFORE the stray-child sweep in run()'s teardown."""
    global _active
    with _active_lock:
        clients = [c for c in (_active, *_keyed.values()) if c is not None]
        _active = None
        _keyed.clear()
    for client in clients:
        client.close()


def prespawn_broker(config, backend: Optional[str] = None) -> threading.Thread:
    """Start the worker's spawn on a background thread (cmd/main.run's
    cold-start overlap). Only while fault injection is inactive: a
    pre-spawn would consume an injected shot outside the supervisor's
    paced accounting."""
    client = get_broker(config, backend=backend)
    thread = threading.Thread(
        target=client.prespawn, name="tfd-broker-prespawn", daemon=True
    )
    thread.start()
    return thread


def acquire_broker_manager(config, backend: Optional[str] = None) -> Manager:
    """The broker-path acquisition unit (resource/factory.build_manager,
    and per token resource/registry.BackendRuntime): ensure the keyed
    worker is up (the spawn is the one backend init) and wrap a fresh
    snapshot. With a live worker this is one RPC."""
    return BrokerManager(get_broker(config, backend=backend))
