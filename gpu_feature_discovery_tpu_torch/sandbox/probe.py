"""Probe children with a hard wall-clock budget enforced by SIGKILL (twin:
``gpu_feature_discovery_tpu/sandbox/probe.py``).

The contract every caller gets:

- The probing runs in a child process; a hang in native code (the CUDA
  driver, a wedged device) wedges ONLY the child. At the
  ``--probe-timeout`` deadline the parent SIGKILLs it: a thread blocked
  inside a C extension never services a Python-level signal.
- A child that dies to a signal surfaces as ``ProbeCrash`` with the
  signal's name and the tail of the child's captured stderr.
- Every child is reaped on every exit path. Children that outlive their
  caller are in a module-level registry and ``kill_stray_children()``
  kills them at epoch end (cmd/main.run's teardown).

Both probe errors subclass ``ResourceError``, so the supervisor treats a
hang or a crash as one more retryable backend-init failure: degraded
labels and backoff, never a fall back to probing in process.

Where the port departs from the twin: the twin forks and runs Python in
the child. A CUDA context does not survive ``fork``, and several parents
have one before they spawn a child (an embedding caller, the smoke
script, the in-process burn-in of ``--probe-broker=off``). So every child
here is a FRESH interpreter, started with ``os.posix_spawn`` running
``sandbox/worker_main.py``: the config goes over the request pipe as the
first frame, and the twin's callables become named ops (``snapshot``,
``select+snapshot``). Raw pids stay, so the registry, the
kill-before-reap discipline and the wait-status classification are the
twin's; ``subprocess.Popen`` would reap behind the registry's back. An
exec'd child starts with default signal handlers and without
``TFD_FAULT_SPEC`` in its environment.

Chaos sites (``TFD_FAULT_SPEC``, utils/faults.py), consumed in the
PARENT and enacted in the child:

    probe.timeout   the probe reports a timeout at once; no child spawned
    probe.hang      the child sleeps until the parent's SIGKILL
    probe.segv      the child raises SIGSEGV on itself
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import select
import signal
import struct
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Set, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import config_to_dict
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource.types import Manager, ResourceError
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import (
    DeviceSnapshot,
    SnapshotManager,
)
from gpu_feature_discovery_tpu_torch.utils.faults import FAULT_SPEC_ENV

log = logging.getLogger("tfd.sandbox")

# How much of the child's captured stderr a crash/error report carries.
STDERR_TAIL_BYTES = 8192

# Length-prefix framing of every pipe: a partial frame (the child died
# mid-write) is detected instead of parsed.
_LEN = struct.Struct(">I")

# The child's ends of its two pipes sit at these descriptors
# (sandbox/worker_main.py reads requests on one, answers on the other).
CHILD_REQUEST_FD = 3
CHILD_RESPONSE_FD = 4
_WORKER_MODULE = "gpu_feature_discovery_tpu_torch.sandbox.worker_main"
# The directory holding the package: the child finds it whatever its
# working directory.
_IMPORT_ROOT = str(Path(__file__).resolve().parents[2])
# Signals the child must take with their default action (a group SIGTERM
# kills the worker instead of queueing on an inherited handler).
_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP, signal.SIGQUIT)

# Probe children still alive (pid set). Registration ends before the
# owner reaps; kill_stray_children sweeps what is left.
_live_lock = threading.Lock()
_live_children: Set[int] = set()

# Registered pids the epoch-close sweep must NOT kill: the persistent
# broker worker registers for the kill discipline but outlives single
# acquisitions; close_broker() retires it gracefully in run()'s teardown,
# and a sweep SIGKILL would read as a crash and provoke a respawn storm
# on every SIGHUP reload.
_sweep_exempt: Set[int] = set()


def exempt_from_sweep(pid: int) -> None:
    """Shield a registered pid from kill_stray_children (broker worker)."""
    with _live_lock:
        _sweep_exempt.add(pid)


def unexempt_from_sweep(pid: int) -> None:
    with _live_lock:
        _sweep_exempt.discard(pid)


class ProbeError(ResourceError):
    """Base: the sandboxed probe did not produce a snapshot."""


class ProbeTimeout(ProbeError):
    """The child exceeded the wall-clock budget and was SIGKILLed."""


class ProbeCrash(ProbeError):
    """The child died to a signal (native SIGSEGV et al.)."""


@dataclass
class ProbeResult:
    """What one child run produced. ``status`` is ok | timeout | crash |
    error; exactly one of payload / error detail is meaningful."""

    status: str
    duration_s: float
    payload: Optional[dict] = None
    error_type: str = ""
    error: str = ""
    term_signal: Optional[int] = None
    stderr_tail: str = ""


def _register(pid: int) -> None:
    with _live_lock:
        _live_children.add(pid)


def _discard(pid: int) -> None:
    """Withdraw a pid from the kill-eligible set. MUST happen before the
    owner's waitpid: a pid is recyclable only once reaped, so "kills
    target registered pids only, registration ends before reaping" means
    no SIGKILL can land on a recycled pid that names another process."""
    with _live_lock:
        _live_children.discard(pid)


def kill_if_live(pid: int) -> bool:
    """SIGKILL ``pid`` iff it is still a registered (unreaped) child; the
    registry lock serialises against the owner's pre-reap discard."""
    with _live_lock:
        if pid not in _live_children:
            return False
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            return False
        return True


def kill_stray_children() -> int:
    """SIGKILL and reap every registered child except the sweep-exempt
    broker worker; called at epoch end so a SIGHUP reload orphans no
    probing child and leaks no zombie. Returns how many were killed."""
    killed = 0
    with _live_lock:
        for pid in sorted(_live_children):
            if pid in _sweep_exempt:
                continue
            if _kill_and_reap(pid):
                killed += 1
        _live_children.intersection_update(_sweep_exempt)
    if killed:
        log.warning("killed %d stray probe child(ren) at epoch end", killed)
    return killed


def _kill_and_reap(pid: int) -> bool:
    """SIGKILL and a bounded reap of one REGISTERED child (the caller holds
    the registry lock). True when the child was still alive to kill."""
    alive = False
    try:
        os.kill(pid, signal.SIGKILL)
        alive = True
    except OSError:
        pass
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        try:
            done, _ = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            return alive
        if done == pid:
            return alive
        time.sleep(0.005)
    return alive


def _above(fd: int, floor: int = 10) -> int:
    """``fd`` moved to a descriptor >= ``floor`` (close-on-exec), so the
    spawn's dup2 actions onto 0-4 can never overwrite a source."""
    high = fcntl.fcntl(fd, fcntl.F_DUPFD_CLOEXEC, floor)
    os.close(fd)
    return high


def spawn_child(role: str, stderr_path: str) -> Tuple[int, int, int]:
    """Start ``python -m ...sandbox.worker_main <role>`` as a fresh
    process: requests on its CHILD_REQUEST_FD, answers on its
    CHILD_RESPONSE_FD, stdout and stderr into ``stderr_path``, stdin from
    /dev/null. Returns ``(pid, request_write_fd, response_read_fd)``, the
    parent's ends. The child does not inherit the fault spec."""
    req_r, req_w = os.pipe()
    resp_r, resp_w = os.pipe()
    child_in, child_out = _above(req_r), _above(resp_w)
    err = _above(os.open(stderr_path, os.O_WRONLY | os.O_APPEND | os.O_CLOEXEC))
    env = dict(os.environ)
    env.pop(FAULT_SPEC_ENV, None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_IMPORT_ROOT, env.get("PYTHONPATH")) if p
    )
    try:
        pid = os.posix_spawn(
            sys.executable,
            [sys.executable, "-m", _WORKER_MODULE, role],
            env,
            file_actions=[
                (os.POSIX_SPAWN_DUP2, child_in, CHILD_REQUEST_FD),
                (os.POSIX_SPAWN_DUP2, child_out, CHILD_RESPONSE_FD),
                (os.POSIX_SPAWN_OPEN, 0, os.devnull, os.O_RDONLY, 0),
                (os.POSIX_SPAWN_DUP2, err, 1),
                (os.POSIX_SPAWN_DUP2, err, 2),
            ],
            setsigmask=(),
            setsigdef=_DEFAULT_SIGNALS,
        )
    except BaseException:
        for fd in (req_w, resp_r):
            os.close(fd)
        raise
    finally:
        for fd in (child_in, child_out, err):
            os.close(fd)
    return pid, req_w, resp_r


def _write_frame(fd: int, doc: dict) -> None:
    data = json.dumps(doc).encode()
    os.write(fd, _LEN.pack(len(data)) + data)


def run_probe(
    op: str,
    config,
    timeout_s: float,
    hang: bool = False,
    segv: bool = False,
    pid_box: Optional[list] = None,
    backend: Optional[str] = None,
) -> ProbeResult:
    """Run the named ``op`` (sandbox/worker_main.py PROBE_OPS) in a child
    under a hard deadline; the op returns a JSON-serialisable dict.
    ``hang``/``segv`` are the chaos behaviours (consumed by the caller,
    enacted in the child). ``pid_box``, when given, receives the child pid
    at spawn so a canceller can SIGKILL it mid-flight. ``backend`` keys
    the child to one registry token (None: the classic selection)."""
    stderr_file = tempfile.NamedTemporaryFile(prefix="tfd-probe-stderr-", delete=False)
    stderr_file.close()
    start = time.monotonic()
    pid, req_w, r_fd = spawn_child("probe", stderr_file.name)
    _register(pid)
    if pid_box is not None:
        pid_box.append(pid)
    try:
        try:
            _write_frame(req_w, {
                "op": op, "config": config_to_dict(config), "backend": backend,
                "hang": hang, "segv": segv,
            })
        except OSError:
            pass  # the child is already gone; its EOF tells how below
        finally:
            os.close(req_w)
        frame = _read_frame(r_fd, start + timeout_s)
        duration = time.monotonic() - start
        if frame is None:
            # Deadline with no complete frame: hard-kill. The child may
            # ALSO be dead already (a crash); waitpid decides. Through
            # kill_if_live: the epoch-close sweep may have reaped the pid.
            kill_if_live(pid)
            _discard(pid)
            status = _reap(pid)
            tail = _stderr_tail(stderr_file.name)
            if status is not None and os.WIFSIGNALED(status) and (
                os.WTERMSIG(status) != signal.SIGKILL
            ):
                return ProbeResult(status="crash", duration_s=duration,
                                   term_signal=os.WTERMSIG(status),
                                   stderr_tail=tail)
            return ProbeResult(status="timeout", duration_s=duration,
                               stderr_tail=tail)
        _discard(pid)
        status = _reap(pid)
        duration = time.monotonic() - start
        if frame == b"":
            # EOF without a frame: a crash if a signal killed the child,
            # an error otherwise.
            tail = _stderr_tail(stderr_file.name)
            if status is not None and os.WIFSIGNALED(status):
                return ProbeResult(status="crash", duration_s=duration,
                                   term_signal=os.WTERMSIG(status),
                                   stderr_tail=tail)
            return ProbeResult(
                status="error", duration_s=duration, error_type="ProbeError",
                error="probe child exited without reporting a result",
                stderr_tail=tail,
            )
        try:
            doc = json.loads(frame.decode())
        except ValueError:
            return ProbeResult(
                status="error", duration_s=duration, error_type="ProbeError",
                error="probe child returned an unparseable result frame",
                stderr_tail=_stderr_tail(stderr_file.name),
            )
        if doc.get("status") == "ok":
            return ProbeResult(status="ok", duration_s=duration,
                               payload=doc.get("payload"))
        return ProbeResult(
            status="error", duration_s=duration,
            error_type=str(doc.get("error_type", "Exception")),
            error=str(doc.get("error", "")),
            stderr_tail=_stderr_tail(stderr_file.name),
        )
    finally:
        _discard(pid)
        os.close(r_fd)
        try:
            os.unlink(stderr_file.name)
        except OSError:
            pass


def _read_frame(r_fd: int, deadline: float) -> Optional[bytes]:
    """One length-prefixed frame from the pipe by ``deadline``: the body,
    b"" on EOF before a whole frame, None when the deadline came first."""
    buf = b""
    want: Optional[int] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        try:
            ready, _, _ = select.select([r_fd], [], [], remaining)
        except InterruptedError:
            continue
        if not ready:
            return None
        chunk = os.read(r_fd, 65536)
        if not chunk:
            return b""
        buf += chunk
        if want is None and len(buf) >= _LEN.size:
            want = _LEN.unpack_from(buf)[0]
        if want is not None and len(buf) >= _LEN.size + want:
            return buf[_LEN.size:_LEN.size + want]


def _reap(pid: int) -> Optional[int]:
    """Blocking waitpid; None when someone else got there first. A
    SIGKILLed or exiting child ends promptly, so the block is bounded."""
    try:
        _, status = os.waitpid(pid, 0)
        return status
    except ChildProcessError:
        return None


def _stderr_tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - STDERR_TAIL_BYTES))
            return f.read().decode(errors="replace").strip()
    except OSError:
        return ""


# ---------------------------------------------------------------------------
# the snapshot probe: what the supervised daemon acquires its backend with
# ---------------------------------------------------------------------------

def probe_device_snapshot(config, timeout_s: float,
                          backend: Optional[str] = None) -> DeviceSnapshot:
    """Initialise the backend the config names and walk its inventory
    INSIDE a child; the reconstructed snapshot in the parent. The twin
    passes a live manager; a fresh interpreter receives the config and
    builds the same manager from its ``--backends`` token (or from
    ``backend``, a registry token)."""
    return _run_snapshot_probe("snapshot", config, timeout_s, backend)


def acquire_snapshot_manager(config, timeout_s: float,
                             backend: Optional[str] = None) -> Manager:
    """The supervised daemon's sandboxed acquisition unit: backend
    selection + init + enumeration inside one child, a SnapshotManager
    over the result in the parent. The ``pjrt_init`` fault site fires
    here, in the parent, where its countdown lives, and so does the
    init-attempt metric, in the registry this process serves."""
    from gpu_feature_discovery_tpu_torch.utils import faults

    obs_metrics.BACKEND_INIT_ATTEMPTS.inc()
    faults.maybe_inject("pjrt_init")
    return SnapshotManager(
        _run_snapshot_probe("select+snapshot", config, timeout_s, backend)
    )


def _run_snapshot_probe(op: str, config, timeout_s: float,
                        backend: Optional[str] = None) -> DeviceSnapshot:
    from gpu_feature_discovery_tpu_torch.utils import faults

    if faults.consume("probe.timeout"):
        # No child was spawned, so no kill and no duration is recorded.
        raise ProbeTimeout(
            f"injected fault at 'probe.timeout' ({faults.FAULT_SPEC_ENV}): "
            f"probe treated as exceeding its {timeout_s:.1f}s budget"
        )
    # At most ONE behaviour per probe: with several sites armed they fire
    # on successive probes, each exercising its own containment path.
    hang = faults.consume("probe.hang")
    segv = False if hang else faults.consume("probe.segv")

    result = run_probe(op, config, timeout_s, hang=hang, segv=segv, backend=backend)
    obs_metrics.PROBE_DURATION.observe(result.duration_s)
    if result.status == "ok":
        return DeviceSnapshot.from_dict(result.payload or {})
    if result.status == "timeout":
        obs_metrics.PROBE_KILLS.inc()
        raise ProbeTimeout(
            f"device probe exceeded its {timeout_s:.1f}s budget and was "
            f"SIGKILLed after {result.duration_s:.1f}s"
            + (f"; child stderr tail:\n{result.stderr_tail}"
               if result.stderr_tail else "")
        )
    if result.status == "crash":
        obs_metrics.PROBE_CRASHES.inc()
        signame = signal.Signals(result.term_signal).name \
            if result.term_signal is not None else "?"
        raise ProbeCrash(
            f"device probe child died to {signame} after "
            f"{result.duration_s:.2f}s"
            + (f"; child stderr tail:\n{result.stderr_tail}"
               if result.stderr_tail else "")
        )
    raise ResourceError(
        f"device probe failed in child: {result.error_type}: {result.error}"
    )


def isolation_mode(config) -> str:
    """Resolve ``--probe-isolation``: ``auto`` (the default) is subprocess
    for the supervised daemon and none for oneshot. Under
    ``--with-burnin`` the probe needs devices resident in the process
    that runs it; with the persistent broker on (the daemon default) the
    broker WORKER is that process, so auto stays subprocess. Only with
    the broker off does auto fall back to none under burn-in. An explicit
    ``--probe-isolation`` always wins."""
    tfd = config.flags.tfd
    mode = tfd.probe_isolation or "auto"
    if mode != "auto":
        return mode
    if tfd.oneshot:
        return "none"
    if tfd.with_burnin:
        from gpu_feature_discovery_tpu_torch.sandbox.broker import broker_mode

        if broker_mode(config) != "on":
            return "none"
    return "subprocess"
