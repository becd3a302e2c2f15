"""Entry module of every sandbox child process (sandbox/probe.py
``spawn_child``): ``python -m gpu_feature_discovery_tpu_torch.sandbox.worker_main
probe|broker``.

The child is a fresh interpreter: no CUDA context, no lock state and no
signal handlers of the parent. It reads its first frame on
CHILD_REQUEST_FD: the config, the backend token it is keyed to (None on
the classic path), the providers an embedder registered in the parent,
the parent-consumed chaos behaviours (``hang``, ``segv``) and, for a
probe child, the named op. Then:

- ``probe``: run the op (PROBE_OPS; ``call`` imports and calls a
  ``SandboxedCall``'s function), answer one frame on
  CHILD_RESPONSE_FD, exit. A chaos behaviour is enacted once the op has
  run and before the answer, so the hung or crashing child holds what
  the op loaded (on a GPU node the select+snapshot op loads the CUDA
  driver and NVML, though it creates no context), as a wedged or
  crashing driver call would;
- ``broker``: become the persistent worker (sandbox/broker.py
  ``_child_main``); a chaos behaviour is enacted before it starts.

A probe child pinned to a MIG device (its ``CUDA_VISIBLE_DEVICES``
names the device's UUID) runs the ``health`` op on that one device. An
op that could not get device memory answers ``busy``, not ``error``:
the device is held by a workload, not sick.

Every path leaves through ``os._exit``. Stdout and stderr go to the file
the parent tails for a crash report. A probe child imports what its op
needs and no more (not the broker): its start counts against the
``--probe-timeout`` budget, where the twin's forked child starts at once.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import time

from gpu_feature_discovery_tpu_torch.config.spec import config_from_dict
from gpu_feature_discovery_tpu_torch.sandbox.probe import (
    CHILD_REQUEST_FD,
    CHILD_RESPONSE_FD,
    _child_read_request,
    _write_frame,
)
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging


def _select_and_snapshot(config, doc: dict) -> dict:
    """Select the backend the config names (or the registry token the
    child is keyed to), init it, walk its inventory. A fresh interpreter
    cannot receive a live manager, so the twin's two probe callables (init
    a given manager; select, then init) are one function here under both
    names."""
    from gpu_feature_discovery_tpu_torch.resource import factory, registry

    backend = doc.get("backend")
    if backend is None:
        manager = factory.select_manager(config)
    else:
        manager = registry.select_backend_manager(config, backend)
    manager.init()
    return DeviceSnapshot.from_manager(manager).to_dict()


def _pinned_health(config, doc: dict) -> dict:
    """One burn-in probe of the one device this child sees (pinned to a
    MIG device by ``CUDA_VISIBLE_DEVICES``): the in-process health
    labeler's MIG probe, which one process cannot run for a second MIG
    device. The report of ``measure_node_health`` at the twin's
    geometry."""
    from gpu_feature_discovery_tpu_torch.lm.health import pinned_devices
    from gpu_feature_discovery_tpu_torch.ops.healthcheck import measure_node_health
    from gpu_feature_discovery_tpu_torch.sandbox.broker import health_options

    devices = pinned_devices()
    if devices is None:
        # The pin did not hold (CUDA lists no device): a fault, not busy.
        raise RuntimeError("the pinned device is not acquirable")
    return measure_node_health(devices=devices, **health_options(doc.get("request") or {}))


def _call(config, doc: dict) -> dict:
    """A ``SandboxedCall``'s function, imported by its ``module:qualname``
    and called with no arguments."""
    import importlib

    module, _, qualname = doc["request"]["target"].partition(":")
    fn = importlib.import_module(module)
    for part in qualname.split("."):
        fn = getattr(fn, part)
    return fn()


PROBE_OPS = {
    "snapshot": _select_and_snapshot,
    "select+snapshot": _select_and_snapshot,
    "health": _pinned_health,
    "call": _call,
}


def _enact_chaos(doc: dict) -> None:
    if doc.get("hang"):
        # probe.hang: a wedged native call; only the parent's SIGKILL at
        # the deadline ends this.
        while True:
            time.sleep(3600)
    if doc.get("segv"):
        # probe.segv: a real signal death, default action first so the
        # faulthandler dump cannot delay it.
        signal.signal(signal.SIGSEGV, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGSEGV)


def _probe_main(doc: dict, config) -> None:
    try:
        payload = PROBE_OPS[doc["op"]](config, doc)
        data = {"status": "ok", "payload": payload}
    except BaseException as e:  # noqa: BLE001 - shipped to the parent
        busy = False
        if "torch" in sys.modules:
            # Only an op that loaded torch can have met a busy device (a
            # cpu-family child never imports it).
            from gpu_feature_discovery_tpu_torch.ops.healthcheck import is_busy_error

            busy = is_busy_error(e)
        data = {"status": "busy" if busy else "error",
                "error_type": type(e).__name__, "error": str(e)}
    _enact_chaos(doc)
    try:
        _write_frame(CHILD_RESPONSE_FD, data)
    except OSError:
        pass
    os._exit(0)


def main() -> None:
    try:
        role = sys.argv[1]
        tfd_logging.setup()
        faulthandler.enable(file=sys.stderr, all_threads=False)
        first, buf = _child_read_request(CHILD_REQUEST_FD, b"")
        if first is None:
            os._exit(1)
        doc = json.loads(first.decode())
        if doc.get("providers"):
            # An embedder's providers, as the twin's forked child inherits them.
            from gpu_feature_discovery_tpu_torch.resource.registry import install_provider_docs

            install_provider_docs(doc["providers"])
        config = None if doc["config"] is None else config_from_dict(doc["config"])
        if role == "probe":
            _probe_main(doc, config)
        _enact_chaos(doc)
        from gpu_feature_discovery_tpu_torch.sandbox.broker import _child_main

        _child_main(CHILD_REQUEST_FD, CHILD_RESPONSE_FD, config, buf,
                    doc.get("backend"), started_ns=doc.get("spawn_ns"))
    finally:
        os._exit(1)


if __name__ == "__main__":
    main()
