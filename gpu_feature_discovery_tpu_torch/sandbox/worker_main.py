"""Entry module of every sandbox child process (sandbox/probe.py
``spawn_child``): ``python -m gpu_feature_discovery_tpu_torch.sandbox.worker_main
probe|broker``.

The child is a fresh interpreter: no CUDA context, no lock state and no
signal handlers of the parent. It reads its first frame on
CHILD_REQUEST_FD: the config, the backend token it is keyed to (None on
the classic path), the parent-consumed chaos behaviours (``hang``,
``segv``) and, for a probe child, the named op. Then:

- ``probe``: run the op (PROBE_OPS), answer one frame on
  CHILD_RESPONSE_FD, exit;
- ``broker``: become the persistent worker (sandbox/broker.py
  ``_child_main``).

Every path leaves through ``os._exit``. Stdout and stderr go to the file
the parent tails for a crash report.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import time

from gpu_feature_discovery_tpu_torch.config.spec import config_from_dict
from gpu_feature_discovery_tpu_torch.sandbox.broker import (
    _child_main,
    _child_read_request,
)
from gpu_feature_discovery_tpu_torch.sandbox.probe import (
    CHILD_REQUEST_FD,
    CHILD_RESPONSE_FD,
    _write_frame,
)
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging


def _select_and_snapshot(config, backend=None) -> dict:
    """Select the backend the config names (or the registry token the
    child is keyed to), init it, walk its inventory. A fresh interpreter
    cannot receive a live manager, so the twin's two probe callables (init
    a given manager; select, then init) are one function here under both
    names."""
    from gpu_feature_discovery_tpu_torch.resource import factory, registry

    if backend is None:
        manager = factory.select_manager(config)
    else:
        manager = registry.select_backend_manager(config, backend)
    manager.init()
    return DeviceSnapshot.from_manager(manager).to_dict()


PROBE_OPS = {
    "snapshot": _select_and_snapshot,
    "select+snapshot": _select_and_snapshot,
}


def _probe_main(op: str, config, backend=None) -> None:
    try:
        payload = PROBE_OPS[op](config, backend)
        data = {"status": "ok", "payload": payload}
    except BaseException as e:  # noqa: BLE001 - shipped to the parent
        data = {"status": "error", "error_type": type(e).__name__, "error": str(e)}
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
        if doc.get("hang"):
            # probe.hang: a wedged native call; only the parent's SIGKILL
            # at the deadline ends this.
            while True:
                time.sleep(3600)
        if doc.get("segv"):
            # probe.segv: a real signal death, default action first so the
            # faulthandler dump cannot delay it.
            signal.signal(signal.SIGSEGV, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGSEGV)
        config = config_from_dict(doc["config"])
        backend = doc.get("backend")
        if role == "probe":
            _probe_main(doc["op"], config, backend)
        _child_main(CHILD_REQUEST_FD, CHILD_RESPONSE_FD, config, buf, backend)
    finally:
        os._exit(1)


if __name__ == "__main__":
    main()
