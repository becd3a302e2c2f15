"""Probe sandbox: process-isolated device probing, persisted label state
and anti-flap hysteresis (twin: ``gpu_feature_discovery_tpu/sandbox/``).

A wedged or crashing native call (the CUDA driver, a faulting device)
cannot be interrupted from Python and takes the whole process with it.
This package moves the device-touching work into killable child
processes:

- ``probe``    — spawn/kill/reap machinery and the sandboxed snapshot
                 probe the supervised daemon acquires its backend through
                 (``--probe-broker=off``).
- ``broker``   — the persistent probe broker (``--probe-broker``, on for
                 the daemon by default): one long-lived worker holds the
                 CUDA devices and serves snapshot and health (burn-in)
                 requests over a pipe.
- ``snapshot`` — the serialisable inventory a child ships back, and the
                 ``SnapshotManager`` that serves it to the labelers.
- ``worker_main`` — the entry module of every child (a fresh
                 interpreter, never a fork).
- ``state``    — persisted last-good labels (``--state-dir``).
- ``flap``     — anti-flap hysteresis (``--flap-window``).

``SandboxedCall`` (``probe``) runs an importable callable in a probe
child and SIGKILLs it on ``cancel()``: the seam behind
``LabelSource.cancel`` for a source whose blocking work runs there.

The names below resolve on first use (PEP 562): a probe child imports
``sandbox.worker_main`` and must not pay for the broker it never runs.
"""

import importlib

_EXPORTS = {
    "broker": (
        "BrokerClient",
        "BrokerCrash",
        "BrokerError",
        "BrokerManager",
        "BrokerTimeout",
        "acquire_broker_manager",
        "broker_enabled",
        "broker_mode",
        "close_broker",
        "get_broker",
        "prespawn_broker",
        "set_broker_death_watch",
    ),
    "flap": ("FLAPPING_LABEL", "FlapDamper"),
    "probe": (
        "ProbeCrash",
        "ProbeError",
        "ProbeTimeout",
        "SandboxedCall",
        "acquire_snapshot_manager",
        "isolation_mode",
        "kill_stray_children",
        "probe_device_snapshot",
        "run_probe",
    ),
    "snapshot": ("DeviceSnapshot", "SnapshotManager"),
    "state": ("LabelStateStore",),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = list(_HOME)


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = globals()[name] = getattr(
        importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME))
