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

The twin's ``SandboxedCall`` (a generic killable callable for engine
sources) has no counterpart: a fresh interpreter cannot run a closure,
and no source of this port needs it; the broker-routed health source
cancels through ``BrokerClient.kill_child``.
"""

from gpu_feature_discovery_tpu_torch.sandbox.broker import (
    BrokerClient,
    BrokerCrash,
    BrokerError,
    BrokerManager,
    BrokerTimeout,
    acquire_broker_manager,
    broker_enabled,
    broker_mode,
    close_broker,
    get_broker,
    prespawn_broker,
    set_broker_death_watch,
)
from gpu_feature_discovery_tpu_torch.sandbox.flap import FLAPPING_LABEL, FlapDamper
from gpu_feature_discovery_tpu_torch.sandbox.probe import (
    ProbeCrash,
    ProbeError,
    ProbeTimeout,
    acquire_snapshot_manager,
    isolation_mode,
    kill_stray_children,
    probe_device_snapshot,
    run_probe,
)
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import (
    DeviceSnapshot,
    SnapshotManager,
)
from gpu_feature_discovery_tpu_torch.sandbox.state import LabelStateStore

__all__ = [
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
    "FLAPPING_LABEL",
    "FlapDamper",
    "ProbeCrash",
    "ProbeError",
    "ProbeTimeout",
    "acquire_snapshot_manager",
    "isolation_mode",
    "kill_stray_children",
    "probe_device_snapshot",
    "run_probe",
    "DeviceSnapshot",
    "SnapshotManager",
    "LabelStateStore",
]
