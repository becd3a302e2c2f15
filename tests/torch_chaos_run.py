#!/usr/bin/env python
"""Chaos driver of the PyTorch port: run the port's supervised daemon loop
under a fault spec and assert the recovery contract, the counterpart of
the twin's ``tests/chaos-run.py`` (same function names, same contract,
same per-row assertions).

Contract asserted, for ANY injected fault mix (init failures, mid-cycle
raises, write errors):

  1. the daemon loop never exits on its own;
  2. the label file CONVERGES: it ends holding either the full label set
     (``nvidia.com/gpu.count`` present) or a degraded one
     (``tfd.degraded=true``), and is never absent once written;
  3. once the fault budget drains, the file reaches FULL labels with the
     degraded/unhealthy markers cleared;
  4. SIGTERM still produces a clean shutdown (file removed).

Usage::

    python tests/torch_chaos_run.py --spec 'pjrt_init:fail:2'
    TFD_FAULT_SPEC='write:raise:OSError:2' python tests/torch_chaos_run.py
    python tests/torch_chaos_run.py --spec 'probe.segv:fail:1' --backend gpu

``ROWS`` is the matrix, one row per fault spec or scenario, and
``EXPECTATIONS`` each row's label expectations and budget (the twin's,
with its keys translated by ``port_key``); ``run_row`` runs one row as
``tests/test_torch_chaos.py`` does. The CLI runs a fault spec with the
expectations given as options, as the twin's CI rows do, and a scenario
row (``slice:``, ``fleet:``, ``reconcile:``, ``actuation:``) with its own
checks.

Rows that are not fault injections (module functions below):
``slice:<scenario>`` runs an in-process slice of port daemons
(``tests/torch_slice_fixture.py`` PortSliceHarness, real HTTP between
them) and kills or partitions members; ``fleet:<scenario>`` runs the
port's fleet collectors over slice daemons or in-process slice leaders,
some as real ``fleet-collector`` subprocesses that are SIGKILLed;
``reconcile:broker-death`` SIGKILLs the broker worker of an event-mode
daemon whose sleep interval is pinned at 60 s, so that only the
``worker_died`` wake can explain a prompt recovery;
``actuation:<scenario>`` runs the cordon advice under a sick chip and
the slice-wide budget under a storm of sick workers.

Backends: the twin's ``mock:v4-8`` is ``mock-gpu:4`` here and its
``mock:v5e-8`` (eight chips on an 8-device virtual mesh) is
``mock-gpu:8`` probing eight CPU devices (``TFD_BURNIN_CPU_DEVICES=8``).
``--backend gpu`` runs a row against the card.

This file imports nothing of the JAX package and neither JAX nor pyyaml:
it also runs on a GPU machine that has neither.
"""

import argparse
import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _path in (REPO, HERE):
    if _path not in sys.path:
        sys.path.insert(0, _path)

CONVERGE_TIMEOUT_S = 8.0
POLL_S = 0.002

TWIN_NS, PORT_NS = "google.com/tpu.", "nvidia.com/gpu."

# The twin's mock backends and the port's tokens for the same inventory.
BACKENDS = {"mock:v4-8": "mock-gpu:4", "mock:v5e-8": "mock-gpu:8"}
# CPU devices the burn-in probes for a mock backend (the twin's virtual
# device mesh): one per mock chip, so chip.<i> faults have a device i.
CPU_DEVICES_ENV = "TFD_BURNIN_CPU_DEVICES"

ROWS = [
    "pjrt_init:fail:2",
    "generate:raise:RuntimeError",
    "write:raise:OSError:2",
    "labeler.interconnect:raise:RuntimeError:2",
    "pjrt_init:fail:1,write:raise:OSError,generate:raise:RuntimeError",
    "probe.hang:fail:1",
    "probe.segv:fail:1",
    "probe.timeout:fail:2",
    "broker.hang:fail:1",
    "broker.crash:fail:1",
    "chip.3.sick:fail:1",
    "chip.2.slow:fail:2",
    "slice:peer-unreachable",
    "slice:leader-failover",
    "slice:slow-peer-storm",
    "slice:cohort-leader-death",
    "slice:tier-partition",
    "pjrt_init.cpu:fail:2",
    "fleet:slice-dark",
    "fleet:region-dark",
    "fleet:collector-failover",
    "fleet:delta-resync",
    "fleet:watch-failover",
    "fleet:notify-lost",
    "fleet:notify-storm",
    "reconcile:broker-death",
    "actuation:sick-chip-cordon",
    "actuation:budget-storm",
]

# Per-row label expectations and convergence budgets beyond the generic
# contract (run_chaos keyword arguments); rows absent here take the
# generic 8 s budget.
EXPECTATIONS = {
    "chip.3.sick:fail:1": {
        "expect_transient": ["nvidia.com/gpu.chip.3.ok=false", "nvidia.com/gpu.chips.sick=1"],
        "expect_final": ["nvidia.com/gpu.chip.3.ok=true", "nvidia.com/gpu.chips.sick=0"],
        "timeout_s": 90.0,
    },
    "chip.2.slow:fail:2": {
        "expect_transient": ["nvidia.com/gpu.straggler-chip=2"],
        "expect_absent": ["nvidia.com/gpu.straggler-chip"],
        "timeout_s": 90.0,
    },
    "slice:peer-unreachable": {"timeout_s": 60.0},
    "slice:leader-failover": {"timeout_s": 60.0},
    "slice:slow-peer-storm": {"timeout_s": 60.0},
    "slice:cohort-leader-death": {"timeout_s": 90.0},
    "slice:tier-partition": {"timeout_s": 90.0},
    "pjrt_init.cpu:fail:2": {
        "backends": "mock-gpu:2,cpu",
        "require_always": ["nvidia.com/gpu.count=2"],
        "expect_transient": ["node.features/cpu.tfd.degraded=true"],
        "expect_absent": ["node.features/cpu.tfd.degraded"],
        "timeout_s": 60.0,
    },
    "fleet:slice-dark": {"timeout_s": 90.0},
    "fleet:region-dark": {"timeout_s": 60.0},
    "fleet:collector-failover": {"timeout_s": 90.0},
    "fleet:delta-resync": {"timeout_s": 90.0},
    "fleet:watch-failover": {"timeout_s": 90.0},
    "fleet:notify-lost": {"timeout_s": 60.0},
    "fleet:notify-storm": {"timeout_s": 60.0},
    "reconcile:broker-death": {"timeout_s": 30.0},
    "actuation:sick-chip-cordon": {"timeout_s": 90.0},
    "actuation:budget-storm": {"timeout_s": 90.0},
}


def port_key(text):
    """A twin label key (or ``key=value``) in the port's namespace: the
    ``google.com/tpu.`` family becomes ``nvidia.com/gpu.``; the
    ``google.com/tfd.*`` markers and other families stay."""
    return PORT_NS + text[len(TWIN_NS):] if text.startswith(TWIN_NS) else text


def port_backend(token):
    return BACKENDS.get(token, token)


def read_labels(path):
    try:
        with open(path) as f:
            return dict(line.strip().split("=", 1) for line in f if "=" in line)
    except OSError:
        return {}


def _free_port():
    from torch_slice_fixture import free_port

    return free_port()


def _scrape_value(port, name, timeout=5):
    """One sample of a live ``/metrics`` exposition, by its full name with
    labels (``tfd_probe_kills_total``, ``tfd_reconcile_wakes_total{...}``);
    None when absent."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=timeout) as resp:
        exposition = resp.read().decode()
    return next((float(line.rsplit(" ", 1)[1]) for line in exposition.splitlines()
                 if line.startswith(name + " ")), None)


class _Env:
    """Set environment variables for one row and put them back after."""

    def __init__(self):
        self._saved = {}

    def set(self, key, value):
        self._saved.setdefault(key, os.environ.get(key))
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value

    def restore(self):
        for key, value in self._saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self._saved.clear()


def _write_targets(path, targets):
    """A collector targets file. JSON is valid under the targets parser
    (config/yaml_subset.py) and needs no pyyaml."""
    with open(path, "w") as f:
        json.dump({"version": "v1",
                   "slices": [{"name": t.name, "hosts": list(t.hosts)} for t in targets]}, f)


def _collector_cmd(targets_path, port, *extra):
    return [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "fleet-collector",
            "--targets-file", targets_path, "--metrics-addr", "127.0.0.1",
            "--metrics-port", str(port), *extra]


def _subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TFD_FAULT_SPEC", None)
    return env


def _wait_ready(port, budget, what):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.05)
    raise AssertionError(f"collector never became ready ({what})")


# ---------------------------------------------------------------------------
# slice rows
# ---------------------------------------------------------------------------

def run_slice_chaos(scenario, workdir, timeout_s=None):
    """One multi-daemon slice chaos scenario: a 4-worker in-process slice
    with one member killed mid-run. A dead follower degrades the SLICE
    labels only (the leader converges to healthy-hosts=3 /
    degraded=true); a dead leader fails over to worker 1; every
    survivor's node-local labels stay untouched."""
    from torch_slice_fixture import PortSliceHarness, non_coord_lines

    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_DEGRADED_LABEL,
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_LEADER_SEEN_LABEL,
        SLICE_ROLE_LABEL,
    )

    if scenario == "slow-peer-storm":
        return run_slow_peer_storm(workdir, timeout_s=timeout_s)
    if scenario == "cohort-leader-death":
        return run_cohort_leader_death(workdir, timeout_s=timeout_s)
    if scenario == "tier-partition":
        return run_tier_partition(workdir, timeout_s=timeout_s)
    victims = {"peer-unreachable": 3, "leader-failover": 0}
    if scenario not in victims:
        raise ValueError(f"unknown slice chaos scenario {scenario!r}")
    budget = timeout_s or 30.0
    started = time.monotonic()
    harness = PortSliceHarness(workdir, workers=4, sleep_interval="0.05s").start()

    def node_local(worker):
        return non_coord_lines(worker.raw_output())

    try:
        harness.wait_for(
            lambda s: (s[0].get(SLICE_ROLE_LABEL) == "leader"
                       and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "4"
                       and all(s[i].get(SLICE_LEADER_SEEN_LABEL) == "true" for i in (1, 2, 3))),
            timeout=budget, what="healthy 4-worker slice")
        victim = victims[scenario]
        survivors = [w for w in harness.workers if w.worker_id != victim]
        before = {w.worker_id: node_local(w) for w in survivors}
        harness.stop_worker(victim)
        new_leader = 1 if scenario == "leader-failover" else 0
        converged = harness.wait_for(
            lambda s: (s[new_leader].get(SLICE_ROLE_LABEL) == "leader"
                       and s[new_leader].get(SLICE_HEALTHY_HOSTS_LABEL) == "3"
                       and s[new_leader].get(SLICE_DEGRADED_LABEL) == "true"),
            timeout=budget, what=f"slice convergence after killing worker {victim}")
        for worker in survivors:
            assert node_local(worker) == before[worker.worker_id], (
                f"worker {worker.worker_id}'s node-local labels moved when worker {victim} died")
    finally:
        harness.stop()
    elapsed = time.monotonic() - started
    return {"spec": f"slice:{scenario}", "converged_s": round(elapsed, 3),
            "labels": len(converged[new_leader])}


def run_slow_peer_storm(workdir, timeout_s=None):
    """slice:slow-peer-storm: workers 3-5 of a 6-worker slice stall each
    /peer/snapshot answer 0.4 s under a 1.0 s round budget that a
    sequential round would overrun. The leader's round stays within ~1x
    --peer-timeout, no peer is skipped for budget, and the slice labels
    and every worker's node-local labels do not move."""
    from torch_slice_fixture import PortSliceHarness, non_coord_lines

    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_DEGRADED_LABEL,
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_LEADER_SEEN_LABEL,
        SLICE_ROLE_LABEL,
    )
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    budget = timeout_s or 60.0
    peer_timeout_s = 1.0
    slow_delay_s = 0.4
    started = time.monotonic()
    harness = PortSliceHarness(workdir, workers=6, sleep_interval="0.05s",
                               peer_timeout=f"{peer_timeout_s}s", round_budget=1.0,
                               slow_workers=(3, 4, 5), slow_delay_s=slow_delay_s)
    leader_coord = harness.workers[0].coordinator
    durations = []
    orig_poll = leader_coord.poll_once

    def timed_poll():
        t0 = time.perf_counter()
        orig_poll()
        durations.append(time.perf_counter() - t0)

    leader_coord.poll_once = timed_poll
    harness.start()

    def healthy(s):
        return (s[0].get(SLICE_ROLE_LABEL) == "leader"
                and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "6"
                and s[0].get(SLICE_DEGRADED_LABEL) == "false"
                and all(s[i].get(SLICE_LEADER_SEEN_LABEL) == "true" for i in range(1, 6)))

    try:
        harness.wait_for(healthy, timeout=budget, what="healthy 6-worker slice")
        before = {w.worker_id: non_coord_lines(w.raw_output()) for w in harness.workers}
        rounds_at_converge = len(durations)
        deadline = time.monotonic() + budget
        while len(durations) < rounds_at_converge + 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        storm_rounds = durations[rounds_at_converge:]
        assert len(storm_rounds) >= 4, (
            f"leader completed only {len(storm_rounds)} rounds in budget")
        worst = max(storm_rounds)
        assert worst < peer_timeout_s, (
            f"leader round took {worst:.3f}s — not bounded by ~1x the {peer_timeout_s}s peer "
            f"timeout (sequential would be >= {3 * slow_delay_s:.1f}s)")
        assert worst >= slow_delay_s * 0.9, (
            f"worst round {worst:.3f}s never engaged the slow peers — the storm did not arm")
        exposition = obs_metrics.REGISTRY.render()
        assert 'tfd_peer_polls_total{outcome="skipped"}' not in exposition, (
            "a poll round skipped a peer for budget under fan-out")
        final = harness.wait_for(healthy, timeout=budget, what="slice still healthy post-storm")
        for worker in harness.workers:
            assert non_coord_lines(worker.raw_output()) == before[worker.worker_id], (
                f"worker {worker.worker_id}'s node-local labels moved")
    finally:
        harness.stop()
    elapsed = time.monotonic() - started
    return {"spec": "slice:slow-peer-storm", "converged_s": round(elapsed, 3),
            "worst_round_s": round(max(durations[rounds_at_converge:]), 3),
            "labels": len(final[0])}


def run_cohort_leader_death(workdir, timeout_s=None):
    """slice:cohort-leader-death: a 6-worker two-tier slice
    (--cohort-size=2) loses cohort 1's leader (w2). w3 re-derives
    cohort leadership, healthy-hosts drops to exactly 5 with no cohort
    degraded marker, no surviving daemon fails a cycle, and every
    survivor's node-local labels stay untouched."""
    from torch_slice_fixture import PortSliceHarness, non_coord_lines

    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_DEGRADED_LABEL,
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_ROLE_LABEL,
        cohort_degraded_label,
    )
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    budget = timeout_s or 60.0
    started = time.monotonic()
    harness = PortSliceHarness(workdir, workers=6, sleep_interval="0.05s", cohort_size=2).start()
    try:
        harness.wait_for(
            lambda s: (s[0].get(SLICE_ROLE_LABEL) == "leader"
                       and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "6"
                       and s[2].get(SLICE_ROLE_LABEL) == "cohort-leader"
                       and s[4].get(SLICE_ROLE_LABEL) == "cohort-leader"),
            timeout=budget, what="healthy 6-worker two-tier slice")
        survivors = [w for w in harness.workers if w.worker_id != 2]
        before = {w.worker_id: non_coord_lines(w.raw_output()) for w in survivors}
        harness.stop_worker(2)
        converged = harness.wait_for(
            lambda s: (s[3].get(SLICE_ROLE_LABEL) == "cohort-leader"
                       and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "5"
                       and s[0].get(SLICE_DEGRADED_LABEL) == "true"
                       and cohort_degraded_label(1) not in s[0]),
            timeout=budget, what="cohort leadership re-derivation after killing w2")
        for worker in survivors:
            assert non_coord_lines(worker.raw_output()) == before[worker.worker_id], (
                f"worker {worker.worker_id}'s node-local labels moved when the cohort "
                "leader died")
        failed = obs_metrics.CYCLES_TOTAL.value(outcome="failed")
        assert failed == 0, f"a cohort-leader death cost {failed} failed cycle(s)"
    finally:
        harness.stop()
    elapsed = time.monotonic() - started
    return {"spec": "slice:cohort-leader-death", "converged_s": round(elapsed, 3),
            "labels": len(converged[0])}


def run_tier_partition(workdir, timeout_s=None):
    """slice:tier-partition: an 8-worker two-tier slice (--cohort-size=4)
    whose cohort-1 leadership chain (w4, w5, w6) drops slice-tier polls
    at the wire. Only cohort 1 degrades, the direct-poll fallback keeps
    healthy-hosts at 8 and slice.degraded false, healing clears the
    marker, node-local labels never move, no cycle fails."""
    from torch_slice_fixture import PortSliceHarness, non_coord_lines

    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_DEGRADED_LABEL,
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_ROLE_LABEL,
        cohort_degraded_label,
    )
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    budget = timeout_s or 60.0
    started = time.monotonic()
    harness = PortSliceHarness(workdir, workers=8, sleep_interval="0.05s", cohort_size=4,
                               tier_partitioned_workers=(4, 5, 6)).start()
    try:
        degraded = harness.wait_for(
            lambda s: (s[0].get(SLICE_ROLE_LABEL) == "leader"
                       and s[0].get(cohort_degraded_label(1)) == "true"
                       and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "8"
                       and s[0].get(SLICE_DEGRADED_LABEL) == "false"),
            timeout=budget, what="cohort 1 degraded with truthful healthy-hosts")
        assert cohort_degraded_label(0) not in degraded[0], (
            "the partition leaked into an unaffected cohort")
        before = {w.worker_id: non_coord_lines(w.raw_output()) for w in harness.workers}
        for wid in (4, 5, 6):
            harness.workers[wid].coordinator.force_tier_partition = False
        healed = harness.wait_for(
            lambda s: (cohort_degraded_label(1) not in s[0]
                       and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "8"
                       and s[0].get(SLICE_DEGRADED_LABEL) == "false"),
            timeout=budget, what="degraded marker clearing after the partition heals")
        for worker in harness.workers:
            assert non_coord_lines(worker.raw_output()) == before[worker.worker_id], (
                f"worker {worker.worker_id}'s node-local labels moved")
        failed = obs_metrics.CYCLES_TOTAL.value(outcome="failed")
        assert failed == 0, f"the tier partition cost {failed} failed cycle(s)"
    finally:
        harness.stop()
    elapsed = time.monotonic() - started
    return {"spec": "slice:tier-partition", "converged_s": round(elapsed, 3),
            "labels": len(healed[0])}


# ---------------------------------------------------------------------------
# fleet rows
# ---------------------------------------------------------------------------

def run_fleet_chaos(scenario, workdir, timeout_s=None):
    """fleet:slice-dark: a collector over three 2-worker slices of port
    daemons; one slice's whole leadership chain is shut down. Within the
    2-miss window its entry flips to degraded-stale, keeping its verdict
    and staleness stamp; the other entries stay live and untouched;
    tfd_fleet_slices_stale reads exactly 1."""
    from torch_slice_fixture import PortSliceHarness

    from gpu_feature_discovery_tpu_torch.fleet import FleetCollector, SliceTarget
    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_ROLE_LABEL,
    )
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    others = {
        "region-dark": run_fleet_region_dark,
        "collector-failover": run_fleet_collector_failover,
        "delta-resync": run_fleet_delta_resync,
        "watch-failover": run_fleet_watch_failover,
        "notify-lost": run_fleet_notify_lost,
        "notify-storm": run_fleet_notify_storm,
    }
    if scenario in others:
        return others[scenario](workdir, timeout_s=timeout_s)
    if scenario != "slice-dark":
        raise ValueError(f"unknown fleet chaos scenario {scenario!r}")
    budget = timeout_s or 60.0
    started = time.monotonic()
    harnesses = []
    collector = None
    try:
        for i in range(3):
            slice_dir = os.path.join(workdir, f"slice-{i}")
            os.makedirs(slice_dir, exist_ok=True)
            harnesses.append(PortSliceHarness(slice_dir, workers=2, sleep_interval="0.05s",
                                              peer_timeout="0.5s"))
        for harness in harnesses:
            harness.start()
        for i, harness in enumerate(harnesses):
            harness.wait_for(
                lambda s: (s[0].get(SLICE_ROLE_LABEL) == "leader"
                           and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "2"),
                timeout=budget, what=f"healthy slice {i}")
        targets = [SliceTarget(name=f"slice-{i}",
                               hosts=tuple(f"127.0.0.1:{w.port}" for w in harness.workers))
                   for i, harness in enumerate(harnesses)]
        collector = FleetCollector(targets, peer_timeout=0.5)
        deadline = time.monotonic() + budget

        def entries():
            return collector.inventory_payload()["slices"]

        while time.monotonic() < deadline:
            collector.poll_round()
            if all(e.get("healthy_hosts") == 2 and not e.get("stale")
                   for e in entries().values()):
                break
            time.sleep(0.02)
        healthy = entries()
        assert all(e["healthy_hosts"] == 2 and e["reachable"] for e in healthy.values()), (
            f"collector never saw 3 healthy slices: {healthy}")
        before = {name: dict(entry) for name, entry in healthy.items() if name != "slice-1"}
        harnesses[1].stop()
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            collector.poll_round()
            if entries()["slice-1"].get("stale"):
                break
            time.sleep(0.02)
        final = entries()
        dark = final["slice-1"]
        assert dark["stale"] is True and dark["reachable"] is False, final
        assert dark["healthy_hosts"] == 2, (
            f"degraded-stale must keep the last-known verdict: {dark}")
        assert dark["last_seen_unix"] is not None, dark
        for name, entry in before.items():
            now_entry = final[name]
            assert now_entry["stale"] is False, final
            assert now_entry["reachable"] is True, final
            assert now_entry["healthy_hosts"] == 2, final
            assert now_entry["leader"] == entry["leader"], final
        assert obs_metrics.FLEET_SLICES_STALE.value() == 1, obs_metrics.FLEET_SLICES_STALE.value()
    finally:
        if collector is not None:
            collector.close()
        for harness in harnesses:
            harness.stop()
    elapsed = time.monotonic() - started
    return {"spec": f"fleet:{scenario}", "converged_s": round(elapsed, 3),
            "labels": len(final["slice-1"])}


def _leader_verdict(prefix, i, healthy_hosts=2, sick=0):
    """A slice leader's published labels: a 2-host slice of 4-GPU nodes."""
    return {
        "nvidia.com/gpu.count": "4",
        "nvidia.com/gpu.chips.healthy": str(4 - sick),
        "nvidia.com/gpu.chips.sick": str(sick),
        "nvidia.com/gpu.slice.role": "leader",
        "nvidia.com/gpu.slice.leader": f"{prefix}{i}w0",
        "nvidia.com/gpu.slice.healthy-hosts": str(healthy_hosts),
        "nvidia.com/gpu.slice.total-hosts": "2",
        "nvidia.com/gpu.slice.degraded": "false" if healthy_hosts == 2 else "true",
        "nvidia.com/gpu.slice.sick-chips": str(sick),
    }


def _fake_slice_leaders(n, prefix):
    """n in-process slice leaders (a SliceCoordinator publishing a
    healthy 2-host verdict and an obs server each) and the SliceTargets
    naming them: the lightweight fleet fixture of the federation rows."""
    from gpu_feature_discovery_tpu_torch.fleet import SliceTarget
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.obs.server import IntrospectionServer, IntrospectionState
    from gpu_feature_discovery_tpu_torch.peering import SliceCoordinator

    coords, servers, targets = [], [], []
    for i in range(n):
        coord = SliceCoordinator(0, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5)
        coord.publish_local(_leader_verdict(prefix, i), "full")
        server = IntrospectionServer(obs_metrics.REGISTRY, IntrospectionState(60.0),
                                     addr="127.0.0.1", port=0,
                                     peer_snapshot=coord.snapshot_response)
        server.start()
        coords.append(coord)
        servers.append(server)
        targets.append(SliceTarget(name=f"{prefix}{i}", hosts=(f"127.0.0.1:{server.port}",)))
    return coords, servers, targets


def _degrade(coords, prefix, i):
    coords[i].publish_local(_leader_verdict(prefix, i, healthy_hosts=1, sick=1), "full")


def run_fleet_region_dark(workdir, timeout_s=None):
    """fleet:region-dark: a root collector (--upstream-mode=collectors)
    over two region collectors, each over two slice leaders; region 1's
    collector dies at the wire. The root serves region 1's slices
    degraded-stale with their verdicts and last_seen_unix kept, marks
    the region stale, leaves region 0's entries byte-identical, and
    tfd_fleet_regions_stale reads exactly 1."""
    from gpu_feature_discovery_tpu_torch.fleet import FleetCollector, SliceTarget
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.obs.server import IntrospectionServer, IntrospectionState

    budget = timeout_s or 60.0
    started = time.monotonic()
    coords, servers = [], []
    regions, region_servers = [], []
    root = None
    try:
        # A pinned wall clock: the quantized freshness stamps cannot
        # straddle a quantum boundary mid-run.
        frozen_wall = 1_700_000_000.0
        region_targets = []
        for r in range(2):
            c, s, t = _fake_slice_leaders(2, prefix=f"r{r}s")
            coords += c
            servers += s
            region = FleetCollector(t, peer_timeout=0.5, wall_clock=lambda: frozen_wall)
            region_server = IntrospectionServer(obs_metrics.REGISTRY, IntrospectionState(60.0),
                                                addr="127.0.0.1", port=0,
                                                fleet_snapshot=region.inventory_response)
            region_server.start()
            regions.append(region)
            region_servers.append(region_server)
            region_targets.append(SliceTarget(name=f"region-{r}",
                                              hosts=(f"127.0.0.1:{region_server.port}",)))
        root = FleetCollector(region_targets, peer_timeout=0.5, upstream_mode="collectors",
                              wall_clock=lambda: frozen_wall)

        def pane():
            return root.inventory_payload()

        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            for region in regions:
                region.poll_round()
            root.poll_round()
            doc = pane()
            if len(doc["slices"]) == 4 and all(
                    e.get("healthy_hosts") == 2 and not e.get("stale")
                    for e in doc["slices"].values()):
                break
            time.sleep(0.02)
        healthy = pane()
        assert len(healthy["slices"]) == 4 and all(
            e["healthy_hosts"] == 2 for e in healthy["slices"].values()), (
            f"root never saw 2 healthy regions: {healthy}")
        before = {k: dict(v) for k, v in healthy["slices"].items()}
        region_servers[1].close()
        regions[1].close()
        dark_keys = [k for k in before if k.startswith("region/region-1/")]
        live_keys = [k for k in before if k.startswith("region/region-0/")]
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            regions[0].poll_round()
            root.poll_round()
            doc = pane()
            if all(doc["slices"][k].get("stale") for k in dark_keys):
                break
            time.sleep(0.02)
        final = pane()
        for key in dark_keys:
            dark = final["slices"][key]
            assert dark["stale"] is True, final
            assert dark["healthy_hosts"] == 2, (
                f"degraded-stale must keep the last-known verdict: {dark}")
            assert dark["last_seen_unix"] == before[key]["last_seen_unix"], (
                f"the staleness stamp must freeze, not vanish: {dark}")
        meta = final["regions"]["region-1"]
        assert meta["reachable"] is False and meta["stale"] is True, final
        for key in live_keys:
            assert final["slices"][key] == before[key], (
                f"the healthy region's entries moved: {final['slices'][key]}")
        assert final["regions"]["region-0"]["stale"] is False, final
        assert obs_metrics.FLEET_REGIONS_STALE.value() == 1, obs_metrics.FLEET_REGIONS_STALE.value()
    finally:
        if root is not None:
            root.close()
        for region_server in region_servers:
            region_server.close()
        for region in regions:
            region.close()
        for server in servers:
            server.close()
        for coord in coords:
            coord.close()
    elapsed = time.monotonic() - started
    return {"spec": "fleet:region-dark", "converged_s": round(elapsed, 3),
            "labels": len(final["slices"])}


def run_fleet_collector_failover(workdir, timeout_s=None):
    """fleet:collector-failover: an HA pair over one fleet, the ACTIVE a
    real ``fleet-collector`` subprocess (SIGKILLed mid-run), the standby
    in process. Before the kill the standby derives standby and its
    mirror agrees (divergence 0, 304s); within one scrape period after
    it, the standby's /fleet/snapshot serves a complete, non-restored
    inventory; within the 2-miss window it re-derives itself active."""
    from gpu_feature_discovery_tpu_torch.fleet import FleetCollector, HaMonitor
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.obs.server import IntrospectionServer, IntrospectionState

    budget = timeout_s or 60.0
    scrape_period_s = 0.5
    started = time.monotonic()
    coords, servers = [], []
    standby = standby_server = ha = active = None
    try:
        coords, servers, targets = _fake_slice_leaders(3, prefix="s")
        targets_path = os.path.join(workdir, "targets.yaml")
        _write_targets(targets_path, targets)
        active_port, standby_port = _free_port(), _free_port()
        active_addr = f"127.0.0.1:{active_port}"
        standby_addr = f"127.0.0.1:{standby_port}"
        active = subprocess.Popen(
            _collector_cmd(targets_path, active_port,
                           "--scrape-interval", f"{scrape_period_s}s", "--peer-timeout", "0.5s",
                           "--ha-peers", f"{active_addr},{standby_addr}",
                           "--ha-self", active_addr),
            env=_subprocess_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

        def http_json(url):
            with urllib.request.urlopen(url, timeout=2) as resp:
                return resp.status, resp.read()

        _wait_ready(active_port, budget, "active collector subprocess")
        standby = FleetCollector(list(targets), peer_timeout=0.5)
        standby_server = IntrospectionServer(obs_metrics.REGISTRY, IntrospectionState(60.0),
                                             addr="127.0.0.1", port=standby_port,
                                             fleet_snapshot=standby.inventory_response)
        standby_server.start()
        ha = HaMonitor([active_addr, standby_addr], standby_addr, peer_timeout=0.5)

        def standby_round():
            standby.poll_round()
            return ha.observe_round(standby.inventory_payload()["slices"])

        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            role = standby_round()
            doc = standby.inventory_payload()
            if (role == "standby" and ha.divergence == 0 and len(doc["slices"]) == 3
                    and all(e.get("healthy_hosts") == 2 for e in doc["slices"].values())):
                break
            time.sleep(0.05)
        assert ha.role == "standby", (
            f"junior replica must derive standby while the active serves: {ha.role}")
        assert ha.divergence == 0, f"the pair must agree before the kill: {ha.divergence}"
        mirror_304s = ha.mirror_not_modified.value
        standby_round()
        assert ha.mirror_not_modified.value > mirror_304s, (
            "an agreeing idle pair must exchange 304s on the mirror")
        before = {k: dict(v) for k, v in standby.inventory_payload()["slices"].items()}
        os.kill(active.pid, signal.SIGKILL)
        active.wait(timeout=10)
        killed = time.monotonic()
        time.sleep(scrape_period_s / 2)
        status, body = http_json(f"http://127.0.0.1:{standby_port}/fleet/snapshot")
        assert status == 200
        served = json.loads(body)
        assert set(served["slices"]) == set(before), (
            f"entries lost across the failover: {sorted(served['slices'])}")
        assert served["restored"] is False, served
        for name, entry in served["slices"].items():
            assert entry["healthy_hosts"] == 2, (name, entry)
            assert entry["restored"] is False, (name, entry)
            assert entry["stale"] is False, (name, entry)
        serving_s = time.monotonic() - killed
        assert serving_s < scrape_period_s + 0.5, serving_s
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if standby_round() == "active":
                break
            time.sleep(0.05)
        assert ha.role == "active", "standby never re-derived active"
        assert obs_metrics.FLEET_HA_ROLE.value() == 1
        failover_s = time.monotonic() - killed
    finally:
        if active is not None and active.poll() is None:
            active.kill()
            active.wait(timeout=10)
        if ha is not None:
            ha.close()
        if standby_server is not None:
            standby_server.close()
        if standby is not None:
            standby.close()
        for server in servers:
            server.close()
        for coord in coords:
            coord.close()
    elapsed = time.monotonic() - started
    return {"spec": "fleet:collector-failover", "converged_s": round(elapsed, 3),
            "serving_after_kill_s": round(serving_s, 3), "failover_s": round(failover_s, 3),
            "labels": len(before)}


def run_fleet_delta_resync(workdir, timeout_s=None):
    """fleet:delta-resync: a real ``fleet-collector`` subprocess
    (--state-dir, --delta-window) serves ``?since=`` deltas to an
    in-process client, is SIGKILLed mid-lineage and restarts on the same
    port and state dir. Before the kill the client rides deltas and
    304s; across the restart it resumes the lineage or pays exactly ONE
    full resync; after it, churn rides deltas again and the client's
    mirror is byte-identical to the full body."""
    import http.client

    from gpu_feature_discovery_tpu_torch.fleet.collector import (
        _HostState,
        drop_connection,
        request_snapshot,
    )
    from gpu_feature_discovery_tpu_torch.fleet.inventory import (
        FLEET_SNAPSHOT_PATH,
        MAX_INVENTORY_BYTES,
        parse_inventory_or_delta,
    )

    budget = timeout_s or 90.0
    started = time.monotonic()
    coords, servers = [], []
    active = hstate = None
    try:
        coords, servers, targets = _fake_slice_leaders(3, prefix="d")
        targets_path = os.path.join(workdir, "targets.yaml")
        _write_targets(targets_path, targets)
        state_dir = os.path.join(workdir, "fleet-state")
        os.makedirs(state_dir, exist_ok=True)
        port = _free_port()

        def spawn():
            return subprocess.Popen(
                _collector_cmd(targets_path, port, "--scrape-interval", "0.1s",
                               "--peer-timeout", "0.5s", "--state-dir", state_dir,
                               "--delta-window", "16"),
                env=_subprocess_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

        def full_body():
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{FLEET_SNAPSHOT_PATH}",
                                        timeout=2) as resp:
                return resp.read()

        def poll():
            """One delta-aware poll; returns (doc, kind), the kind read off
            the mirror: a full apply clears last_changed, a 304 leaves it
            empty, a delta names keys."""
            if hstate.conn is None:
                hstate.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            doc = request_snapshot(hstate, 5.0, FLEET_SNAPSHOT_PATH, parse_inventory_or_delta,
                                   MAX_INVENTORY_BYTES, delta=True)
            hstate.last_snapshot = doc
            changed = hstate.mirror.last_changed
            if changed is None:
                return doc, "full"
            return doc, ("not_modified" if not changed else "delta")

        active = spawn()
        _wait_ready(port, budget, "first start")
        hstate = _HostState(host="127.0.0.1", port=port)
        hstate.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            doc, _kind = poll()
            if len(doc["slices"]) == 3 and all(
                    e.get("healthy_hosts") == 2 and not e.get("restored")
                    for e in doc["slices"].values()):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"pane never converged: {doc}")
        _doc, kind = poll()
        assert kind == "not_modified", kind
        _degrade(coords, "d", 0)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            doc, kind = poll()
            if kind == "delta":
                break
            assert kind == "not_modified", f"pre-kill churn must ride the delta path, got {kind}"
            time.sleep(0.05)
        else:
            raise AssertionError("delta never arrived pre-kill")
        assert hstate.mirror.last_changed == {"d0"}, hstate.mirror.last_changed
        assert doc["slices"]["d0"]["healthy_hosts"] == 1, doc
        assert hstate.mirror.body == full_body()
        generation_pre_kill = hstate.mirror.generation
        os.kill(active.pid, signal.SIGKILL)
        active.wait(timeout=10)
        active = spawn()
        _wait_ready(port, budget, "restart")
        _degrade(coords, "d", 1)
        kinds = {"full": 0, "delta": 0, "not_modified": 0}
        deadline = time.monotonic() + budget
        converged = False
        while time.monotonic() < deadline:
            try:
                doc, kind = poll()
            except Exception:
                drop_connection(hstate)
                time.sleep(0.05)
                continue
            kinds[kind] += 1
            if (doc["slices"]["d1"].get("healthy_hosts") == 1 and not doc["restored"]
                    and not any(e.get("restored") for e in doc["slices"].values())):
                converged = True
                break
            time.sleep(0.05)
        assert converged, f"pane never re-converged after restart: {doc}"
        assert kinds["full"] <= 1, kinds
        assert hstate.mirror.body == full_body()
        assert hstate.mirror.generation >= generation_pre_kill
        assert doc["slices"]["d0"]["healthy_hosts"] == 1, doc
        _degrade(coords, "d", 2)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            doc, kind = poll()
            assert kind != "full", "client fell off the lineage after the restart"
            if kind == "delta" and "d2" in hstate.mirror.last_changed:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("post-restart delta never arrived")
        assert doc["slices"]["d2"]["healthy_hosts"] == 1, doc
        assert hstate.mirror.body == full_body()
    finally:
        if active is not None and active.poll() is None:
            active.kill()
            active.wait(timeout=10)
        if hstate is not None:
            drop_connection(hstate)
        for server in servers:
            server.close()
        for coord in coords:
            coord.close()
    elapsed = time.monotonic() - started
    return {"spec": "fleet:delta-resync", "converged_s": round(elapsed, 3),
            "resyncs_after_restart": kinds["full"], "deltas_after_restart": kinds["delta"],
            "generation": hstate.mirror.generation,
            "labels": len(hstate.last_snapshot["slices"])}


def run_fleet_watch_failover(workdir, timeout_s=None):
    """fleet:watch-failover: two consumers hold filtered
    ``?degraded=true`` panes against a real ``fleet-collector``
    subprocess and park in ``?watch=`` long-polls. The collector is
    SIGKILLed mid-park and restarted on the same port and state dir:
    every watcher resumes via ``?since=`` with at most ONE full resync,
    ends byte-identical to a fresh filtered full body, and post-restart
    churn rides filtered deltas again."""
    import http.client

    from gpu_feature_discovery_tpu_torch.fleet.inventory import (
        FLEET_SNAPSHOT_PATH,
        DeltaMirror,
        DeltaSyncError,
    )

    budget = timeout_s or 90.0
    started = time.monotonic()
    coords, servers = [], []
    active = None
    stop = threading.Event()
    threads = []
    n_watchers = 2
    mirrors = [None] * n_watchers
    counts = [{"full": 0, "delta": 0, "errors": 0} for _ in range(n_watchers)]
    try:
        coords, servers, targets = _fake_slice_leaders(3, prefix="w")
        targets_path = os.path.join(workdir, "targets.yaml")
        _write_targets(targets_path, targets)
        state_dir = os.path.join(workdir, "fleet-state")
        os.makedirs(state_dir, exist_ok=True)
        port = _free_port()

        def spawn():
            return subprocess.Popen(
                _collector_cmd(targets_path, port, "--scrape-interval", "0.1s",
                               "--peer-timeout", "0.5s", "--state-dir", state_dir,
                               "--delta-window", "16", "--watch-timeout", "2s"),
                env=_subprocess_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

        def filtered_full_body():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{FLEET_SNAPSHOT_PATH}?degraded=true",
                    timeout=2) as resp:
                return resp.read()

        def parked_watchers():
            """The parked-watcher gauge from the collector's live /metrics."""
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                            timeout=2) as resp:
                    text = resp.read().decode()
            except OSError:
                return -1
            for line in text.splitlines():
                if line.startswith("tfd_fleet_watchers"):
                    return int(float(line.split()[-1]))
            return 0

        def watcher_loop(idx):
            """A filtered-pane consumer: full body once, then parked
            ?since=&watch= long-polls through a verifying DeltaMirror; a
            DeltaSyncError drops the mirror for ONE counted full resync."""
            mirror = DeltaMirror()
            mirrors[idx] = mirror
            etag = None
            conn = None
            while not stop.is_set():
                try:
                    if conn is None:
                        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                    if mirror.doc is None:
                        path = f"{FLEET_SNAPSHOT_PATH}?degraded=true"
                        headers = {}
                    else:
                        path = (f"{FLEET_SNAPSHOT_PATH}?degraded=true"
                                f"&since={mirror.generation}&watch=30")
                        headers = {"If-None-Match": etag} if etag else {}
                    conn.request("GET", path, headers=headers)
                    resp = conn.getresponse()
                    body = resp.read()
                except Exception:
                    if conn is not None:
                        conn.close()
                    conn = None
                    time.sleep(0.05)
                    continue
                if resp.status == 304:
                    mirror.note_unchanged()
                    continue
                if resp.status != 200:
                    counts[idx]["errors"] += 1
                    time.sleep(0.05)
                    continue
                doc = json.loads(body.decode())
                resp_etag = resp.headers.get("ETag")
                try:
                    mirror.apply(doc, resp_etag)
                except DeltaSyncError:
                    mirror = DeltaMirror()
                    mirrors[idx] = mirror
                    etag = None
                    continue
                etag = resp_etag
                counts[idx]["delta" if doc.get("delta") else "full"] += 1

        def wait_mirrors(pred, what):
            deadline = time.monotonic() + budget
            while time.monotonic() < deadline:
                if all(m is not None and m.doc is not None and pred(m) for m in mirrors):
                    return
                time.sleep(0.05)
            raise AssertionError(f"watchers never converged ({what}): "
                                 f"{[m.doc if m else None for m in mirrors]}")

        active = spawn()
        _wait_ready(port, budget, "first start")
        for idx in range(n_watchers):
            thread = threading.Thread(target=watcher_loop, args=(idx,))
            thread.start()
            threads.append(thread)
        wait_mirrors(lambda m: True, "first filtered body")
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline and parked_watchers() < 2:
            time.sleep(0.05)
        assert parked_watchers() >= 2, "watchers never parked pre-kill"
        _degrade(coords, "w", 0)
        wait_mirrors(lambda m: "w0" in m.doc["slices"]
                     and m.doc.get("filter") == "degraded=true", "pre-kill wake")
        assert all(c["delta"] >= 1 for c in counts), counts
        pre_kill = [dict(c) for c in counts]
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline and parked_watchers() < 2:
            time.sleep(0.05)
        assert parked_watchers() >= 2, "watchers never re-parked"
        os.kill(active.pid, signal.SIGKILL)
        active.wait(timeout=10)
        active = spawn()
        _wait_ready(port, budget, "restart")
        _degrade(coords, "w", 1)
        wait_mirrors(lambda m: "w1" in m.doc["slices"] and "w0" in m.doc["slices"]
                     and not m.doc.get("restored"), "post-restart convergence")
        resyncs = [counts[i]["full"] - pre_kill[i]["full"] for i in range(n_watchers)]
        assert all(r <= 1 for r in resyncs), counts
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            reference = filtered_full_body()
            if all(m.body == reference for m in mirrors):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"filtered mirrors never matched the served pane: "
                                 f"{[m.generation for m in mirrors]}")
        post_restart = [dict(c) for c in counts]
        _degrade(coords, "w", 2)
        wait_mirrors(lambda m: "w2" in m.doc["slices"], "post-restart delta")
        assert all(counts[i]["full"] == post_restart[i]["full"]
                   for i in range(n_watchers)), counts
        assert all(counts[i]["delta"] > post_restart[i]["delta"]
                   for i in range(n_watchers)), counts
        assert all(c["errors"] == 0 for c in counts), counts
    finally:
        stop.set()
        if active is not None and active.poll() is None:
            active.kill()
            active.wait(timeout=10)
        for thread in threads:
            thread.join(timeout=15)
        for server in servers:
            server.close()
        for coord in coords:
            coord.close()
    elapsed = time.monotonic() - started
    return {"spec": "fleet:watch-failover", "converged_s": round(elapsed, 3),
            "watchers": n_watchers, "resyncs_after_restart": max(resyncs),
            "deltas": [c["delta"] for c in counts], "labels": len(mirrors[0].doc["slices"])}


_PUSH_TOKEN = "chaos-notify-token"


def _push_slice_leaders(n, prefix, sweep_interval):
    """_fake_slice_leaders with the push-on-delta CHILD side wired: each
    leader carries a NotifySender and a subscription registry, its obs
    server feeds poll-header subscriptions back, and its snapshot polls
    are counted (the storm row's bound is real HTTP polls)."""
    from gpu_feature_discovery_tpu_torch.fleet import SliceTarget
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.obs.server import IntrospectionServer, IntrospectionState
    from gpu_feature_discovery_tpu_torch.peering import SliceCoordinator

    coords, servers, targets, poll_counts = [], [], [], []
    for i in range(n):
        coord = SliceCoordinator(0, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5,
                                 peer_token=_PUSH_TOKEN, push_notify=True,
                                 sweep_interval=sweep_interval)
        coord.publish_local(_leader_verdict(prefix, i), "full")
        counter = {"polls": 0}

        def counted(_coord=coord, _counter=counter):
            _counter["polls"] += 1
            return _coord.snapshot_response()

        server = IntrospectionServer(obs_metrics.REGISTRY, IntrospectionState(60.0),
                                     addr="127.0.0.1", port=0, peer_snapshot=counted,
                                     peer_token=_PUSH_TOKEN,
                                     notify_subscribe=coord.notify_subscriptions.observe_poll)
        server.start()
        coords.append(coord)
        servers.append(server)
        poll_counts.append(counter)
        targets.append(SliceTarget(name=f"{prefix}{i}", hosts=(f"127.0.0.1:{server.port}",)))
    return coords, servers, targets, poll_counts


def _push_collector_stack(targets, sweep_interval):
    """A push-enabled FleetCollector and the server that receives its
    children's /peer/notify POSTs, the notify port wired: the parent
    side of cmd/fleet.py, in process."""
    from gpu_feature_discovery_tpu_torch.fleet import FleetCollector
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.obs.server import IntrospectionServer, IntrospectionState

    collector = FleetCollector(targets, peer_timeout=0.5, peer_token=_PUSH_TOKEN,
                               push_notify=True, sweep_interval=sweep_interval)
    server = IntrospectionServer(obs_metrics.REGISTRY, IntrospectionState(60.0),
                                 addr="127.0.0.1", port=0, peer_token=_PUSH_TOKEN,
                                 peer_notify=collector.mark_dirty)
    server.start()
    collector.set_notify_port(server.port)
    return collector, server


def run_fleet_notify_lost(workdir, timeout_s=None):
    """fleet:notify-lost: the first change's upward notification is
    DROPPED at the child's sender (notify.drop). The parent stays clean
    (no early poll, no pane movement), the change converges within ONE
    sweep window, and a second change with the wire healthy converges
    well inside the sweep period."""
    from gpu_feature_discovery_tpu_torch.utils import faults

    budget = timeout_s or 60.0
    sweep_s = 2.0
    started = time.monotonic()
    coords, servers = [], []
    collector = parent_server = None
    try:
        coords, servers, targets, _polls = _push_slice_leaders(3, "nl", sweep_s)
        collector, parent_server = _push_collector_stack(targets, sweep_s)

        def entry(name):
            return collector.inventory_payload()["slices"][name]

        collector.poll_round()
        assert all(entry(f"nl{i}")["healthy_hosts"] == 2 for i in range(3)), (
            collector.inventory_payload())
        assert all(len(c.notify_subscriptions) == 1 for c in coords), (
            "cold sweep must subscribe the parent at every child")
        swept_at = time.monotonic()
        # Drain every in-flight delivery before arming the drop: the fault
        # must land on coords[1]'s next notification and nothing else.
        collector.notify_sender.flush()
        for coord in coords:
            coord.notify_sender.flush()
        registry = faults.load_fault_spec("notify.drop:fail:1")
        coords[1].publish_local(_leader_verdict("nl", 1, 1), "full")
        coords[1].notify_sender.flush()
        assert "notify.drop" not in registry.armed_sites(), (
            "the armed drop must have consumed the notification")
        collector.poll_round()
        assert entry("nl1")["healthy_hosts"] == 2, (
            "a dropped notification must not reach the pane early")
        deadline = swept_at + sweep_s + budget
        while time.monotonic() < deadline:
            collector.poll_round()
            if entry("nl1")["healthy_hosts"] == 1:
                break
            time.sleep(0.05)
        lost_converged_s = time.monotonic() - swept_at
        assert entry("nl1")["healthy_hosts"] == 1, collector.inventory_payload()
        assert lost_converged_s <= sweep_s + 1.0, (
            f"lost notification must converge within one sweep window, took "
            f"{lost_converged_s:.2f}s against {sweep_s}s")
        flowed_at = time.monotonic()
        coords[1].publish_local(_leader_verdict("nl", 1, 2), "full")
        coords[1].notify_sender.flush()
        deadline = flowed_at + budget
        while time.monotonic() < deadline:
            collector.poll_round()
            if entry("nl1")["healthy_hosts"] == 2:
                break
            time.sleep(0.02)
        pushed_converged_s = time.monotonic() - flowed_at
        assert entry("nl1")["healthy_hosts"] == 2, collector.inventory_payload()
        assert pushed_converged_s < sweep_s, (
            f"the push path must beat the sweep cadence, took {pushed_converged_s:.2f}s "
            f"against {sweep_s}s")
    finally:
        faults.reset()
        if collector is not None:
            collector.close()
        if parent_server is not None:
            parent_server.close()
        for server in servers:
            server.close()
        for coord in coords:
            coord.close()
    elapsed = time.monotonic() - started
    return {"spec": "fleet:notify-lost", "converged_s": round(elapsed, 3), "labels": 3,
            "lost_converged_s": round(lost_converged_s, 3),
            "pushed_converged_s": round(pushed_converged_s, 3)}


def run_fleet_notify_storm(workdir, timeout_s=None):
    """fleet:notify-storm: one child republishes 50 times in a burst while
    two siblings stay idle. The stormed child costs at most a handful of
    real snapshot polls, the siblings none between sweeps, and the pane
    lands on the LAST published verdict."""
    budget = timeout_s or 60.0
    storm = 50
    started = time.monotonic()
    coords, servers, poll_counts = [], [], []
    collector = parent_server = None
    try:
        # A sweep far beyond the row's runtime: every poll after the cold
        # start is push-driven.
        coords, servers, targets, poll_counts = _push_slice_leaders(3, "ns", 300.0)
        collector, parent_server = _push_collector_stack(targets, 300.0)
        collector.poll_round()
        baseline = [c["polls"] for c in poll_counts]
        for k in range(storm):
            coords[0].publish_local(_leader_verdict("ns", 0, 2 if k % 2 == 0 else 1), "full")
        coords[0].notify_sender.flush()
        deadline = time.monotonic() + budget
        rounds = 0
        while time.monotonic() < deadline:
            collector.poll_round()
            rounds += 1
            entry = collector.inventory_payload()["slices"]["ns0"]
            if entry["healthy_hosts"] == 1 and rounds >= 3:
                break
            time.sleep(0.02)
        entry = collector.inventory_payload()["slices"]["ns0"]
        assert entry["healthy_hosts"] == 1, entry
        storm_polls = poll_counts[0]["polls"] - baseline[0]
        assert 1 <= storm_polls <= 5, (
            f"storm of {storm} notifications must coalesce to a handful of polls, "
            f"saw {storm_polls}")
        for i in (1, 2):
            assert poll_counts[i]["polls"] == baseline[i], (
                f"idle sibling ns{i} polled during the storm: "
                f"{poll_counts[i]['polls']} vs {baseline[i]}")
    finally:
        if collector is not None:
            collector.close()
        if parent_server is not None:
            parent_server.close()
        for server in servers:
            server.close()
        for coord in coords:
            coord.close()
    elapsed = time.monotonic() - started
    return {"spec": "fleet:notify-storm", "converged_s": round(elapsed, 3), "labels": 3,
            "storm_polls": storm_polls, "storm_notifications": storm}


# ---------------------------------------------------------------------------
# the event loop's worker_died wake
# ---------------------------------------------------------------------------

def run_reconcile_chaos(scenario, workdir, timeout_s=None, backend="mock:v4-8",
                        probe_timeout_s=2.0, extra_cli=None, scrape=False, observe=None):
    """reconcile:broker-death: SIGKILL the broker worker of an event-mode
    daemon under a 60 s sleep interval; fresh full labels (a full cycle
    against a respawned worker) must land within 2x --probe-timeout of
    the kill, through a ``worker_died`` wake, with zero failed cycles.
    Runs the real supervised loop and the real broker on a thread of this
    process; the metrics are read from the registry the daemon records
    into, and, with ``scrape``, from its live ``/metrics`` as well.

    ``backend``, ``probe_timeout_s`` and ``extra_cli`` let the same row
    run against the card (``--backend gpu --with-burnin``);
    ``observe(stage, info)`` is called just before the kill
    (``"before_kill"``, with the worker's pid) and once the recovery is
    asserted, before SIGTERM (``"recovered"``, with the killed and the
    new worker's pids and the numbers of the result)."""
    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.cmd.main import run
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.resource import factory

    if scenario != "broker-death":
        raise ValueError(f"unknown reconcile chaos scenario {scenario!r}")
    budget = timeout_s or 30.0
    machine = os.path.join(workdir, "machine-type")
    with open(machine, "w") as f:
        f.write("Chaos Node\n")
    out = os.path.join(workdir, "tfd")
    obs_metrics.reset_for_tests()
    metrics_port = _free_port() if scrape else 0
    cli_values = {
        "oneshot": False,
        "output-file": out,
        "machine-type-file": machine,
        # The interval alone could NOT recover in budget: only the
        # worker_died wake explains the latency.
        "sleep-interval": "60s",
        "reconcile": "event",
        "reconcile-debounce": "0.05s",
        "probe-timeout": f"{probe_timeout_s}s",
        "init-backoff-max": "0.02s",
        "metrics-port": str(metrics_port),
    }
    if scrape:
        cli_values["metrics-addr"] = "127.0.0.1"
    cli_values.update(extra_cli or {})
    config = new_config(cli_values=cli_values, environ={})
    env = _Env()
    env.set("TFD_BACKEND", port_backend(backend))
    sigs = queue.Queue()
    result = {}

    def target():
        try:
            result["restart"] = run(lambda: factory.build_manager(config), config, sigs,
                                    supervisor=Supervisor(config), interconnect=Empty())
        except BaseException as e:  # noqa: BLE001 - reported as violation
            result["error"] = e

    t = threading.Thread(target=target)
    started = time.monotonic()
    t.start()
    info = {}
    try:
        deadline = started + budget

        def full_cycles():
            return obs_metrics.CYCLES_TOTAL.value(outcome="full")

        while time.monotonic() < deadline and (
                full_cycles() < 1 or obs_metrics.BROKER_UP.value() != 1):
            time.sleep(POLL_S)
        assert full_cycles() >= 1, f"daemon never served a full cycle: {result.get('error')!r}"
        full_before = full_cycles()
        client = sandbox.get_broker(config)
        pid = client.pid
        assert pid is not None, "no live broker worker to kill"
        if observe is not None:
            observe("before_kill", {"killed_pid": pid, "output_file": out})
        t_kill = time.monotonic()
        os.kill(pid, signal.SIGKILL)
        recovery_budget = 2 * probe_timeout_s
        while time.monotonic() - t_kill < recovery_budget:
            if full_cycles() > full_before and obs_metrics.BROKER_UP.value() == 1:
                break
            time.sleep(POLL_S)
        elapsed_kill = time.monotonic() - t_kill
        assert full_cycles() > full_before and obs_metrics.BROKER_UP.value() == 1, (
            f"no fresh full cycle within 2x probe-timeout ({recovery_budget:.1f}s) of the "
            "worker kill")
        wakes = obs_metrics.RECONCILE_WAKES.value(reason="worker_died")
        assert wakes >= 1, (
            "recovery happened without a worker_died wake — the 60s interval cannot "
            "explain it, so what did?")
        assert obs_metrics.BROKER_RESPAWNS.value() >= 1
        failed = obs_metrics.CYCLES_TOTAL.value(outcome="failed")
        assert failed == 0, (
            "the kill cost a failed cycle — death was discovered on the RPC, not by the watch")
        labels = read_labels(out)
        assert "nvidia.com/gpu.count" in labels, labels
        assert "error" not in result, result.get("error")
        assert t.is_alive(), "daemon loop ended without error or signal"
        info = {"killed_pid": pid, "worker_pid": sandbox.get_broker(config).pid,
                "kill_to_full_s": elapsed_kill, "killed_at": t_kill,
                "worker_died_wakes": wakes, "failed_cycles": failed,
                "output_file": out, "metrics_port": metrics_port}
        if scrape:
            info["scraped_worker_died_wakes"] = _scrape_value(
                metrics_port, 'tfd_reconcile_wakes_total{reason="worker_died"}')
            info["scraped_failed_cycles"] = _scrape_value(
                metrics_port, 'tfd_cycles_total{outcome="failed"}')
            assert info["scraped_worker_died_wakes"] == wakes, info
        if observe is not None:
            observe("recovered", info)
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=max(10.0, probe_timeout_s))
        env.restore()
    assert not t.is_alive(), "daemon did not honor SIGTERM"
    assert result.get("restart") is False
    assert not os.path.exists(out), "clean shutdown must remove the file"
    return {"spec": f"reconcile:{scenario}", "converged_s": round(elapsed_kill, 3),
            "labels": len(labels), **{k: v for k, v in info.items() if k != "output_file"}}


# ---------------------------------------------------------------------------
# actuation rows
# ---------------------------------------------------------------------------

def run_actuation_chaos(scenario, workdir, timeout_s=None):
    if scenario == "sick-chip-cordon":
        return run_sick_chip_cordon(workdir, timeout_s=timeout_s)
    if scenario == "budget-storm":
        return run_budget_storm(workdir, timeout_s=timeout_s)
    raise ValueError(f"unknown actuation chaos scenario {scenario!r}")


def run_sick_chip_cordon(workdir, timeout_s=None):
    """actuation:sick-chip-cordon: a real sick chip (chip.3.sick, two
    shots, so the verdict holds the 2-cycle window) under
    --actuation=enforce. The advice family fires within the window,
    every advice label is gone once the fault drains, and the non-advice
    labels converge byte-identical to the healthy pre-fault set."""
    from gpu_feature_discovery_tpu_torch.actuation.engine import (
        ADVICE_LABELS,
        CORDON_ADVICE_LABEL,
        REASON_SICK_CHIPS,
        SCHEDULABLE_LABEL,
    )
    from gpu_feature_discovery_tpu_torch.lm.health import HEALTH_PROBE_MS
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.reset_for_tests()
    result = run_chaos(
        "chip.3.sick:fail:2", workdir, timeout_s=timeout_s or 90.0,
        extra_cli={"actuation": "enforce", "actuation-window": "2"},
        expect_transient=[f"{SCHEDULABLE_LABEL}=false",
                          f"{CORDON_ADVICE_LABEL}={REASON_SICK_CHIPS}"],
        expect_final=["nvidia.com/gpu.chip.3.ok=true", "nvidia.com/gpu.chips.sick=0"],
        expect_absent=list(ADVICE_LABELS),
        capture_labels=True,
    )
    cycles = obs_metrics.ACTUATION_CONVERGENCE_CYCLES.value()
    assert 0 < cycles <= 2, (
        f"advice fired after {cycles} confirming cycles — outside the 2-cycle window")
    armed = result.pop("armed_labels")
    converged = result.pop("converged_labels")
    assert armed is not None, "healthy pre-fault snapshot never captured"
    # probe-ms is a per-probe timing, volatile by design.
    volatile = set(ADVICE_LABELS) | {HEALTH_PROBE_MS}
    baseline = {k: v for k, v in armed.items() if k not in volatile}
    non_advice = {k: v for k, v in converged.items() if k not in volatile}
    assert non_advice == baseline, (
        "non-advice labels moved across the cordon/uncordon round trip: "
        f"{sorted(set(baseline.items()) ^ set(non_advice.items()))}")
    result["spec"] = "actuation:sick-chip-cordon"
    result["convergence_cycles"] = int(cycles)
    return result


def run_budget_storm(workdir, timeout_s=None):
    """actuation:budget-storm: every worker of a 6-worker slice reads sick
    at once under --actuation=enforce and --max-actuated-fraction=0.25.
    At most ceil(0.25 * 6) = 2 hosts (the two lowest worker ids) settle
    with advice, the rest raise tfd_actuation_budget_exhausted, and no
    daemon exits."""
    from torch_slice_fixture import PortSliceHarness

    from gpu_feature_discovery_tpu_torch.actuation.engine import (
        advice_present,
        budget_allowance,
    )
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    budget = timeout_s or 90.0
    workers = 6
    allowed = budget_allowance(workers, 0.25)
    assert allowed == 2, f"budget arithmetic drifted: {allowed}"
    started = time.monotonic()
    # Window 3: the first poll rounds propagate every member's verdict
    # before anyone's streak matures.
    harness = PortSliceHarness(
        workdir, workers=workers, sleep_interval="0.05s",
        extra_cli={"actuation": "enforce", "actuation-window": "3",
                   "max-actuated-fraction": "0.25"},
        sick_workers=tuple(range(workers))).start()

    def advised(snapshots):
        return sorted(wid for wid, s in snapshots.items() if advice_present(s))

    try:
        harness.wait_for(lambda s: advised(s) == list(range(allowed)), timeout=budget,
                         what=f"advice settled on the {allowed} lowest worker ids")
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            now_advised = advised(harness.snapshot())
            assert len(now_advised) <= allowed, (
                f"budget overrun: {now_advised} hosts carry advice (allowed {allowed})")
            time.sleep(0.05)
        assert now_advised == list(range(allowed)), (
            f"advised set drifted after convergence: {now_advised}")
        assert obs_metrics.ACTUATION_BUDGET_EXHAUSTED.value() == 1, (
            "suppressed members never raised tfd_actuation_budget_exhausted")
        assert obs_metrics.ACTUATION_TRANSITIONS.value(action="budget-suppressed") >= 1, (
            "no budget-suppressed transition recorded")
        for worker in harness.workers:
            assert worker.alive, f"worker {worker.worker_id} exited under the storm"
        final = harness.workers[0].labels()
    finally:
        harness.stop()
    elapsed = time.monotonic() - started
    return {"spec": "actuation:budget-storm", "converged_s": round(elapsed, 3),
            "advised": allowed, "labels": len(final)}


# ---------------------------------------------------------------------------
# the generic contract
# ---------------------------------------------------------------------------

def run_chaos(spec, workdir, backend="mock:v4-8", probe_timeout="0.5s",
              assert_probe_kills=None, expect_transient=None, expect_final=None,
              expect_absent=None, timeout_s=None, backends=None, require_always=None,
              extra_cli=None, capture_labels=False):
    """Execute one chaos scenario; returns a result dict (raises
    AssertionError on contract violations).

    ``probe_timeout`` bounds the sandboxed probe. ``assert_probe_kills``,
    when set, binds the introspection server on an ephemeral port and
    asserts through a live /metrics scrape that exactly that many probe
    children were SIGKILLed and that recovery landed within one
    probe-timeout + recovery window.

    ``expect_transient`` ("key=value") must each be OBSERVED before
    convergence; ``expect_final`` must hold and ``expect_absent`` keys be
    gone IN the converged set.

    ``chip.<i>.*`` specs run the per-chip path: --with-burnin
    --burnin-interval=1 with --probe-broker=off, the probe in process on
    eight CPU devices against ``mock-gpu:8``, armed once the first probe
    has published health labels.

    ``backends`` runs the multi-backend registry cycle instead of the
    TFD_BACKEND single path: full = every enabled family's count key,
    clean = every family's degraded marker gone; ``require_always`` must
    hold in EVERY non-empty observation.

    ``extra_cli`` merges --flag values into the daemon's config;
    ``capture_labels`` adds the label set at fault-arm time
    (``armed_labels``) and the converged set (``converged_labels``).
    ``backend`` is a twin token (``mock:v4-8``) or the port's own (``gpu``
    runs the row against the card)."""
    from gpu_feature_discovery_tpu_torch.cmd.main import run
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import (
        DEGRADED_LABEL,
        UNHEALTHY_CYCLES_LABEL,
        Supervisor,
    )
    from gpu_feature_discovery_tpu_torch.config.flags import new_config, parse_duration
    from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.resource import factory
    from gpu_feature_discovery_tpu_torch.utils import faults

    kind, _, scenario = spec.partition(":")
    drivers = {"slice": run_slice_chaos, "reconcile": run_reconcile_chaos,
               "fleet": run_fleet_chaos, "actuation": run_actuation_chaos}
    if kind in drivers:
        return drivers[kind](scenario, workdir, timeout_s=timeout_s)
    chip_faults = any(e.strip().startswith("chip.") for e in spec.split(",") if e.strip())
    backend = port_backend(backend)
    env = _Env()
    if chip_faults:
        env.set("TFD_BURNIN_ALLOW_CPU", "1")
        env.set("TFD_BURNIN_GEOMETRY", "128x2")
        if backend == port_backend("mock:v4-8"):
            backend = port_backend("mock:v5e-8")  # 8 chips, one per CPU device
        env.set(CPU_DEVICES_ENV, backend.partition(":")[2] or "1")
        if timeout_s is None:
            timeout_s = 60.0
    machine = os.path.join(workdir, "machine-type")
    with open(machine, "w") as f:
        f.write("Chaos Node\n")
    out = os.path.join(workdir, "tfd")
    cli_values = {
        "oneshot": False,
        "output-file": out,
        "machine-type-file": machine,
        "sleep-interval": "0.01s",
        "init-backoff-max": "0.02s",
        # Generous bounds: chaos proves containment and recovery; the
        # escalation bounds have their own tests.
        "init-retries": "50",
        "max-consecutive-failures": "50",
        "probe-timeout": probe_timeout,
    }
    if chip_faults:
        cli_values.update({
            "with-burnin": True,
            "burnin-interval": "1",
            # The probe in process, where its devices live.
            "probe-broker": "off",
            "labeler-timeout": "60s",
        })
    if extra_cli:
        cli_values.update(extra_cli)
    degraded_markers = [DEGRADED_LABEL, UNHEALTHY_CYCLES_LABEL]
    full_keys = ["nvidia.com/gpu.count"]
    if backends:
        from gpu_feature_discovery_tpu_torch.lm.pjrt_family import (
            FAMILY_COUNT_KEYS,
            FAMILY_DEGRADED_LABELS,
        )
        from gpu_feature_discovery_tpu_torch.resource import registry

        cli_values["backends"] = backends
        cli_values["probe-isolation"] = "none"
        families = [registry.provider_for(t.strip()).family
                    for t in backends.split(",") if t.strip()]
        full_keys = [FAMILY_COUNT_KEYS[f] for f in families]
        degraded_markers.extend(FAMILY_DEGRADED_LABELS[f] for f in families)
    metrics_port = None
    if assert_probe_kills is not None:
        obs_metrics.reset_for_tests()
        metrics_port = _free_port()
        cli_values["metrics-addr"] = "127.0.0.1"
        cli_values["metrics-port"] = str(metrics_port)
    config = new_config(cli_values=cli_values, environ={})
    # The registry cycle resolves --backends only while TFD_BACKEND (the
    # forced single-backend override) is unset.
    env.set("TFD_BACKEND", None if backends else backend)
    if not chip_faults:
        faults.load_fault_spec(spec)
    # chip.* specs arm once the first probe has published health labels:
    # the fault lands in a RUNNING healthy daemon, on steady-state probes.
    sigs = queue.Queue()
    result = {}

    def target():
        try:
            result["restart"] = run(lambda: factory.build_manager(config), config, sigs,
                                    supervisor=Supervisor(config), interconnect=Empty())
        except BaseException as e:  # noqa: BLE001 - reported as violation
            result["error"] = e

    expect_transient = list(expect_transient or [])
    final_pairs = [e.partition("=")[::2] for e in (expect_final or [])]
    expect_absent = list(expect_absent or [])
    always_pairs = [e.partition("=")[::2] for e in (require_always or [])]

    t = threading.Thread(target=target)
    started = time.monotonic()
    t.start()
    try:
        deadline = started + (timeout_s or CONVERGE_TIMEOUT_S)
        ever_present = False
        ever_degraded = False
        armed = not chip_faults
        armed_snapshot = None
        seen_transient = set()
        converged = None
        while time.monotonic() < deadline:
            labels = read_labels(out)
            if labels:
                ever_present = True
                if not armed and "nvidia.com/gpu.health.ok" in labels:
                    armed_snapshot = dict(labels)
                    faults.load_fault_spec(spec)
                    armed = True
                if DEGRADED_LABEL in labels:
                    ever_degraded = True
                for exp in expect_transient:
                    key, _, value = exp.partition("=")
                    if labels.get(key) == value:
                        seen_transient.add(exp)
                for key, value in always_pairs:
                    assert labels.get(key) == value, (
                        f"require-always {key}={value} violated: {labels.get(key)!r} (a "
                        "degraded sibling family must not interrupt a healthy one)")
                full = all(k in labels for k in full_keys)
                clean = not any(m in labels for m in degraded_markers)
                extras_ok = (len(seen_transient) == len(expect_transient)
                             and all(labels.get(k) == v for k, v in final_pairs)
                             and not any(k in labels for k in expect_absent))
                if full and clean and extras_ok:
                    converged = dict(labels)
                    break
            if not t.is_alive():
                break
            time.sleep(POLL_S)
        converged_at = time.monotonic()
        elapsed = converged_at - started

        assert "error" not in result, f"daemon loop exited under faults: {result['error']!r}"
        assert t.is_alive(), "daemon loop ended without error or signal"
        assert ever_present, "label file never appeared — labels went absent"
        assert converged is not None, (
            f"did not converge to full clean labels (transients seen: "
            f"{sorted(seen_transient)}); last: {read_labels(out)}")
        if chip_faults:
            # A sick or slow CHIP is a measurement, never a daemon fault.
            assert not ever_degraded, "chip fault escalated to full-node DEGRADED"
        if assert_probe_kills is not None:
            # Recovery prompt after the kill: elapsed runs from daemon
            # start, so it also pays the epoch's setup and the respawn.
            budget = parse_duration(probe_timeout) + 5.0
            assert elapsed < budget, (
                f"converged in {elapsed:.2f}s, outside the probe-timeout + recovery window "
                f"({budget:.2f}s)")
            kills = _scrape_value(metrics_port, "tfd_probe_kills_total")
            assert kills == float(assert_probe_kills), (
                f"expected tfd_probe_kills_total=={assert_probe_kills}, scraped {kills}")
            degraded_now = _scrape_value(metrics_port, "tfd_degraded")
            assert degraded_now == 0.0, f"tfd_degraded still {degraded_now} after convergence"
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=30 if chip_faults else max(5.0, parse_duration(probe_timeout)))
        faults.reset()
        env.restore()
    assert not t.is_alive(), "daemon did not honor SIGTERM"
    assert result.get("restart") is False
    assert not os.path.exists(out), "clean shutdown must remove the file"
    result = {"spec": spec, "converged_s": round(elapsed, 3), "labels": len(converged),
              "converged_at": converged_at}
    if capture_labels:
        result["armed_labels"] = armed_snapshot
        result["converged_labels"] = converged
    return result


def run_row(spec, workdir):
    """One row of the matrix as the tests run it: its expectations and
    budget from EXPECTATIONS. Returns (result, budget in seconds)."""
    kwargs = dict(EXPECTATIONS.get(spec, {}))
    budget = kwargs.get("timeout_s", CONVERGE_TIMEOUT_S)
    return run_chaos(spec, workdir, **kwargs), budget


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spec", default=os.environ.get("TFD_FAULT_SPEC", ""),
                        help="fault spec or scenario (defaults to $TFD_FAULT_SPEC)")
    parser.add_argument("--backend", default="mock:v4-8",
                        help="the backend of the daemon under test: a twin token "
                        f"({', '.join(f'{k} = {v}' for k, v in BACKENDS.items())}) or "
                        "the port's own (gpu, mock-gpu:<n>)")
    parser.add_argument("--probe-timeout", default="0.5s",
                        help="--probe-timeout handed to the daemon under test (Go duration "
                        "or bare seconds)")
    parser.add_argument("--assert-probe-kills", type=int, default=None,
                        help="scrape /metrics after convergence and assert exactly this many "
                        "probe children were SIGKILLed, with recovery inside one "
                        "probe-timeout + recovery window")
    parser.add_argument("--expect-transient", action="append", default=None,
                        metavar="KEY=VALUE",
                        help="label that must be OBSERVED before convergence (repeatable)")
    parser.add_argument("--expect-final", action="append", default=None, metavar="KEY=VALUE",
                        help="label that must hold IN the converged set (repeatable)")
    parser.add_argument("--expect-absent", action="append", default=None, metavar="KEY",
                        help="label key that must be gone from the converged set (repeatable)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="convergence budget in seconds (default 8; chip rows 60)")
    parser.add_argument("--backends", default=None,
                        help="run the multi-backend registry cycle with this --backends value "
                        "(e.g. 'mock-gpu:2,cpu') instead of the TFD_BACKEND single path")
    parser.add_argument("--require-always", action="append", default=None,
                        metavar="KEY=VALUE",
                        help="label that must hold in EVERY non-empty observation (repeatable)")
    parser.add_argument("--print-labels", action="store_true",
                        help="print the converged label set as one JSON line before the "
                        "summary (fault-spec rows)")
    args = parser.parse_args(argv)
    if not args.spec:
        parser.error("no fault spec: pass --spec or set TFD_FAULT_SPEC")
    # The daemon under test parses the spec through the fault registry;
    # no half-set environment copy may reach it.
    os.environ.pop("TFD_FAULT_SPEC", None)
    with tempfile.TemporaryDirectory(prefix="tfd-chaos-") as workdir:
        result = run_chaos(
            args.spec, workdir, backend=args.backend, probe_timeout=args.probe_timeout,
            assert_probe_kills=args.assert_probe_kills,
            expect_transient=args.expect_transient, expect_final=args.expect_final,
            expect_absent=args.expect_absent, timeout_s=args.timeout,
            backends=args.backends, require_always=args.require_always,
            capture_labels=args.print_labels)
    if args.print_labels:
        print(json.dumps(result.get("converged_labels"), sort_keys=True))
    print(f"chaos: spec={result['spec']!r} converged in {result['converged_s']}s "
          f"with {result['labels']} labels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
