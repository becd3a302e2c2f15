#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port, ``gpu_feature_discovery_tpu_torch``.

Run from the repo root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device``   — CUDA must be available (else exit 2 with no result);
                  the card's name and power limit from nvidia-smi.
2. ``build``    — compile every kernel from the repo's sources with nvcc.
3. ``kernels``  — each hand-written kernel against its plain PyTorch
                  version on the card, at the main path's shapes, with
                  its slip twins, bitwise determinism and kernels per
                  call; timed with CUDA events in turns with a library
                  call, beside its bound and ptxas's report. The
                  burn-in's RMS epilogue (one more ``kernels`` line):
                  held to its plain version at the probe's, the CPU's
                  and the verdicts' layers and one off the 8-float
                  vector, on grids of 1, 16 and 132 SMs; NaN and Inf
                  reaching rms and the checksum; its ticket counter
                  back at 0; bad inputs refused with no launch; one
                  layer timed as a graph of its own in turns with the
                  plain version and ``rms_norm``; the burn-in graph's
                  replay and kernels per replay against the same pass
                  captured with the plain epilogue. Then a
                  seeded sweep (``--seed``, numpy) of ``hbm_stream_sum``
                  over 240 draws of 1 to 2048 chunks on grids of 1 to the
                  card's SMs: the chunk and tile patterns exact, each with
                  one unit slipped or doubled caught, random buffers
                  within rel 1e-6 of the plain version, one kernel per
                  launch (torch.profiler, batch by batch); and a
                  misaligned view, a strided view, float64 and rows that
                  are not whole chunks each refused with a ValueError and
                  no launch. One ``kernels_sweep`` line: the draws, the
                  chunk and SM ranges, the largest relative error.
4. ``collectives``— the multi-GPU probes on every card: NCCL's first use
                  apart, through the several-device helper even on one
                  card; the timed all-reduce (32 MiB per card: on one card
                  the one-device copy, timed beside NCCL over the card,
                  with no NCCL call in the probes) and its timing gates
                  (device ms beside the host's queueing ms and each
                  card's outcome), the ring sweeps over
                  the chip mesh and the (data, model) mesh, peer copies
                  per ring edge, the DP+TP train step against the same
                  step on the CPU, the dry run, and the node probe's
                  ``ici_*`` keys.
5. ``main_path``— one oneshot ``--with-burnin`` label cycle through the
                  CLI entry point; checks the label file (host facts
                  included, and the ``health.ici.*`` labels on several
                  cards) and that the cycle launched every kernel
                  (launch counts zeroed just before, read just after).
6. ``host_facts``— NVML (loaded with ctypes) against nvidia-smi field by
                  field; a fresh child running the NVML-only manager and
                  the labelers without torch and without a CUDA context;
                  ``--backends native`` against ``--backends gpu``; the
                  three MIG strategies as the card's MIG mode implies;
                  family, generation, slice capability and the PCI count
                  against sysfs; NVML's cost beside ``gpu.acquire``; and
                  a ``fault5`` line: the probe report's device UUIDs
                  among nvidia-smi's (``--query-gpu=uuid``), device 0's
                  equal to it on one card. Where NVML lists more GPUs
                  than CUDA (``per_device_labels`` false, said on a
                  line after ``device``), every phase expects no
                  ``chip.<i>.*`` label and ``slice``/``actuation`` fail.
7. ``daemon``   — the supervised daemon loop with the probe in process
                  (``--probe-broker off``): ``cmd.main.run`` on a worker
                  thread with ``--burnin-interval 2 --sleep-interval 1s``
                  (one ``daemon_cycle`` line per cycle), its /metrics
                  scraped (``tfd_broker_up`` 0, ``tfd_chip_*`` from the
                  in-process probe), SIGHUP and SIGTERM through its signal
                  queue; a ``methodology`` line from three fresh probes'
                  oneshots in this process: the published
                  ``health.matmul-tflops`` and ``health.hbm-gbps`` are the
                  2048 x 4 burn-in's flops and the 256 MiB stream's bytes
                  over the report's own median device ms (within the ms'
                  printed rounding), ``health.timing=device-profiler``;
                  ``--chip-probes=false`` publishes the same keys less the
                  per-device family, with the same verdicts; a provider
                  registered through ``registry.register`` (the CUDA
                  manager under ``smoke-gpu``) is listed after the in-tree
                  ones and publishes ``gpu``'s keys and verdicts with 1 + 3
                  launches; then the real CLI as a subprocess at its
                  defaults, so through the broker worker, with real
                  signals (``daemon_cli``), its introspection server
                  scraped over HTTP (promtool_lite, the broker, chip,
                  first-use, kernel-cache and restart-to-labels series
                  against the labels and the log, /healthz, /readyz, an
                  authenticated ``POST /probe`` wake, the same port after
                  SIGHUP, a refused port after SIGTERM).
8. ``broker``   — ``cmd.main.run`` at the default isolation and broker
                  settings: the burn-in and the HBM kernel run in the
                  broker worker process (one ``broker_cycle`` line per
                  cycle, launches read from the reports it ships); the
                  first write carries the host facts; a ``broker.hang``
                  and a ``broker.crash`` fault shot are killed and
                  respawned to fresh health labels, and the registry
                  counts one kill and two respawns.
9. ``config_registry`` — the CLI in a fresh process from a config file
                  (``backends: gpu,cpu``, time-slicing replicas 4) and
                  one CLI flag the file contradicts: the file's replicas
                  and -SHARED product, the CLI over the file, one broker
                  worker per family (only the gpu one maps CUDA and NVML
                  and launches hbm_stream_sum, counted from its probe
                  reports), ``tfd_backend_up`` per family on /metrics, a
                  live reload by atomic rename (replicas 2, the cpu family
                  and its worker gone, one ``config_changed`` wake, a new
                  gpu worker whose launch count starts again); then a
                  second CLI under ``pjrt_init.cpu:fail:<n>`` where the
                  cpu family alone degrades while the gpu family keeps
                  fresh health labels, and recovers.
10. ``slice``   — three CLI daemons on the one card form one slice over
                  127.0.0.1 (``WORKER_HOSTNAMES``/``WORKER_ID``,
                  ``--slice-coordination auto``, a ``--peer-token``), each
                  at its defaults through its own broker worker with
                  ``--backends gpu --with-burnin`` and one shared, fresh
                  kernel cache: worker 0 leads and followers see it; the
                  leader's ``slice.sick-chips`` follows worker 2's card
                  verdict under ``chip.0.sick:fail:1`` from 1 back to 0
                  (pushed by ``POST /peer/notify``); ``/peer/snapshot`` on
                  worker 1 answers 403 / 401 / 200 with a strong ETag /
                  304; the leader's 304s and reused connections; SIGTERM
                  of the leader promotes worker 1 (healthy-hosts 2,
                  degraded) with the survivors' node-local labels
                  unchanged; 1 + 3k launches of ``hbm_stream_sum`` in each
                  worker, none in a labeling process. The ``fleet`` line
                  rides the same daemons: a region collector (``python -m
                  gpu_feature_discovery_tpu_torch fleet-collector``) over
                  the three and a root collector over it (``--upstream-mode
                  collectors``), both with the token: the region's entry
                  follows worker 2's sick verdict 1 -> 0, equals the
                  leader's ``/peer/snapshot`` section, and the root serves
                  it under ``region/<name>/<slice>``; a re-GET with
                  ``If-None-Match`` is a 304, an anonymous one 403;
                  ``tfd_fleet_*`` scraped live; neither collector maps
                  ``libcuda.so`` or ``libnvidia-ml.so``; after the
                  leader's SIGTERM the chain walk reaches worker 1 (2 of
                  3 hosts, degraded); once every daemon is down the entry
                  goes stale under the 2-miss rule with its last verdict
                  kept, on the root too; both collectors exit 0 on
                  SIGTERM.
11. ``actuation``— ``--version`` (exit 0, the port's string, no torch
                  imported); then three such CLI daemons with ``--actuation
                  enforce --actuation-window 2 --max-actuated-fraction
                  0.25`` (an allowance of 1 host of 3), workers 1 and 2 under
                  ``chip.0.sick``, worker 2 started once worker 1 advises:
                  worker 1 advises exactly 2 full cycles after its first
                  ``chips.sick=1``; worker 2 is held back by the budget; no
                  ``/peer/snapshot`` carries advice; worker 1's SIGKILL takes
                  its broker worker with it and re-ranks worker 2 into the
                  budget; worker 1 restarted on its ``--state-dir`` after its
                  lease lapsed restores no advice (one ``lease-lapsed``);
                  worker 2's advice clears 2 clean cycles after its device
                  heals; every advice change moves the advice family alone
                  and no two live daemons advise at once; 1 + 3k launches in
                  each gpu worker, none in a CLI.
12. ``deploy``  — the deployment layer (deployments/torch/) as its files
                  state it: the image's prebuild step (``python -m
                  gpu_feature_discovery_tpu_torch.ops.kernel_cache
                  --prebuild``) into a fresh directory, timed, then made
                  read-only; the static DaemonSet's container started as
                  a process from its own command and env over the image's
                  ``ENV`` (hostPath mounts but /sys, and /tmp, mapped to
                  directories, the image's kernel directory to the fresh
                  one), with no nvcc reachable: its labels, health labels
                  from its broker worker mapping the prebuilt library,
                  ``tfd_compile_cache_enabled 1``, each declared probe at
                  its initial delay and again once the health labels are
                  in, its exit within the grace period after SIGTERM; then the Job template with NODE_NAME
                  substituted and the env the chart's withBurnin renders:
                  exit 0, the health labels, ``hbm_stream_sum`` launched
                  from the prebuilt library (counted at the process's exit
                  by a start-up hook on PYTHONPATH); the directory
                  unchanged byte for byte. One ``deploy`` line.
13. ``mig``     — a STAND-IN for a MIG node (the card's MIG mode is never
                  changed): a FakeNvml inventory of one H100 in MIG mode
                  with N 1g.10gb MIG devices, each named by the card's own
                  ``GPU-`` UUID, so every one-shot child pinned by
                  ``CUDA_VISIBLE_DEVICES=<that UUID>`` runs on the card.
                  For N = 1, 3 and 7 the daemon's label sources drive one
                  round through the broker path, one child per device,
                  spawned together: each lists one CUDA device, launches
                  ``hbm_stream_sum`` 1 + 3 times from the kernel cache (no
                  library built) with an exact checksum, and the labels
                  follow the MIG table under ``single``. Recorded per
                  round: the time to its health labels, its wall and host
                  CPU seconds (``RUSAGE_CHILDREN``), the card's
                  ``memory.used`` at its peak (sampled every 50 ms) and
                  after it, back at the pre-round baseline within 16 MiB,
                  and the children's peak VmRSS. At N = 3 also three
                  steady rounds at ``--burnin-interval 1``, a round with
                  ``chip.1.sick`` (device 1 alone reads false), a round
                  with a child SIGKILLed mid-probe (its device alone),
                  ``none`` (one GPU, no rate), the in-process path's
                  children, the card as a plain GPU beside the MIG GPU,
                  and run()'s teardown mid-round leaving no child. Then
                  ``hbm_stream_sum`` on the persistent grids of the H100
                  MIG profiles' SM counts (16, 32, 60, 64, 132), each
                  exact against its plain version, timed in turns. Every
                  child sees the whole card's L2 and HBM: none of this is
                  a MIG measurement. One ``mig_run`` line per N and one
                  ``mig`` line.
14. ``busy``    — a busy card. First the footprint of a pinned child's
                  first probe, split in the warm-up's order (``total -
                  free`` after the context, the kernel library, the
                  burn-in inputs, the 256 MiB buffer, the burn-in's side
                  stream, cuBLAS's first pass, the graph capture, the
                  one-device verdicts (under 8 MiB, no NCCL call), the
                  kernel's first launch and the probe; reserved against
                  allocated). Then a holder process takes the card's free
                  memory less a margin: 64 MiB (no CUDA context fits), one
                  chosen from the split for each step where the probe can
                  fail (the buffer, the side stream, cuBLAS, the
                  capture), and ``fits``: the first probe's need plus 64
                  MiB, where a fresh classic broker worker answers ok and
                  publishes health labels. At each other margin: a fresh
                  worker's probe answers ``unacquirable`` with the error
                  it met and publishes no ``health.*`` label, and the
                  worker stays up; a worker up before the holder still
                  probes ok; the MIG stand-in at N = 3 in process
                  publishes no health label; after the
                  holder exits the busy worker holds at most its context
                  and the code its attempt loaded (the split's use at
                  the step where the attempt stops, less the caching
                  allocator's share; read against a steady baseline, with every other
                  process of the card back at it once the worker is
                  gone), and health labels return through it (1 + 3
                  launches: the busy attempts launched nothing). At the
                  context and buffer margins also: the stand-in through
                  the broker; a CLI with ``--actuation enforce`` that
                  publishes no health label, ``chips.sick``, advice or
                  ``slice.sick-chips`` and logs the busy device; and, at
                  the buffer margin, the stand-in's health after the
                  holder. One ``busy_run`` line per margin and one
                  ``busy`` line.
15. ``chaos``   — rows of the port's chaos matrix
                  (tests/torch_chaos_run.py, loaded by path) against the
                  card: ``probe.segv:fail:1`` and ``probe.hang:fail:1`` in
                  the one-shot sandbox (``--probe-broker=off
                  --probe-isolation=subprocess --with-burnin
                  --burnin-interval=1``, 20 s ``--probe-timeout``): the
                  faulty child runs the gpu select+snapshot, then dies to
                  SIGSEGV or hangs until its SIGKILL; whether it mapped
                  libcuda.so and held a context (the card's memory.used
                  while it lived), the seconds from its death to full labels
                  with ``health.ok=true``, the card's memory.used before
                  and after (within 16 MiB), the kernel's launches per
                  probing cycle; then ``reconcile:broker-death`` at the
                  daemon's 30 s ``--probe-timeout``, ``--reconcile=event``
                  and a 60 s sleep interval: the broker worker SIGKILLed,
                  the ``worker_died`` wake from a live scrape, the seconds
                  to fresh full labels (under 60 s), zero failed cycles,
                  memory.used with the new worker as with the old (within
                  16 MiB) and at the baseline after SIGTERM, the wake's
                  cycle's launches in the new worker (1 + 3), and each
                  worker's own memory report (the broker's ``memory`` op:
                  pid, the caching allocator's reserve and allocation, its
                  context's share of the card before its first
                  allocation), so a new worker above the old names the
                  process and the pool. One
                  ``chaos_row`` line per row and one ``chaos`` line;
                  ``chaos_launches`` in the ``kernels`` line.
16. ``golden``  — the reference's tier 3 on the card: the port's
                  integration script (tests/torch-integration-tests.py,
                  loaded by path) runs ``python -m
                  gpu_feature_discovery_tpu_torch --oneshot --with-burnin
                  --backends gpu`` with a made-up one-host slice and diffs
                  the whole label file both ways against
                  tests/torch-expected-output-live-h100.txt, under each
                  ``--tpu-topology-strategy`` (the strategy's own label
                  added as a regex) and against ``_strategy_expectation``;
                  the daemon's ``hbm_stream_sum`` launches (1 + 3 each)
                  are counted at its exit by the deploy phase's start-up
                  hook (``golden_launches`` in the ``kernels`` line). One
                  ``golden`` line: per scenario the label count, the
                  unmatched lines and patterns, the seconds; and how many
                  label sets the phases held to the k8s grammar.

Every label set a phase reads (``_read_labels``, ``_grammar_checked``) is
held to the k8s label grammar; a label outside it fails the phase. After
the phases a ``docs`` line: every label key a phase read has its row in
docs/torch/labels.md and every ``tfd_*`` family scraped from a live
daemon (``_scrape``) its row in docs/torch/observability.md, with the
counts; a key or family with no row fails the script.

Then a ``metrics`` line (the cost of a scrape, the exposition's size,
restart-to-labels, first use, the broker's request histogram and the
daemon's steady cycle times), a ``{"kernels": [...]}`` summary line, the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero without the last
line.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import math
import os
import re
import secrets
import shutil
import signal
import socket
import stat
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth, and the f32 rate outside the tensor
# cores (the stream sum's adds).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TIMED_LAUNCHES = 20
# The kernel sweep's numpy seed (--seed).
SEED = 0
# Whether CUDA lists exactly NVML's GPUs (joined by UUID), so the health
# labeler publishes chip.<i>.* keyed by NVML's index; set by phase_device.
# Where it does not (CUDA_VISIBLE_DEVICES naming a subset), the phases
# expect no per-device label.
PER_DEVICE_LABELS = True


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int = TIMED_LAUNCHES, warmup: int = 2) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls, by CUDA
    events on the current stream, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
    }
    emit("device", **info)
    global PER_DEVICE_LABELS
    from gpu_feature_discovery_tpu_torch.native import nvml
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    nvml_uuids = [d.uuid for d in nvml.read_inventory().devices]
    cuda_uuids = healthcheck.device_uuids(
        [torch.device("cuda", i) for i in range(info["count"])])
    where = nvml.inventory_positions(nvml_uuids, cuda_uuids)
    PER_DEVICE_LABELS = len(where) == len(nvml_uuids) == len(cuda_uuids)
    if not PER_DEVICE_LABELS:
        emit("per_device_labels", published=False, nvml_gpus=len(nvml_uuids),
             cuda_devices=len(cuda_uuids),
             note="CUDA lists other GPUs than NVML's: the phases expect no "
                  "chip.<i>.*, chips.* or straggler-chip label")
    return info


def phase_build() -> dict:
    """The port's kernel sources, each built with its own nvcc, all
    started together; returns ptxas's lines per kernel library."""
    from concurrent.futures import ThreadPoolExecutor

    from gpu_feature_discovery_tpu_torch.ops import hbm, rms_epilogue, timing_gate

    t0 = time.perf_counter()
    builders = {"hbm_stream_sum": hbm.build_kernel,
                "rms_epilogue": rms_epilogue.build_kernel,
                "timing_gate": timing_gate.build_kernel}
    with ThreadPoolExecutor(len(builders)) as pool:
        built = {name: pool.submit(fn) for name, fn in builders.items()}
        built = {name: future.result() for name, future in built.items()}
    ptxas = {name: [line for line in log.splitlines() if "ptxas" in line]
             for name, (_, log) in built.items()}
    emit(
        "build",
        seconds=time.perf_counter() - t0,
        libraries=[os.path.relpath(path, REPO) for path, _ in built.values()],
        ptxas=ptxas,
    )
    return ptxas


def in_turns(fns: dict, rounds: int = 3) -> dict:
    """Median device ms per call of each of ``fns`` over ``TIMED_LAUNCHES``
    windows, taken in turns (a, b, b, a, ...) so that clocks and
    neighbours shift every one alike; the samples beside the medians."""
    import statistics

    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            samples[name].append(cuda_ms(fns[name], warmup=0))
    return {"median_ms": {n: statistics.median(v) for n, v in samples.items()},
            "samples_ms": samples}


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host microseconds to queue one call (no wait for the device
    between calls): above the call's device time, back-to-back windows
    time the host."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / calls * 1e6


def _kernel_launches_in(fn) -> dict:
    """Device kernels that one call of ``fn`` ran, by name, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA and not \
                event.name.startswith(("Memcpy", "Memset", "cudaEvent")):
            kernels[event.name] = kernels.get(event.name, 0) + 1
    return kernels


def _kernel_us_in(fn, calls: int = TIMED_LAUNCHES) -> dict:
    """Each device kernel that ``calls`` calls of ``fn`` ran, by name (its
    first 96 characters): launches per call and mean device us per
    launch, from torch.profiler. A session that recorded no kernel at
    all (CUPTI drops records now and then) is profiled again, up to
    three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA and not \
                    event.name.startswith(("Memcpy", "Memset", "cudaEvent")):
                times.setdefault(event.name[:96], []).append(event.time_range.elapsed_us())
        if times:
            break
    return {name: {"per_call": len(us) / calls, "mean_us": sum(us) / len(us)}
            for name, us in times.items()}


# The seeded sweep of hbm_stream_sum against its plain version, the port's
# counterpart of the twin's native-against-Python walker agreement on
# random inputs (tests/test_fuzz.py): every geometry the wrapper accepts,
# not the probe's one.
SWEEP_DRAWS = 240
SWEEP_MAX_CHUNKS = 2048
SWEEP_KINDS = ("chunk", "tile", "random", "chunk-slip", "chunk-double",
               "tile-slip", "tile-double")
# The kernel's TMA ring depth (csrc/hbm_stream_sum.cu kStages).
SWEEP_RING = 4
# Buffers held at once: each batch's launches run under one profiler.
SWEEP_BATCH_BYTES = 4 << 30


def _sweep_draw(rng, chunks: int, sms: int, kind: str) -> dict:
    """One draw; a chunk slip needs two chunks, so one chunk slips a tile.
    A slip copies a unit of another value over ``dst``; a doubling copies
    unit ``dst`` over the next one (neighbours always differ)."""
    from gpu_feature_discovery_tpu_torch.ops import hbm

    if kind.startswith("chunk-") and chunks == 1:
        kind = "tile-" + kind.split("-", 1)[1]
    draw = {"chunks": chunks, "sms": sms, "kind": kind}
    if kind.endswith(("-slip", "-double")):
        unit, period = (
            (hbm.CHUNK_ROWS, 7) if kind.startswith("chunk") else (hbm.TILE_ROWS, 13))
        units = chunks * hbm.CHUNK_ROWS // unit
        if kind.endswith("-double"):
            draw["dst"] = int(rng.integers(0, units - 1))
            draw["src"] = draw["dst"]
        else:
            draw["dst"] = int(rng.integers(0, units))
            src = draw["dst"]
            while src % period == draw["dst"] % period:
                src = int(rng.integers(0, units))
            draw["src"] = src
    return draw


def hbm_sweep_draws(seed: int, max_sms: int, n: int = SWEEP_DRAWS) -> list:
    """``n`` seeded draws of (chunks, sms, content). First every content
    kind at the geometries the sweep must hold (one chunk; fewer tiles
    than the grid's blocks; counts off the ring's depth; the probe's 1024;
    the largest; one SM, the MIG profiles' SM counts and every SM); then
    chunk counts log-uniform over 1..SWEEP_MAX_CHUNKS on uniform SMs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    geometries = [(1, 1), (1, max_sms), (2, max_sms), (3, max_sms),
                  (max(1, (max_sms - 1) // 8), max_sms), (5, 60), (13, 32),
                  (1023, max_sms), (1024, max_sms), (1024, 1), (1024, 16),
                  (SWEEP_MAX_CHUNKS, max_sms), (SWEEP_MAX_CHUNKS, 1)]
    draws = [_sweep_draw(rng, k, min(s, max_sms), kind)
             for k, s in geometries for kind in SWEEP_KINDS]
    while len(draws) < n:
        k = int(min(SWEEP_MAX_CHUNKS, max(1, round(
            math.exp(rng.uniform(0.0, math.log(SWEEP_MAX_CHUNKS)))))))
        draws.append(_sweep_draw(rng, k, int(rng.integers(1, max_sms + 1)),
                                 SWEEP_KINDS[int(rng.integers(len(SWEEP_KINDS)))]))
    return draws[:n]


def sweep_buffer(draw: dict, device, gen=None):
    """(buffer, the pattern's exact sum or None for a random buffer)."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import hbm

    rows = draw["chunks"] * hbm.CHUNK_ROWS
    kind = draw["kind"]
    if kind == "random":
        return torch.rand((rows, hbm.LANES), generator=gen, device=device), None
    if kind.startswith("chunk"):
        buf, expected, unit = (hbm.stream_pattern(rows, device),
                               hbm.expected_stream_sum(rows), hbm.CHUNK_ROWS)
    else:
        buf, expected, unit = (hbm.tile_pattern(rows, device),
                               hbm.expected_tile_pattern_sum(rows), hbm.TILE_ROWS)
    if "dst" in draw:
        src, dst = draw["src"], draw["dst"] + (1 if kind.endswith("-double") else 0)
        buf[dst * unit:(dst + 1) * unit] = buf[src * unit:(src + 1) * unit].clone()
    return buf, expected


def run_hbm_sweep(draws: list, device, launch, kernels_in=None, seed: int = 0) -> dict:
    """Every draw launched through ``launch(buf, sms)`` and held to the
    plain version: a pattern exact against its host sum, a slipped or
    doubled twin exact against its plain sum and unequal to the
    pattern's, a random buffer within rel 1e-6. ``kernels_in(fn)`` (the
    card's profiler) must see one kernel per launch, batch by batch."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import hbm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t0 = time.monotonic()
    worst = {"rel": 0.0, "draw": None}
    detected = kernels = recounted = 0
    i = 0
    while i < len(draws):
        batch, held = [], 0
        while i < len(draws) and (not batch or held + draws[i]["chunks"] * (256 << 10)
                                  <= SWEEP_BATCH_BYTES):
            buf, expected = sweep_buffer(draws[i], device, gen)
            batch.append((draws[i], buf, expected))
            held += buf.numel() * 4
            i += 1
        outs = []

        def launch_batch():
            outs[:] = [launch(buf, d["sms"]) for d, buf, _ in batch]

        if kernels_in is None:
            launch_batch()
        else:
            # CUPTI drops a kernel record now and then (2 of 45 profiled
            # batches of 8 launches read 7, on the card in PR 18): a count
            # below the launches is profiled again, up to three times; a
            # count above them, or any other kernel, fails at once.
            for attempt in range(3):
                ran = kernels_in(launch_batch)
                seen = sum(n for name, n in ran.items() if "stream_sum" in name)
                check(seen <= len(batch) and all("stream_sum" in name for name in ran),
                      f"{len(batch)} launches ran {ran}, want one stream_sum kernel each")
                if seen == len(batch):
                    break
                recounted += 1
            check(seen == len(batch), f"{len(batch)} launches: the profiler saw {seen} "
                                      f"kernels in each of 3 sessions")
            kernels += seen
        for (d, buf, expected), out in zip(batch, outs):
            got = out.item()
            plain = hbm.hbm_stream_sum_reference(buf).item()
            rel = abs(got - plain) / abs(plain)
            if d["kind"] == "random":
                # rel 1e-6: the kernel sums each thread's share of a tile
                # in f32, the plain version everything in f64.
                check(rel <= 1e-6, f"sweep {d}: kernel {got} vs plain {plain}")
            else:
                check(got == plain, f"sweep {d}: kernel {got} != plain {plain}")
                if "dst" in d:
                    check(got != expected, f"sweep {d}: the twin's sum {got} is the "
                                           f"pattern's {expected}, not detected")
                    detected += 1
                else:
                    check(got == expected, f"sweep {d}: kernel {got} != {expected}")
            if rel >= worst["rel"]:
                worst = {"rel": rel, "draw": d}
        del batch, outs
    chunks = [d["chunks"] for d in draws]
    sms = [d["sms"] for d in draws]
    tiles_per_chunk = hbm.CHUNK_ROWS // hbm.TILE_ROWS
    return {
        "draws": len(draws), "seed": seed,
        "chunks_range": [min(chunks), max(chunks)], "sms_range": [min(sms), max(sms)],
        "kinds": {k: sum(d["kind"] == k for d in draws) for k in SWEEP_KINDS},
        "fewer_tiles_than_blocks": sum(
            d["chunks"] * tiles_per_chunk < d["sms"] for d in draws),
        "chunks_off_ring_depth": sum(d["chunks"] % SWEEP_RING != 0 for d in draws),
        "slips_detected": detected, "kernels_seen": kernels,
        "batches_recounted": recounted,
        "max_rel_err": worst["rel"], "max_rel_err_draw": worst["draw"],
        "seconds": time.monotonic() - t0,
    }


# What hbm_stream_sum refuses before any launch (ops/hbm.py): a view off
# the 16-byte alignment TMA needs, a strided view, a dtype other than f32,
# and rows that are not whole chunks.
def hbm_rejections(device) -> dict:
    import torch

    from gpu_feature_discovery_tpu_torch.ops import hbm

    rows, lanes = hbm.CHUNK_ROWS, hbm.LANES
    flat = torch.zeros(rows * lanes + 4, device=device)
    return {
        "misaligned": (flat[1:1 + rows * lanes].view(rows, lanes), "16-byte aligned"),
        "non_contiguous": (torch.zeros(rows, 2 * lanes, device=device)[:, :lanes],
                           "contiguous"),
        "float64": (torch.zeros(rows, lanes, dtype=torch.float64, device=device),
                    "float32"),
        "rows_not_whole_chunks": (torch.zeros(rows + hbm.TILE_ROWS, lanes, device=device),
                                  f"(k*{rows}, {lanes})"),
    }


def check_hbm_rejections(device, kernels_in=None) -> dict:
    """Each case raises hbm_stream_sum's ValueError and launches nothing."""
    from gpu_feature_discovery_tpu_torch.ops import hbm

    out = {}
    for name, (buf, text) in hbm_rejections(device).items():
        before = hbm.hbm_stream_sum.launches
        caught = []

        def call():
            try:
                hbm.hbm_stream_sum(buf)
            except ValueError as e:
                caught.append(str(e))

        ran = kernels_in(call) if kernels_in is not None else {}
        if kernels_in is None:
            call()
        check(caught and text in caught[0], f"{name}: {caught or 'no ValueError'}")
        check(hbm.hbm_stream_sum.launches == before and not ran,
              f"{name}: launched ({ran}) before refusing")
        out[name] = caught[0]
    return out


def phase_kernels(ptxas: list) -> dict:
    """hbm_stream_sum at the probe's 256 MiB geometry: exact on the chunk
    pattern and on the tile pattern, every slip twin caught, bitwise
    deterministic, within rel 1e-6 of the plain version on a random
    buffer, one kernel per call; timed in turns with f32 torch.sum."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import hbm

    dev = torch.device("cuda", 0)
    rows = hbm.probe_rows(256)
    expected = hbm.expected_stream_sum(rows)
    pattern = hbm.stream_pattern(rows, dev)
    got = hbm.hbm_stream_sum(pattern).item()
    plain = hbm.hbm_stream_sum_reference(pattern).item()
    check(got == expected, f"kernel {got} != expected {expected} on the pattern")
    check(plain == expected, f"plain {plain} != expected {expected} on the pattern")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rnd = torch.rand((rows, hbm.LANES), generator=gen, device=dev)
    got_r = hbm.hbm_stream_sum(rnd)
    again_r = hbm.hbm_stream_sum(rnd)
    bitwise = bool(torch.equal(got_r.view(torch.int32), again_r.view(torch.int32)))
    check(bitwise, f"two launches on one buffer differ: {got_r.item()} {again_r.item()}")
    got_r = got_r.item()
    plain_r = hbm.hbm_stream_sum_reference(rnd).item()
    rel_r = abs(got_r - plain_r) / abs(plain_r)
    # Tolerance rel 1e-6: the kernel sums each thread's share of a tile in
    # f32, the plain version everything in f64.
    check(rel_r <= 1e-6, f"random buffer: kernel {got_r} vs plain {plain_r}")

    # Slot-misread twins: chunk 0 holding chunk 4's data (a slip of the
    # TPU kernel's 4-deep ring), and chunk 1 a copy of chunk 0.
    chunk = hbm.CHUNK_ROWS
    aliased = pattern.clone()
    aliased[:chunk] = pattern[4 * chunk:5 * chunk]
    doubled = pattern.clone()
    doubled[chunk:2 * chunk] = pattern[:chunk]
    aliased_sum = hbm.hbm_stream_sum(aliased).item()
    doubled_sum = hbm.hbm_stream_sum(doubled).item()
    check(aliased_sum != expected, "aliased-slot twin not detected")
    check(doubled_sum != expected, "doubled-chunk twin not detected")
    del aliased, doubled

    # The same at tile granularity, which the chunk pattern cannot see: tile
    # 0 holding tile 4's data (a slip of this kernel's 4-stage ring inside
    # one chunk), and tile 1 a copy of tile 0.
    tile = hbm.TILE_ROWS
    tiles = hbm.tile_pattern(rows, dev)
    tile_expected = hbm.expected_tile_pattern_sum(rows)
    tile_sum = hbm.hbm_stream_sum(tiles).item()
    check(tile_sum == tile_expected,
          f"kernel {tile_sum} != expected {tile_expected} on the tile pattern")
    slipped = tiles.clone()
    slipped[:tile] = tiles[4 * tile:5 * tile]
    doubled = tiles.clone()
    doubled[tile:2 * tile] = tiles[:tile]
    tile_slip_sum = hbm.hbm_stream_sum(slipped).item()
    doubled_tile_sum = hbm.hbm_stream_sum(doubled).item()
    check(tile_slip_sum != tile_expected, "tile-slip twin not detected")
    check(doubled_tile_sum != tile_expected, "doubled-tile twin not detected")
    del tiles, slipped, doubled, rnd

    launched = _kernel_launches_in(lambda: hbm.hbm_stream_sum(pattern))
    check(sum(launched.values()) == 1, f"one call ran {launched}, want one kernel")

    # The same call in f32, the TPU kernel's accumulator type.
    library_f32_sum = torch.sum(pattern).item()
    check(library_f32_sum == expected,
          f"torch.sum in f32 {library_f32_sum} != expected {expected}")
    turns = in_turns({"kernel": lambda: hbm.hbm_stream_sum(pattern),
                      "library_f32": lambda: torch.sum(pattern)})
    host_us = {"kernel": host_us_per_call(lambda: hbm.hbm_stream_sum(pattern)),
               "library_f32": host_us_per_call(lambda: torch.sum(pattern))}
    ms = turns["median_ms"]["kernel"]
    library_f32_ms = turns["median_ms"]["library_f32"]
    plain_ms = cuda_ms(lambda: hbm.hbm_stream_sum_reference(pattern))
    library_ms = cuda_ms(lambda: torch.sum(pattern, dtype=torch.float64))
    sweep = run_hbm_sweep(
        hbm_sweep_draws(SEED, torch.cuda.get_device_properties(dev).multi_processor_count),
        dev, hbm._launch, kernels_in=_kernel_launches_in, seed=SEED)
    sweep["rejected"] = check_hbm_rejections(dev, kernels_in=_kernel_launches_in)
    emit("kernels_sweep", **sweep)
    torch.cuda.empty_cache()
    nbytes = pattern.numel() * pattern.element_size() + 4  # read once, write (1,1) f32
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = pattern.numel() / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    entry = {
        "name": "hbm_stream_sum",
        "route": "cuda",
        "source": "gpu_feature_discovery_tpu_torch/ops/csrc/hbm_stream_sum.cu",
        "replaces": "gpu_feature_discovery_tpu/ops/hbm.py:54",
        "max_abs_err": max(abs(got - plain), abs(got_r - plain_r)),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }
    emit(
        "kernels",
        kernels=[{
            **entry,
            "shape": [rows, hbm.LANES],
            "pattern_sum": got,
            "expected_sum": expected,
            "random_rel_err": rel_r,
            "random_bitwise_equal": bitwise,
            "aliased_slot_sum": aliased_sum,
            "doubled_chunk_sum": doubled_sum,
            "tile_pattern_sum": tile_sum,
            "tile_expected_sum": tile_expected,
            "tile_slip_sum": tile_slip_sum,
            "doubled_tile_sum": doubled_tile_sum,
            "kernels_per_call": launched,
            "library_f32_ms": library_f32_ms,
            "library_f32_sum": library_f32_sum,
            "in_turns": turns,
            "host_us_per_call": host_us,
            "pct_of_bound": 100 * bound_ms / ms,
            "library_f32_pct_of_bound": 100 * bound_ms / library_f32_ms,
            "ptxas": ptxas,
            "comparison_launches": hbm.hbm_stream_sum.launches,
            "gib_per_s": nbytes / (ms / 1e3) / 2**30,
        }],
    )
    return entry


# The burn-in's RMS epilogue (ops/rms_epilogue.py) at the shapes its
# callers use: the probe's 2048 x 2048 layers, the CPU geometry's 512, the
# verdicts' 128, and one that is no multiple of the 8-float vector.
EPILOGUE_SHAPES = ((2048, 2048), (512, 512), (128, 128), (37, 29))
# The grids it is held on: one SM, a MIG 1g slice's 16, and every SM.
EPILOGUE_SMS = (1, 16, 132)


def bf16_ulps(a, b):
    """Per element, how many bf16 steps lie between two bf16 tensors of
    finite values (+0 and -0 are one value)."""
    import torch

    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def epilogue_agreement(y, got) -> dict:
    """An epilogue's ``(carry, rms, checksum)`` on ``y`` against the plain
    version's: the rms's relative gap, the carry's bf16 steps apart (most
    and share of elements that differ), and the checksum (where there is
    one) against the f32 and the f64 sum of its own carry, each over the
    carry's absolute sum."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import rms_epilogue

    carry, rms, total = got
    plain_carry, plain_rms, _ = rms_epilogue.rms_epilogue_reference(y, torch.bfloat16)
    ulps = bf16_ulps(carry, plain_carry)
    out = {
        "shape": list(y.shape),
        "rms_rel": abs(rms.item() - plain_rms.item()) / plain_rms.item(),
        "carry_max_ulps": int(ulps.max().item()),
        "carry_differ_share": (ulps != 0).double().mean().item(),
    }
    if total is not None:
        wide = carry.float()
        scale = wide.abs().double().sum().item()
        out["checksum_vs_f32_sum"] = abs(total.item() - wide.sum().item()) / scale
        out["checksum_vs_f64_sum"] = abs(total.item() - wide.double().sum().item()) / scale
    return out


# Tolerances of the agreement, each with its reason: the rms differs only
# in the order of the f32 sum of squares (per vector in f32, then f64);
# a carry element rounds to another bf16 only where that order moved rms
# by an ulp and the quotient lay at a rounding edge; the checksum sums
# each 8 values in f32 and the rest in f64, so it lies within f32's
# rounding of the f64 sum, and torch's f32 sum within its own
# accumulation error of both.
EPILOGUE_LIMITS = {"rms_rel": 1e-6, "carry_max_ulps": 1, "carry_differ_share": 1e-3,
                   "checksum_vs_f32_sum": 1e-5, "checksum_vs_f64_sum": 1e-6}


def check_epilogue_agreement(got: dict, where: str) -> None:
    for key, limit in EPILOGUE_LIMITS.items():
        if key in got:
            check(got[key] <= limit, f"epilogue {where}: {key} {got[key]} over {limit}")


# What rms_epilogue refuses before any launch: an f64 product, a strided
# view, a 1-D tensor, an empty one, a carry in a dtype other than bf16 and
# (on a card) a view off the 16-byte alignment of the vector loads.
def epilogue_rejections(device) -> dict:
    import torch

    flat = torch.zeros(64 * 64 + 1, device=device)
    cases = {
        "float64": (torch.zeros(64, 64, dtype=torch.float64, device=device),
                    torch.bfloat16, "float32"),
        "non_contiguous": (torch.zeros(64, 128, device=device)[:, :64],
                           torch.bfloat16, "contiguous"),
        "one_d": (torch.zeros(64, device=device), torch.bfloat16, "2-D"),
        "empty": (torch.zeros(0, 64, device=device), torch.bfloat16, "non-empty"),
    }
    if torch.device(device).type == "cuda":
        cases["float16_carry"] = (torch.zeros(64, 64, device=device), torch.float16,
                                  "bfloat16")
        cases["misaligned"] = (flat[1:].view(64, 64), torch.bfloat16, "16-byte aligned")
    return cases


def check_epilogue_rejections(device, kernels_in=None) -> dict:
    """Each case raises rms_epilogue's ValueError and launches nothing."""
    from gpu_feature_discovery_tpu_torch.ops import rms_epilogue

    out = {}
    for name, (y, dtype, text) in epilogue_rejections(device).items():
        before = rms_epilogue.rms_epilogue.launches
        caught = []

        def call():
            try:
                rms_epilogue.rms_epilogue(y, dtype, checksum=True)
            except ValueError as e:
                caught.append(str(e))

        ran = kernels_in(call) if kernels_in is not None else {}
        if kernels_in is None:
            call()
        check(caught and text in caught[0], f"{name}: {caught or 'no ValueError'}")
        check(rms_epilogue.rms_epilogue.launches == before and not ran,
              f"{name}: launched ({ran}) before refusing")
        out[name] = caught[0]
    return out


def _plain_burnin_step(x, ws):
    """The burn-in pass as it ran before the hand-written epilogue: the
    products and the plain epilogue, the yardstick of the graph's time."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import healthcheck, rms_epilogue

    carry = x
    rms = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in ws:
        carry, rms, _ = rms_epilogue.rms_epilogue_reference(
            healthcheck._matmul_f32(carry, w), x.dtype)
    return carry.float().sum(), rms


def phase_rms_epilogue(ptxas: list) -> dict:
    """The burn-in's RMS epilogue against its plain version on the card:
    at EPILOGUE_SHAPES on random products and on the probe's own first
    layer, on grids of EPILOGUE_SMS; NaN and Inf carried into rms and the
    checksum; bitwise deterministic; the ticket counter back at 0; bad
    inputs refused with no launch; two kernels per call. Timed at the
    probe's layer in turns with the plain version and the library's
    ``rms_norm``, beside its byte bound; and the burn-in graph's replay,
    its kernels per replay, against the same pass captured with the plain
    epilogue."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import healthcheck, rms_epilogue

    dev = torch.device("cuda", 0)
    device_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    agreement, worst = [], dict.fromkeys(EPILOGUE_LIMITS, 0.0)
    for shape in EPILOGUE_SHAPES:
        y = torch.randn(shape, generator=gen, device=dev) * 7.0
        for sms in sorted({min(s, device_sms) for s in EPILOGUE_SMS}):
            got = epilogue_agreement(y, rms_epilogue._launch(y, checksum=True, sms=sms))
            check_epilogue_agreement(got, f"{shape} on {sms} SMs")
            agreement.append({**got, "sms": sms})
            worst = {k: max(worst[k], got[k]) for k in worst}
    size, depth = healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH
    x, ws = healthcheck._burnin_workspace(dev, size, depth, healthcheck.PROBE_DTYPE)
    y = healthcheck._matmul_f32(x, ws[0])
    probe_layer = epilogue_agreement(
        y, rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True))
    check_epilogue_agreement(probe_layer, "at the probe's first layer")

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    first = rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True)
    again = [rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True) for _ in range(3)]
    bitwise = all(torch.equal(bits(a), bits(b)) for call in again for a, b in zip(first, call))
    check(bitwise, "two epilogue calls on one product differ")
    torch.cuda.synchronize(dev)
    counter = rms_epilogue.launch_scratch(
        dev, torch.cuda.current_stream(dev).cuda_stream)[1].item()
    check(counter == 0, f"the ticket counter holds {counter} after the launches")

    poisoned = {}
    for name, value in (("nan", float("nan")), ("inf", float("inf"))):
        bad = y.clone()
        bad[size // 3, size // 5] = value
        carry, rms, total = rms_epilogue.rms_epilogue(bad, torch.bfloat16, checksum=True)
        poisoned[name] = {"rms": rms.item(), "checksum": total.item()}
        check(not math.isfinite(rms.item()) and not math.isfinite(total.item()),
              f"a {name} in y left rms {rms.item()} / checksum {total.item()} finite")
    verdicts, _ = healthcheck.sharded_chip_verdicts(
        [dev], healthcheck.VERDICT_MAX_SIZE, healthcheck.VERDICT_MAX_DEPTH, sick_chips={0})
    check(verdicts == [False], f"the NaN-poisoned verdict pass read {verdicts}")

    rejected = check_epilogue_rejections(dev, kernels_in=_kernel_launches_in)
    launched = _kernel_launches_in(
        lambda: rms_epilogue.rms_epilogue(y, torch.bfloat16, checksum=True))
    check(sum(launched.values()) == 2 and all("rms_" in k for k in launched),
          f"one call ran {launched}, want rms_sumsq and rms_scale_cast")

    # The burn-in pass: the probe's graph against the same pass captured
    # with the plain epilogue, kernels per replay and device ms in turns.
    healthcheck.reset_probe_workspaces()
    graph, cs, rms = healthcheck._burnin_graph(dev, size, depth)
    x, ws = healthcheck._burnin_workspace(dev, size, depth, healthcheck.PROBE_DTYPE)
    side = torch.cuda.Stream(dev)
    _plain_burnin_step(x, ws)
    plain_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(plain_graph, stream=side, capture_error_mode="thread_local"):
        plain_cs, plain_rms = _plain_burnin_step(x, ws)
    graph.replay()
    plain_graph.replay()
    torch.cuda.synchronize(dev)
    eager_cs, eager_rms = healthcheck.burnin_step(x, ws)
    check(cs.item() == eager_cs.item() and rms.item() == eager_rms.item(),
          f"graph {cs.item()} / {rms.item()} against eager {eager_cs.item()} / "
          f"{eager_rms.item()}")
    pass_gaps = {"checksum_rel": abs(cs.item() - plain_cs.item()) / abs(plain_cs.item()),
                 "rms_rel": abs(rms.item() - plain_rms.item()) / plain_rms.item()}
    per_replay = {"kernel": _kernel_launches_in(graph.replay),
                  "plain": _kernel_launches_in(plain_graph.replay)}
    pass_turns = in_turns({"kernel": graph.replay, "plain": plain_graph.replay})

    # One layer's epilogue. Queueing a call from the host takes longer
    # than its device time, so back-to-back calls would time the host:
    # each call is captured in a graph of its own and the replays timed.
    y = healthcheck._matmul_f32(x, ws[0])

    def graphed(fn):
        fn()
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            rms_epilogue.launch_scratch(dev, stream.cuda_stream)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream, capture_error_mode="thread_local"):
            fn()
        return g

    layer_graphs = {
        "kernel": graphed(lambda: rms_epilogue.rms_epilogue(y, torch.bfloat16, True)),
        "plain": graphed(lambda: rms_epilogue.rms_epilogue_reference(y, torch.bfloat16, True)),
        "library": graphed(
            lambda: torch.nn.functional.rms_norm(y, y.shape, eps=rms_epilogue.EPS)),
    }
    layer_turns = in_turns({name: g.replay for name, g in layer_graphs.items()})
    grid_graphs = {sms: graphed(lambda: rms_epilogue._launch(y, True, sms=sms))
                   for sms in sorted({min(s, device_sms) for s in EPILOGUE_SMS})}
    grids_ms = {sms: cuda_ms(g.replay) for sms, g in grid_graphs.items()}
    layer_kernels = {name: _kernel_us_in(g.replay) for name, g in layer_graphs.items()}
    pass_kernels = {"kernel": _kernel_us_in(graph.replay),
                    "plain": _kernel_us_in(plain_graph.replay)}
    host_us = host_us_per_call(lambda: rms_epilogue.rms_epilogue(y, torch.bfloat16, True))
    # Bound: y read once and the bf16 carry written once (the two scalars
    # are nothing); the design's own traffic adds the second read of y,
    # 42 MB a layer from HBM at most.
    nbytes = y.numel() * (4 + 2)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms = layer_turns["median_ms"]["kernel"]
    entry = {
        "name": "rms_epilogue",
        "route": "cuda",
        "source": "gpu_feature_discovery_tpu_torch/ops/csrc/rms_epilogue.cu",
        "replaces": "none (the burn-in's RMS epilogue, left to XLA by the JAX package)",
        "ms": ms,
        "plain_ms": layer_turns["median_ms"]["plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": layer_turns["median_ms"]["library"],
    }
    emit(
        "kernels",
        kernels=[{
            **entry,
            "shape": [size, size],
            "probe_layer": probe_layer,
            "agreement_worst": worst,
            "agreement": agreement,
            "random_bitwise_equal": bitwise,
            "poisoned": poisoned,
            "rejected": rejected,
            "kernels_per_call": launched,
            "in_turns": layer_turns,
            "kernel_us": layer_kernels,
            "grids_ms": grids_ms,
            "host_us_per_call": host_us,
            "pct_of_bound": 100 * bound_ms / ms,
            "ptxas": ptxas,
            "pass": {
                "kernels_per_replay": {k: sum(v.values()) for k, v in per_replay.items()},
                "kernels": per_replay,
                "in_turns": pass_turns,
                "kernel_us": pass_kernels,
                "bound_ms": healthcheck.burnin_flops(size, depth) / 989e12 * 1e3,
                "gaps_to_plain": pass_gaps,
            },
        }],
    )
    del graph, plain_graph, layer_graphs, grid_graphs
    healthcheck.reset_probe_workspaces()
    torch.cuda.empty_cache()
    return entry


def _max_rel(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / (np.abs(want) + 1e-30)))


def _close(got, want, what: str) -> None:
    import numpy as np

    # rtol 1e-5, atol 1e-6: f32 on both sides (TF32 off on the card), only
    # the order of the sums differs between cuBLAS and the CPU's BLAS.
    check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"{what}: card and CPU differ (max rel {_max_rel(got, want)})")


def phase_collectives(count: int) -> None:
    """The multi-GPU probes on every card of the machine: NCCL over every
    card through ``collectives.nccl_all_reduce``, the timed all-reduce,
    both ring sweeps, the DP+TP train step held against the same step on
    the CPU, the dry run, and the node probe's collective keys. On one
    card the all-reduce is the card's own value, a copy with no NCCL
    call, and the rings have one device; their checks hold all the
    same."""
    import numpy as np
    import torch
    import torch.cuda.nccl as nccl

    from gpu_feature_discovery_tpu_torch import entry
    from gpu_feature_discovery_tpu_torch.ops import carry, collectives, device_timing, healthcheck

    devices = [torch.device("cuda", i) for i in range(count)]
    out = {"devices": count}

    # NCCL's first use, apart: no earlier phase used NCCL. The probe calls
    # it only over several devices; the helper that branch calls launches
    # it here on every card, so the binding stays held on one card too.
    small = [torch.ones(1, device=d) for d in devices]
    small_out = [torch.empty_like(t) for t in small]
    for use in ("first", "second"):
        t0 = time.perf_counter()
        collectives.nccl_all_reduce(small, small_out)
        for d in devices:
            torch.cuda.synchronize(d)
        out[f"nccl_{use}_use_ms"] = (time.perf_counter() - t0) * 1e3
    check(all(float(o) == count for o in small_out), f"NCCL's sum: {small_out}")
    payload = 32 << 20
    ones = [torch.ones(payload // 4, device=d) for d in devices]
    dst = [torch.empty_like(t) for t in ones]
    nccl_ms = cuda_ms(lambda: collectives.nccl_all_reduce(ones, dst))
    check(all(bool(torch.all(o == float(count))) for o in dst), "NCCL's 32 MiB sum")

    # From here to the node probe every NCCL call is counted: over one
    # card the probes' reductions are the device's own value and call none.
    real_all_reduce, nccl_calls = nccl.all_reduce, []

    def counting(*args, **kwargs):
        nccl_calls.append(1)
        return real_all_reduce(*args, **kwargs)

    nccl.all_reduce = counting

    # The timing gate (ops/timing_gate.py): each card's gate kernel holds
    # its stream until the host has queued every call and opened it, or
    # until its 1 ms watchdog. Each gate of 5 calls here reports every
    # card's outcome; the probe's (3 calls) warns if one timed out.
    collectives.all_reduce(ones, out=dst)  # first use on these buffers, untimed
    gates = [device_timing.gated_windows(
        devices, lambda: collectives.all_reduce(ones, out=dst), 5)]
    probe = healthcheck.ici_allreduce_probe(devices, mib_per_chip=32)
    check(probe["checksum_ok"], f"all-reduce checksum failed: {probe}")
    check(probe["bytes"] == payload, f"all-reduce payload {probe['bytes']}")
    check(probe["gbps"] == 0.0 if count == 1 else probe["gbps"] > 0,
          f"all-reduce gbps {probe['gbps']} at n={count}")
    for _ in range(4):
        gates.append(device_timing.gated_windows(
            devices, lambda: collectives.all_reduce(ones, out=dst), 5))
    out["gates"] = [{"gate_ms": g.gate_s * 1e3, "queued_ms": g.queued_s * 1e3,
                     "held": g.held, "outcomes": list(g.outcomes)} for g in gates]
    check(all(g.held for g in gates),
          f"the host queued the all-reduces past the timing gate: {out['gates']}")
    # One card copies its payload out of place: read once, written once.
    out["allreduce"] = {
        **probe, "device_ms": probe["seconds"] * 1e3,
        "gated_windows_ms": [w * 1e3 for w in gates[-1].windows],
        "back_to_back_ms": cuda_ms(lambda: collectives.all_reduce(ones, out=dst)),
        "nccl_back_to_back_ms": nccl_ms,
        "one_rank_bound_ms": 2 * probe["bytes"] / HBM_BYTES_PER_S * 1e3,
    }

    sweeps = {}
    for name, mesh in (("chip_mesh", healthcheck.chip_mesh(devices)),
                       ("build_mesh", healthcheck.build_mesh(count))):
        t0 = time.perf_counter()
        sweep = healthcheck.ici_ring_sweep(mesh)
        sweeps[name] = {**sweep, "shape": list(mesh.devices.shape),
                        "ms": (time.perf_counter() - t0) * 1e3}
        check(sweep["links_ok"] and sweep["allreduce_ok"], f"{name} sweep: {sweep}")
    out["sweeps"] = sweeps
    edges = []
    for i in range(count if count > 1 else 0):
        src, dst_dev = devices[i], devices[(i + 1) % count]
        buf = ones[i]
        with torch.cuda.device(dst_dev):
            ms = cuda_ms(lambda: buf.to(dst_dev))
        edges.append({"src": i, "dst": dst_dev.index,
                      "peer_access": torch.cuda.can_device_access_peer(src, dst_dev),
                      "copy_ms": ms, "bytes": buf.numel() * 4})
    out["ring_edges"] = edges

    # The train step: weights from a numpy seed, on the card and on the CPU.
    rng = np.random.default_rng(0)
    d_model, d_hidden, batch = 128, 256, 32
    weights = {
        "w1": (rng.standard_normal((d_model, d_hidden)) / np.sqrt(d_model)).astype(np.float32),
        "w2": (rng.standard_normal((d_hidden, d_model)) / np.sqrt(d_hidden)).astype(np.float32),
    }
    x = rng.standard_normal((batch, d_model)).astype(np.float32)
    y = rng.standard_normal((batch, d_model)).astype(np.float32)
    runs = {}
    for where, mesh in (("card", healthcheck.build_mesh(count)),
                        ("cpu", healthcheck.build_mesh(count, [torch.device("cpu")] * count))):
        params = carry.slice_params_from_numpy(weights, mesh)
        xs, ys = carry.slice_batch_from_numpy(x, y, mesh)
        step, _ = healthcheck.make_slice_train_step(mesh, params=params, batch_xy=(xs, ys))
        new, loss = step(params, xs, ys)
        losses = [float(loss)]
        p = new
        for _ in range(5):
            p, later = step(p, xs, ys)
            losses.append(float(later))
        runs[where] = (carry.slice_params_to_numpy(new, mesh), losses, step, params, xs, ys)
    (card_p, card_l, step, params, xs, ys), (cpu_p, cpu_l, *_) = runs["card"], runs["cpu"]
    _close(card_l[0], cpu_l[0], "train-step loss")
    for key in ("w1", "w2"):
        _close(card_p[key], cpu_p[key], f"train-step {key}")
    check(card_l[-1] < card_l[0], f"five steps did not lower the loss: {card_l}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_LAUNCHES):
        step(params, xs, ys)
    torch.cuda.synchronize()
    out["train_step"] = {
        "losses_card": card_l, "losses_cpu": cpu_l,
        "loss_rel_err": _max_rel(card_l[0], cpu_l[0]),
        "w1_max_rel_err": _max_rel(card_p["w1"], cpu_p["w1"]),
        "w2_max_rel_err": _max_rel(card_p["w2"], cpu_p["w2"]),
        "device_ms": cuda_ms(lambda: step(params, xs, ys)),
        "wall_ms": (time.perf_counter() - t0) * 1e3 / TIMED_LAUNCHES,
    }

    entry.dryrun_multichip(count)
    out["dryrun_multichip"] = "passed"

    report = healthcheck.measure_node_health(devices=devices, per_chip=True)
    ici_phases = sorted(k for k in report["phases"] if k.startswith("ici_"))
    if count == 1:
        check(not ici_phases and report["ici_ok"] is None and report["ici_gbps"] is None,
              f"one card ran a collective probe: {ici_phases} {report['ici_ok']}")
        try:
            healthcheck.measure_node_health(devices=devices, per_chip=True, ici=True)
        except ValueError as e:
            out["ici_true_one_device"] = f"ValueError: {e}"
        else:
            check(False, "ici=True on one card did not raise ValueError")
    else:
        check(report["ici_ok"] is True and (report["ici_gbps"] or 0) > 0,
              f"multi-GPU node probe: ici_ok {report['ici_ok']} gbps {report['ici_gbps']}")
    out["node_probe"] = {k: report[k] for k in ("ici_ok", "ici_gbps", "chips_allreduce_ok")}
    out["node_probe_phases"] = {k: report["phases"][k] for k in ici_phases}
    nccl.all_reduce = real_all_reduce
    out["nccl_calls_in_probes"] = len(nccl_calls)
    check((len(nccl_calls) == 0) == (count == 1),
          f"{len(nccl_calls)} NCCL calls in the probes over {count} card(s)")
    # The main path warms its own probe, as a fresh process would.
    healthcheck.reset_probe_workspaces()
    emit("collectives", **out)


class _PhaseCapture(logging.Handler):
    """Keeps the probe report's ``phases``, which the health labeler logs
    at debug level."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.phases = None

    def emit(self, record):
        if record.msg.startswith("burn-in probe timing="):
            self.phases = record.args[1]


def phase_main_path(entries: dict, count: int) -> None:
    import torch

    from gpu_feature_discovery_tpu_torch.cmd.main import start
    from gpu_feature_discovery_tpu_torch.ops import hbm, rms_epilogue

    capture = _PhaseCapture()
    lm_log = logging.getLogger("tfd.lm")
    lm_log.setLevel(logging.DEBUG)
    lm_log.addHandler(capture)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        hbm.hbm_stream_sum.launches = 0
        rms_epilogue.rms_epilogue.launches = 0
        t0 = time.perf_counter()
        rc = start(["--oneshot", "--with-burnin", "--backends", "gpu",
                    "--output-file", out])
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches = {"hbm_stream_sum": hbm.hbm_stream_sum.launches,
                    "rms_epilogue": rms_epilogue.rms_epilogue.launches}
        check(rc == 0, f"oneshot cycle exited {rc}")
        labels = _read_labels(out)
    lm_log.removeHandler(capture)
    emit("main_path", seconds=cycle_s, launches=launches, labels=labels,
         phases=capture.phases)
    want = {
        "nvidia.com/gpu.health.ok": "true",
        "nvidia.com/gpu.health.timing": "device-profiler",
        "nvidia.com/gpu.chip.0.ok": "true" if PER_DEVICE_LABELS else None,
        "nvidia.com/gpu.count": str(count),
        "nvidia.com/gpu.family": "hopper",
        "nvidia.com/gpu.generation.major": "9",
        "nvidia.com/gpu.generation.minor": "0",
    }
    for key, value in want.items():
        check(labels.get(key) == value, f"label {key}={labels.get(key)!r}, want {value!r}")
    for key in HOST_FACT_KEYS:
        check(key in labels, f"main path published no {key}")
    ici = {k: labels.get(k) for k in (ICI_OK, ICI_GBPS)}
    if count > 1:
        check(ici[ICI_OK] == "true" and int(ici[ICI_GBPS] or "0") > 0,
              f"multi-GPU main path: {ici}")
    else:
        check(ici == {ICI_OK: None, ICI_GBPS: None}, f"one card published {ici}")
    for key in ("nvidia.com/gpu.health.matmul-tflops", "nvidia.com/gpu.health.hbm-gbps"):
        # Present means inside the plausibility gate (<= 1.5x the spec peak).
        check(int(labels.get(key, "0")) > 0, f"label {key} missing or zero")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
        entries[name]["launches"] = n


def _oneshot_labels(*args: str) -> dict:
    """One oneshot cycle of the CLI entry point in this process; its
    labels without the timestamp."""
    from gpu_feature_discovery_tpu_torch.cmd.main import start

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        rc = start(["--oneshot", "--no-timestamp", *args, "--output-file", out])
        check(rc == 0, f"oneshot {args} exited {rc}")
        return _read_labels(out)


def _sysfs_gpu_functions() -> list:
    """NVIDIA display-class functions (class 0x03xxxx) on the PCI bus,
    read here without the port's scanner."""
    root = "/sys/bus/pci/devices"
    found = []
    for address in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        try:
            with open(os.path.join(root, address, "vendor")) as f:
                vendor = f.read().strip()
            with open(os.path.join(root, address, "class")) as f:
                cls = f.read().strip()
        except OSError:
            continue
        if vendor == "0x10de" and cls.startswith("0x03"):
            with open(os.path.join(root, address, "config"), "rb") as f:
                found.append({"address": address, "class": cls,
                              "config_bytes": len(f.read())})
    return found


_NVML_CHILD = r"""
import json, sys
from gpu_feature_discovery_tpu_torch.cmd.main import new_interconnect_labeler
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
config = new_config(environ={})
manager = NvmlManager()
labels = LabelEngine(parallel=False).generate(new_label_sources(
    manager, config, interconnect=new_interconnect_labeler(config)))
with open("/proc/self/maps") as f:
    maps = f.read()
from chip_smoke import _nvml_used_mib
# The card's memory in use while this process is alive: a CUDA context of
# its own would add hundreds of MiB.
used = _nvml_used_mib()
print(json.dumps({
    "labels": dict(labels),
    "torch_imported": "torch" in sys.modules,
    "maps_libcuda": "libcuda.so" in maps,
    "maps_libnvidia_ml": "libnvidia-ml.so" in maps,
    "device_used_mib": used,
    "init_ms": manager.nvml_inventory.init_ms,
    "enumerate_ms": manager.nvml_inventory.enumerate_ms,
}))
"""


def _nvml_used_mib() -> list:
    """Each GPU's memory in use (NVML's ``nvmlMemory_t.used``), MiB."""
    from gpu_feature_discovery_tpu_torch.native import nvml

    lib = nvml.load_library()
    check(lib is not None, f"NVML not loadable ({nvml.NVML_LIBRARY})")
    api = nvml.Nvml(lib)
    api.init()
    try:
        return [api.memory_info(api.handle(i)).used // 2**20
                for i in range(api.device_count())]
    finally:
        api.shutdown()


def _strategy_expectation(inv, strategy: str, labels: dict) -> None:
    """The labels the reference's MIG strategies give for NVML's view."""
    enabled = [d for d in inv.devices if d.mig_enabled]
    profiles = {}
    for d in enabled:
        for m in d.mig_devices:
            profiles[m.profile] = profiles.get(m.profile, 0) + 1
    strategy_label = labels.get("nvidia.com/gpu.topology.strategy")
    mig_keys = sorted(k for k in labels if k.startswith("nvidia.com/mig-"))
    if strategy == "none":
        check(strategy_label is None and not mig_keys,
              f"strategy none published {strategy_label!r} {mig_keys}")
        return
    check(strategy_label == strategy, f"strategy label {strategy_label!r}")
    if strategy == "mixed":
        got = {k[len("nvidia.com/mig-"):-len(".count")]: int(v)
               for k, v in labels.items()
               if k.startswith("nvidia.com/mig-") and k.endswith(".count")}
        check(got == profiles, f"mixed MIG counts {got}, NVML {profiles}")
        return
    check(not mig_keys, f"strategy single published {mig_keys}")
    product = labels.get("nvidia.com/gpu.product", "")
    if not enabled:
        check("-MIG-" not in product, f"single without MIG: product {product}")
    elif (len(enabled) == len(inv.devices) and len(profiles) == 1
          and all(d.mig_devices for d in enabled)):
        check(product.endswith("-MIG-" + next(iter(profiles))), f"single: {product}")
    else:
        check(product.endswith("-MIG-INVALID"), f"single invalid: {product}")


def phase_host_facts(count: int) -> dict:
    """NVML, sysfs and the DMI file on the card: the facts against
    nvidia-smi and sysfs, the NVML path without torch or CUDA, and the
    labels of each backend and strategy. Returns the ``--backends gpu``
    labels, which the daemon phases expect."""
    import torch

    from gpu_feature_discovery_tpu_torch.native import nvml

    inv = nvml.read_inventory()  # raises where NVML does not load
    again = nvml.read_inventory()
    if PER_DEVICE_LABELS:
        check(len(inv.devices) == torch.cuda.device_count(),
              f"NVML sees {len(inv.devices)} GPUs, torch {torch.cuda.device_count()}")
    else:
        check(len(inv.devices) >= torch.cuda.device_count(),
              f"NVML sees {len(inv.devices)} GPUs, torch {torch.cuda.device_count()}")
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version,name,memory.total,pci.bus_id,"
         "mig.mode.current,compute_cap,uuid", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    check(len(rows) == len(inv.devices), f"nvidia-smi rows {rows}")
    smi_uuids = []
    for dev, row in zip(inv.devices, rows):
        driver, name, memory, bus_id, mig_mode, cc, uuid = [f.strip() for f in row.split(",")]
        smi_uuids.append(uuid)
        smi_mig = {"Enabled": (True, True), "Disabled": (True, False)}.get(
            mig_mode, (False, False))
        for what, got, want in (
            ("driver_version", inv.driver_version, driver),
            ("name", dev.name, name),
            ("memory.total", dev.memory_mb, int(memory)),
            # "[N/A]" where the host gives NVML no PCI information.
            ("pci.bus_id", dev.bus_id,
             None if bus_id.strip("[]") == "N/A" else nvml.normalize_bus_id(bus_id)),
            ("mig.mode.current", (dev.mig_capable, dev.mig_enabled), smi_mig),
            ("compute_cap", "%d.%d" % dev.compute_capability, cc),
            ("uuid", dev.uuid, uuid),
        ):
            check(got == want, f"GPU {dev.index} {what}: NVML {got!r}, nvidia-smi {want!r}")

    # NVML without torch and without a CUDA context. On some drivers
    # nvmlInit_v2 itself maps libcuda.so (R580 does); that is recorded,
    # and the check is that no context appears: the card's memory in use
    # stays where it was before the child started.
    used_before = sum(_nvml_used_mib())
    proc = subprocess.run([sys.executable, "-c", _NVML_CHILD], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"NVML child failed: {proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not child["torch_imported"], "the NVML child imported torch")
    check(child["maps_libnvidia_ml"], "the NVML child maps no libnvidia-ml.so")
    check(sum(child["device_used_mib"]) - used_before < CONTEXT_MIB,
          f"the NVML child took device memory: {used_before} MiB before, "
          f"{child['device_used_mib']} MiB while it ran")

    # Fault 5: the probe's devices are CUDA's, the labels' index is
    # NVML's; each report entry carries its device's UUID (torch's, bare)
    # and it must be one of nvidia-smi's (NVML's, "GPU-" prefixed).
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    report = healthcheck.measure_node_health(
        per_chip=True, inventory_uuids=[d.uuid for d in inv.devices])
    probe_uuids = [e["uuid"] for e in report["per_chip"]]
    smi_bare = [nvml.normalize_uuid(u) for u in smi_uuids]
    check(all(u in smi_bare for u in probe_uuids),
          f"probe UUIDs {probe_uuids} against nvidia-smi's {smi_uuids}")
    if len(smi_bare) == 1:
        check(probe_uuids == smi_bare, f"device 0: probe {probe_uuids}, nvidia-smi {smi_uuids}")
    emit("fault5", nvidia_smi_uuids=smi_uuids, probe_uuids=probe_uuids,
         label_index_of_cuda_device=[smi_bare.index(u) for u in probe_uuids],
         per_device_labels=PER_DEVICE_LABELS)

    gpu = _oneshot_labels("--backends", "gpu")
    native = _oneshot_labels("--backends", "native")
    diff = sorted(set(gpu.items()) ^ set(native.items()))
    check(not diff, f"--backends native and gpu differ: {diff}")
    _grammar_checked(child["labels"], "the NVML child")
    check(child["labels"] == native, "the NVML child's labels differ from native's: "
          f"{sorted(set(child['labels'].items()) ^ set(native.items()))}")
    check(gpu.get("nvidia.com/gpu.count") == str(count), f"gpu.count {gpu}")
    for key, value in (("nvidia.com/gpu.family", "hopper"),
                       ("nvidia.com/gpu.generation.major", "9"),
                       ("nvidia.com/gpu.generation.minor", "0"),
                       ("nvidia.com/gpu.driver.major", inv.driver_version.split(".")[0]),
                       ("nvidia.com/gpu.slice.capable",
                        str(any(d.mig_capable for d in inv.devices)).lower()),
                       ("nvidia.com/gpu.memory", str(inv.devices[0].memory_mb))):
        check(gpu.get(key) == value, f"label {key}={gpu.get(key)!r}, want {value!r}")
    check("nvidia.com/gpu.pci.host-interface" not in gpu,
          f"a GPU's vendor capability decoded as a record: {gpu}")
    functions = _sysfs_gpu_functions()
    check(gpu.get("nvidia.com/gpu.pci.count") == (str(len(functions)) if functions else None),
          f"pci.count {gpu.get('nvidia.com/gpu.pci.count')!r}, sysfs {functions}")

    strategies = {}
    for strategy in ("none", "single", "mixed"):
        labels = _oneshot_labels("--backends", "gpu", "--tpu-topology-strategy", strategy)
        _strategy_expectation(inv, strategy, labels)
        strategies[strategy] = {k: v for k, v in labels.items()
                                if "strategy" in k or k.startswith("nvidia.com/mig-")
                                or k == "nvidia.com/gpu.product"}
    props = torch.cuda.get_device_properties(0)
    emit("host_facts", nvml_init_ms=[inv.init_ms, again.init_ms],
         nvml_enumerate_ms=[inv.enumerate_ms, again.enumerate_ms],
         child_nvml_init_ms=child["init_ms"], child_nvml_enumerate_ms=child["enumerate_ms"],
         child_maps_libcuda=child["maps_libcuda"], device_used_mib_before=used_before,
         child_device_used_mib=child["device_used_mib"],
         driver_version=inv.driver_version, cuda_driver_version=inv.cuda_driver_version,
         devices=[{"name": d.name, "bus_id": d.bus_id, "memory_mb": d.memory_mb,
                   "compute_capability": d.compute_capability,
                   "mig_capable": d.mig_capable, "mig_enabled": d.mig_enabled,
                   "mig": [m.profile for m in d.mig_devices]} for d in inv.devices],
         torch_total_memory_mib=props.total_memory // 2**20,
         sysfs_gpu_functions=functions, labels=gpu, strategies=strategies)
    # The fresh child's read is what a new process pays.
    return {"labels": gpu, "nvml_init_ms": child["init_ms"],
            "nvml_enumerate_ms": child["enumerate_ms"]}


class _CycleCapture(logging.Handler):
    """One entry per labeling cycle of the daemon loop, cut at its "Cycle
    timings" line: the mode (probing, cached-health, or full without
    health), the cycle's wall ms, the probe's ``probe_ms`` and
    ``phases``, and the kernel launches counted so far."""

    def __init__(self, launches, on_cycle=None):
        super().__init__(logging.DEBUG)
        self._launches = launches
        self._on_cycle = on_cycle
        self.cycles = []
        self.spawns = []    # (pid, ms) per broker worker spawn
        self.failures = []  # supervisor's failed-cycle messages
        self._probe = None
        self._cached = False
        self._warming = False

    def emit(self, record):
        msg = str(record.msg)
        if msg.startswith("burn-in probe timing="):
            self._probe = {"probe_ms": record.args[2], "phases": record.args[1]}
        elif msg.startswith("burn-in not due"):
            self._cached = True
        elif msg.startswith("burn-in probe still warming"):
            self._warming = True
        elif msg.startswith("broker worker %d ready in"):
            self.spawns.append((record.args[0], record.args[1]))
        elif msg.startswith("labeling cycle failed"):
            self.failures.append(record.getMessage())
        elif msg.startswith("Cycle timings: "):
            stages = dict(
                part.split("=", 1) for part in str(record.args[0]).split()
            )
            mode = (
                "probing" if self._probe
                else "cached-health" if self._cached
                else "warming" if self._warming
                else "full"
            )
            self.cycles.append({
                "mode": mode,
                "wall_ms": float(stages["labelgen.total"].rstrip("ms")),
                "launches": self._launches(),
                **(self._probe or {}),
            })
            self._probe, self._cached, self._warming = None, False, False
            if self._on_cycle is not None:
                # On the daemon's own thread, between this cycle's probe
                # and the next cycle's first broker request.
                self._on_cycle()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(port: int, method: str, path: str, headers=None):
    """One request to 127.0.0.1:port: (status, body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def _samples(body: str) -> dict:
    """{(name, labels): value} of one exposition, ``labels`` as rendered."""
    out = {}
    for line in body.splitlines():
        m = _SAMPLE.match(line)
        if m and not line.startswith("#"):
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _validate_exposition(body: str) -> dict:
    """The repo's promtool grammar check (tests/promtool_lite.py)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from promtool_lite import validate_exposition
    finally:
        sys.path.pop(0)
    return validate_exposition(body)


def _scrape(port: int) -> dict:
    """GET /metrics: it must answer 200 and pass promtool_lite."""
    code, body = _http(port, "GET", "/metrics")
    check(code == 200, f"/metrics answered {code}")
    _validate_exposition(body)
    DOCS_SEEN["families"].update(re.findall(r"^# TYPE (tfd_\w+) ", body, re.M))
    return _samples(body)


# The k8s label grammar (tests/test_label_validity.py:22-37, which this
# machine cannot import): NFD drops a label that breaks it without a word,
# so every label a phase reads is held to it. Matched whole, so a stray
# newline fails too.
_LABEL_NAME = re.compile(r"[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?")
_DNS_LABEL = re.compile(r"[a-z0-9]([-a-z0-9]*[a-z0-9])?")
_LABEL_VALUE = re.compile(r"([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?")
# Label sets held to the grammar so far, and their labels.
GRAMMAR_CHECKED = {"sets": 0, "labels": 0}


def label_grammar_error(key: str, value: str):
    """None for a label NFD keeps, else what breaks the grammar."""
    prefix, slash, name = key.rpartition("/")
    if not name:
        return "empty name"
    if len(name) > 63 or not _LABEL_NAME.fullmatch(name):
        return "invalid name"
    if slash and (len(prefix) > 253
                  or not all(_DNS_LABEL.fullmatch(p) for p in prefix.split("."))):
        return "invalid prefix"
    if len(value) > 63 or not _LABEL_VALUE.fullmatch(value):
        return "invalid value"
    return None


def _grammar_checked(labels: dict, where: str) -> dict:
    bad = {f"{k}={v}": e for k, v in labels.items()
           if (e := label_grammar_error(k, v)) is not None}
    check(not bad, f"{where}: labels outside the k8s grammar: {bad}")
    GRAMMAR_CHECKED["sets"] += 1
    GRAMMAR_CHECKED["labels"] += len(labels)
    DOCS_SEEN["label_keys"].update(labels)
    return labels


# The port's reference documentation, held to what the phases read: every
# label key has its row in docs/torch/labels.md, every tfd_* family
# scraped from a live daemon its row in docs/torch/observability.md. A
# row's first cell is the key, with <i> a device index, <n> a cohort
# index and <profile> a MIG profile.
DOCS = os.path.join(REPO, "docs", "torch")
DOCS_SEEN = {"label_keys": set(), "families": set()}
_DOC_PLACEHOLDERS = {"<i>": "[0-9]+", "<n>": "[0-9]+",
                     "<profile>": "[0-9a-z][0-9a-z.+-]*"}
_DOC_ROW = re.compile(r"^\| `([^`]+)` \|", re.M)


def doc_label_patterns(text: str) -> list:
    """The key pattern of each table row of labels.md."""
    patterns = []
    for key in _DOC_ROW.findall(text):
        rx = re.escape(key)
        for placeholder, sub in _DOC_PLACEHOLDERS.items():
            rx = rx.replace(placeholder, sub)
        patterns.append(re.compile(rx))
    return patterns


def undocumented_labels(keys, text: str) -> list:
    """The keys no row of labels.md (``text``) matches."""
    patterns = doc_label_patterns(text)
    return sorted(k for k in keys if not any(p.fullmatch(k) for p in patterns))


def doc_metric_families(text: str) -> set:
    """The tfd_* families with a row in observability.md (``text``)."""
    return {name for name in _DOC_ROW.findall(text) if name.startswith("tfd_")}


def phase_docs() -> dict:
    """Every label key and scraped family the phases read has its row."""
    with open(os.path.join(DOCS, "labels.md")) as f:
        labels_doc = f.read()
    with open(os.path.join(DOCS, "observability.md")) as f:
        families_doc = f.read()
    out = {
        "label_keys": len(DOCS_SEEN["label_keys"]),
        "label_rows": len(doc_label_patterns(labels_doc)),
        "families": len(DOCS_SEEN["families"]),
        "family_rows": len(doc_metric_families(families_doc)),
        "undocumented_labels": undocumented_labels(DOCS_SEEN["label_keys"], labels_doc),
        "undocumented_families": sorted(
            DOCS_SEEN["families"] - doc_metric_families(families_doc)),
    }
    emit("docs", **out)
    check(not out["undocumented_labels"] and not out["undocumented_families"],
          f"docs/torch has no row for {out['undocumented_labels']} "
          f"{out['undocumented_families']}")
    return out


def _read_labels(path: str) -> dict:
    try:
        with open(path) as f:
            labels = dict(l.rstrip("\n").split("=", 1) for l in f if "=" in l)
    except FileNotFoundError:
        return {}
    return _grammar_checked(labels, path)


def _wait_for(cond, timeout: float, what: str, poll: float = 0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(poll)
    raise SystemExit(f"chip_smoke: check failed: {what} within {timeout}s")


HEALTH_KEYS = ("nvidia.com/gpu.health.matmul-tflops", "nvidia.com/gpu.health.hbm-gbps")
ICI_OK = "nvidia.com/gpu.health.ici.ok"
ICI_GBPS = "nvidia.com/gpu.health.ici.allreduce-gbps"
# Less than the smallest CUDA context on an H100 (about 500 MiB).
CONTEXT_MIB = 100
# Labels every GPU node now carries beside its device count.
HOST_FACT_KEYS = ("nvidia.com/gpu.machine", "nvidia.com/gpu.slice.capable",
                  "nvidia.com/gpu.family", "nvidia.com/gpu.generation.major")


def _has_health(labels: dict) -> bool:
    return (
        labels.get("nvidia.com/gpu.health.ok") == "true"
        and labels.get("nvidia.com/gpu.health.timing") == "device-profiler"
        and all(int(labels.get(k, "0")) > 0 for k in HEALTH_KEYS)
    )


# The registry seam on the card: a provider an embedder registers, the
# port's CUDA manager under a token of its own.
REGISTERED_TOKEN = "smoke-gpu"
# Labels of the per-device family, which --chip-probes=false drops.
PER_DEVICE_KEY = re.compile(
    r"^nvidia\.com/gpu\.(chip\.\d+\.|chips\.|straggler-chip$|health\.ici\.allreduce-gbps$)")
VERDICT_KEYS = ("nvidia.com/gpu.health.ok", "nvidia.com/gpu.health.timing",
                "nvidia.com/gpu.health.ici.ok")


def build_registered_gpu(config, token):
    """The registered provider's build: the port's CUDA manager."""
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import CudaManager

    return CudaManager()


def _probed_oneshot(*args: str) -> tuple:
    """A fresh probe's oneshot in this process (the probe caches dropped,
    so it pays its warm-up as a fresh process would): its labels, the
    report's phases and its hbm_stream_sum launches."""
    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck

    healthcheck.reset_probe_workspaces()
    capture = _PhaseCapture()
    lm_log = logging.getLogger("tfd.lm")
    lm_log.setLevel(logging.DEBUG)
    lm_log.addHandler(capture)
    hbm.hbm_stream_sum.launches = 0
    try:
        labels = _grammar_checked(_oneshot_labels("--with-burnin", *args), f"oneshot {args}")
    finally:
        lm_log.removeHandler(capture)
    return labels, capture.phases, hbm.hbm_stream_sum.launches


def _rate_range(work: float, device_ms: float, unit: float) -> tuple:
    """The integer labels a rate can print, given its device ms as the
    report prints it (6 decimals): work over the ms at both ends of its
    rounding half-unit."""
    lo_ms, hi_ms = device_ms - 0.5e-6, device_ms + 0.5e-6
    return int(work / (hi_ms / 1e3) / unit), int(work / (lo_ms / 1e3) / unit)


def phase_methodology(entries: dict, count: int, smi: str) -> dict:
    """The twin's unit-tier pins held on the card: (a) the published rates
    are the probe's bytes and flops over its median device times, (b)
    --chip-probes=false publishes the aggregate labels, (c) a provider
    registered through ``registry.register`` publishes what ``gpu`` does,
    with 1 + 3 launches."""
    from gpu_feature_discovery_tpu_torch.ops import healthcheck
    from gpu_feature_discovery_tpu_torch.ops.hbm import LANES, probe_rows
    from gpu_feature_discovery_tpu_torch.resource import registry

    t0 = time.perf_counter()
    on, phases, on_launches = _probed_oneshot("--backends", "gpu")
    # (a) the probe's 2048 x 4 geometry and its 256 MiB stream.
    flops = healthcheck.burnin_flops(healthcheck.CUDA_PROBE_SIZE, healthcheck.CUDA_PROBE_DEPTH)
    nbytes = probe_rows(healthcheck.PROBE_HBM_MIB) * LANES * 4
    check(on.get("nvidia.com/gpu.health.timing") == "device-profiler",
          f"health.timing {on.get('nvidia.com/gpu.health.timing')!r}")
    rates = {}
    for key, work, ms_key, unit in (
            ("nvidia.com/gpu.health.matmul-tflops", flops, "burnin_device_ms", 1e12),
            ("nvidia.com/gpu.health.hbm-gbps", nbytes, "hbm_device_ms", 2**30)):
        lo, hi = _rate_range(work, phases[ms_key], unit)
        label = int(on.get(key, "-1"))
        rates[key] = {"label": label, "device_ms": phases[ms_key],
                      "recomputed": work / (phases[ms_key] / 1e3) / unit}
        check(lo <= label <= hi,
              f"{key}={label} is not {work} over {phases[ms_key]} ms ({lo}..{hi})")
    check(on_launches == healthcheck.PROBE_HBM_ITERS + 1,
          f"the chip-probes oneshot launched {on_launches}")
    # (b) the aggregate labels with the per-device family off.
    off, _, off_launches = _probed_oneshot("--backends", "gpu", "--chip-probes=false")
    per_device = sorted(k for k in on if PER_DEVICE_KEY.match(k))
    check(sorted(off) == sorted(set(on) - set(per_device)),
          f"chip probes off: keys {sorted(set(off) ^ (set(on) - set(per_device)))} differ")
    check(all(off.get(k) == on.get(k) for k in VERDICT_KEYS),
          f"chip probes off: verdicts {[(k, on.get(k), off.get(k)) for k in VERDICT_KEYS]}")
    # (c) the registry seam: a provider registered before run().
    in_tree = [p.name for p in registry.providers()]
    registry.register(registry.BackendProvider(REGISTERED_TOKEN, registry.FAMILY_GPU,
                                               build_registered_gpu))
    try:
        listed = [p.name for p in registry.providers()]
        check(listed == in_tree + [REGISTERED_TOKEN], f"providers() lists {listed}")
        registered, _, registered_launches = _probed_oneshot("--backends", REGISTERED_TOKEN)
    finally:
        registry._PROVIDERS.pop(REGISTERED_TOKEN, None)
    check(sorted(registered) == sorted(on),
          f"registered provider: keys {sorted(set(registered) ^ set(on))} differ from gpu's")
    verdicts = [k for k in on if k in VERDICT_KEYS or k.endswith(".ok")
                or k.startswith("nvidia.com/gpu.chips.")]
    check(all(registered[k] == on[k] for k in verdicts),
          f"registered provider: verdicts {[(k, on[k], registered[k]) for k in verdicts]}")
    check(registered_launches == healthcheck.PROBE_HBM_ITERS + 1,
          f"registered provider's oneshot launched {registered_launches}")
    seconds = time.perf_counter() - t0
    entries["hbm_stream_sum"]["methodology_launches"] = [on_launches, off_launches,
                                                         registered_launches]
    out = {"nvidia_smi": smi, "rates": rates, "phases": phases,
           "per_device_keys_off": len(per_device), "keys_on": len(on), "keys_off": len(off),
           "registered_token": REGISTERED_TOKEN, "providers": listed,
           "launches": {"on": on_launches, "off": off_launches,
                        "registered": registered_launches},
           "seconds": seconds}
    emit("methodology", **out)
    return out


def phase_daemon(entries: dict, count: int, smi: str) -> dict:
    """(a) ``run()`` in process, (b) the CLI as a subprocess; returns the
    CLI's figures with the in-process daemon's steady cycle times."""
    import queue

    import torch

    from gpu_feature_discovery_tpu_torch.cmd.main import run
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck
    from gpu_feature_discovery_tpu_torch.resource import factory

    # The oneshot cycle of main_path recorded into the same registry: from
    # here on, what it holds is this daemon's.
    obs_metrics.REGISTRY.reset_values()
    metrics_port = _free_port()

    # The daemon's first probe pays its first use (warm-up, graph
    # capture) again, as in a fresh process; CUDA, cuBLAS and NCCL stay
    # set up from the earlier phases.
    healthcheck.reset_probe_workspaces()
    capture = _CycleCapture(lambda: hbm.hbm_stream_sum.launches)
    tfd_log = logging.getLogger("tfd")
    lm_log = logging.getLogger("tfd.lm")
    tfd_log.setLevel(logging.INFO)
    lm_log.setLevel(logging.DEBUG)
    tfd_log.addHandler(capture)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        # Broker off: auto isolation then resolves to in process under
        # burn-in, as in the twin (the broker phase drives the default).
        config = new_config(
            cli_values={"with-burnin": "true", "backends": "gpu",
                        "burnin-interval": "2", "sleep-interval": "1s",
                        "probe-broker": "off", "output-file": out,
                        "metrics-addr": "127.0.0.1", "metrics-port": str(metrics_port)},
            environ=dict(os.environ),
        )
        sigs = queue.SimpleQueue()
        process_state = {"live_full_served": False}
        result = {}

        def epoch():
            result["restart"] = run(
                lambda: factory.build_manager(config), config, sigs,
                supervisor=Supervisor(config), process_state=process_state,
            )

        health.reset_burnin_schedule()
        hbm.hbm_stream_sum.launches = 0
        # With CUDA already warm the first probe may end inside the wait
        # and be published at once, as a synchronous probe would. A wait
        # of 0 makes the first write prove it did not wait for the probe:
        # it must carry the base labels and no health label.
        wait_s = health.FIRST_PROBE_WAIT_S
        health.FIRST_PROBE_WAIT_S = 0.0
        try:
            t0 = time.monotonic()
            worker = threading.Thread(target=epoch, daemon=True)
            worker.start()
            first = _wait_for(lambda: _read_labels(out), wait_s + 1.0,
                              "first write", poll=0.005)
            first_write_s = time.monotonic() - t0
            _wait_for(lambda: _has_health(_read_labels(out)), 15.0,
                      "health labels in the daemon's file")
        finally:
            health.FIRST_PROBE_WAIT_S = wait_s
        check(first.get("nvidia.com/gpu.count") == str(count),
              f"first write count {first.get('nvidia.com/gpu.count')!r}")
        early = sorted(k for k in first if k.startswith("nvidia.com/gpu.health.")
                       or k.startswith("nvidia.com/gpu.chip."))
        check(not early, f"first write waited for the first probe: {early}")
        for key in HOST_FACT_KEYS:
            check(key in first, f"daemon first write has no {key}")

        def steady():
            modes = [c["mode"] for c in capture.cycles]
            probing = [i for i, m in enumerate(modes) if m == "probing"]
            return len(probing) >= 2 and "cached-health" in modes[probing[1]:]

        _wait_for(steady, 15.0, "two probing cycles and a cached one after")
        torch.cuda.synchronize()
        memory = {"reserved": torch.cuda.memory_reserved(),
                  "allocated": torch.cuda.memory_allocated()}
        # The probe ran in this process: no broker worker, and the chip
        # series are this probe's, as its labels are.
        scraped = _scrape(metrics_port)
        labels = _read_labels(out)
        check(scraped[("tfd_broker_up", "")] == 0, "tfd_broker_up with the broker off")
        for i in range(count if PER_DEVICE_LABELS else 0):
            ok = scraped.get(("tfd_chip_ok", f'{{chip="{i}"}}'))
            want = 1.0 if labels.get(f"nvidia.com/gpu.chip.{i}.ok") == "true" else 0.0
            check(ok == want, f"tfd_chip_ok{{chip={i}}} {ok}, label says {want}")
            tflops = scraped.get(("tfd_chip_tflops", f'{{chip="{i}"}}'))
            check(tflops is not None and math.isfinite(tflops) and tflops > 0,
                  f"tfd_chip_tflops{{chip={i}}} {tflops}")
        check(scraped[("tfd_first_probe_compile_seconds", "")] > 0,
              "in-process first probe's compile not recorded")
        sigs.put(signal.SIGHUP)
        worker.join(10)
        check(not worker.is_alive() and result.get("restart") is True,
              f"SIGHUP: run() returned {result.get('restart')!r}")
        check(not os.path.exists(out), "SIGHUP left the output file")
        daemon_launches = hbm.hbm_stream_sum.launches
        cycles = list(capture.cycles)

        # A second epoch, as start()'s reload loop runs it.
        health.reset_burnin_schedule()
        worker = threading.Thread(target=epoch, daemon=True)
        worker.start()
        _wait_for(lambda: _has_health(_read_labels(out)), 15.0,
                  "health labels after the reload")
        sigs.put(signal.SIGTERM)
        worker.join(10)
        check(not worker.is_alive() and result.get("restart") is False,
              f"SIGTERM: run() returned {result.get('restart')!r}")
        check(not os.path.exists(out) and not os.path.exists(
            os.path.join(tmp, "tfd-tmp")), "SIGTERM left the output file")
    tfd_log.removeHandler(capture)

    prev = 0
    for i, c in enumerate(cycles):
        phases = c.get("phases") or {}
        emit("daemon_cycle", index=i, mode=c["mode"], wall_ms=c["wall_ms"],
             probe_ms=c.get("probe_ms"), launches=c["launches"] - prev,
             compile_ms=phases.get("compile_ms"),
             burnin_device_ms=phases.get("burnin_device_ms"),
             hbm_device_ms=phases.get("hbm_device_ms"))
        prev = c["launches"]
    probing = [c for c in cycles if c["mode"] == "probing"]
    check(probing[0]["phases"]["compile_ms"] > 0, "first probe paid no warm-up")
    check(probing[1]["phases"]["compile_ms"] == 0,
          f"second probe compile_ms {probing[1]['phases']['compile_ms']}")
    deltas = [c["launches"] - p["launches"]
              for p, c in zip([{"launches": 0}] + cycles, cycles)]
    cached = [d for c, d in zip(cycles, deltas) if c["mode"] == "cached-health"]
    check(cached and all(d == 0 for d in cached),
          f"cached cycles launched kernels: {cached}")
    # Launches counted per probing cycle: the first one's count runs from
    # the zeroing (its first probe may straddle earlier cycles) and holds
    # the warm-up; each later one is its own delta.
    per_probe = [c["launches"] if i == 0 else d
                 for i, (c, d) in enumerate(
                     (c, d) for c, d in zip(cycles, deltas) if c["mode"] == "probing")]
    want = [healthcheck.PROBE_HBM_ITERS + 1] + [healthcheck.PROBE_HBM_ITERS] * (
        len(per_probe) - 1)
    check(per_probe == want,
          f"launches per probing cycle {per_probe}, want {want}")
    check(daemon_launches == sum(per_probe),
          f"{daemon_launches} launches in the epoch, {sum(per_probe)} in its "
          "probing cycles")
    entries["hbm_stream_sum"]["daemon_launches"] = daemon_launches
    entries["hbm_stream_sum"]["daemon_launches_per_probing_cycle"] = per_probe
    emit("daemon", first_write_s=first_write_s, probing_cycles=len(probing),
         cached_cycles=len(cached), launches=daemon_launches,
         launches_per_probing_cycle=per_probe, memory_bytes=memory,
         chip_ok=[scraped.get(("tfd_chip_ok", f'{{chip="{i}"}}')) for i in range(count)],
         first_probe_compile_s=scraped[("tfd_first_probe_compile_seconds", "")])
    phase_methodology(entries, count, smi)
    cli = phase_daemon_cli(count)
    # Steady cycles: the probing ones after the first (which pays first
    # use) and the cached ones.
    cli["daemon_steady_probing_wall_ms"] = [c["wall_ms"] for c in probing[1:]]
    cli["daemon_cached_wall_ms"] = [c["wall_ms"] for c in cycles
                                    if c["mode"] == "cached-health"]
    return cli


def _first_cycle_stages(log_path: str):
    """Stage -> ms of the first "Cycle timings" line in a CLI log."""
    with open(log_path) as f:
        for line in f:
            if "Cycle timings: " in line:
                return {k: float(v.rstrip("ms")) for k, v in (
                    part.split("=", 1)
                    for part in line.split("Cycle timings: ", 1)[1].split())}
    return None


def _children(pid: int) -> list:
    """Pids whose parent is ``pid``."""
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            kids.append(int(entry))
    return kids


def _maps_libcuda(pid: int, library: str = "libcuda.so") -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return library in f.read()


def _gone(pid: int) -> bool:
    """No such process, or a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _host_memory(pids: dict) -> dict:
    """VmRSS (shared library pages included) and RssAnon (private) in KiB
    per named pid; None for a field the machine's /proc does not give."""
    out = {}
    for name, pid in pids.items():
        with open(f"/proc/{pid}/status") as f:
            fields = dict(l.split(":", 1) for l in f if ":" in l)
        for key in ("VmRSS", "RssAnon"):
            value = fields.get(key)
            out[f"{name}_{key}_kib"] = int(value.split()[0]) if value else None
    return out


def _device_used_mib() -> int:
    """The card's memory in use, all processes, by nvidia-smi."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])


def _chip_series_agree(port: int, out: str) -> dict:
    """tfd_chip_ok{chip="0"} against health.ok and chip.0.ok, and the raw
    tfd_chip_tflops{chip="0"} against the chip.0.tflops label (its floor)
    when the label is published. A probe lands between the label file and
    the scrape now and then, so the three are read until the file reads the
    same before and after the scrape; returns that scrape."""
    for _ in range(20):
        before = _read_labels(out)
        scraped = _scrape(port)
        if _read_labels(out) == before:
            break
        time.sleep(0.1)
    else:
        raise SystemExit("chip_smoke: check failed: the label file never held "
                         "still across a scrape")
    ok = scraped.get(("tfd_chip_ok", '{chip="0"}'))
    if not PER_DEVICE_LABELS:
        check(ok is None and "nvidia.com/gpu.chip.0.ok" not in before,
              f"per-device health published on a CUDA subset: {ok}, {before}")
        return scraped
    want = 1.0 if before.get("nvidia.com/gpu.chip.0.ok") == "true" else 0.0
    check(ok == want and (ok == 1.0) == (before.get("nvidia.com/gpu.health.ok") == "true"),
          f"tfd_chip_ok{{chip=0}} {ok} against chip.0.ok "
          f"{before.get('nvidia.com/gpu.chip.0.ok')!r} and health.ok "
          f"{before.get('nvidia.com/gpu.health.ok')!r}")
    tflops = scraped.get(("tfd_chip_tflops", '{chip="0"}'))
    check(tflops is not None and math.isfinite(tflops) and tflops > 0,
          f"tfd_chip_tflops{{chip=0}} {tflops}")
    label = before.get("nvidia.com/gpu.chip.0.tflops")
    check(label is None or int(label) == int(tflops),
          f"tfd_chip_tflops{{chip=0}} {tflops} against the label {label!r}")
    return scraped


def phase_daemon_cli(count: int) -> dict:
    """The CLI in its own process at its defaults, with real signals: it
    acquires through the broker worker, which holds the card and runs the
    burn-in, while the CLI process maps no libcuda.so. The first cycle's
    health request waits no longer than ``HEALTH_WAIT_S``. Its
    introspection server is scraped over HTTP on a free port of
    127.0.0.1, and ``POST /probe`` is authenticated by a fresh token."""
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    build_dir = os.path.join(REPO, "build")
    port = _free_port()
    token = secrets.token_hex(16)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        log_path = os.path.join(tmp, "log")
        # The card's memory before the CLI starts: its rise while the CLI
        # runs is the worker's (the CLI process holds no CUDA context).
        used_before = _device_used_mib()
        t0 = time.monotonic()
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
                 "--with-burnin", "--sleep-interval", "1s", "--output-file", out,
                 "--metrics-addr", "127.0.0.1", "--metrics-port", str(port),
                 "--probe-token", token],
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            )
        workers = []
        try:
            base = _wait_for(lambda: _read_labels(out), 90.0, "CLI first write",
                             poll=0.005)
            first_write_s = time.monotonic() - t0
            first_cycle = _wait_for(lambda: _first_cycle_stages(log_path), 5.0,
                                    "CLI first cycle's timings line")
            first = _wait_for(
                lambda: (lambda l: l if _has_health(l) else None)(_read_labels(out)),
                90.0, "CLI health labels",
            )
            health_s = time.monotonic() - t0
            workers = _children(proc.pid)
            check(len(workers) == 1, f"CLI children {workers}, want one worker")
            check(not _maps_libcuda(proc.pid), "the CLI process maps libcuda.so")
            check(not _maps_libcuda(proc.pid, "libnvidia-ml.so"),
                  "the CLI process loaded NVML")
            check(_maps_libcuda(workers[0]), "the broker worker maps no libcuda.so")
            check(_maps_libcuda(workers[0], "libnvidia-ml.so"),
                  "the broker worker did not load NVML")

            # The scrape, once health labels are on disk.
            scraped = _chip_series_agree(port, out)
            cycles = sum(v for (n, _), v in scraped.items() if n == "tfd_cycles_total")
            check(scraped[("tfd_broker_up", "")] == 1, "tfd_broker_up under the broker")
            check(scraped[("tfd_broker_requests_total", "")] >= cycles,
                  f"{scraped[('tfd_broker_requests_total', '')]} broker requests "
                  f"in {cycles} cycles")
            first_use_s = scraped[("tfd_first_probe_compile_seconds", "")]
            check(first_use_s > 0, "tfd_first_probe_compile_seconds is 0")
            check(scraped[("tfd_compile_cache_enabled", "")] == 1,
                  "tfd_compile_cache_enabled is 0")
            restart_s = scraped[("tfd_restart_to_labels_seconds", "")]
            check(first_cycle["gpu.acquire"] / 1e3 <= restart_s <= first_write_s + 1.0,
                  f"tfd_restart_to_labels_seconds {restart_s} outside "
                  f"[gpu.acquire {first_cycle['gpu.acquire'] / 1e3}, "
                  f"first write {first_write_s} + 1]")
            for path in ("/healthz", "/readyz"):
                code, body = _http(port, "GET", path)
                check(code == 200, f"{path} answered {code}: {body}")
            # The cycle that first published health labels posted a
            # health_delta; a wake counts its first event's reason, so the
            # probe is posted once that wake has passed: two cycles on.
            full = ("tfd_cycles_total", '{outcome="full"}')
            settled = _wait_for(lambda: (lambda s: s if s[full] >= scraped[full] + 2
                                         else None)(_scrape(port)),
                                10.0, "two cycles after the health labels")
            wake = ("tfd_reconcile_wakes_total", '{reason="probe_request"}')
            wakes = settled.get(wake, 0.0)
            code, _ = _http(port, "POST", "/probe")
            check(code == 401, f"POST /probe without the token answered {code}")
            code, _ = _http(port, "POST", "/probe", {"X-TFD-Probe-Token": token})
            check(code == 202, f"POST /probe with the token answered {code}")
            woke = _wait_for(lambda: (lambda s: s if s.get(wake, 0.0) == wakes + 1
                                      else None)(_scrape(port)),
                             10.0, "a probe_request wake")
            _wait_for(lambda: _scrape(port)[full] > woke[full], 10.0,
                      "a full cycle after the probe_request wake")
            # The cost of a scrape, against the live CLI.
            scrape_ms = []
            for _ in range(20):
                t = time.perf_counter()
                code, body = _http(port, "GET", "/metrics")
                scrape_ms.append((time.perf_counter() - t) * 1e3)
                check(code == 200, f"/metrics answered {code}")
            exposition = {
                "bytes": len(body.encode()),
                "families": len(_validate_exposition(body)),
                "series": len(_samples(body)),
            }
            final = _samples(body)
            check(not _maps_libcuda(proc.pid), "serving metrics mapped libcuda.so")
            check(not _maps_libcuda(proc.pid, "libnvidia-ml.so"),
                  "serving metrics loaded NVML")
            memory = {**_host_memory({"parent": proc.pid, "worker": workers[0]}),
                      "device_used_mib_before": used_before,
                      "device_used_mib_with_worker": _device_used_mib()}
            stamp = int(first["google.com/tfd.timestamp"])
            # A new epoch's timestamp is later by at least a second.
            time.sleep(max(0.0, stamp + 1.05 - time.time()))
            proc.send_signal(signal.SIGHUP)
            second = _wait_for(
                lambda: (lambda l: l if _has_health(l) and int(
                    l.get("google.com/tfd.timestamp", "0")) > stamp
                    and "nvidia.com/gpu.health.probe-ms" in l else None)(
                    _read_labels(out)),
                60.0, "fresh health labels after SIGHUP",
            )
            workers += [w for w in _children(proc.pid) if w not in workers]
            check(len(workers) == 2, f"workers {workers}: SIGHUP must respawn one")
            check(not _maps_libcuda(proc.pid), "the CLI process maps libcuda.so")
            # The same port, the new epoch's server. A commanded close
            # retires the epoch's broker client; the new epoch's first
            # spawn is its client's first, so no respawn is counted (the
            # twin's rule).
            with open(log_path) as f:
                listening = f.read().count(f"Introspection server listening on 127.0.0.1:{port}")
            check(listening == 2, f"{listening} introspection binds, want one per epoch")
            reloaded = _chip_series_agree(port, out)
            check(reloaded[("tfd_broker_up", "")] == 1, "tfd_broker_up after SIGHUP")
            check(reloaded[("tfd_broker_respawns_total", "")] == 0,
                  f"{reloaded[('tfd_broker_respawns_total', '')]} respawns counted "
                  "for a commanded close")
            t_term = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=15)
            _wait_for(lambda: all(_gone(w) for w in workers),
                      max(0.0, t_term + broker.GRACEFUL_CLOSE_S + 1.0 - time.monotonic()),
                      f"no broker worker of {workers} alive after SIGTERM")
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
            except OSError:
                refused = True
            else:
                refused = False
            check(refused, f"port {port} still answers after SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log_path) as f:
            text = f.read()
        tail, head = text[-2000:], text[:3000]
        check(rc == 0, f"CLI exited {rc} after SIGTERM; log tail:\n{tail}")
        check(not os.path.exists(out), "CLI exit left the output file")
    check(base.get("nvidia.com/gpu.count") == str(count),
          f"CLI first write count {base.get('nvidia.com/gpu.count')!r}")
    # The first cycle acquires the backend (gpu.acquire: the worker's
    # spawn, torch's import and CUDA's set-up in it); its health request
    # then waits at most HEALTH_WAIT_S for the worker's first probe, which
    # the first write carries when it ended inside the wait.
    base_health = any(k.startswith("nvidia.com/gpu.health.") for k in base)
    check(first_cycle["labeler.health"] <= (broker.HEALTH_WAIT_S + 0.5) * 1e3
          and first_cycle["labelgen.total"] - first_cycle["gpu.acquire"]
          <= (broker.HEALTH_WAIT_S + 1.0) * 1e3,
          f"CLI first cycle took {first_cycle}; log:\n{head}")
    spawn_ms = [float(m) for m in re.findall(r"broker worker \d+ ready in (\d+) ms", text)]
    emit("daemon_cli", first_write_s=first_write_s,
         first_cycle_stages_ms=first_cycle, restart_to_labels_s=restart_s,
         first_write_health=base_health,
         health_s=health_s, rc=rc, worker_spawn_ms=spawn_ms, memory=memory,
         probe_ms_first=int(first.get("nvidia.com/gpu.health.probe-ms", -1)),
         probe_ms_after_reload=int(second["nvidia.com/gpu.health.probe-ms"]),
         matmul_tflops=int(second[HEALTH_KEYS[0]]),
         hbm_gbps=int(second[HEALTH_KEYS[1]]))
    for key in HOST_FACT_KEYS:
        check(key in base, f"CLI first write has no {key}")
    return {
        "first_cycle": first_cycle,
        "restart_to_labels_s": restart_s,
        "first_probe_compile_s": first_use_s,
        "scrape_ms": scrape_ms,
        "exposition": exposition,
        "broker_request_duration": {
            "count": final[("tfd_broker_request_duration_seconds_count", "")],
            "sum_s": final[("tfd_broker_request_duration_seconds_sum", "")],
        },
        "chip_tflops": final[("tfd_chip_tflops", '{chip="0"}')],
    }


BROKER_PROBE_TIMEOUT_S = 20.0


def phase_broker(entries: dict, count: int, host_labels: dict) -> None:
    """``cmd.main.run`` at the default isolation and broker settings, on a
    thread of this process (which holds CUDA from the earlier phases: the
    worker is a fresh interpreter, never a fork). The HBM kernel runs in
    the worker; its launches are read from the reports the worker ships
    (``phases.hbm_stream_sum_launches*``), and this process launches
    none."""
    import queue

    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.cmd.main import run
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck
    from gpu_feature_discovery_tpu_torch.resource import factory
    from gpu_feature_discovery_tpu_torch.sandbox import broker
    from gpu_feature_discovery_tpu_torch.utils import faults

    arm = {"spec": None}

    def on_cycle():
        if arm["spec"]:
            faults.load_fault_spec(arm["spec"])
            arm["spec"] = None

    capture = _CycleCapture(lambda: hbm.hbm_stream_sum.launches, on_cycle)
    tfd_log = logging.getLogger("tfd")
    tfd_log.setLevel(logging.INFO)
    logging.getLogger("tfd.lm").setLevel(logging.DEBUG)
    tfd_log.addHandler(capture)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    faults.reset()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        config = new_config(
            cli_values={"with-burnin": "true", "backends": "gpu",
                        "burnin-interval": "2", "sleep-interval": "1s",
                        "probe-timeout": f"{BROKER_PROBE_TIMEOUT_S}s",
                        "output-file": out, "metrics-port": "0"},
            environ=dict(os.environ),
        )
        check(sandbox.isolation_mode(config) == "subprocess"
              and sandbox.broker_enabled(config), "defaults did not pick the broker")
        sigs = queue.SimpleQueue()
        result = {}

        def epoch():
            result["restart"] = run(
                lambda: factory.build_manager(config), config, sigs,
                supervisor=Supervisor(config),
            )

        def worker_pid():
            client = broker._active
            return client.pid if client is not None else None

        def fresh_health(after_cycle):
            return any(c["mode"] == "probing" and c["phases"] and
                       i >= after_cycle for i, c in enumerate(capture.cycles)) \
                and _has_health(_read_labels(out))

        health.reset_burnin_schedule()
        hbm.hbm_stream_sum.launches = 0
        # A health request that waits 0 s answers "warming" whatever the
        # worker's pre-warm did: the first write must then carry the base
        # labels and no health label. Restored once it landed.
        wait_s, broker.HEALTH_WAIT_S = broker.HEALTH_WAIT_S, 0.0
        t0 = time.monotonic()
        thread = threading.Thread(target=epoch, daemon=True)
        thread.start()
        try:
            first = _wait_for(lambda: _read_labels(out), BROKER_PROBE_TIMEOUT_S + 10,
                              "broker first write", poll=0.005)
        finally:
            broker.HEALTH_WAIT_S = wait_s
        first_write_s = time.monotonic() - t0
        check(first.get("nvidia.com/gpu.count") == str(count),
              f"broker first write count {first.get('nvidia.com/gpu.count')!r}")
        early = sorted(k for k in first if k.startswith("nvidia.com/gpu.health.")
                       or k.startswith("nvidia.com/gpu.chip."))
        check(not early, f"broker first write carried health labels: {early}")
        # The host facts reach this process through the worker's snapshot
        # (and its own sysfs and DMI reads): those of the oneshot cycle.
        facts = {k: first.get(k) for k in host_labels}
        check(facts == host_labels, "broker first write's host facts differ: "
              f"{sorted(set(facts.items()) ^ set(host_labels.items()))}")
        pids = [worker_pid()]
        check(pids[0] is not None and pids[0] != os.getpid(),
              f"broker worker pid {pids[0]}")
        _wait_for(lambda: fresh_health(0), 30.0, "health labels through the broker")

        def steady():
            modes = [c["mode"] for c in capture.cycles]
            probing = [i for i, m in enumerate(modes) if m == "probing"]
            return len(probing) >= 2 and "cached-health" in modes[probing[1]:]

        _wait_for(steady, 15.0, "two probing cycles and a cached one after")
        steady_cycles = list(capture.cycles)

        # The registry of this process, which the epoch records into.
        counters = {"kills": obs_metrics.PROBE_KILLS, "crashes": obs_metrics.PROBE_CRASHES,
                    "respawns": obs_metrics.BROKER_RESPAWNS}
        before = {k: c.value() for k, c in counters.items()}
        recoveries, messages = {}, {}
        for site in ("broker.hang", "broker.crash"):
            old = worker_pid()
            n_cycles, n_failures = len(capture.cycles), len(capture.failures)
            arm["spec"] = f"{site}:fail:1"  # armed as the next cycle ends
            _wait_for(lambda: len(capture.failures) > n_failures,
                      BROKER_PROBE_TIMEOUT_S + 10, f"{site}: the cycle failing")
            t_fail = time.monotonic()
            messages[site] = capture.failures[n_failures]
            check(_gone(old), f"{site}: worker {old} still alive after the failure")
            _wait_for(lambda: worker_pid() not in (None, old),
                      BROKER_PROBE_TIMEOUT_S + 10, f"{site}: respawn")
            pids.append(worker_pid())
            after = len(capture.cycles)
            _wait_for(lambda: fresh_health(after), 30.0,
                      f"{site}: fresh health labels after the respawn")
            recoveries[site] = {"message": messages[site][:300],
                                "failure_to_fresh_health_s": time.monotonic() - t_fail,
                                "cycles_to_failure": after - n_cycles}
        hang = re.search(r"SIGKILLed after ([0-9.]+)s", messages["broker.hang"])
        check("exceeded its" in messages["broker.hang"] and hang is not None
              and BROKER_PROBE_TIMEOUT_S <= float(hang.group(1))
              <= BROKER_PROBE_TIMEOUT_S + 1,
              f"broker.hang not killed at --probe-timeout: {messages['broker.hang']}")
        check("SIGSEGV" in messages["broker.crash"],
              f"broker.crash did not surface: {messages['broker.crash']}")
        rendered = obs_metrics.REGISTRY.render()
        _validate_exposition(rendered)
        counted = {k: c.value() - before[k] for k, c in counters.items()}
        check(counted == {"kills": 1, "crashes": 1, "respawns": 2},
              f"the registry counted {counted} for one hang and one crash")
        check(obs_metrics.BROKER_UP.value() == 1, "tfd_broker_up after the respawns")
        check(obs_metrics.CHIP_OK.value(chip="0") == (1 if PER_DEVICE_LABELS else 0),
              "tfd_chip_ok{chip=0} after fresh health labels")
        sigs.put(signal.SIGTERM)
        t_term = time.monotonic()
        thread.join(BROKER_PROBE_TIMEOUT_S)
        check(not thread.is_alive() and result.get("restart") is False,
              f"SIGTERM: run() returned {result.get('restart')!r}")
        check(all(_gone(p) for p in pids), f"broker workers {pids} outlived run()")
        close_s = time.monotonic() - t_term
        check(not os.path.exists(out), "SIGTERM left the output file")
    tfd_log.removeHandler(capture)
    faults.reset()

    cycles = list(capture.cycles)
    for i, c in enumerate(cycles):
        phases = c.get("phases") or {}
        emit("broker_cycle", index=i, mode=c["mode"], wall_ms=c["wall_ms"],
             probe_ms=c.get("probe_ms"),
             launches=phases.get("hbm_stream_sum_launches"),
             worker_launches=phases.get("hbm_stream_sum_launches_process"),
             compile_ms=phases.get("compile_ms"),
             burnin_device_ms=phases.get("burnin_device_ms"),
             hbm_device_ms=phases.get("hbm_device_ms"))
    check(hbm.hbm_stream_sum.launches == 0,
          f"this process launched the kernel {hbm.hbm_stream_sum.launches} times")
    probes = [c["phases"] for c in cycles if c["mode"] == "probing"]
    per_probe = [p["hbm_stream_sum_launches"] for p in probes]
    check(all(n in (healthcheck.PROBE_HBM_ITERS, healthcheck.PROBE_HBM_ITERS + 1)
              for n in per_probe), f"launches per probe {per_probe}")
    # Each worker launches the kernel once to warm up (its pre-warm, or its
    # first probe when that took the devices first), then 3 per probe: the
    # process count each report ships is 1 + 3k after the worker's k-th
    # probe. A report of at most 4 opens a new worker.
    last_counts = []
    for p in probes:
        total = p["hbm_stream_sum_launches_process"]
        if total <= healthcheck.PROBE_HBM_ITERS + 1:
            last_counts.append(0)
        check(bool(last_counts) and total == last_counts[-1] + (
            healthcheck.PROBE_HBM_ITERS + 1 if last_counts[-1] == 0
            else healthcheck.PROBE_HBM_ITERS),
            f"worker launch counts {[q['hbm_stream_sum_launches_process'] for q in probes]}")
        last_counts[-1] = total
    check(len(last_counts) == 3,
          f"{len(last_counts)} workers probed, want 3 (start, after hang, after crash)")
    broker_launches = sum(last_counts)
    entries["hbm_stream_sum"]["broker_launches"] = broker_launches
    entries["hbm_stream_sum"]["broker_launches_per_probing_cycle"] = per_probe
    steady_probes = [c for c in steady_cycles if c["mode"] == "probing"]
    emit("broker", first_write_s=first_write_s, worker_pids=pids,
         spawn_ms=[ms for _, ms in capture.spawns],
         warming_cycles=sum(c["mode"] == "warming" for c in steady_cycles),
         probing_cycles=len(probes), launches=broker_launches,
         launches_per_probing_cycle=per_probe,
         steady_probe_ms=[c["probe_ms"] for c in steady_probes[1:]],
         recoveries=recoveries, close_s=close_s, registry_counted=counted)


# The config-file CLI (phase_config_registry): a fresh process that runs
# the CLI's own entry point, main(), with the arguments a user passes; it
# only lowers the tfd.lm logger to debug first, so that the log carries the
# probe reports the gpu worker ships (their hbm_stream_sum launch counts).
_CONFIG_CLI = (
    "import logging, sys\n"
    "logging.getLogger('tfd.lm').setLevel(logging.DEBUG)\n"
    "from gpu_feature_discovery_tpu_torch.cmd.main import main\n"
    "sys.argv = ['gpu-feature-discovery-torch'] + sys.argv[1:]\n"
    "main()\n"
)

_CONFIG_FILE = """\
version: v1
flags:
  tfd:
    withBurnin: true
    noTimestamp: false
    sleepInterval: 1s
    backends: {backends}
    metricsAddr: 127.0.0.1
    metricsPort: {port}
    outputFile: {out}
sharing:
  timeSlicing:
    resources:
      - name: nvidia.com/gpu
        replicas: {replicas}
"""

CPU_DEGRADED = "node.features/cpu.tfd.degraded"
GPU_DEGRADED = "nvidia.com/gpu.tfd.degraded"
# Failed cpu-family inits under the fault spec: with the registry's 1, 2, 4,
# 8 s backoff the family stays down for some 25-40 s, past the gpu worker's
# spawn and pre-warm, so gpu health labels publish while it is down.
CPU_FAULT_SHOTS = 5


def _spawned(log_path: str) -> dict:
    """{backend: [(pid, ms), ...]} from the "broker worker ... ready in"
    lines; the classic path's worker is keyed ''."""
    out = {}
    with open(log_path) as f:
        for m in re.finditer(r"broker worker (\d+) ready in (\d+) ms"
                             r"(?: for backend (\S+))?", f.read()):
            out.setdefault(m.group(3) or "", []).append((int(m.group(1)), int(m.group(2))))
    return out


def _probe_reports(log_path: str) -> list:
    """(launches in the probe, launches in its worker so far) per probe
    report in the log."""
    with open(log_path) as f:
        text = f.read()
    return [(int(a), int(b)) for a, b in re.findall(
        r"'hbm_stream_sum_launches': (\d+).*?'hbm_stream_sum_launches_process': (\d+)",
        text)]


def _per_worker_totals(reports: list) -> list:
    """The last process count of each worker: a report of at most 4 (the
    warm-up plus one probe) opens a new worker; after it, 3 per probe."""
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    iters = healthcheck.PROBE_HBM_ITERS
    totals = []
    for per_probe, total in reports:
        check(per_probe in (iters, iters + 1), f"launches per probe {reports}")
        if total <= iters + 1:
            totals.append(0)
        check(bool(totals) and total == totals[-1] + (
            iters + 1 if totals[-1] == 0 else iters), f"worker launch counts {reports}")
        totals[-1] = total
    return totals


def _start_config_cli(tmp: str, name: str, text: str, env=None):
    path = os.path.join(tmp, "tfd.yaml")
    with open(path, "w") as f:
        f.write(text)
    log_path = os.path.join(tmp, f"{name}.log")
    environ = dict(os.environ)
    environ.pop("TFD_FAULT_SPEC", None)
    environ.update(env or {})
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _CONFIG_CLI, "--config-file", path,
             "--no-timestamp", "true"],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=environ,
        )
    return proc, path, log_path


def _stop_config_cli(proc, log_path: str, pids: list) -> None:
    t_term = time.monotonic()
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    _wait_for(lambda: all(_gone(p) for p in pids),
              max(0.0, t_term + broker.GRACEFUL_CLOSE_S * len(pids) + 1.0
                  - time.monotonic()),
              f"no broker worker of {pids} alive after SIGTERM")
    with open(log_path) as f:
        tail = f.read()[-3000:]
    check(rc == 0, f"config CLI exited {rc}; log tail:\n{tail}")


def phase_config_registry(entries: dict, product: str, smi: str) -> dict:
    """The CLI started from a config file with ``backends: gpu,cpu`` and
    one CLI flag the file contradicts (``--no-timestamp``): the file's
    time-slicing replicas and -SHARED product, the CLI over the file, one
    broker worker per family (only the gpu one maps CUDA and NVML, runs
    the burn-in and launches hbm_stream_sum), ``tfd_backend_up`` per
    family, then a live reload by atomic rename to ``replicas: 2`` and
    ``backends: gpu``. A second CLI under ``pjrt_init.cpu:fail:<n>``
    degrades the cpu family alone, and recovers."""
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    port = _free_port()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        fields = {"port": port, "out": out}
        t0 = time.monotonic()
        proc, path, log_path = _start_config_cli(
            tmp, "registry", _CONFIG_FILE.format(backends="gpu,cpu", replicas=4, **fields))
        pids = []
        try:
            first = _wait_for(lambda: (lambda l: l if _has_health(l) and
                                       "node.features/cpu.count" in l else None)(
                _read_labels(out)), 120.0, "config CLI: both families with health")
            health_s = time.monotonic() - t0
            want = {"nvidia.com/gpu.replicas": "4",
                    "nvidia.com/gpu.product": f"{product}-SHARED",
                    "node.features/cpu.count": "1", "node.features/cpu.product": "cpu"}
            got = {k: first.get(k) for k in want}
            check(got == want, f"the file's settings: {got}, want {want}")
            check("google.com/tfd.timestamp" not in first,
                  "--no-timestamp did not beat the file's noTimestamp: false")
            check(not any(k.endswith(".tfd.degraded") for k in first),
                  f"degraded markers in a healthy start: {sorted(first)}")
            spawned = _spawned(log_path)
            check(sorted(spawned) == ["cpu", "gpu"] and all(
                len(v) == 1 for v in spawned.values()), f"workers spawned: {spawned}")
            gpu_pid, cpu_pid = spawned["gpu"][0][0], spawned["cpu"][0][0]
            pids = [gpu_pid, cpu_pid]
            check(sorted(_children(proc.pid)) == sorted(pids),
                  f"CLI children {_children(proc.pid)}, want the workers {pids}")
            maps = {name: {lib: _maps_libcuda(pid, lib)
                           for lib in ("libcuda.so", "libnvidia-ml.so")}
                    for name, pid in (("cli", proc.pid), ("gpu_worker", gpu_pid),
                                      ("cpu_worker", cpu_pid))}
            check(maps["gpu_worker"] == {"libcuda.so": True, "libnvidia-ml.so": True}
                  and not any(maps["cli"].values())
                  and not any(maps["cpu_worker"].values()),
                  f"CUDA and NVML mappings: {maps}")
            check(not _maps_libcuda(cpu_pid, "libtorch"),
                  "the cpu family's worker imported torch")

            # A scrape's cost is the GET alone, as in daemon_cli.
            scrape_ms = []
            for _ in range(20):
                t = time.perf_counter()
                code, _ = _http(port, "GET", "/metrics")
                scrape_ms.append((time.perf_counter() - t) * 1e3)
                check(code == 200, f"/metrics answered {code}")
            scraped = _scrape(port)
            up = {b: scraped.get(("tfd_backend_up", f'{{backend="{b}"}}'))
                  for b in ("gpu", "cpu")}
            check(up == {"gpu": 1.0, "cpu": 1.0}, f"tfd_backend_up {up}")
            # A second probe, so the worker's launch count shows 1 + 3k.
            _wait_for(lambda: len(_probe_reports(log_path)) >= 2, 60.0,
                      "two probe reports from the gpu worker")
            before_reload = _per_worker_totals(_probe_reports(log_path))
            check(len(before_reload) == 1, f"gpu workers {before_reload}")

            # Live reload: the new file replaces the old by an atomic rename.
            with open(path + ".new", "w") as f:
                f.write(_CONFIG_FILE.format(backends="gpu", replicas=2, **fields))
            n_reports = len(_probe_reports(log_path))
            t_rename = time.monotonic()
            os.replace(path + ".new", path)
            reloaded = _wait_for(lambda: (lambda l: l if l.get(
                "nvidia.com/gpu.replicas") == "2" else None)(_read_labels(out)),
                60.0, "replicas 2 after the rename")
            reload_labels_s = time.monotonic() - t_rename
            check(not any(k.startswith("node.features/") for k in reloaded),
                  f"cpu labels after the reload: {sorted(reloaded)}")
            check(reloaded.get("nvidia.com/gpu.product") == f"{product}-SHARED",
                  f"product after the reload {reloaded.get('nvidia.com/gpu.product')}")
            _wait_for(lambda: _has_health(_read_labels(out)), 60.0,
                      "health labels from the new gpu worker")
            reload_health_s = time.monotonic() - t_rename
            check(_gone(cpu_pid) and _gone(gpu_pid), "the first epoch's workers outlived it")
            respawned = _spawned(log_path)
            new_pid = respawned.get("", [(None, None)])[0][0]
            check(new_pid is not None and _children(proc.pid) == [new_pid],
                  f"workers after the reload {respawned}, children {_children(proc.pid)}")
            pids.append(new_pid)
            _wait_for(lambda: len(_probe_reports(log_path)) > n_reports, 60.0,
                      "a probe report from the new worker")
            # A report of at most 1 + 3 opens a worker: the count started again.
            totals = _per_worker_totals(_probe_reports(log_path))
            check(len(totals) == 2,
                  f"the new worker's launch count did not start again: {totals}")
            settled = _scrape(port)
            wakes = settled.get(("tfd_reconcile_wakes_total", '{reason="config_changed"}'))
            check(wakes == 1, f"config_changed wakes {wakes}")
            with open(log_path) as f:
                check("Config file changed, restarting." in f.read(),
                      "no config-change restart in the log")
        finally:
            _stop_config_cli(proc, log_path, pids)
        launches = sum(totals)

        # The cpu family alone degrades, and recovers.
        out2 = os.path.join(tmp, "faulted")
        proc, _, log2 = _start_config_cli(
            tmp, "faulted", _CONFIG_FILE.format(
                backends="gpu,cpu", replicas=4, port=port, out=out2),
            env={"TFD_FAULT_SPEC": f"pjrt_init.cpu:fail:{CPU_FAULT_SHOTS}"})
        pids2 = []
        try:
            degraded = _wait_for(lambda: (lambda l: l if l.get(CPU_DEGRADED) == "true"
                                          else None)(_read_labels(out2)),
                                 120.0, "the cpu family's degraded marker")
            check("node.features/cpu.count" not in degraded, "a down cpu family's count")
            # The gpu family publishes fresh health while the cpu one is down.
            both = _wait_for(lambda: (lambda l: l if _has_health(l) else None)(
                _read_labels(out2)), 120.0, "gpu health labels beside the down cpu family")
            scraped = _scrape(port)
            during = {"cpu_degraded": both.get(CPU_DEGRADED),
                      "gpu_degraded": both.get(GPU_DEGRADED),
                      "up_cpu": scraped.get(("tfd_backend_up", '{backend="cpu"}')),
                      "up_gpu": scraped.get(("tfd_backend_up", '{backend="gpu"}'))}
            check(during == {"cpu_degraded": "true", "gpu_degraded": None,
                             "up_cpu": 0.0, "up_gpu": 1.0},
                  f"while the cpu family is down: {during}")
            t_spent = time.monotonic()
            recovered = _wait_for(lambda: (lambda l: l if CPU_DEGRADED not in l and
                                           l.get("node.features/cpu.count") == "1"
                                           else None)(_read_labels(out2)),
                                  90.0, "the cpu family's recovery")
            recover_s = time.monotonic() - t_spent
            check(_has_health(recovered) and GPU_DEGRADED not in recovered,
                  f"after the recovery: {sorted(recovered)}")
            scraped = _scrape(port)
            inits = {o: scraped.get(("tfd_backend_inits_total",
                                     f'{{backend="cpu",outcome="{o}"}}'))
                     for o in ("error", "ok")}
            check(inits == {"error": float(CPU_FAULT_SHOTS), "ok": 1.0},
                  f"tfd_backend_inits_total for cpu {inits}")
            check(scraped.get(("tfd_backend_up", '{backend="cpu"}')) == 1.0,
                  "tfd_backend_up cpu after the recovery")
            pids2 = [pid for v in _spawned(log2).values() for pid, _ in v]
        finally:
            _stop_config_cli(proc, log2, pids2)
    emit("config_registry", nvidia_smi=smi,
         worker_spawn_ms={b: [ms for _, ms in v] for b, v in spawned.items()},
         reload_worker_spawn_ms=[ms for _, ms in respawned.get("", [])],
         first_health_s=health_s, maps=maps,
         scrape_ms_median=statistics.median(scrape_ms), scrape_ms_max=max(scrape_ms),
         launches_per_worker=totals, launches_before_reload=before_reload,
         rename_to_labels_s=reload_labels_s, rename_to_health_s=reload_health_s,
         faulted_cpu_inits=inits, faulted_recovery_after_gpu_health_s=recover_s)
    entries["hbm_stream_sum"]["config_registry_launches"] = launches
    return {"rename_to_labels_s": reload_labels_s}

SLICE_WORKERS = 3
SLICE_SLEEP_S = 0.5
SLICE_PEER_TIMEOUT_S = 2.0
# Worker 2 probes every 20 cycles: its chip.0.sick shot makes one sick
# probe, and the next one, some seconds later, recovers. Workers 0 and 1
# probe once (the first probe of the epoch). The leader is killed just
# after a probe of worker 2, so no burn-in rate moves in a file across
# the failover.
SLICE_SICK_BURNIN_INTERVAL = 20
SLICE_QUIET_BURNIN_INTERVAL = 100000
SLICE_PREFIX = "nvidia.com/gpu.slice."


def _node_local(labels: dict) -> dict:
    """A label set less the slice coordination family (lm/slice_labeler.py;
    the node fact slice.capable is not of it)."""
    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_COORD_LABELS,
        is_cohort_label,
    )

    return {k: v for k, v in labels.items()
            if k not in SLICE_COORD_LABELS and not is_cohort_label(k)}


def _histogram_median(samples: dict, name: str):
    """histogram_quantile(0.5, ...) over one unlabelled histogram: linear
    interpolation inside the bucket that holds the median."""
    buckets = sorted(
        (float(m.group(1)), v) for (n, lab), v in samples.items()
        if n == f"{name}_bucket" and (m := re.search(r'le="([^"]+)"', lab)))
    total = samples.get((f"{name}_count", ""), 0.0)
    if not total:
        return None
    rank, lower, below = total / 2, 0.0, 0.0
    for bound, count in buckets:
        if count >= rank:
            if math.isinf(bound):
                return lower
            return lower + (bound - lower) * (rank - below) / max(count - below, 1e-12)
        lower, below = bound, count
    return None


def _sick_pair(ls: list, want: str) -> bool:
    """Worker 2's chips.sick and the leader's slice.sick-chips both read
    ``want`` in one sample of the three label files."""
    return (ls[2].get("nvidia.com/gpu.chips.sick") == want
            and ls[0].get(SLICE_PREFIX + "sick-chips") == want)


def _timed_get(port: int, headers: dict, rounds: int = 5):
    """(status, ETag, body, median ms) of ``rounds`` GET /peer/snapshot."""
    ms, answer = [], None
    for _ in range(rounds):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            t = time.perf_counter()
            conn.request("GET", "/peer/snapshot", headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            ms.append((time.perf_counter() - t) * 1e3)
            answer = (resp.status, resp.getheader("ETag"), body)
        finally:
            conn.close()
    return answer + (statistics.median(ms),)


# The fleet phase: a region collector over the slice's three daemons and a
# root collector over it (--upstream-mode collectors), each in a fresh
# process at a fast cadence.
FLEET_SCRAPE_INTERVAL_S = 0.2
FLEET_PEER_TIMEOUT_S = 0.5
FLEET_SLICE = "slice-a"
FLEET_REGION = "region-a"
FLEET_VERDICT = ("healthy_hosts", "total_hosts", "degraded", "sick_chips")


class _FleetWatch:
    """The ``fleet`` phase's collectors (``python -m
    gpu_feature_discovery_tpu_torch fleet-collector``) over the slice
    phase's live daemons, and a sampler of the region collector's entry
    for the slice: (monotonic time, entry) at each change."""

    def __init__(self, tmp: str, ports: list, token: str):
        self.token = token
        self.region_port, self.root_port = _free_port(), _free_port()
        region_targets = os.path.join(tmp, "fleet-targets.yaml")
        root_targets = os.path.join(tmp, "fleet-root-targets.yaml")
        with open(region_targets, "w") as f:
            f.write("version: v1\nslices:\n  - name: %s\n    hosts: [%s]\n" % (
                FLEET_SLICE, ", ".join(f'"127.0.0.1:{p}"' for p in ports)))
        with open(root_targets, "w") as f:
            f.write('version: v1\nslices:\n  - name: %s\n    hosts: ["127.0.0.1:%d"]\n'
                    % (FLEET_REGION, self.region_port))
        env = dict(os.environ)
        env.pop("TFD_FAULT_SPEC", None)
        self.logs = {name: os.path.join(tmp, f"fleet-{name}.log") for name in ("region", "root")}
        self.procs = {}
        for name, targets, port, extra in (
                ("region", region_targets, self.region_port, []),
                ("root", root_targets, self.root_port, ["--upstream-mode", "collectors"])):
            with open(self.logs[name], "w") as log:
                self.procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "fleet-collector",
                     "--targets-file", targets, "--metrics-addr", "127.0.0.1",
                     "--metrics-port", str(port),
                     "--scrape-interval", f"{FLEET_SCRAPE_INTERVAL_S}s",
                     "--peer-timeout", f"{FLEET_PEER_TIMEOUT_S}s",
                     "--peer-token", token, *extra],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        self.timeline = []
        self._stop = threading.Event()
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()

    def get(self, port: int, path: str = "/fleet/snapshot", etag=None):
        """(status, ETag, body, ms) of one GET with the token."""
        headers = {"X-TFD-Probe-Token": self.token}
        if etag:
            headers["If-None-Match"] = etag
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            t = time.perf_counter()
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            return resp.status, resp.getheader("ETag"), body, (time.perf_counter() - t) * 1e3
        finally:
            conn.close()

    def entry(self, port=None, key=FLEET_SLICE):
        """The slice's entry on the region collector (or ``key`` on
        another), None before it serves."""
        try:
            status, _etag, body, _ms = self.get(port or self.region_port)
        except (OSError, http.client.HTTPException):
            return None
        return json.loads(body)["slices"].get(key) if status == 200 else None

    def _sample(self):
        last = None
        while not self._stop.is_set():
            entry = self.entry()
            if entry != last:
                self.timeline.append((time.monotonic(), entry))
                last = entry
            time.sleep(0.02)

    def first(self, cond, after: float = 0.0):
        """The time of the first sample after ``after`` whose entry meets
        ``cond``; None if none has."""
        return next((t for t, e in list(self.timeline) if t > after and e and cond(e)), None)

    def wait(self, cond, timeout: float, what: str, after: float = 0.0) -> float:
        return _wait_for(lambda: self.first(cond, after), timeout, what)

    def stop(self) -> list:
        """SIGTERM both collectors: their exit codes."""
        self._stop.set()
        self._sampler.join(timeout=5)
        rcs = []
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in self.procs.values():
            try:
                rcs.append(proc.wait(timeout=15))
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        return rcs


def _verdict(entry: dict) -> dict:
    return {k: entry.get(k) for k in FLEET_VERDICT}


def phase_slice(entries: dict, smi: str) -> dict:
    """Three CLI daemons on the one card form one slice over 127.0.0.1:
    each at its defaults through its own broker worker (``--backends gpu
    --with-burnin``), peers from ``WORKER_HOSTNAMES``/``WORKER_ID``,
    ``--slice-coordination auto`` and a ``--peer-token`` (so push-notify
    resolves on). Worker 2 runs under ``chip.0.sick:fail:1``: the leader's
    ``slice.sick-chips`` follows the card's verdict from 1 back to 0. Then
    the leader is SIGTERMed and worker 1 takes over.

    The ``fleet`` phase rides it, adding no gpu worker: a region collector
    over the three daemons and a root collector over the region, started
    with the daemons; their entries are checked against the leader's
    ``/peer/snapshot`` through the sick window, the failover and the
    shutdown of every daemon."""
    check(PER_DEVICE_LABELS, "the slice phase reads each daemon's per-device "
          "verdict (chips.sick), which a node whose CUDA lists a subset of "
          "NVML's GPUs does not publish")
    from gpu_feature_discovery_tpu_torch.ops import kernel_cache
    from gpu_feature_discovery_tpu_torch.peering.coordinator import CONFIRM_POLLS
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    ports = [_free_port() for _ in range(SLICE_WORKERS)]
    hostnames = ",".join(f"127.0.0.1:{p}" for p in ports)
    token = secrets.token_hex(16)
    procs, pids = [], {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # One fresh kernel cache for the three: their workers' first use
        # builds the same libraries at once (a per-pid temp file, then an
        # atomic rename), and the cache ends with one of each.
        cache = os.path.join(tmp, "kernel-cache")
        outs = [os.path.join(tmp, f"w{i}.tfd") for i in range(SLICE_WORKERS)]
        logs = [os.path.join(tmp, f"w{i}.log") for i in range(SLICE_WORKERS)]
        used_before = _device_used_mib()
        t0 = time.monotonic()
        for i in range(SLICE_WORKERS):
            env = dict(os.environ, WORKER_HOSTNAMES=hostnames, WORKER_ID=str(i))
            env.pop("TFD_FAULT_SPEC", None)
            env.pop("TFD_BACKEND", None)
            if i == 2:
                env["TFD_FAULT_SPEC"] = "chip.0.sick:fail:1"
            interval = SLICE_SICK_BURNIN_INTERVAL if i == 2 else SLICE_QUIET_BURNIN_INTERVAL
            with open(logs[i], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--debug",
                     "--backends", "gpu", "--with-burnin",
                     "--sleep-interval", f"{SLICE_SLEEP_S}s",
                     "--burnin-interval", str(interval),
                     "--output-file", outs[i], "--state-dir", os.path.join(tmp, f"state{i}"),
                     "--compilation-cache-dir", cache,
                     "--metrics-addr", "127.0.0.1", "--metrics-port", str(ports[i]),
                     "--slice-coordination", "auto", "--peer-token", token,
                     "--peer-timeout", f"{SLICE_PEER_TIMEOUT_S}s"],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        # The sick window is a few seconds: a sampler records every file
        # change from the start.
        timeline, stop_sampling = [], threading.Event()

        def sample():
            last = None
            while not stop_sampling.is_set():
                now = tuple(tuple(sorted(_read_labels(o).items())) for o in outs)
                if now != last:
                    timeline.append((time.monotonic(), [dict(x) for x in now]))
                    last = now
                time.sleep(0.01)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        fleet = _FleetWatch(tmp, ports, token)
        try:
            def converged():
                ls = [_read_labels(o) for o in outs]
                w0 = ls[0]
                ok = (w0.get(SLICE_PREFIX + "role") == "leader"
                      and w0.get(SLICE_PREFIX + "total-hosts") == "3"
                      and w0.get(SLICE_PREFIX + "healthy-hosts") == "3"
                      and w0.get(SLICE_PREFIX + "degraded") == "false"
                      and all(l.get(SLICE_PREFIX + "role") == "follower"
                              and l.get(SLICE_PREFIX + "leader-seen") == "true"
                              for l in ls[1:]))
                return ls if ok else None

            for i, p in enumerate(procs):
                check(p.poll() is None, f"slice worker {i} exited early")
            first = _wait_for(converged, 180.0, "the three daemons forming one slice")
            first_slice_s = time.monotonic() - t0
            check(first[0][SLICE_PREFIX + "leader"] == "127.0.0.1",
                  f"slice.leader {first[0].get(SLICE_PREFIX + 'leader')}")

            # Worker 2's card verdict, carried across the wire: its chips.sick
            # 1 with the leader's sick-chips 1, then both 0.
            _wait_for(lambda: any(_sick_pair(ls, "1") for _, ls in list(timeline)), 120.0,
                      "the leader's sick-chips 1 while worker 2's chips.sick is 1")
            t_sick = next(t for t, ls in timeline if _sick_pair(ls, "1"))
            _wait_for(lambda: any(t > t_sick and _sick_pair(ls, "0")
                                  for t, ls in list(timeline)),
                      120.0, "the leader's sick-chips back to 0 after worker 2's next probe")
            # The collector's entry followed the same verdict: sick 1 on
            # the whole slice, then 0.
            t_fleet_sick = fleet.wait(lambda e: e["sick_chips"] == 1 and e["reachable"],
                                      30.0, "the collector's sick_chips 1")
            fleet.wait(lambda e: e["sick_chips"] == 0 and e["healthy_hosts"] == 3,
                       30.0, "the collector's sick_chips back to 0", after=t_fleet_sick)
            all_health = _wait_for(
                lambda: (lambda ls: ls if all(_has_health(l) for l in ls) else None)(
                    [_read_labels(o) for o in outs]), 60.0, "health labels on all three")
            rates = [{k.rsplit(".", 1)[1]: l.get(k) for k in HEALTH_KEYS} for l in all_health]
            for i, l in enumerate(all_health):
                check(l.get("nvidia.com/gpu.chips.sick") == "0", f"worker {i} still sick")

            # Each daemon's broker worker: one spawn, CUDA and NVML mapped
            # there, neither in the labeling process.
            spawned = [_spawned(log) for log in logs]
            for i, sp in enumerate(spawned):
                check(list(sp) == [""] and len(sp[""]) == 1, f"worker {i} spawns {sp}")
                pids[i] = sp[""][0][0]
                check(_children(procs[i].pid) == [pids[i]],
                      f"daemon {i} children {_children(procs[i].pid)}")
            maps = {f"cli{i}": {lib: _maps_libcuda(procs[i].pid, lib)
                                for lib in ("libcuda.so", "libnvidia-ml.so")}
                    for i in range(SLICE_WORKERS)}
            maps.update({f"worker{i}": {lib: _maps_libcuda(pids[i], lib)
                                        for lib in ("libcuda.so", "libnvidia-ml.so")}
                         for i in range(SLICE_WORKERS)})
            check(all(not any(maps[f"cli{i}"].values()) and all(maps[f"worker{i}"].values())
                      for i in range(SLICE_WORKERS)), f"CUDA and NVML mappings: {maps}")
            used_mib = _device_used_mib() - used_before
            libs = sorted(os.listdir(cache))
            check(libs == sorted(kernel_cache.library_path(src).name
                                 for src in kernel_cache.KERNEL_SOURCES),
                  f"the shared kernel cache holds {libs}")

            fleet_checks = _fleet_steady(fleet, ports)

            # By hand on worker 1: the token gate, the ETag, the 304.
            missing = _timed_get(ports[1], {}, rounds=1)
            wrong = _timed_get(ports[1], {"X-TFD-Probe-Token": "not-" + token}, rounds=1)
            check((missing[0], wrong[0]) == (403, 401),
                  f"/peer/snapshot without the token {missing[0]}, wrong token {wrong[0]}")
            ok = _timed_get(ports[1], {"X-TFD-Probe-Token": token})
            check(ok[0] == 200 and ok[1] and ok[1].startswith('"') and ok[1].endswith('"')
                  and json.loads(ok[2])["worker_id"] == 1, f"/peer/snapshot answered {ok[:2]}")
            nm = _timed_get(ports[1], {"X-TFD-Probe-Token": token, "If-None-Match": ok[1]})
            check(nm[:3] == (304, ok[1], b""), f"If-None-Match answered {nm[:3]}")

            # The leader after a few steady rounds: 304s, reused connections,
            # and the notification worker 2's delta sent.
            time.sleep(4 * SLICE_SLEEP_S)
            leader = _scrape(ports[0])
            sender = _scrape(ports[2])
            steady = {
                "not_modified": leader.get(("tfd_peer_snapshot_not_modified_total", ""), 0),
                "reuses": leader.get(("tfd_peer_connection_reuses_total", ""), 0),
                "notify_received_ok": leader.get(
                    ("tfd_notify_received_total", '{outcome="ok"}'), 0),
                "notify_sent_ok": sender.get(("tfd_notify_sent_total", '{outcome="ok"}'), 0),
            }
            check(all(v > 0 for v in steady.values()), f"the leader's steady state {steady}")
            poll_median_s = _histogram_median(leader, "tfd_peer_poll_duration_seconds")
            poll_mean_s = (leader[("tfd_peer_poll_duration_seconds_sum", "")]
                           / leader[("tfd_peer_poll_duration_seconds_count", "")])

            # Failover: SIGTERM the leader; worker 1 takes over. Killed one
            # cycle after a probe report of worker 2 (the only one still
            # probing), so no burn-in lands in the window.
            n_reports = len(_probe_reports(logs[2]))
            _wait_for(lambda: len(_probe_reports(logs[2])) > n_reports, 60.0,
                      "a probe of worker 2 before the failover")
            time.sleep(2 * SLICE_SLEEP_S)
            before = [_node_local(_read_labels(o)) for o in outs[1:]]
            reports_before = [len(_probe_reports(log)) for log in logs[1:]]
            t_term = time.monotonic()
            procs[0].send_signal(signal.SIGTERM)

            def promoted():
                l = _read_labels(outs[1])
                return l if (l.get(SLICE_PREFIX + "role") == "leader"
                             and l.get(SLICE_PREFIX + "total-hosts") == "3"
                             and l.get(SLICE_PREFIX + "healthy-hosts") == "2"
                             and l.get(SLICE_PREFIX + "degraded") == "true") else None

            bound = (broker.GRACEFUL_CLOSE_S + CONFIRM_POLLS * SLICE_SLEEP_S
                     + SLICE_PEER_TIMEOUT_S + 5.0)
            promoted_labels = _wait_for(promoted, bound,
                                        "worker 1 leading the slice after the SIGTERM")
            failover_s = time.monotonic() - t_term
            # The collector's chain walk passes the dead leader and finds
            # worker 1's verdict: the slice stays live with one host fewer.
            t_fleet_leader = fleet.wait(
                lambda e: (e["reachable"] and not e["stale"] and e["healthy_hosts"] == 2
                           and e["total_hosts"] == 3 and e["degraded"] is True),
                bound, "the collector following worker 1's verdict", after=t_term)
            fleet_failover_s = t_fleet_leader - t_term
            section = json.loads(fleet.get(ports[1], "/peer/snapshot")[2])["slice"]
            check(_verdict(fleet.entry()) == _verdict(section),
                  f"collector {fleet.entry()} against worker 1's section {section}")
            check(promoted_labels.get(SLICE_PREFIX + "sick-chips") == "0",
                  f"sick-chips after the failover {promoted_labels}")
            rc0 = procs[0].wait(timeout=30)
            check(rc0 == 0, f"the leader exited {rc0}")
            after = [_node_local(_read_labels(o)) for o in outs[1:]]
            check([len(_probe_reports(log)) for log in logs[1:]] == reports_before,
                  "a burn-in probe landed in the failover window")
            check(after == before, "node-local labels moved across the failover: "
                  f"{[{k: (b.get(k), a.get(k)) for k in set(a) | set(b) if a.get(k) != b.get(k)} for a, b in zip(after, before)]}")
            w1 = _scrape(ports[1])
            degraded = {
                "slice_degraded": w1.get(("tfd_slice_degraded", "")),
                "unreachable": w1.get(("tfd_peer_unreachable",
                                       f'{{peer="127.0.0.1:{ports[0]}"}}')),
            }
            check(degraded == {"slice_degraded": 1.0, "unreachable": 1.0},
                  f"worker 1's series after the failover {degraded}")
            check(_gone(pids[0]), "the leader's broker worker outlived it")
            t_stop = time.monotonic()
            rcs = _stop_daemons(procs)
            t_all_down = time.monotonic()
            # Every daemon is gone: after two missed rounds the slice is
            # stale, its last verdict kept, on the region and the root. A
            # daemon closes its server before its process exits, so the
            # flip may come before the last exit.
            t_stale = fleet.wait(lambda e: e["stale"] and not e["reachable"], 30.0,
                                 "the collector's entry going stale", after=t_stop)
            fleet_stale_s = {"from_sigterm": t_stale - t_stop,
                             "from_last_exit": t_stale - t_all_down}
            dark = fleet.entry()
            check(dark["healthy_hosts"] == 2 and dark["last_seen_unix"] is not None,
                  f"the stale entry lost its last verdict: {dark}")
            root_key = f"region/{FLEET_REGION}/{FLEET_SLICE}"
            _wait_for(lambda: (fleet.entry(fleet.root_port, root_key) or {}).get("stale"),
                      30.0, "the root's entry going stale")
            fleet_rcs = fleet.stop()
            check(fleet_rcs == [0, 0], f"fleet collectors exited {fleet_rcs}")
            check(all(_gone(p.pid) for p in fleet.procs.values()),
                  "a fleet collector outlived its SIGTERM")
        finally:
            stop_sampling.set()
            sampler.join(timeout=5)
            fleet.stop()
            t_stop = time.monotonic()
            rcs = _stop_daemons(procs)
            _wait_for(lambda: all(_gone(pid) for pid in pids.values()),
                      max(0.0, t_stop + broker.GRACEFUL_CLOSE_S * SLICE_WORKERS + 2.0
                          - time.monotonic()), f"no broker worker of {pids} alive")
        check(rcs == [0] * SLICE_WORKERS, f"slice daemons exited {rcs}")
        totals = [_per_worker_totals(_probe_reports(log)) for log in logs]
        check(all(len(t) == 1 for t in totals), f"workers per daemon {totals}")
        from gpu_feature_discovery_tpu_torch.ops import healthcheck

        iters = healthcheck.PROBE_HBM_ITERS
        check(all((t[0] - 1) % iters == 0 and t[0] >= 1 + iters for t in totals),
              f"hbm_stream_sum launches per worker {totals}, want 1 + 3k")
    emit("fleet", nvidia_smi=smi, **fleet_checks,
         sigterm_to_new_leader_in_fleet_s=fleet_failover_s,
         last_daemons_down_to_stale_s=fleet_stale_s, stale_entry=dark,
         collector_rcs=fleet_rcs)
    emit("slice", nvidia_smi=smi, first_slice_labels_s=first_slice_s,
         sigterm_to_new_leader_s=failover_s, failover_bound_s=bound,
         peer_poll_median_s=poll_median_s, peer_poll_mean_s=poll_mean_s,
         snapshot_get_ms={"200": ok[3], "304": nm[3]},
         worker_spawn_ms=[sp[""][0][1] for sp in spawned],
         device_used_mib_three_workers=used_mib, steady=steady, rates=rates,
         launches_per_worker=[t[0] for t in totals], maps=maps)
    entries["hbm_stream_sum"]["slice_launches"] = sum(t[0] for t in totals)
    return {"failover_s": failover_s}



def _stop_daemons(procs: list) -> list:
    """SIGTERM every daemon still running: their exit codes."""
    rcs = []
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            rcs.append(p.wait(timeout=30))
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def _fleet_steady(fleet: _FleetWatch, ports: list) -> dict:
    """The collectors against the healthy slice: the region's entry is the
    leader's published verdict, the root serves it under
    region/<name>/<slice>, a re-GET with If-None-Match is a 304, the
    tfd_fleet_* series are live, and neither collector maps CUDA or NVML."""
    section = json.loads(fleet.get(ports[0], "/peer/snapshot")[2])["slice"]
    entry = _wait_for(lambda: (lambda e: e if e and _verdict(e) == _verdict(section)
                               else None)(fleet.entry()),
                      30.0, f"the collector's entry equal to the leader's section {section}")
    check(entry["reachable"] and not entry["stale"] and entry["healthy_hosts"] == 3
          and entry["degraded"] is False and entry["sick_chips"] == 0,
          f"the healthy slice's entry {entry}")
    root_key = f"region/{FLEET_REGION}/{FLEET_SLICE}"
    root_entry = _wait_for(lambda: (lambda e: e if e and e.get("generation") == entry[
        "generation"] else None)(fleet.entry(fleet.root_port, root_key)),
        30.0, f"the root serving {root_key}")
    check({k: v for k, v in root_entry.items() if k != "region"} == entry
          and root_entry["region"] == FLEET_REGION,
          f"the root's {root_key} {root_entry} against the region's {entry}")
    status, etag, body, _ms = fleet.get(fleet.region_port)
    check(status == 200 and etag and etag.startswith('"'), f"/fleet/snapshot {status} {etag}")
    not_modified = []
    for _ in range(5):
        got = fleet.get(fleet.region_port, etag=etag)
        check(got[:3] == (304, etag, b""), f"If-None-Match answered {got[:3]}")
        not_modified.append(got[3])
    anonymous = _http(fleet.region_port, "GET", "/fleet/snapshot")[0]
    check(anonymous == 403, f"/fleet/snapshot without the token answered {anonymous}")
    region, root = _scrape(fleet.region_port), _scrape(fleet.root_port)
    series = {
        "slices": region.get(("tfd_fleet_slices", "")),
        "slices_stale": region.get(("tfd_fleet_slices_stale", "")),
        "scrape_rounds": region.get(("tfd_fleet_scrape_rounds_total", "")),
        "polls_ok": region.get(("tfd_fleet_polls_total", '{outcome="ok"}')),
        "upstream_304": region.get(("tfd_fleet_snapshot_not_modified_total", "")),
        "served_304": region.get(("tfd_fleet_inventory_not_modified_total", "")),
        "root_regions": root.get(("tfd_fleet_regions", "")),
        "root_slices": root.get(("tfd_fleet_slices", "")),
    }
    check(series["slices"] == 1 and series["slices_stale"] == 0
          and series["scrape_rounds"] > 0 and series["polls_ok"] > 0
          and series["upstream_304"] > 0 and series["served_304"] >= 5
          and series["root_regions"] == 1 and series["root_slices"] == 1,
          f"the collectors' tfd_fleet_* series {series}")
    round_median_s = _histogram_median(region, "tfd_fleet_scrape_round_duration_seconds")
    pids = {name: p.pid for name, p in fleet.procs.items()}
    maps = {name: {lib: _maps_libcuda(pid, lib) for lib in ("libcuda.so", "libnvidia-ml.so")}
            for name, pid in pids.items()}
    check(not any(v for m in maps.values() for v in m.values()),
          f"a collector maps CUDA or NVML: {maps}")
    return {
        "scrape_round_median_ms": round_median_s * 1e3,
        "not_modified_get_ms": statistics.median(not_modified),
        "body_bytes": len(body), "series": series,
        "maps": maps, "memory": _host_memory(pids),
    }


ACT_WORKERS = 3
ACT_SLEEP_S = 0.5
ACT_WINDOW = 2
ACT_FRACTION = 0.25
# Workers 1 and 2 start with a sick device: worker 1 probes once (its
# first probe, sick until it is killed); worker 2 probes every
# ACT_SICK_BURNIN_INTERVAL cycles, each probe taking one of its
# ACT_SICK_SHOTS sick shots, so its verdict holds through the kill and
# the restart (some 20 s) and then heals. Worker 0 probes once, healthy.
ACT_SICK_SHOTS = 10
ACT_SICK_BURNIN_INTERVAL = 10
ACT_QUIET_BURNIN_INTERVAL = 100000
GPU_NS = "nvidia.com/gpu."
# Labels a probe measures anew each time, and probe-ms, which only a
# probing cycle carries: the cycle of an advice change may be the one
# right after a probe, or a probe itself.
_RATE_KEY = re.compile(r"(tflops|gbps|probe-ms)$")


def _advice_of(labels: dict) -> dict:
    from gpu_feature_discovery_tpu_torch.actuation.engine import ADVICE_LABELS

    return {k: v for k, v in labels.items() if k in ADVICE_LABELS}


def _without_advice(labels: dict) -> dict:
    """Node-local labels less the advice family, the restored marker and
    what each probe measures anew."""
    from gpu_feature_discovery_tpu_torch.actuation.engine import ADVICE_LABELS
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import RESTORED_LABEL

    return {k: v for k, v in _node_local(labels).items()
            if k not in ADVICE_LABELS and k != RESTORED_LABEL and not _RATE_KEY.search(k)}


def _counter(samples: dict, action: str) -> float:
    return samples.get(("tfd_actuation_transitions_total", f'{{action="{action}"}}'), 0.0)


def _actuation_series(port: int) -> dict:
    s = _scrape(port)
    return {
        "advice": s.get(("tfd_actuation_advice", "")),
        "budget_exhausted": s.get(("tfd_actuation_budget_exhausted", "")),
        "convergence_cycles": s.get(("tfd_actuation_convergence_cycles", "")),
        **{a: _counter(s, a) for a in ("fired", "cleared", "budget-suppressed",
                                       "lease-lapsed")},
    }


def _version_check() -> dict:
    """``--version``: exit 0, the port's string, and no torch imported."""
    from gpu_feature_discovery_tpu_torch.info.version import get_version_string

    plain = subprocess.run([sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
                            "--version"], cwd=REPO, capture_output=True, text=True,
                           timeout=60)
    check(plain.returncode == 0 and plain.stdout.strip() == get_version_string(),
          f"--version answered {plain.returncode} {plain.stdout!r} {plain.stderr[-500:]!r}")
    probe = subprocess.run([sys.executable, "-c", (
        "import runpy, sys\n"
        "sys.argv = ['gpu_feature_discovery_tpu_torch', '--version']\n"
        "try:\n"
        "    runpy.run_module('gpu_feature_discovery_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code, 'torch' in sys.modules)\n")],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    check(probe.stdout.split()[-3:] == ["exit", "0", "False"],
          f"--version imported torch or failed: {probe.stdout!r} {probe.stderr[-500:]!r}")
    return {"version": plain.stdout.strip()}


def phase_actuation(entries: dict, smi: str) -> dict:
    """Three CLI daemons as one slice, each through its own broker worker
    with ``--actuation enforce --actuation-window 2
    --max-actuated-fraction 0.25``: an allowance of 1 host of 3. Workers 1
    and 2 hold a sick device (``chip.0.sick``). Worker 2 starts once
    worker 1 advises, so its verdict meets worker 1's on the wire before
    its own window holds. Worker 1 advises; worker 2 is held back by the
    budget; no peer snapshot carries advice; worker 1's SIGKILL re-ranks
    worker 2 into the budget; worker 1, restarted on its state after its
    lease lapsed, restores no advice; worker 2's advice clears once its
    device heals."""
    from gpu_feature_discovery_tpu_torch.lm.health import CHIPS_SICK
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    check(PER_DEVICE_LABELS, "the actuation phase reads each daemon's per-device "
          "verdict (chips.sick), which a node whose CUDA lists a subset of "
          "NVML's GPUs does not publish")
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    out = _version_check()
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    ports = [_free_port() for _ in range(ACT_WORKERS)]
    hostnames = ",".join(f"127.0.0.1:{p}" for p in ports)
    token = secrets.token_hex(16)
    sick_spec = f"chip.0.sick:fail:{ACT_SICK_SHOTS}"
    SCHED = GPU_NS + "schedulable"
    CORDON = GPU_NS + "tfd.cordon-advice"
    LEASE = GPU_NS + "tfd.actuation-lease"
    RESTORED = GPU_NS + "tfd.restored"
    procs, logs, cli_pids, worker_pids = {}, {}, [], []
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cache = os.path.join(tmp, "kernel-cache")
        outs = [os.path.join(tmp, f"w{i}.tfd") for i in range(ACT_WORKERS)]

        def start(i: int, fault: str, name: str):
            env = dict(os.environ, WORKER_HOSTNAMES=hostnames, WORKER_ID=str(i))
            env.pop("TFD_FAULT_SPEC", None)
            env.pop("TFD_BACKEND", None)
            if fault:
                env["TFD_FAULT_SPEC"] = fault
            interval = (ACT_SICK_BURNIN_INTERVAL if i == 2 and fault
                        else ACT_QUIET_BURNIN_INTERVAL)
            logs[name] = os.path.join(tmp, f"{name}.log")
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--debug",
                     "--backends", "gpu", "--with-burnin",
                     "--sleep-interval", f"{ACT_SLEEP_S}s",
                     "--burnin-interval", str(interval),
                     "--output-file", outs[i],
                     "--state-dir", os.path.join(tmp, f"state{i}"),
                     "--compilation-cache-dir", cache,
                     "--metrics-addr", "127.0.0.1", "--metrics-port", str(ports[i]),
                     "--peer-token", token,
                     "--actuation", "enforce", "--actuation-window", str(ACT_WINDOW),
                     "--max-actuated-fraction", str(ACT_FRACTION)],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
            cli_pids.append(procs[name].pid)
            return procs[name]

        timeline, stop_sampling = [], threading.Event()

        def sample():
            last = None
            while not stop_sampling.is_set():
                now = tuple(tuple(sorted(_read_labels(o).items())) for o in outs)
                if now != last:
                    timeline.append((time.monotonic(), [dict(x) for x in now]))
                    last = now
                time.sleep(0.01)

        def alive(name):
            return procs[name].poll() is None

        def live_advised(ls, live):
            return [i for i in range(ACT_WORKERS) if live[i] and _advice_of(ls[i])]

        def first_t(i, cond, after=0.0):
            return next((t for t, ls in list(timeline) if t > after and cond(ls[i])), None)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        used_before = _device_used_mib()
        t0 = time.monotonic()
        try:
            start(0, "", "w0")
            start(1, sick_spec, "w1")
            # (b) Worker 1 advises, exactly ACT_WINDOW full cycles after its
            # first chips.sick=1.
            w1 = _wait_for(lambda: (lambda l: l if l.get(SCHED) == "false" else None)(
                _read_labels(outs[1])), 180.0, "worker 1's cordon advice")
            first_advice_s = time.monotonic() - t0
            check(w1.get(CORDON) == "sick-chips" and int(w1[LEASE]) > time.time(),
                  f"worker 1's advice {_advice_of(w1)}")
            t_sick1 = _wait_for(lambda: first_t(1, lambda l: l.get(CHIPS_SICK) == "1"), 5.0,
                                "worker 1's first sick write in the timeline")
            check(not _advice_of(
                next(ls for t, ls in timeline if t == t_sick1)[1]),
                "worker 1's first sick write already carried advice")
            s1 = _actuation_series(ports[1])
            check((s1["convergence_cycles"], s1["advice"], s1["fired"])
                  == (ACT_WINDOW, 1.0, 1.0), f"worker 1's series {s1}")
            with open(logs["w1"]) as f:
                check(f"after {ACT_WINDOW} confirming cycles" in f.read(),
                      "worker 1's log does not name its confirming cycles")

            # (c) Worker 2 holds a sick verdict too; the budget holds it back.
            start(2, sick_spec, "w2")
            _wait_for(lambda: _read_labels(outs[2]).get(CHIPS_SICK) == "1", 180.0,
                      "worker 2's sick verdict")
            s2 = _wait_for(lambda: (lambda s: s if s["budget-suppressed"] == 1 else None)(
                _actuation_series(ports[2])), 30.0, "worker 2 held back by the budget")
            ls = [_read_labels(o) for o in outs]
            check(not _advice_of(ls[2]) and not _advice_of(ls[0]) and _advice_of(ls[1]),
                  f"advice with worker 2 held back: {[_advice_of(l) for l in ls]}")
            check((s2["budget_exhausted"], s2["fired"], s2["advice"]) == (1.0, 0.0, 0.0),
                  f"worker 2's series {s2}")
            check(_actuation_series(ports[0])["fired"] == 0, "worker 0 advised")
            used_mib = _device_used_mib() - used_before

            # (d) The wire carries the verdicts and never the advice.
            docs = []
            for i in range(ACT_WORKERS):
                code, _, body, _ = _timed_get(ports[i], {"X-TFD-Probe-Token": token},
                                              rounds=1)
                check(code == 200, f"worker {i}'s /peer/snapshot answered {code}")
                docs.append(json.loads(body))
            check(not any(_advice_of(d["labels"]) for d in docs),
                  "advice on a peer snapshot")
            check([d["chips"]["sick"] for d in docs[1:]] == [1, 1]
                  and all(d["labels"].get(CHIPS_SICK) == "1" for d in docs[1:]),
                  f"sick verdicts on the wire {[d['chips'] for d in docs]}")

            # (e) SIGKILL worker 1: its broker worker goes with it, and
            # worker 2 re-ranks into the budget.
            spawned = {n: _spawned(logs[n]) for n in ("w0", "w1", "w2")}
            for n, sp in spawned.items():
                check(list(sp) == [""] and len(sp[""]) == 1, f"{n} spawns {sp}")
            worker_pids.extend(sp[""][0][0] for sp in spawned.values())
            maps = {n: _maps_libcuda(procs[n].pid) for n in ("w0", "w1", "w2")}
            lease1 = int(_read_labels(outs[1])[LEASE])
            t_kill = time.monotonic()
            procs["w1"].kill()
            procs["w1"].wait(timeout=30)
            w1_worker = spawned["w1"][""][0][0]
            _wait_for(lambda: _gone(w1_worker), 10.0, "worker 1's broker worker gone")
            w1_worker_gone_s = time.monotonic() - t_kill
            _wait_for(lambda: _read_labels(outs[2]).get(SCHED) == "false", 30.0,
                      "worker 2's advice after worker 1's SIGKILL")
            kill_to_rerank_s = time.monotonic() - t_kill
            lease_overlap_s = lease1 - time.time()
            s2 = _actuation_series(ports[2])
            check((s2["fired"], s2["budget_exhausted"], s2["advice"]) == (1.0, 0.0, 1.0),
                  f"worker 2's series after the re-rank {s2}")

            # (f) Worker 1 again on its state, once its lease has lapsed:
            # its first write is the restored inventory without advice.
            _wait_for(lambda: time.time() > lease1 + 0.5, 30.0, "worker 1's lease to lapse")
            before = _read_labels(outs[1])
            n_timeline = len(timeline)
            t_restart = time.monotonic()
            start(1, "", "w1b")
            restored = _wait_for(lambda: (lambda l: l if l.get(RESTORED) == "true" else None)(
                _read_labels(outs[1])), 60.0, "worker 1's restored write")
            restart_to_first_write_s = time.monotonic() - t_restart
            t_back = _wait_for(lambda: first_t(1, lambda l: l != before, after=t_restart),
                               5.0, "worker 1's first write in the timeline")
            check(not _advice_of(restored) and restored.get(CHIPS_SICK) == "1",
                  f"worker 1's restored write {restored}")
            check(_without_advice(restored) == _without_advice(before),
                  "the restore moved more than the advice")
            live = _wait_for(lambda: (lambda l: l if _has_health(l) and RESTORED not in l
                                      else None)(_read_labels(outs[1])), 120.0,
                             "worker 1's live health after the restart")
            check(live.get(CHIPS_SICK) == "0" and not _advice_of(live),
                  f"worker 1 after the restart {live}")
            s1 = _actuation_series(ports[1])
            check((s1["lease-lapsed"], s1["fired"]) == (1.0, 0.0),
                  f"worker 1's series after the restart {s1}")
            w2 = _wait_for(lambda: (lambda l: l if l.get(SCHED) == "false" else None)(
                _read_labels(outs[2])), 30.0, "worker 2's advice with worker 1 back")
            check(w2.get(CHIPS_SICK) == "1", "worker 2 healed before worker 1 came back")
            # The restored sick verdict is worker 1's honest last answer:
            # on the wire it outranks worker 2 until worker 1's first live
            # write, if worker 2 polled it in that window.
            w2_withdrawn = any(not _advice_of(ls[2]) for _, ls in timeline[n_timeline:])
            maps["w1b"] = _maps_libcuda(procs["w1b"].pid)
            spawned["w1b"] = _spawned(logs["w1b"])
            worker_pids.append(spawned["w1b"][""][0][0])

            # (g) Worker 2's shots run out: its advice clears after
            # ACT_WINDOW clean cycles.
            t_heal = _wait_for(lambda: first_t(2, lambda l: l.get(CHIPS_SICK) == "0",
                                               after=t_restart), 120.0,
                               "worker 2's device healed")
            # The sampler, not this thread, records when the file changed.
            t_clear = _wait_for(lambda: first_t(2, lambda l: not _advice_of(l), after=t_heal),
                                30.0, "worker 2's advice cleared")
            heal_to_clear_s = t_clear - t_heal
            check(_advice_of(next(ls for t, ls in timeline if t == t_heal)[2]) != {},
                  "worker 2's advice cleared on its first clean cycle")
            s2 = _actuation_series(ports[2])
            check((s2["cleared"], s2["advice"]) == (1.0, 0.0), f"worker 2's series {s2}")
            with open(logs["w2"]) as f:
                check(f"cleared after {ACT_WINDOW} clean cycles" in f.read(),
                      "worker 2's log does not name its clean cycles")
            s_end = [_actuation_series(p) for p in ports]
            check(all(l is False for l in maps.values()), f"a CLI maps libcuda.so: {maps}")
        finally:
            stop_sampling.set()
            sampler.join(timeout=5)
            t_stop = time.monotonic()
            for p in procs.values():
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            rcs = {}
            for n, p in procs.items():
                try:
                    rcs[n] = p.wait(timeout=30)
                finally:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            # (j) No broker worker alive 3 s after the SIGTERMs.
            _wait_for(lambda: all(_gone(pid) for pid in worker_pids),
                      max(0.0, t_stop + 3.0 - time.monotonic()),
                      f"no broker worker of {worker_pids} alive")
        check(rcs == {"w0": 0, "w1": -signal.SIGKILL, "w2": 0, "w1b": 0},
              f"actuation daemons exited {rcs}")
        # (h) Every advice change (keys added or dropped; a lease renewal,
        # or the reason the held advice names in its clear window, is
        # none) moved the advice family alone, and two live daemons never
        # advised at once.
        def verdict(l):
            return sorted(_advice_of(l))

        # Worker 1 is no live host from its SIGKILL to its restarted
        # process's first write (t_back): until then its file is the dead
        # process's last one, whose advice the SIGKILL froze under a lease
        # that has lapsed.
        moves, dead_file_samples, prev = 0, 0, None
        for t, ls in timeline:
            if prev is not None:
                for i in range(ACT_WORKERS):
                    if verdict(ls[i]) != verdict(prev[i]) and prev[i] and ls[i]:
                        moves += 1
                        a, b = _without_advice(prev[i]), _without_advice(ls[i])
                        check(a == b, f"worker {i}'s advice change at {t - t0:.2f}s moved "
                              f"{ {k: (a.get(k), b.get(k)) for k in set(a) | set(b) if a.get(k) != b.get(k)} }")
            live = [True, not (t_kill <= t < t_back), True]
            dead_file_samples += t_restart <= t < t_back
            advised = live_advised(ls, live)
            check(len(advised) <= 1,
                  f"live hosts {advised} advised at once at {t - t0:.2f}s (SIGKILL "
                  f"{t_kill - t0:.2f}s, restart {t_restart - t0:.2f}s, its first write "
                  f"{t_back - t0:.2f}s): {[_advice_of(ls[i]) for i in advised]}")
            prev = ls
        reasons = sorted({ls[2][CORDON] for _, ls in timeline if CORDON in ls[2]})
        w0_local = [_without_advice(ls[0]) for _, ls in timeline if _has_health(ls[0])]
        check(all(l == w0_local[0] for l in w0_local), "worker 0's node labels moved")
        # (i) 1 + 3k launches of hbm_stream_sum in each gpu worker.
        totals = {n: _per_worker_totals(_probe_reports(logs[n])) for n in logs}
        iters = healthcheck.PROBE_HBM_ITERS
        check(all(len(t) == 1 and (t[0] - 1) % iters == 0 and t[0] >= 1 + iters
                  for t in totals.values()),
              f"hbm_stream_sum launches per worker {totals}, want 1 + 3k")
    out.update(
        nvidia_smi=smi, first_advice_s=first_advice_s,
        convergence_cycles=ACT_WINDOW, kill_to_rerank_s=kill_to_rerank_s,
        killed_worker_gone_s=w1_worker_gone_s, dead_lease_left_s=lease_overlap_s,
        restart_to_first_write_s=restart_to_first_write_s,
        w2_withdrawn_while_w1_restored=w2_withdrawn, heal_to_clear_s=heal_to_clear_s,
        w2_cordon_reasons=reasons,
        advice_moves=moves, dead_file_samples_after_restart=dead_file_samples,
        series=s_end, device_used_mib_three_workers=used_mib,
        launches_per_worker={n: t[0] for n, t in totals.items()}, cli_maps_libcuda=maps,
        worker_spawn_ms={n: sp[""][0][1] for n, sp in spawned.items()})
    emit("actuation", **out)
    entries["hbm_stream_sum"]["actuation_launches"] = sum(t[0] for t in totals.values())
    return out


# The deployment layer (deployments/torch/): the image's runtime stage and
# the static manifests, run on this machine as a kubelet would run them.
DEPLOY_DIR = os.path.join(REPO, "deployments", "torch")
DEPLOY_DAEMONSET = os.path.join(DEPLOY_DIR, "static",
                                "gpu-feature-discovery-torch-daemonset.yaml")
DEPLOY_JOB = os.path.join(DEPLOY_DIR, "static",
                          "gpu-feature-discovery-torch-job.yaml.template")
DOCKERFILE = os.path.join(DEPLOY_DIR, "container", "Dockerfile")
# What the chart's withBurnin=true adds to the daemon's env
# (tests/test_torch_deployments.py renders the chart and pins it): the
# Job runs with it beside its template's own.
BURNIN_ENV = {"TFD_WITH_BURNIN": "true"}
# Kubernetes' defaults where a pod spec sets none.
DEFAULT_GRACE_S = 30
DEFAULT_PROBE_TIMEOUT_S = 1
PROBE_KINDS = ("startupProbe", "livenessProbe", "readinessProbe")
DEPLOY_HEALTH_WAIT_S = 180
JOB_TIMEOUT_S = 300

# Loaded at interpreter start-up through PYTHONPATH: at exit it records
# the process's hbm_stream_sum launches and the library it loaded (the
# broker worker leaves through os._exit and records nothing), then runs
# the interpreter's own sitecustomize, if any.
_LAUNCH_HOOK = '''\
import atexit, importlib.machinery, importlib.util, json, os, sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _record():
    hbm = sys.modules.get("gpu_feature_discovery_tpu_torch.ops.hbm")
    if hbm is None:
        return
    lib = getattr(hbm, "_lib", None)
    with open(os.path.join(OUT, "%d.json" % os.getpid()), "w") as f:
        json.dump({"launches": hbm.hbm_stream_sum.launches,
                   "library": getattr(lib, "_name", None)}, f)


atexit.register(_record)
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _HERE])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''


def dockerfile_stages(path: str = DOCKERFILE) -> list:
    """The Dockerfile's instructions, continuations joined and comments
    dropped, one list per ``FROM`` stage."""
    with open(path) as f:
        lines = [l for l in f.read().splitlines() if not l.lstrip().startswith("#")]
    text = re.sub(r"\s*\\\n\s*", " ", "\n".join(lines))
    stages: list = []
    for line in (l.strip() for l in text.splitlines()):
        if line.split(" ", 1)[0].upper() == "FROM":
            stages.append([])
        if line and stages:
            stages[-1].append(line)
    return stages


def image_env(path: str = DOCKERFILE) -> dict:
    """The runtime stage's ``ENV`` but PATH: what every container of the
    image starts with."""
    env = {}
    for instruction in dockerfile_stages(path)[-1]:
        word, _, rest = instruction.partition(" ")
        if word.upper() == "ENV":
            key, _, value = rest.partition("=")
            if key != "PATH":
                env[key] = value
    return env


def load_manifest(path: str, node_name: str = "") -> dict:
    """One manifest, read as the card reads YAML (config/yaml_subset.py),
    with ``NODE_NAME`` substituted where a name is given."""
    from gpu_feature_discovery_tpu_torch.config import yaml_subset

    with open(path) as f:
        text = f.read()
    if node_name:
        text = text.replace("NODE_NAME", node_name)
    return yaml_subset.safe_load(text)


def _mapper(mapping: dict):
    """A function that rewrites each container path of ``mapping`` (a
    whole path component sequence) inside a string to its directory here."""
    paths = sorted(mapping, key=len, reverse=True)
    pattern = re.compile(r"(?<![\w./-])(" + "|".join(map(re.escape, paths))
                         + r")(?=/|['\"\s]|$)")
    return lambda text: pattern.sub(lambda m: mapping[m.group(1)], text)


def _bindable(port: int) -> bool:
    s = socket.socket()
    try:
        s.bind(("", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def start_pod(manifest: dict, root: str, kernel_dir: str, *, extra_env=None) -> dict:
    """Start the manifest's container as a process, as the kubelet starts
    it in the image: its ``command`` and ``args``, the image's ``ENV``
    under the manifest's ``env``, and ``extra_env`` last. Each hostPath
    mount but ``/sys``, and the container's ``/tmp``, is a directory under
    ``root``; the image's kernel directory is ``kernel_dir``; a container
    port the host holds is moved to a free one. The package comes from
    this checkout (PYTHONPATH), beside the launch-recording hook. nvcc is
    unreachable: PATH keeps no directory holding one, CUDA_HOME names
    none. ``--output-file`` goes under the mapped features.d."""
    from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_OUTPUT_FILE

    spec = manifest["spec"]["template"]["spec"]
    (ctr,) = spec["containers"]
    image = image_env()
    host_volumes = {v["name"] for v in spec.get("volumes", []) if "hostPath" in v}
    mapping = {"/tmp": os.path.join(root, "tmp"),
               image["TFD_COMPILATION_CACHE_DIR"]: kernel_dir}
    for mount in ctr.get("volumeMounts", []):
        if mount["name"] in host_volumes and mount["mountPath"] != "/sys":
            mapping[mount["mountPath"]] = os.path.join(root, "mounts", mount["name"])
    mapped = _mapper(mapping)
    bin_dir, hook_dir, launches_dir, work = (
        os.path.join(root, d) for d in ("bin", "hook", "launches", "work"))
    for d in [bin_dir, hook_dir, launches_dir, work, os.path.join(root, "home"),
              *(v for k, v in mapping.items() if v != kernel_dir)]:
        os.makedirs(d, exist_ok=True)
    shim = os.path.join(bin_dir, "python3")  # the manifests' interpreter
    with open(shim, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(shim, 0o755)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(f"OUT = {launches_dir!r}\n" + _LAUNCH_HOOK)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TFD_") and k not in ("CUDA_HOME", "CUDA_PATH", "HOME")}
    path = [bin_dir] + [d for d in os.environ.get("PATH", "").split(os.pathsep)
                        if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env.update(PATH=os.pathsep.join(path), CUDA_HOME="/nonexistent",
               HOME=os.path.join(root, "home"),
               PYTHONPATH=os.pathsep.join(
                   p for p in (hook_dir, REPO, os.environ.get("PYTHONPATH")) if p))
    env.update({k: mapped(v) for k, v in image.items()})
    for var in ctr.get("env", []):
        check("value" in var, f"{var['name']}: only literal env values run here")
        env[var["name"]] = mapped(str(var["value"]))
    env.update(extra_env or {})
    ports = {p["containerPort"]: p["containerPort"] if _bindable(p["containerPort"])
             else _free_port() for p in ctr.get("ports", [])}
    if "TFD_METRICS_PORT" in env:
        env["TFD_METRICS_PORT"] = str(ports.get(int(env["TFD_METRICS_PORT"]),
                                                env["TFD_METRICS_PORT"]))
    out = mapped(DEFAULT_OUTPUT_FILE)
    argv = [*ctr["command"], *ctr.get("args", []), "--output-file", out]
    log_path = os.path.join(root, "container.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(argv, cwd=work, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    return {"proc": proc, "t0": time.monotonic(), "container": ctr, "env": env,
            "ports": ports, "mapped": mapped, "out": out, "log": log_path,
            "launches_dir": launches_dir, "work": work,
            "grace_s": spec.get("terminationGracePeriodSeconds", DEFAULT_GRACE_S)}


def run_probe(pod: dict, probe: dict) -> dict:
    """One probe as the kubelet runs it: an httpGet to the container's
    port (a name resolves through its ``ports``) passes on a status of
    200-399, an exec on exit 0; both within ``timeoutSeconds``."""
    timeout = probe.get("timeoutSeconds", DEFAULT_PROBE_TIMEOUT_S)
    t0 = time.perf_counter()
    if "httpGet" in probe:
        get = probe["httpGet"]
        port = get["port"]
        if isinstance(port, str):
            port = {p["name"]: p["containerPort"] for p in pod["container"]["ports"]}[port]
        conn = http.client.HTTPConnection("127.0.0.1", pod["ports"].get(port, port),
                                          timeout=timeout)
        try:
            conn.request("GET", get["path"])
            status = conn.getresponse().status
        finally:
            conn.close()
        result = {"httpGet": get["path"], "status": status, "ok": 200 <= status < 400}
    elif "exec" in probe:
        command = [pod["mapped"](a) for a in probe["exec"]["command"]]
        rc = subprocess.run(command, env=pod["env"], cwd=pod["work"],
                            timeout=timeout).returncode
        result = {"exec": command[0], "rc": rc, "ok": rc == 0}
    else:
        raise SystemExit(f"chip_smoke: unsupported probe {sorted(probe)}")
    result["ms"] = (time.perf_counter() - t0) * 1e3
    return result


def pod_launches(pod: dict) -> list:
    """The hook's records: one per process of the pod that imported the
    kernel's module and left through the interpreter's exit."""
    out = []
    for name in sorted(os.listdir(pod["launches_dir"])):
        with open(os.path.join(pod["launches_dir"], name)) as f:
            out.append(json.load(f))
    return out


def stop_pod(pod: dict) -> dict:
    """SIGTERM, as the kubelet sends it; the process must exit within the
    grace period. Returns the exit code and the seconds it took."""
    proc = pod["proc"]
    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=pod["grace_s"])
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit(f"chip_smoke: check failed: the pod outlived its "
                         f"{pod['grace_s']} s grace period after SIGTERM")
    return {"rc": rc, "exit_s": time.monotonic() - t0}


def tree_digest(path: str) -> dict:
    """{relative path: (mode, sha256 of a file's bytes)} of a directory,
    itself included."""
    out = {".": (stat.S_IMODE(os.lstat(path).st_mode), None)}
    for dirpath, dirnames, filenames in os.walk(path):
        for name in dirnames + filenames:
            full = os.path.join(dirpath, name)
            digest = None
            if name in filenames:
                with open(full, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
            out[os.path.relpath(full, path)] = (stat.S_IMODE(os.lstat(full).st_mode), digest)
    return out


def phase_deploy(entries: dict, smi: str) -> dict:
    """The deployment layer run as its files state: (a) the image's
    prebuild into a fresh directory, made read-only; (b) the static
    DaemonSet's container as a process with no nvcc reachable: its labels,
    its declared probes at their initial delays and again with the health
    labels in, ``tfd_compile_cache_enabled`` 1, its broker worker mapping
    the prebuilt library, and its exit within the grace period after
    SIGTERM; (c) the Job template with NODE_NAME
    substituted and the chart's burn-in env: exit 0, the health labels,
    ``hbm_stream_sum`` launched from the prebuilt library; the directory
    unchanged byte for byte throughout."""
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="deploy-", dir=build_dir)
    kernel_dir = os.path.join(root, "image-kernels")
    try:
        # (a) The Dockerfile's build step, with this machine's nvcc.
        t0 = time.perf_counter()
        built = subprocess.run(
            [sys.executable, "-m", "gpu_feature_discovery_tpu_torch.ops.kernel_cache",
             "--prebuild", kernel_dir], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        prebuild_s = time.perf_counter() - t0
        check(built.returncode == 0, f"prebuild exited {built.returncode}: {built.stderr[-2000:]}")
        libraries = dict(line.split() for line in built.stdout.splitlines())
        check(sorted(libraries) == sorted(os.listdir(kernel_dir)),
              f"prebuild printed {libraries}, built {os.listdir(kernel_dir)}")
        subprocess.run(["chmod", "-R", "a-w", kernel_dir], check=True)
        before = tree_digest(kernel_dir)

        # (b) The DaemonSet.
        ds = load_manifest(DEPLOY_DAEMONSET)
        pod = start_pod(ds, os.path.join(root, "daemonset"), kernel_dir)
        env = pod["env"]
        nvcc_on_path = shutil.which("nvcc", path=env["PATH"])
        no_nvcc = subprocess.run(
            ["python3", "-m", "gpu_feature_discovery_tpu_torch.ops.kernel_cache",
             "--prebuild", os.path.join(root, "nvcc-check")],
            env=env, cwd=pod["work"], capture_output=True, text=True, timeout=120)
        check(nvcc_on_path is None and no_nvcc.returncode != 0
              and "no nvcc" in no_nvcc.stderr,
              f"nvcc reachable in the pod: {nvcc_on_path} {no_nvcc.returncode} "
              f"{no_nvcc.stderr[-500:]!r}")
        try:
            first_write_s = _wait_for(
                lambda: os.path.exists(pod["out"]) and time.monotonic() - pod["t0"],
                DEPLOY_HEALTH_WAIT_S, "the DaemonSet's first write", poll=0.05)
            # Each declared probe at its initial delay, while the worker may
            # still warm up, and once more when the health labels are in.
            declared = sorted(((kind, pod["container"][kind]) for kind in PROBE_KINDS
                               if kind in pod["container"]),
                              key=lambda kp: kp[1].get("initialDelaySeconds", 0))
            check(declared, "the DaemonSet declares no probe")
            probes = {}
            for kind, probe in declared:
                time.sleep(max(0.0, pod["t0"] + probe.get("initialDelaySeconds", 0)
                               - time.monotonic()))
                probes[kind] = [{**run_probe(pod, probe), "at_s": time.monotonic() - pod["t0"]}]
            health_s = _wait_for(
                lambda: _has_health(_read_labels(pod["out"])) and time.monotonic() - pod["t0"],
                DEPLOY_HEALTH_WAIT_S, "the DaemonSet's health labels", poll=0.05)
            for kind, probe in declared:
                probes[kind].append({**run_probe(pod, probe),
                                     "at_s": time.monotonic() - pod["t0"]})
                check(all(r["ok"] for r in probes[kind]), f"{kind} failed: {probes[kind]}")
            workers = _children(pod["proc"].pid)
            worker_maps = {w: _maps_libcuda(w, kernel_dir + os.sep) for w in workers}
            check(any(worker_maps.values()),
                  f"no worker of {workers} maps a library from {kernel_dir}")
            samples = _scrape(int(env["TFD_METRICS_PORT"]))
            check(samples.get(("tfd_compile_cache_enabled", "")) == 1.0,
                  f"tfd_compile_cache_enabled {samples.get(('tfd_compile_cache_enabled', ''))}")
            stopped = stop_pod(pod)
        finally:
            if pod["proc"].poll() is None:
                pod["proc"].kill()
                pod["proc"].wait()
        with open(pod["log"]) as f:
            tail = f.read()[-3000:]
        check(stopped["rc"] == 0, f"the DaemonSet exited {stopped['rc']}; log tail:\n{tail}")
        _wait_for(lambda: all(_gone(w) for w in workers), broker.GRACEFUL_CLOSE_S + 1.0,
                  f"no broker worker of {workers} alive after the DaemonSet's exit")
        check(pod_launches(pod) == [], f"the DaemonSet's CLI launched {pod_launches(pod)}")

        # (c) The Job.
        node = socket.gethostname()
        job = load_manifest(DEPLOY_JOB, node_name=node)
        check(job["spec"]["template"]["spec"]["nodeName"] == node, "NODE_NAME not substituted")
        jpod = start_pod(job, os.path.join(root, "job"), kernel_dir, extra_env=BURNIN_ENV)
        try:
            rc = jpod["proc"].wait(timeout=JOB_TIMEOUT_S)
        finally:
            if jpod["proc"].poll() is None:
                jpod["proc"].kill()
                jpod["proc"].wait()
        job_s = time.monotonic() - jpod["t0"]
        with open(jpod["log"]) as f:
            tail = f.read()[-3000:]
        check(rc == 0, f"the Job exited {rc}; log tail:\n{tail}")
        job_labels = _read_labels(jpod["out"])
        check(job_labels.get("nvidia.com/gpu.health.ok") == "true" and _has_health(job_labels),
              f"the Job's labels carry no health: {job_labels}")
        records = pod_launches(jpod)
        job_launches = sum(r["launches"] for r in records)
        check(job_launches > 0 and all(
            r["library"] and os.path.dirname(r["library"]) == kernel_dir
            for r in records if r["launches"]),
            f"the Job's hbm_stream_sum launches {records}, want the library in {kernel_dir}")
        after = tree_digest(kernel_dir)
        check(after == before, f"the kernel directory changed: {before} -> {after}")
    finally:
        subprocess.run(["chmod", "-R", "u+w", root], check=False)
        shutil.rmtree(root, ignore_errors=True)
    out = {
        "nvidia_smi": smi,
        "prebuild_s": prebuild_s,
        "library_bytes": {name: int(size) for name, size in libraries.items()},
        "nvcc_reachable": False,
        "kernel_dir_unchanged": True,
        "daemonset": {"first_write_s": first_write_s, "health_labels_s": health_s,
                      "worker_maps_prebuilt": True, "probes": probes,
                      "compile_cache_enabled": 1, "sigterm_exit_s": stopped["exit_s"],
                      "grace_s": pod["grace_s"], "rc": stopped["rc"]},
        "job": {"wall_s": job_s, "rc": rc, "hbm_stream_sum_launches": job_launches,
                "health": {k: job_labels.get(k) for k in
                           ("nvidia.com/gpu.health.ok", *HEALTH_KEYS)}},
    }
    emit("deploy", **out)
    entries["hbm_stream_sum"]["deploy_launches"] = job_launches
    return out


# The H100 MIG profiles' SM counts (resource/testing.py H100_MIG_PROFILES):
# 1g.10gb and 1g.20gb, 2g.20gb, 3g.40gb, 4g.40gb, 7g.80gb.
MIG_GRID_SMS = (16, 32, 60, 64, 132)
MIG_CHILD_COUNTS = (1, 3, 7)
# The stand-in node on which the steady rounds, the fault shot, the kill,
# strategy none, the in-process path and the plain GPU beside MIG run.
MIG_FULL_N = 3
MIG_STEADY_ROUNDS = 3
# After a round the card's memory.used must be back at its baseline
# within this many MiB: the daemon holds nothing of a MIG device between
# rounds.
MIG_AFTER_ROUND_MIB = 16
# How often the card's memory.used is sampled during a round.
MEMORY_SAMPLE_MS = 50
STAND_IN_NOTE = ("stand-in: one H100 with MIG off, named by its own UUID as N "
                 "MIG devices; every pinned child sees the whole card's L2 and "
                 "HBM, so no number here is a MIG measurement")


class _CardMemory:
    """The card's memory.used (MiB), sampled every MEMORY_SAMPLE_MS by one
    ``nvidia-smi -lms`` process, with the host's monotonic clock."""

    def __init__(self):
        self.samples = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
             "-lms", str(MEMORY_SAMPLE_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self._proc.stdout:
            if line.strip().isdigit():
                self.samples.append((time.monotonic(), int(line)))

    def peak(self, t0: float, t1: float):
        inside = [v for t, v in self.samples if t0 <= t <= t1]
        return max(inside) if inside else None

    def stop(self):
        self._proc.terminate()
        self._proc.wait(timeout=10)
        self._reader.join(timeout=5)


class _ChildRss:
    """The summed VmRSS (KiB) of a MIG round's live children, sampled on a
    thread every MEMORY_SAMPLE_MS; its peak."""

    def __init__(self, pids):
        self._pids = pids
        self.peak_kib = 0
        self.peak_each_kib = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(MEMORY_SAMPLE_MS / 1e3):
            total = 0
            for pid in list(self._pids):
                try:
                    with open(f"/proc/{pid}/status") as f:
                        rss = next((int(l.split()[1]) for l in f if l.startswith("VmRSS:")), 0)
                except OSError:
                    continue
                total += rss
                self.peak_each_kib = max(self.peak_each_kib, rss)
            self.peak_kib = max(self.peak_kib, total)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _environ(pid: int) -> dict:
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)


def _worker_children() -> list:
    """This process's children that are probe or broker processes."""
    out = []
    for pid in _children(os.getpid()):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if b"sandbox.worker_main" in f.read() and not _gone(pid):
                    out.append(pid)
        except OSError:
            continue
    return out


def _mig_grids(entries: dict) -> dict:
    """hbm_stream_sum at the 256 MiB probe buffer on the persistent grid a
    MIG profile's SM count gives it: exact against the plain version at
    every grid, timed in turns (the whole card's HBM serves each)."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import hbm

    dev = torch.device("cuda", 0)
    rows = hbm.probe_rows(256)
    pattern = hbm.stream_pattern(rows, dev)
    plain = hbm.hbm_stream_sum_reference(pattern).item()
    before = hbm.hbm_stream_sum.launches
    out = {}
    for sms in MIG_GRID_SMS:
        got = hbm._launch(pattern, sms).item()
        check(got == plain == hbm.expected_stream_sum(rows),
              f"{sms}-SM grid: kernel {got}, plain {plain}")
        out[str(sms)] = {"blocks": hbm.grid_blocks(rows // hbm.TILE_ROWS, sms),
                         "max_abs_err": abs(got - plain)}
    check(hbm.hbm_stream_sum.launches - before == len(MIG_GRID_SMS),
          "one launch per grid")
    turns = in_turns({str(s): (lambda s=s: hbm._launch(pattern, s))
                      for s in MIG_GRID_SMS})
    nbytes = pattern.numel() * pattern.element_size() + 4
    for sms, row in out.items():
        row["ms"] = turns["median_ms"][sms]
        row["pct_of_bound"] = 100 * entries["hbm_stream_sum"]["bound_ms"] / row["ms"]
        row["gib_per_s"] = nbytes / (row["ms"] / 1e3) / 2**30
    del pattern
    torch.cuda.empty_cache()
    return out


def _stand_in_node(n: int, card_uuid: str, classic, plain: bool = False):
    """The labeling process's manager on the stand-in: the snapshot a
    classic worker would ship of a FakeNvml H100 in MIG mode whose N
    1g.10gb devices are named by the card's UUID, and that worker's
    client. With ``plain`` a GPU outside MIG mode, the card itself, comes
    first (NVML index 0), which the classic worker probes; without, no
    health request reaches the classic worker."""
    from gpu_feature_discovery_tpu_torch.native import nvml
    from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
    from gpu_feature_discovery_tpu_torch.resource.testing import FakeGpu, FakeNvml
    from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot, SnapshotManager

    gpus = [FakeGpu(bus_id=None, uuid=card_uuid)] if plain else []
    nvml_manager = NvmlManager(FakeNvml(gpus + [FakeGpu(
        bus_id=None, mig_mode=nvml.NVML_DEVICE_MIG_ENABLE, mig=["1g.10gb"] * n,
        mig_uuids=[card_uuid] * n)]))
    nvml_manager.init()
    manager = SnapshotManager(DeviceSnapshot.from_dict(json.loads(json.dumps(
        DeviceSnapshot.from_manager(nvml_manager).to_dict()))))
    manager.broker = classic
    return manager


class _MigStandIn:
    """The daemon's label sources over a stand-in MIG node, with the MIG
    round's children watched: each round is one cycle that starts it and
    the cycles that collect it."""

    def __init__(self, card_uuid: str):
        from gpu_feature_discovery_tpu_torch.lm import health

        self.card_uuid = card_uuid
        self.reports = []
        # Each MIG device's outcome status in the last fold, by label index.
        self.statuses = {}
        self._health = health
        self._real_fold = health._fold

        def recording_fold(targets, classic, outcomes):
            self.reports.extend(o.get("report") for k, o in outcomes.items()
                                if k != "classic" and o.get("report"))
            self.statuses = {t.index: outcomes[t.key].get("status") for t in targets.mig}
            return self._real_fold(targets, classic, outcomes)

        health._fold = recording_fold

    def close(self):
        self._health._fold = self._real_fold

    @staticmethod
    def config(strategy: str, **cli):
        from gpu_feature_discovery_tpu_torch.config.flags import new_config

        return new_config(cli_values={
            "with-burnin": "true", "burnin-interval": "1", "backends": "gpu",
            "tpu-topology-strategy": strategy, "probe-timeout": "120s",
            "machine-type-file": "", **cli}, environ={})

    @staticmethod
    def cycle(manager, cfg) -> dict:
        from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
        from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources

        return _grammar_checked(
            dict(LabelEngine(parallel=False).generate(new_label_sources(manager, cfg))),
            "the MIG stand-in's cycle")

    def pids(self, manager, n: int, timeout: float = 60.0) -> list:
        """The running round's n children, once spawned."""
        sched = self._health._schedule_for(manager)
        rnd = _wait_for(lambda: (lambda r: r if r is not None and len(r.pids) == n
                                 else None)(sched.mig_round), timeout, f"{n} children spawned")
        return list(rnd.pids)

    def round(self, manager, cfg, n: int, memory=None, during=None) -> dict:
        """One whole round through the broker path: the cycle that starts
        it, ``during(pids)`` while its children run, and the cycles until
        it publishes. Its labels, wall and host CPU seconds, the card's
        peak and after-round memory.used, the children's peak VmRSS."""
        import resource

        sched = self._health._schedule_for(manager)
        check(sched.mig_round is None, "a round still running")
        del self.reports[:]
        cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
        t0 = time.monotonic()
        labels = self.cycle(manager, cfg)
        pids = list(sched.mig_round.pids) if sched.mig_round is not None else []
        rss = _ChildRss(pids) if sched.mig_round is not None else None
        if sched.mig_round is not None:
            pids[:] = self.pids(manager, n)
            env = sorted(_environ(p).get(b"CUDA_VISIBLE_DEVICES", b"").decode() for p in pids)
            check(env == [self.card_uuid] * n, f"children pinned to {env}")
            if during is not None:
                during(pids)
        while sched.mig_round is not None:
            time.sleep(0.05)
            labels = self.cycle(manager, cfg)
        wall_s = time.monotonic() - t0
        if rss is not None:
            rss.stop()
        cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
        _wait_for(lambda: all(_gone(p) for p in pids), 10.0, "the round's children exited")
        out = {"labels": labels, "wall_s": wall_s, "pids": pids,
               "cpu_s": (cpu1.ru_utime + cpu1.ru_stime) - (cpu0.ru_utime + cpu0.ru_stime),
               "children_peak_vmrss_kib": rss.peak_kib if rss else None,
               "child_peak_vmrss_kib": rss.peak_each_kib if rss else None}
        if memory is not None:
            time.sleep(2 * MEMORY_SAMPLE_MS / 1e3)
            out["device_peak_mib"] = memory.peak(t0, time.monotonic())
            out["device_after_mib"] = _device_used_mib()
        return out


def _per_device(labels: dict) -> dict:
    return {k[len("nvidia.com/gpu."):]: v for k, v in labels.items()
            if re.match(r"nvidia\.com/gpu\.(chip\.\d+\.|chips\.|health\.ok$)", k)}


def _single_ok(labels: dict, n: int, sick=()) -> None:
    """The labels under a valid single on n MIG devices, ``sick`` false."""
    want = {"health.ok": "false" if sick else "true",
            "chips.healthy": str(n - len(sick)), "chips.sick": str(len(sick))}
    for i in range(n):
        want[f"chip.{i}.ok"] = "false" if i in sick else "true"
    got = {k: v for k, v in _per_device(labels).items()
           if not k.endswith((".tflops", ".hbm-gbps"))}
    check(got == want, f"single, sick {list(sick)}: {got} != {want}")
    for i in range(n):
        if i not in sick:
            check(int(labels.get(f"nvidia.com/gpu.chip.{i}.tflops", "0")) > 0,
                  f"chip.{i}.tflops: {labels}")
    check(labels.get("nvidia.com/gpu.health.timing") == "device-profiler", "timing")


def _no_health(labels: dict, what: str) -> None:
    bad = [k for k in labels if k.startswith(("nvidia.com/gpu.health.",
                                              "nvidia.com/gpu.chip"))]
    check(not bad, f"{what}: health labels {bad}")


def _kernel_cache_files() -> dict:
    from gpu_feature_discovery_tpu_torch.ops import kernel_cache

    root = kernel_cache.kernel_cache_dir()
    return {p.name: p.stat().st_mtime_ns for p in root.glob("*.so")}


def phase_mig(entries: dict, smi: str) -> dict:
    """The probe of a MIG node through a stand-in (see the module's
    docstring, phase 13): the daemon's label sources over the stand-in's
    inventory, one one-shot pinned child per MIG device on the card per
    round."""
    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.native import nvml
    from gpu_feature_discovery_tpu_torch.resource.probe_targets import probe_targets
    from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
    from gpu_feature_discovery_tpu_torch.sandbox.snapshot import SnapshotManager
    from gpu_feature_discovery_tpu_torch.utils import faults

    card_uuid = nvml.read_inventory().devices[0].uuid
    stand_in = _MigStandIn(card_uuid)
    config = stand_in.config
    faults.reset()
    cache_before = _kernel_cache_files()
    check(cache_before, "no kernel in the cache before the mig phase")
    memory = _CardMemory()
    out = {"note": STAND_IN_NOTE, "nvidia_smi": smi, "card_uuid": card_uuid, "runs": {}}

    def held_by_round(run: dict, baseline: int) -> None:
        check(run["device_after_mib"] - baseline <= MIG_AFTER_ROUND_MIB,
              f"after the round the card holds {run['device_after_mib']} MiB, "
              f"baseline {baseline} MiB")

    try:
        for n in MIG_CHILD_COUNTS:
            classic = broker_mod.get_broker(config("single"))
            manager = _stand_in_node(n, card_uuid, classic)
            targets = probe_targets(manager, "single")
            check(len(targets.mig) == n and targets.per_mig_device, f"{n} targets")
            health.reset_burnin_schedule()
            baseline = _device_used_mib()
            first = stand_in.round(manager, config("single"), n, memory)
            held_by_round(first, baseline)
            labels = first["labels"]
            _single_ok(labels, n)
            reports = list(stand_in.reports)
            check(len(reports) == n, f"{len(reports)} reports for {n} devices")
            for report in reports:
                check(report["chips"] == 1 and len(report["per_chip"]) == 1,
                      f"a pinned child probed {report['chips']} devices")
                check(report["per_chip"][0]["hbm_gbps"] is not None,
                      "a pinned child's checksum was not exact")
                # A child's one probe pays its own warm-up: 1 + 3 launches.
                check(report["phases"]["hbm_stream_sum_launches"] == 4,
                      f"launches per probe {report['phases']}")
            torch_uuids = sorted({r["per_chip"][0]["uuid"] for r in reports})
            run = {
                "first_health_s": first["wall_s"], "round_wall_s": first["wall_s"],
                "round_cpu_s": first["cpu_s"],
                "device_baseline_mib": baseline,
                "device_peak_mib": first["device_peak_mib"],
                "device_peak_rise_mib": first["device_peak_mib"] - baseline,
                "device_after_mib": first["device_after_mib"],
                "children_peak_vmrss_kib": first["children_peak_vmrss_kib"],
                "child_peak_vmrss_kib": first["child_peak_vmrss_kib"],
                "launches_per_child": [r["phases"]["hbm_stream_sum_launches_process"]
                                       for r in reports],
                "torch_uuid_in_child": torch_uuids,
                "torch_uuid_is_the_pin": torch_uuids == [nvml.normalize_uuid(card_uuid)],
            }
            check(all(n_ == 4 for n_ in run["launches_per_child"]),
                  f"1 + 3 launches per child: {run['launches_per_child']}")
            if n == MIG_FULL_N:
                # Steady rounds at --burnin-interval 1: each starts on the
                # cycle after the last one published.
                steady = [stand_in.round(manager, config("single"), n, memory)
                          for _ in range(MIG_STEADY_ROUNDS)]
                for r in steady:
                    _single_ok(r["labels"], n)
                    held_by_round(r, baseline)
                run["steady_round_wall_s"] = [r["wall_s"] for r in steady]
                run["steady_round_cpu_s"] = [r["cpu_s"] for r in steady]
                run["steady_device_peak_mib"] = [r["device_peak_mib"] for r in steady]
                run["steady_device_after_mib"] = [r["device_after_mib"] for r in steady]
                # chip.1.sick flips device 1 alone.
                faults.load_fault_spec("chip.1.sick:fail:1")
                sick = stand_in.round(manager, config("single"), n, memory)
                faults.reset()
                _single_ok(sick["labels"], n, sick={1})
                # A child SIGKILLed mid-probe costs its own device alone,
                # and the next round, probed at once, is healthy.
                killed = stand_in.round(manager, config("single"), n, memory,
                                        lambda pids: os.kill(pids[-1], signal.SIGKILL))
                lost = [i for i, status in stand_in.statuses.items() if status != "ok"]
                check(len(lost) == 1, f"one killed child: {stand_in.statuses}")
                _single_ok(killed["labels"], n, sick=set(lost))
                run["killed_device"] = lost[0]
                _single_ok(stand_in.round(manager, config("single"), n, memory)["labels"], n)
                # The same children under strategy none: one GPU, no rate.
                none = stand_in.round(manager, config("none"), n, memory)["labels"]
                check(_per_device(none) == {"health.ok": "true", "chips.healthy": "1",
                                            "chips.sick": "0", "chip.0.ok": "true"},
                      f"none: {_per_device(none)}")
                check("nvidia.com/gpu.health.matmul-tflops" not in none,
                      "a MIG GPU's rate published as a GPU's")
                # The in-process path: the same one-shot children, waited for.
                health.reset_burnin_schedule()
                t2 = time.monotonic()
                oneshot = stand_in.cycle(SnapshotManager(manager.snapshot), config(
                    "single", oneshot="true", **{"probe-broker": "off"}))
                run["in_process_s"] = time.monotonic() - t2
                _single_ok(oneshot, n)
                # A plain GPU (the card, NVML 0) beside the MIG GPU (NVML
                # 1): the classic worker probes the card, joined by its
                # UUID; the children give GPU 1's verdict, unrated.
                health.reset_burnin_schedule()
                half = _stand_in_node(n, card_uuid, classic, plain=True)
                t3 = time.monotonic()
                labels = _wait_for(lambda: (lambda l: l if "nvidia.com/gpu.health.ok" in l
                                            else None)(stand_in.cycle(half, config("none"))),
                                   240.0, "the plain GPU beside MIG", poll=0.2)
                run["plain_beside_mig_s"] = time.monotonic() - t3
                verdicts = {k: v for k, v in _per_device(labels).items()
                            if not k.endswith((".tflops", ".hbm-gbps"))}
                check(verdicts == {
                    "health.ok": "true", "chips.healthy": "2", "chips.sick": "0",
                    "chip.0.ok": "true", "chip.1.ok": "true"}, f"half: {_per_device(labels)}")
                check(int(labels.get("nvidia.com/gpu.chip.0.tflops", "0")) > 0
                      and "nvidia.com/gpu.chip.1.tflops" not in labels
                      and int(labels.get("nvidia.com/gpu.health.matmul-tflops", "0")) > 0,
                      f"half rates: {labels}")
                # The daemon's exit mid-round (run()'s teardown): no child
                # is left.
                health.reset_burnin_schedule()
                stand_in.cycle(manager, config("single"))
                stand_in.pids(manager, n)
                sandbox.close_broker()
                sandbox.kill_stray_children()
                check(not _worker_children(), f"children left: {_worker_children()}")
                health.reset_burnin_schedule()
            sandbox.close_broker()
            out["runs"][str(n)] = run
            emit("mig_run", children=n, **run)
    finally:
        memory.stop()
        stand_in.close()
        faults.reset()
        sandbox.close_broker()
        health.reset_burnin_schedule()
    check(_kernel_cache_files() == cache_before,
          "a child built the kernel instead of loading it from the cache")
    out["grids"] = _mig_grids(entries)
    entries["hbm_stream_sum"]["mig_launches"] = {
        n: r["launches_per_child"] for n, r in out["runs"].items()}
    entries["hbm_stream_sum"]["mig_grids"] = out["grids"]
    emit("mig", **{k: v for k, v in out.items() if k != "runs"},
         first_health_s={n: r["first_health_s"] for n, r in out["runs"].items()},
         round_cpu_s={n: r["round_cpu_s"] for n, r in out["runs"].items()},
         device_peak_rise_mib={n: r["device_peak_rise_mib"] for n, r in out["runs"].items()})
    return out


# The busy phase: a holder process takes the card's free memory less a
# margin. The context margin is below a CUDA context, so a new process
# cannot create one; each busy margin after it is chosen from the
# footprint split so that the probe's attempt fails at one step: the 256
# MiB buffer, the burn-in's side stream, cuBLAS's handle and the graph
# capture. The last, BUSY_FITS, leaves the first probe's need and
# BUSY_LOW_MARGIN_MIB more, where a fresh worker probes ok
# (``_busy_margins``). Every check runs at the margins of BUSY_FULL; at the
# others, a fresh worker and the early worker, and at the busy ones the
# MIG stand-in in process (at BUSY_FITS its three children would race for
# one probe's room).
BUSY_LOW_MARGIN_MIB = 64
# The capture's margin, this far short of the split's use after the
# capture: torch.cuda.graph empties the allocator's cache before it
# captures, so the capture ends below the side pass's peak on a card with
# room, while on a full card the side pass reuses freed blocks and fits in
# less than the capture (tools/torch_busy_margins.py shows where each
# margin fails).
BUSY_CAPTURE_SHORT_MIB = 16
# margin -> the split's step whose use less the caching allocator's share
# bounds what a busy worker keeps: the step that failed, of which a failed
# creation may keep a part. Nothing at the context margin; at BUSY_FITS
# the whole first probe, its workspaces included, as a worker that probed
# keeps them.
BUSY_FITS = "fits"
BUSY_KEEPS = {
    "context": None,
    "allocation": "stream_buffer_256mib",
    "stream": "side_stream",
    "cublas": "cublas_first_pass",
    "capture": "graph_capture",
    BUSY_FITS: "first_probe",
}
BUSY_FULL = ("context", "allocation")
# The one-device verdicts' rise in the footprint split: their 128x2
# inputs and code, and no NCCL communicator.
VERDICTS_RISE_MAX_MIB = 8
# The card's memory.used is steady once two readings this far apart agree
# within BUSY_STEADY_MIB.
BUSY_STEADY_S = 0.5
BUSY_STEADY_MIB = 2
# What the card may drift by, all other processes, across one margin.
BUSY_DRIFT_MIB = 16
BUSY_CLI_CYCLES = 6
BUSY_CLI_SLEEP_S = 0.5
PARENT_BUSY_NOTE = ("the parent tree maps every exception of the probe to "
                    "probe-failed (sandbox/broker.py _HealthProbe._run, and a "
                    "pinned child's error in lm/health.py _probe_mig_in_child): "
                    "health.ok=false, chip.<i>.ok=false, chips.sick, hence "
                    "slice.sick-chips and cordon advice")

_FOOTPRINT_CHILD = r"""
import json, sys, torch
import torch.cuda.nccl as nccl
from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck as hc

dev = torch.device("cuda", 0)
steps, reserved, allocated = {}, {}, {}
# Every NCCL call of the child is counted: over one device there is none.
nccl_calls, real_all_reduce = [], nccl.all_reduce

def counting_all_reduce(*args, **kwargs):
    nccl_calls.append(1)
    return real_all_reduce(*args, **kwargs)

nccl.all_reduce = counting_all_reduce

def used(step):
    torch.cuda.synchronize(dev)
    free, total = torch.cuda.mem_get_info(dev)
    steps[step] = (total - free) / 2**20
    reserved[step] = torch.cuda.memory_reserved(dev) / 2**20
    allocated[step] = torch.cuda.memory_allocated(dev) / 2**20

used("context")
hbm._kernel_library()
used("kernel_library")
# In the warm-up's order (ops/healthcheck.py _warm_probe_kernels).
xb, wsb = hc._burnin_workspace(dev, hc.CUDA_PROBE_SIZE, hc.CUDA_PROBE_DEPTH, hc.PROBE_DTYPE)
used("burnin_inputs")
buf = hbm.stream_workspace(dev, hbm.probe_rows(hc.PROBE_HBM_MIB))
used("stream_buffer_256mib")
# The burn-in graph's capture (hc._burnin_graph) step by step, its entry
# then registered so that the probe below captures no second graph.
side = torch.cuda.Stream(dev)
used("side_stream")
hc.burnin_step(xb, wsb)
used("cublas_first_pass")
with torch.cuda.stream(side):
    hc.rms_epilogue.launch_scratch(dev, side.cuda_stream)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
    cs, rms = hc.burnin_step(xb, wsb)
hc._burnin_graphs[(dev, hc.CUDA_PROBE_SIZE, hc.CUDA_PROBE_DEPTH)] = (graph, cs, rms)
used("graph_capture")
hc.sharded_chip_verdicts((dev,), hc.VERDICT_MAX_SIZE, hc.VERDICT_MAX_DEPTH)
used("verdicts_one_device")
hbm.hbm_stream_sum(buf)
used("stream_kernel_first_launch")
del buf, xb, wsb, graph, cs, rms
report = hc.measure_node_health(devices=[dev], per_chip=True)
used("first_probe")
at_end = {"reserved_mib": torch.cuda.memory_reserved(dev) / 2**20,
          "allocated_mib": torch.cuda.memory_allocated(dev) / 2**20}
# What a worker keeps after a busy attempt that got this far.
hc.release_probe_memory()
used("after_release")
print(json.dumps({"steps": steps, "allocator_reserved_mib": reserved,
                  "allocator_allocated_mib": allocated, **at_end,
                  "healthy": report["healthy"], "nccl_calls": len(nccl_calls),
                  "launches": report["phases"]["hbm_stream_sum_launches_process"]}))
"""

_HOLDER = r"""
import json, sys, torch
margin = int(sys.argv[1]) << 20
free, total = torch.cuda.mem_get_info()
held = torch.empty(free - margin, dtype=torch.uint8, device="cuda")
torch.cuda.synchronize()
after, _ = torch.cuda.mem_get_info()
print(json.dumps({"held_mib": held.numel() / 2**20, "free_mib": after / 2**20}), flush=True)
sys.stdin.read()
"""


def _child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def _footprint(card_uuid: str) -> dict:
    """What a pinned child holds of the card after each step of its first
    probe: ``total - free`` (cudaMemGetInfo) less the card's use without
    the child, and the caching allocator's reserve against what is
    allocated at the end. The use without the child is the lesser of two
    steady readings, before the child and after it: a process of an
    earlier phase that is still giving its memory back, or this process's
    own share shrinking, must not count as the child's."""
    before = _steady_used_mib()
    proc = subprocess.run([sys.executable, "-c", _FOOTPRINT_CHILD], cwd=REPO,
                          env=_child_env(CUDA_VISIBLE_DEVICES=card_uuid),
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"footprint child failed: {proc.stderr[-2000:]}")
    after = _steady_used_mib()
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    check(doc["healthy"] and doc["launches"] == 5, f"footprint child's probe: {doc}")
    check(doc["nccl_calls"] == 0, f"{doc['nccl_calls']} NCCL calls over one device")
    without = min(before, after)
    steps = doc["steps_mib"] = {k: v - without for k, v in doc.pop("steps").items()}
    doc["card_before_mib"], doc["card_after_mib"] = before, after
    doc["verdicts_rise_mib"] = steps["verdicts_one_device"] - steps["graph_capture"]
    return doc


class _Holder:
    """A process that takes the card's free memory less ``margin_mib`` and
    keeps it until stopped."""

    def __init__(self, margin_mib: int):
        self.proc = subprocess.Popen([sys.executable, "-c", _HOLDER, str(margin_mib)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     text=True, env=_child_env())
        line = self.proc.stdout.readline()
        check(line.startswith("{"), f"the holder did not take the memory: {line!r}")
        self.doc = json.loads(line)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)


def _health_outcome(client, **request) -> dict:
    """The client's health RPCs until one is not ``warming``."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        outcome = client.health(**request)
        if outcome.get("status") != "warming":
            return outcome
        time.sleep(0.2)
    raise SystemExit("chip_smoke: check failed: a health outcome within 120 s")


def _busy_cli(tmp: str, name: str):
    """The CLI at its defaults with actuation on and a probe every cycle."""
    out = os.path.join(tmp, f"{name}-tfd")
    log_path = os.path.join(tmp, f"{name}-log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--backends", "gpu",
         "--with-burnin", "--burnin-interval", "1", "--sleep-interval",
         f"{BUSY_CLI_SLEEP_S}s", "--probe-timeout", "60s", "--metrics-port", "0",
         "--actuation", "enforce", "--actuation-window", "2",
         "--state-dir", os.path.join(tmp, f"{name}-state"), "--output-file", out],
        cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, out, log_path


def _steady_used_mib(timeout: float = 20.0) -> int:
    """The card's memory.used once two readings BUSY_STEADY_S apart agree
    within BUSY_STEADY_MIB: no process is still taking or freeing."""
    deadline = time.monotonic() + timeout
    last = _device_used_mib()
    while True:
        time.sleep(BUSY_STEADY_S)
        now = _device_used_mib()
        if abs(now - last) <= BUSY_STEADY_MIB:
            return now
        check(time.monotonic() < deadline, f"the card's memory.used steady within {timeout}s")
        last = now


def _live_children() -> set:
    """This process's children that are not zombies."""
    return {p for p in _children(os.getpid()) if not _gone(p)}


def _busy_worker(cfg, health, broker_mod, run: dict, fits: bool = False):
    """(a) A fresh classic worker under the holder: its first probe
    answers ``unacquirable`` with the error it met, the labels carry no
    health, and the worker stays up; where the probe ``fits``, it answers
    ok and the labels carry health. Returns the client, its manager and
    the outcomes it answered."""
    t0 = time.monotonic()
    w1 = broker_mod.BrokerClient(cfg)
    try:
        w1_manager = broker_mod.BrokerManager(w1)
    except Exception as e:  # noqa: BLE001 - reported as the failed check
        w1.close()
        raise SystemExit(f"chip_smoke: check failed: a fresh worker's spawn under the "
                         f"holder: {e}")
    run["fresh_worker_spawn_s"] = time.monotonic() - t0
    w1_pid = w1.pid
    seen = []
    real_health = w1.health

    def recording(**request):
        seen.append(real_health(**request))
        return seen[-1]

    w1.health = recording
    labels = {}
    deadline = time.monotonic() + 120
    while (not seen or seen[-1]["status"] == "warming") and time.monotonic() < deadline:
        labels = _grammar_checked(dict(health.new_health_labeler(w1_manager, cfg).labels()),
                                  "the busy worker's health labels")
    outcome = seen[-1]
    run["fresh_worker_labels"] = labels
    if fits:
        check(outcome["status"] == "ok" and outcome["report"]["healthy"]
              and _has_health(labels), f"a fresh worker where the probe fits: {outcome} "
              f"{labels}")
    else:
        check(outcome["status"] == "unacquirable" and outcome.get("error"),
              f"a fresh worker under the holder: {outcome}")
        _no_health(labels, "a fresh worker under the holder")
        run["fresh_worker_error"] = outcome["error"]
    check(w1.alive and w1.pid == w1_pid and not _gone(w1_pid),
          "the busy worker did not stay up")
    return w1, w1_manager, seen


def _busy_cli_checks(cli, cli_out: str, cli_log: str, run: dict) -> None:
    """(c) The CLI with actuation under the holder: a write per cycle,
    never a health label, chips.sick or advice; the busy device logged."""
    snaps = []

    def cycles_seen():
        labels = _read_labels(cli_out)
        if labels and (not snaps or labels != snaps[-1]):
            snaps.append(labels)
        with open(cli_log) as f:
            return f.read().count("Cycle timings: ") >= BUSY_CLI_CYCLES

    _wait_for(cycles_seen, 120.0, f"{BUSY_CLI_CYCLES} CLI cycles", poll=0.05)
    for labels in snaps + [_read_labels(cli_out)]:
        _no_health(labels, "the CLI under the holder")
        bad = [k for k in labels if k.endswith(
            ("schedulable", "cordon-advice", "slice.sick-chips"))]
        check(not bad, f"the CLI under the holder: {bad}")
    with open(cli_log) as f:
        busy_lines = [l.strip() for l in f if "a device is busy" in l]
    check(busy_lines, "the CLI logged no busy device")
    run["cli_busy_line"] = busy_lines[0][-400:]
    cli_workers = _children(cli.pid)
    check(len(cli_workers) == 1, f"CLI workers {cli_workers}")
    cli.send_signal(signal.SIGTERM)
    check(cli.wait(timeout=30) == 0, "the CLI did not exit 0")


def _busy_margins(steps: dict) -> dict:
    """Each margin of the busy phase in MiB, by the step of the probe it
    makes fail: half way between two steps of the split, or, for the
    capture, BUSY_CAPTURE_SHORT_MIB short of its end."""
    def mid(below, above):
        return int(round((steps[below] + steps[above]) / 2))

    return {
        "context": BUSY_LOW_MARGIN_MIB,
        "allocation": mid("burnin_inputs", "stream_buffer_256mib"),
        "stream": mid("stream_buffer_256mib", "side_stream"),
        "cublas": mid("side_stream", "cublas_first_pass"),
        "capture": int(round(steps["graph_capture"])) - BUSY_CAPTURE_SHORT_MIB,
        BUSY_FITS: int(round(steps["first_probe"])) + BUSY_LOW_MARGIN_MIB,
    }


def _kept_allowed(steps: dict, reserved: dict, name: str) -> float:
    """What a busy worker may keep after its attempt at the margin
    ``name``: nothing when no context fitted; else the card's use at the
    margin's BUSY_KEEPS step of the split less the caching allocator's
    share there, its CUDA context and the code and library state its
    attempt loaded, which no torch call frees. At BUSY_FITS the worker
    probed and keeps its workspaces too: the whole first probe."""
    step = BUSY_KEEPS[name]
    if step is None:
        return 0.0
    return steps[step] - (0.0 if name == BUSY_FITS else reserved[step])


def phase_busy(entries: dict, smi: str) -> dict:
    """A busy card (see the module's docstring, phase 14): at each margin
    a fresh classic worker and the MIG stand-in at N = 3 in process (at
    the margins of BUSY_FULL also a CLI with actuation and the stand-in
    through the broker) publish no health label; the worker stays up
    holding at most its context and the code its attempt loaded; a worker
    that was up before the holder still probes ok; after the holder
    exits, health labels return."""
    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.native import nvml
    from gpu_feature_discovery_tpu_torch.ops.healthcheck import release_probe_memory
    from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
    from gpu_feature_discovery_tpu_torch.sandbox.snapshot import SnapshotManager

    card_uuid = nvml.read_inventory().devices[0].uuid
    footprint = _footprint(card_uuid)
    emit("footprint", nvidia_smi=smi, **footprint)
    check(footprint["verdicts_rise_mib"] < VERDICTS_RISE_MAX_MIB,
          f"the one-device verdicts took {footprint['verdicts_rise_mib']} MiB")
    steps = footprint["steps_mib"]
    reserved = footprint["allocator_reserved_mib"]
    margins = _busy_margins(steps)
    check(BUSY_LOW_MARGIN_MIB < steps["context"] < margins["allocation"],
          f"margins {margins} against the split {steps}")
    stand_in = _MigStandIn(card_uuid)
    config = stand_in.config
    cfg = config("none")
    build_dir = os.path.join(REPO, "build")
    out = {"nvidia_smi": smi, "parent_note": PARENT_BUSY_NOTE, "margins_mib": margins,
           "runs": {}}
    # This process's own probe caches go first, so that its share of the
    # card stays put under every reading below.
    release_probe_memory()
    # (e) A worker up before the holder: it keeps its own memory.
    w0 = broker_mod.BrokerClient(cfg)
    try:
        first = _health_outcome(w0, per_chip=True)
        check(first["status"] == "ok", f"the early worker: {first}")
        for name, margin in margins.items():
            full, fits = name in BUSY_FULL, name == BUSY_FITS
            run = {"margin_mib": margin, "full": full}
            launches = {}
            health.reset_burnin_schedule()
            others = _live_children()
            check(w0.pid in others, f"the early worker among {others}")
            baseline = _steady_used_mib()
            holder = _Holder(margin)
            run["holder"] = holder.doc
            cli = w1 = None
            try:
                with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
                    w1, w1_manager, seen = _busy_worker(cfg, health, broker_mod, run, fits)
                    # (e) The early worker still probes.
                    early = _health_outcome(w0, per_chip=True)
                    check(early["status"] == "ok" and early["report"]["healthy"],
                          f"the early worker under the holder: {early}")
                    run["early_worker"] = early["status"]
                    launches["early_worker"] = \
                        early["report"]["phases"]["hbm_stream_sum_launches_process"]
                    manager = None if fits else _stand_in_node(MIG_FULL_N, card_uuid, w0)
                    if full:
                        cli, cli_out, cli_log = _busy_cli(tmp, name)
                        # (b) The MIG stand-in through the broker.
                        mig = stand_in.round(manager, config("single"), MIG_FULL_N)
                        _no_health(mig["labels"], "the MIG stand-in through the broker")
                        run["mig_broker_round_s"] = mig["wall_s"]
                        health.reset_burnin_schedule()
                    if not fits:
                        # (b) The MIG stand-in in process.
                        t1 = time.monotonic()
                        oneshot = stand_in.cycle(SnapshotManager(manager.snapshot), config(
                            "single", oneshot="true", **{"probe-broker": "off"}))
                        run["mig_in_process_s"] = time.monotonic() - t1
                        _no_health(oneshot, "the MIG stand-in in process")
                    if full:
                        _busy_cli_checks(cli, cli_out, cli_log, run)
                        cli = None
                    holder.stop()
                    # (c) What the busy worker keeps: every other process
                    # of the card is where it was at the baseline (checked
                    # again once the worker is gone, below).
                    check(_live_children() == others | {w1.pid},
                          f"children {_live_children()} at the reading, {others} and "
                          f"{w1.pid} at the baseline")
                    run["busy_worker_holds_mib"] = _steady_used_mib() - baseline
                    # (d) After the holder: health labels, through the same
                    # worker, and for the MIG stand-in.
                    t2 = time.monotonic()
                    labels = _wait_for(lambda: (lambda l: l if l.get(
                        "nvidia.com/gpu.health.ok") == "true" else None)(dict(
                            health.new_health_labeler(w1_manager, cfg).labels())),
                        120.0, "health labels after the holder", poll=0.2)
                    run["holder_exit_to_health_s"] = time.monotonic() - t2
                    check(_has_health(labels), f"after the holder: {labels}")
                    # Its first ok probe: 1 + 3 launches, none in a busy
                    # attempt before it.
                    first_ok = next(o for o in seen if o["status"] == "ok")
                    launches["fresh_worker"] = \
                        first_ok["report"]["phases"]["hbm_stream_sum_launches_process"]
                    check(launches["fresh_worker"] == 4,
                          f"the fresh worker's first ok probe after {launches['fresh_worker']} "
                          f"launches, not 1 + 3: {launches}")
                    if name == "allocation":
                        health.reset_burnin_schedule()
                        mig = stand_in.round(manager, config("single"), MIG_FULL_N)
                        _single_ok(mig["labels"], MIG_FULL_N)
                        run["mig_after_holder_round_s"] = mig["wall_s"]
                        launches["mig_children_after"] = [
                            r["phases"]["hbm_stream_sum_launches_process"]
                            for r in stand_in.reports]
            finally:
                if cli is not None and cli.poll() is None:
                    cli.kill()
                    cli.wait()
                holder.stop()
                if w1 is not None:
                    w1_pid = w1.pid
                    w1.close()
                    _wait_for(lambda: _gone(w1_pid), 30.0, "the busy worker's exit")
                health.reset_burnin_schedule()
            run["card_drift_mib"] = _steady_used_mib() - baseline
            run["launches"] = launches
            out["runs"][name] = run
            emit("busy_run", margin=name, **run)
            held = run["busy_worker_holds_mib"]
            allowed = _kept_allowed(steps, reserved, name)
            check(abs(run["card_drift_mib"]) <= BUSY_DRIFT_MIB,
                  f"at the {name} margin the card's other processes moved by "
                  f"{run['card_drift_mib']} MiB")
            check(-BUSY_DRIFT_MIB <= held <= allowed + BUSY_DRIFT_MIB,
                  f"at the {name} margin the busy worker holds {held} MiB, its context "
                  f"and code {allowed} MiB")
    finally:
        w0.close()
        stand_in.close()
        sandbox.close_broker()
        health.reset_burnin_schedule()
    entries["hbm_stream_sum"]["busy_launches"] = {
        name: r["launches"] for name, r in out["runs"].items()}
    emit("busy", **{k: v for k, v in out.items() if k != "runs"},
         errors={name: r["fresh_worker_error"][:300] for name, r in out["runs"].items()
                 if "fresh_worker_error" in r},
         busy_worker_holds_mib={name: r["busy_worker_holds_mib"]
                                for name, r in out["runs"].items()},
         allowed_mib={name: _kept_allowed(steps, reserved, name) for name in margins})
    return out



# The chaos phase: rows of the port's chaos matrix (tests/torch_chaos_run.py)
# against the card. The one-shot sandbox rows run the acquisition in a
# probe child per attempt (no broker) and the burn-in in this process; the
# healthy child's gpu select+snapshot (torch's import and CUDA's set-up)
# fits CHAOS_PROBE_TIMEOUT_S, which is also what the hung child costs. The
# reconcile row runs at the daemon's own --probe-timeout.
CHAOS_PROBE_TIMEOUT_S = 20.0
CHAOS_DAEMON_PROBE_TIMEOUT_S = 30.0
CHAOS_ROW_TIMEOUT_S = 90.0
CHAOS_ONESHOT_ROWS = ("probe.segv:fail:1", "probe.hang:fail:1")
CHAOS_ONESHOT_CLI = {"probe-broker": "off", "probe-isolation": "subprocess",
                     "with-burnin": True, "burnin-interval": "1"}
# The reconcile row's health request waits for the respawned worker's
# pre-warm and first probe, so that the wake's cycle itself publishes
# health labels; below the row's --probe-timeout.
CHAOS_HEALTH_WAIT_S = 25.0
# A hung child is read once it has held libcuda.so this long.
CHAOS_HUNG_READ_S = 3.0
WORKER_MAIN = b"gpu_feature_discovery_tpu_torch.sandbox.worker_main"


def _test_script(name: str, filename: str):
    """A script of tests/ that imports no JAX and no yaml, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tests", filename))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _chaos_driver():
    """tests/torch_chaos_run.py, every label file it reads held to the
    grammar too."""
    module = _test_script("torch_chaos_run", "torch_chaos_run.py")
    module.read_labels = _read_labels
    return module


class _ChildWatch:
    """This process's sandbox children (``sandbox.worker_main``), polled
    every 5 ms: the role, when each was first seen, whether its maps ever
    held libcuda.so, when it was gone, and for a child that holds libcuda
    and lives CHAOS_HUNG_READ_S, the card's memory.used while it does."""

    def __init__(self):
        self.children = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)

    def _entry(self, pid: int, now: float):
        entry = self.children.get(pid)
        if entry is None:
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = [a for a in f.read().split(b"\0") if a]
            except OSError:
                return None
            if WORKER_MAIN not in argv:
                return None
            entry = self.children[pid] = {"pid": pid, "role": argv[-1].decode(),
                                          "seen": now, "libcuda": False,
                                          "libcuda_at": None, "gone": None,
                                          "held_used_mib": None}
        return entry

    def _run(self):
        while not self._stop.is_set():
            now = time.monotonic()
            live = set()
            for pid in _children(os.getpid()):
                if _gone(pid):
                    continue
                entry = self._entry(pid, now)
                if entry is None:
                    continue
                live.add(pid)
                if not entry["libcuda"]:
                    try:
                        entry["libcuda"] = _maps_libcuda(pid)
                    except OSError:
                        continue
                    if entry["libcuda"]:
                        entry["libcuda_at"] = now
                elif (entry["held_used_mib"] is None
                      and now - entry["libcuda_at"] >= CHAOS_HUNG_READ_S):
                    entry["held_used_mib"] = _device_used_mib()
            for pid, entry in self.children.items():
                if entry["gone"] is None and pid not in live:
                    entry["gone"] = now
            self._stop.wait(0.005)


def _chaos_oneshot_row(driver, spec: str, capture, build_dir: str) -> dict:
    """One one-shot sandbox row: the first probe child is the faulty one
    (the fault is armed before the daemon starts), a later one acquires,
    and the daemon converges to full labels with ``health.ok=true`` from
    a probe in this process."""
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck

    health.reset_burnin_schedule()
    healthcheck.release_probe_memory()
    before_mib = _steady_used_mib()
    counters = {"kills": obs_metrics.PROBE_KILLS, "crashes": obs_metrics.PROBE_CRASHES}
    counted = {k: c.value() for k, c in counters.items()}
    n_cycles = len(capture.cycles)
    hbm.hbm_stream_sum.launches = 0
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp, _ChildWatch() as watch:
        result = driver.run_chaos(
            spec, tmp, backend="gpu", probe_timeout=f"{CHAOS_PROBE_TIMEOUT_S}s",
            expect_final=["nvidia.com/gpu.health.ok=true"], timeout_s=CHAOS_ROW_TIMEOUT_S,
            extra_cli=CHAOS_ONESHOT_CLI)
    launches = hbm.hbm_stream_sum.launches
    counted = {k: c.value() - counted[k] for k, c in counters.items()}
    healthcheck.release_probe_memory()
    after_mib = _steady_used_mib()
    probes = sorted((c for c in watch.children.values() if c["role"] == "probe"),
                    key=lambda c: c["seen"])
    check(len(probes) >= 2 and all(c["gone"] is not None for c in probes),
          f"{spec}: probe children {probes}")
    faulty = probes[0]
    cycles = capture.cycles[n_cycles:]
    per_probe = [c["phases"].get("hbm_stream_sum_launches") for c in cycles
                 if c["mode"] == "probing"]
    row = {"spec": spec, "converged_s": result["converged_s"],
           "child_pid": faulty["pid"], "child_libcuda": faulty["libcuda"],
           "child_lived_s": faulty["gone"] - faulty["seen"],
           "fault_to_health_s": result["converged_at"] - faulty["gone"],
           "probe_children": len(probes), "registry_counted": counted,
           "used_before_mib": before_mib, "used_after_mib": after_mib,
           "launches": launches, "launches_per_probing_cycle": per_probe}
    # A context shows as the card's memory.used while the child lives
    # (523 MiB for a probe's, PERF.md section 5); libcuda.so alone is the
    # driver loaded. None where the child died too soon to be read.
    if faulty["held_used_mib"] is not None:
        row["child_held_mib"] = faulty["held_used_mib"] - before_mib
        row["cuda_context"] = row["child_held_mib"] > CONTEXT_MIB
    else:
        row["cuda_context"] = None
    emit("chaos_row", **row)
    check(abs(after_mib - before_mib) <= MIG_AFTER_ROUND_MIB,
          f"{spec}: memory.used {before_mib} -> {after_mib} MiB")
    check(per_probe and all(n in (healthcheck.PROBE_HBM_ITERS, healthcheck.PROBE_HBM_ITERS + 1)
                            for n in per_probe) and launches >= sum(per_probe),
          f"{spec}: launches {launches}, per probing cycle {per_probe}")
    if spec.startswith("probe.segv"):
        check(counted == {"kills": 0, "crashes": 1}, f"{spec}: the registry counted {counted}")
    else:
        check(counted == {"kills": 1, "crashes": 0}, f"{spec}: the registry counted {counted}")
        check(CHAOS_PROBE_TIMEOUT_S - 0.5 <= row["child_lived_s"]
              <= CHAOS_PROBE_TIMEOUT_S + 2,
              f"{spec}: the hung child lived {row['child_lived_s']:.2f}s")
    return row


def card_used_bytes() -> int:
    """The card's used memory as CUDA reports it (total - free), the
    measure a broker worker's ``memory`` report uses."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return total - free


def worker_memory_mib(base_used: int) -> dict:
    """The live broker worker's own memory (the broker's ``memory`` op),
    in MiB: its pid; per device the caching allocator's reserve and
    allocation; and its context's share, the card's used memory when its
    context first saw it, before its first allocation, less ``base_used``
    (``card_used_bytes`` before the worker)."""
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    client = broker._active
    if client is None or not client.alive:
        return {}
    report = client.memory()
    mib = float(2 ** 20)
    used = report.get("context_used_bytes") or []
    return {"pid": report.get("pid"),
            "reserved_mib": [d["reserved_bytes"] / mib for d in report["devices"]],
            "allocated_mib": [d["allocated_bytes"] / mib for d in report["devices"]],
            "context_used_mib": [u / mib for u in used],
            "context_share_mib": [(u - base_used) / mib for u in used]}


def _chaos_reconcile_row(driver, capture, build_dir: str) -> dict:
    """reconcile:broker-death against the card: the event-mode daemon at
    the default --probe-timeout, sleep interval 60 s, its broker worker
    SIGKILLed once it served; the wake's cycle respawns the worker and
    publishes fresh full labels with health."""
    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    healthcheck.release_probe_memory()
    base_mib = _steady_used_mib()
    base_used = card_used_bytes()
    hbm.hbm_stream_sum.launches = 0
    seen = {}

    def observe(stage, info):
        if stage == "before_kill":
            seen["old_libcuda"] = _maps_libcuda(info["killed_pid"])
            seen["before_kill_mib"] = _steady_used_mib()
            seen["killed_memory"] = worker_memory_mib(base_used)
            seen["cycles_before_kill"] = len(capture.cycles)
        else:
            seen["new_libcuda"] = _maps_libcuda(info["worker_pid"])
            seen["recovered_mib"] = _steady_used_mib()
            seen["worker_memory"] = worker_memory_mib(base_used)
            seen["labels"] = _read_labels(info["output_file"])
            seen["cycles_recovered"] = len(capture.cycles)

    wait_s, broker.HEALTH_WAIT_S = broker.HEALTH_WAIT_S, CHAOS_HEALTH_WAIT_S
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            result = driver.run_reconcile_chaos(
                "broker-death", tmp, timeout_s=CHAOS_ROW_TIMEOUT_S, backend="gpu",
                probe_timeout_s=CHAOS_DAEMON_PROBE_TIMEOUT_S,
                extra_cli={"with-burnin": True, "burnin-interval": "1"}, scrape=True,
                observe=observe)
    finally:
        broker.HEALTH_WAIT_S = wait_s
        sandbox.close_broker()
    after_mib = _steady_used_mib()
    check(hbm.hbm_stream_sum.launches == 0,
          f"this process launched the kernel {hbm.hbm_stream_sum.launches} times")
    recovered = capture.cycles[seen["cycles_before_kill"]:seen["cycles_recovered"]]
    check(recovered and recovered[0]["mode"] == "probing",
          f"the wake's cycle: {[c['mode'] for c in recovered]}")
    phases = recovered[0]["phases"]
    worker_mib = seen["before_kill_mib"] - base_mib
    row = {"spec": result["spec"], "kill_to_full_s": result["kill_to_full_s"],
           "worker_died_wakes": result["worker_died_wakes"],
           "scraped_worker_died_wakes": result["scraped_worker_died_wakes"],
           "failed_cycles": result["failed_cycles"],
           "scraped_failed_cycles": result["scraped_failed_cycles"],
           "killed_pid": result["killed_pid"], "worker_pid": result["worker_pid"],
           "killed_libcuda": seen["old_libcuda"], "worker_libcuda": seen["new_libcuda"],
           "health_labels": _has_health(seen["labels"]),
           "used_base_mib": base_mib, "used_before_kill_mib": seen["before_kill_mib"],
           "used_recovered_mib": seen["recovered_mib"], "used_after_mib": after_mib,
           "worker_mib": worker_mib,
           # Each worker's own report, so a new worker above the old one
           # names the process and the pool that holds the difference.
           "killed_worker_memory": seen["killed_memory"],
           "new_worker_memory": seen["worker_memory"],
           "launches": phases.get("hbm_stream_sum_launches"),
           "worker_launches": phases.get("hbm_stream_sum_launches_process"),
           "health_wait_s": CHAOS_HEALTH_WAIT_S}
    emit("chaos_row", **row)
    check(row["kill_to_full_s"] < 2 * CHAOS_DAEMON_PROBE_TIMEOUT_S,
          f"kill to full labels {row['kill_to_full_s']:.2f}s")
    check(row["worker_died_wakes"] >= 1 and row["scraped_worker_died_wakes"] >= 1
          and row["failed_cycles"] == 0 and row["scraped_failed_cycles"] in (0, None),
          f"reconcile: {row}")
    check(row["killed_libcuda"] and row["worker_libcuda"] and row["health_labels"],
          f"reconcile: libcuda in the workers, health labels after: {row}")
    check(abs(seen["recovered_mib"] - seen["before_kill_mib"]) <= MIG_AFTER_ROUND_MIB
          and abs(after_mib - base_mib) <= MIG_AFTER_ROUND_MIB,
          f"reconcile: memory.used {base_mib} / {seen['before_kill_mib']} / "
          f"{seen['recovered_mib']} / {after_mib} MiB")
    check(row["launches"] in (healthcheck.PROBE_HBM_ITERS, healthcheck.PROBE_HBM_ITERS + 1)
          and row["worker_launches"] == healthcheck.PROBE_HBM_ITERS + 1,
          f"reconcile: the wake's cycle launched {row['launches']} "
          f"(its worker {row['worker_launches']})")
    return row


def phase_chaos(entries: dict, smi: str) -> dict:
    """Rows of the port's chaos matrix against the card (the module's
    docstring, phase 15): a probe child that holds libcuda and dies to a
    real SIGSEGV, one that hangs until its SIGKILL at --probe-timeout,
    both in the one-shot sandbox, and the SIGKILL of an event-mode
    daemon's broker worker, recovered through the worker_died wake."""
    import torch

    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck

    t0 = time.monotonic()
    driver = _chaos_driver()
    # This process's own first use of the probe (its context, torch's and
    # cuBLAS's code), which the one-shot rows' in-process probe would
    # otherwise add to the card's memory.used in the first row; the phases
    # before this one have paid it already when the whole script runs.
    # The daemon's first probe runs on a thread of its own, so the warm-up
    # does too.
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    warm = threading.Thread(target=healthcheck.measure_node_health,
                            kwargs={"devices": devices, "per_chip": True})
    warm.start()
    warm.join()
    hbm.hbm_stream_sum.launches = 0
    capture = _CycleCapture(lambda: hbm.hbm_stream_sum.launches)
    tfd_log, lm_log = logging.getLogger("tfd"), logging.getLogger("tfd.lm")
    levels = (tfd_log.level, lm_log.level)
    tfd_log.setLevel(logging.INFO)
    lm_log.setLevel(logging.DEBUG)
    tfd_log.addHandler(capture)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    rows = {}
    try:
        for spec in CHAOS_ONESHOT_ROWS:
            rows[spec] = _chaos_oneshot_row(driver, spec, capture, build_dir)
        row = _chaos_reconcile_row(driver, capture, build_dir)
        rows[row["spec"]] = row
    finally:
        tfd_log.removeHandler(capture)
        tfd_log.setLevel(levels[0])
        lm_log.setLevel(levels[1])
    launches = {spec: r["launches"] for spec, r in rows.items()}
    entries["hbm_stream_sum"]["chaos_launches"] = launches
    emit("chaos", nvidia_smi=smi,
         cuda_context={s: r.get("cuda_context", r.get("worker_mib", 0) > CONTEXT_MIB)
                       for s, r in rows.items()},
         fault_to_health_s={s: r.get("fault_to_health_s", r.get("kill_to_full_s"))
                            for s, r in rows.items()},
         worker_died_wakes=rows["reconcile:broker-death"]["scraped_worker_died_wakes"],
         failed_cycles=rows["reconcile:broker-death"]["failed_cycles"],
         used_mib={s: [r.get("used_before_mib", r.get("used_base_mib")),
                       r["used_after_mib"]] for s, r in rows.items()},
         launches=launches, wall_s=time.monotonic() - t0)
    return rows


GOLDEN = os.path.join(REPO, "tests", "torch-expected-output-live-h100.txt")
# The oneshot's wall-clock budget in the integration script: torch's
# import, CUDA's set-up, the kernel from the cache and one probe.
GOLDEN_TIMEOUT_S = 300.0


def _golden_extra(strategy: str) -> list:
    """Regexes the live golden (strategy none, this machine's virtualised
    host without PCI functions) lacks for this run: the strategy's label,
    and the PCI labels where sysfs lists NVIDIA functions."""
    extra = []
    if strategy != "none":
        extra.append(r"nvidia\.com\/gpu\.topology\.strategy=" + strategy)
    functions = _sysfs_gpu_functions()
    if functions:
        extra += [r"nvidia\.com\/gpu\.pci\.present=true",
                  r"nvidia\.com\/gpu\.pci\.count=%d" % len(functions)]
    return [re.compile(x) for x in extra]


def phase_golden(entries: dict, smi: str) -> dict:
    """Tier 3 of the reference on the card (phase 16): the integration
    script's oneshot with ``--with-burnin`` against the live golden, under
    each MIG strategy; its launches counted in the daemon's process by the
    start-up hook the deploy phase uses."""
    from gpu_feature_discovery_tpu_torch.native import nvml
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    t0 = time.monotonic()
    script = _test_script("torch_integration_tests", "torch-integration-tests.py")
    inv = nvml.read_inventory()
    golden = GOLDEN
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    if not PER_DEVICE_LABELS:
        # CUDA lists other GPUs than NVML's: no chip.<i>.* or chips.*.
        golden = os.path.join(build_dir, "torch-expected-output-live-h100-no-per-device.txt")
        with open(GOLDEN) as f, open(golden, "w") as g:
            g.writelines(l for l in f if "gpu\\.chip" not in l)
    scenarios = {}
    for strategy in ("none", "single", "mixed"):
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            hook_dir, launches_dir = os.path.join(tmp, "hook"), os.path.join(tmp, "launches")
            os.makedirs(hook_dir)
            os.makedirs(launches_dir)
            with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
                f.write(f"OUT = {launches_dir!r}\n" + _LAUNCH_HOOK)
            result = script.run(
                ["--backend", "gpu", "--strategy", strategy, "--with-burnin",
                 "--hostenv", script.LIVE_HOSTENV, "--golden", golden,
                 "--timeout", str(GOLDEN_TIMEOUT_S)],
                extra_env={"PYTHONPATH": os.pathsep.join(
                    p for p in (hook_dir, REPO, os.environ.get("PYTHONPATH")) if p)},
                extra_regexs=_golden_extra(strategy))
            records = pod_launches({"launches_dir": launches_dir})
        check(result["labels"] is not None, f"golden {strategy}: the oneshot failed")
        labels = _grammar_checked(dict(l.split("=", 1) for l in result["labels"]),
                                  f"golden {strategy}")
        scenarios[strategy] = {
            "labels": len(labels), "unexpected": result["unexpected"],
            "missing": result["missing"], "seconds": result["seconds"],
            "launches": [r["launches"] for r in records],
            "library": sorted({os.path.basename(r["library"] or "") for r in records})}
        check(result["ok"], f"golden {strategy}: {scenarios[strategy]}")
        _strategy_expectation(inv, strategy, labels)
        check(scenarios[strategy]["launches"] == [healthcheck.PROBE_HBM_ITERS + 1],
              f"golden {strategy}: hbm_stream_sum launches per process "
              f"{scenarios[strategy]['launches']}, want 1 + {healthcheck.PROBE_HBM_ITERS}")
    entries["hbm_stream_sum"]["golden_launches"] = {
        s: sum(r["launches"]) for s, r in scenarios.items()}
    emit("golden", nvidia_smi=smi, golden=os.path.relpath(GOLDEN, REPO),
         per_device_labels=PER_DEVICE_LABELS, scenarios=scenarios,
         grammar_checked=dict(GRAMMAR_CHECKED), wall_s=time.monotonic() - t0)
    return scenarios


def main(argv=None) -> int:
    import argparse
    import importlib.util

    import torch

    parser = argparse.ArgumentParser(description="On-card smoke run of the PyTorch port.")
    parser.add_argument("--seed", type=int, default=0,
                        help="numpy seed of the kernels phase's sweep")
    global SEED
    SEED = parser.parse_args(argv).seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if importlib.util.find_spec("gpu_feature_discovery_tpu_torch") is None:
        print("chip_smoke: gpu_feature_discovery_tpu_torch not found beside "
              "this script; run it from the repo root", file=sys.stderr)
        return 2
    info = phase_device()
    ptxas = phase_build()
    entries = {"hbm_stream_sum": phase_kernels(ptxas["hbm_stream_sum"]),
               "rms_epilogue": phase_rms_epilogue(ptxas["rms_epilogue"])}
    phase_collectives(info["count"])
    phase_main_path(entries, info["count"])
    facts = phase_host_facts(info["count"])
    cli = phase_daemon(entries, info["count"], info["nvidia_smi"])
    # NVML's cost in a fresh process against the first acquisition of a
    # fresh CLI (the broker worker's spawn) and its first full write, for
    # the first-write item of the roadmap.
    emit("nvml_vs_acquire", nvml_init_ms=facts["nvml_init_ms"],
         nvml_enumerate_ms=facts["nvml_enumerate_ms"],
         gpu_acquire_ms=cli["first_cycle"]["gpu.acquire"],
         restart_to_labels_s=cli["restart_to_labels_s"])
    phase_broker(entries, info["count"], facts["labels"])
    phase_config_registry(entries, facts["labels"]["nvidia.com/gpu.product"],
                          info["nvidia_smi"])
    phase_slice(entries, info["nvidia_smi"])
    phase_actuation(entries, info["nvidia_smi"])
    phase_deploy(entries, info["nvidia_smi"])
    phase_mig(entries, info["nvidia_smi"])
    phase_busy(entries, info["nvidia_smi"])
    phase_chaos(entries, info["nvidia_smi"])
    phase_golden(entries, info["nvidia_smi"])
    phase_docs()
    # What serving and recording metrics cost, beside the card.
    emit("metrics", nvidia_smi=info["nvidia_smi"],
         scrape_ms_median=statistics.median(cli["scrape_ms"]),
         scrape_ms_max=max(cli["scrape_ms"]), scrapes=len(cli["scrape_ms"]),
         exposition=cli["exposition"],
         restart_to_labels_s=cli["restart_to_labels_s"],
         first_probe_compile_s=cli["first_probe_compile_s"],
         broker_request_duration=cli["broker_request_duration"],
         daemon_steady_probing_wall_ms=cli["daemon_steady_probing_wall_ms"],
         daemon_cached_wall_ms=cli["daemon_cached_wall_ms"])
    print(json.dumps({"kernels": list(entries.values())}))
    print(info["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
