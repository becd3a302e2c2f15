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
                  call, beside its bound and ptxas's report.
4. ``collectives``— the multi-GPU probes on every card: the timed NCCL
                  all-reduce (32 MiB per card) with its communicator's
                  first use apart and its timing gate's spins (device ms
                  beside the host's queueing ms), the ring sweeps over
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
                  against sysfs; NVML's cost beside ``gpu.acquire``.
7. ``daemon``   — the supervised daemon loop with the probe in process
                  (``--probe-broker off``): ``cmd.main.run`` on a worker
                  thread with ``--burnin-interval 2 --sleep-interval 1s``
                  (one ``daemon_cycle`` line per cycle), its /metrics
                  scraped (``tfd_broker_up`` 0, ``tfd_chip_*`` from the
                  in-process probe), SIGHUP and SIGTERM through its signal
                  queue; then the real CLI as a subprocess at its
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

Then a ``metrics`` line (the cost of a scrape, the exposition's size,
restart-to-labels, first use, the broker's request histogram and the
daemon's steady cycle times), a ``{"kernels": [...]}`` summary line, the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero without the last
line.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import os
import re
import secrets
import signal
import socket
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
    return info


def phase_build() -> list:
    """The port's one kernel source, built with nvcc (a later source gets
    its own nvcc, all started together); returns ptxas's lines."""
    from gpu_feature_discovery_tpu_torch.ops import hbm

    t0 = time.perf_counter()
    path, log = hbm.build_kernel()
    ptxas = [line for line in log.splitlines() if "ptxas" in line]
    emit(
        "build",
        seconds=time.perf_counter() - t0,
        libraries=[os.path.relpath(path, REPO)],
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
    """The multi-GPU probes on every card of the machine: the timed NCCL
    all-reduce, both ring sweeps, the DP+TP train step held against the
    same step on the CPU, the dry run, and the node probe's collective
    keys. On one card the all-reduce has one rank and the rings one
    device; their checks hold all the same."""
    import numpy as np
    import torch

    from gpu_feature_discovery_tpu_torch import entry
    from gpu_feature_discovery_tpu_torch.ops import carry, collectives, device_timing, healthcheck

    devices = [torch.device("cuda", i) for i in range(count)]
    out = {"devices": count}

    # The communicator's first use, apart: no earlier phase used NCCL.
    small = [torch.ones(1, device=d) for d in devices]
    t0 = time.perf_counter()
    collectives.all_reduce(small)
    for d in devices:
        torch.cuda.synchronize(d)
    out["nccl_first_use_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    collectives.all_reduce(small)
    for d in devices:
        torch.cuda.synchronize(d)
    out["nccl_second_use_ms"] = (time.perf_counter() - t0) * 1e3

    # The timing gate: the first spin on these devices runs
    # GATE_FIRST_CYCLES and calibrates; the probe's (3 calls) and every
    # later one (5 calls) are sized from the host's queueing time per call
    # that the last one measured.
    payload = 32 << 20
    ones = [torch.ones(payload // 4, device=d) for d in devices]
    dst = [torch.empty_like(t) for t in ones]
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
                     "held": g.held} for g in gates]
    check(all(g.held for g in gates),
          f"the host queued the all-reduces past the timing gate: {out['gates']}")
    # One rank copies its payload out of place: read once, written once.
    out["allreduce"] = {
        **probe, "device_ms": probe["seconds"] * 1e3,
        "gated_windows_ms": [w * 1e3 for w in gates[-1].windows],
        "back_to_back_ms": cuda_ms(lambda: collectives.all_reduce(ones, out=dst)),
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
    from gpu_feature_discovery_tpu_torch.ops import hbm

    capture = _PhaseCapture()
    lm_log = logging.getLogger("tfd.lm")
    lm_log.setLevel(logging.DEBUG)
    lm_log.addHandler(capture)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        out = os.path.join(tmp, "tfd")
        hbm.hbm_stream_sum.launches = 0
        t0 = time.perf_counter()
        rc = start(["--oneshot", "--with-burnin", "--backends", "gpu",
                    "--output-file", out])
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches = {"hbm_stream_sum": hbm.hbm_stream_sum.launches}
        check(rc == 0, f"oneshot cycle exited {rc}")
        with open(out) as f:
            labels = dict(line.rstrip("\n").split("=", 1) for line in f if "=" in line)
    lm_log.removeHandler(capture)
    emit("main_path", seconds=cycle_s, launches=launches, labels=labels,
         phases=capture.phases)
    want = {
        "nvidia.com/gpu.health.ok": "true",
        "nvidia.com/gpu.health.timing": "device-profiler",
        "nvidia.com/gpu.chip.0.ok": "true",
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
    check(len(inv.devices) == torch.cuda.device_count(),
          f"NVML sees {len(inv.devices)} GPUs, torch {torch.cuda.device_count()}")
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version,name,memory.total,pci.bus_id,"
         "mig.mode.current,compute_cap", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    check(len(rows) == len(inv.devices), f"nvidia-smi rows {rows}")
    for dev, row in zip(inv.devices, rows):
        driver, name, memory, bus_id, mig_mode, cc = [f.strip() for f in row.split(",")]
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

    gpu = _oneshot_labels("--backends", "gpu")
    native = _oneshot_labels("--backends", "native")
    diff = sorted(set(gpu.items()) ^ set(native.items()))
    check(not diff, f"--backends native and gpu differ: {diff}")
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
    return _samples(body)


def _read_labels(path: str) -> dict:
    try:
        with open(path) as f:
            return dict(l.rstrip("\n").split("=", 1) for l in f if "=" in l)
    except FileNotFoundError:
        return {}


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


def phase_daemon(entries: dict, count: int) -> dict:
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
        for i in range(count):
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
         chip_ok=[scraped[("tfd_chip_ok", f'{{chip="{i}"}}')] for i in range(count)],
         first_probe_compile_s=scraped[("tfd_first_probe_compile_seconds", "")])
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
        check(obs_metrics.CHIP_OK.value(chip="0") == 1,
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


def main() -> int:
    import importlib.util

    import torch

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
    entries = {"hbm_stream_sum": phase_kernels(ptxas)}
    phase_collectives(info["count"])
    phase_main_path(entries, info["count"])
    facts = phase_host_facts(info["count"])
    cli = phase_daemon(entries, info["count"])
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
