#!/usr/bin/env python3
"""Where the PyTorch port's health probe spends its time on a CUDA card.

Run from the repo root on a CUDA card, in a fresh process:

    python3 tools/torch_probe_breakdown.py [--size 2048] [--depth 4] [--thread]

Prints one JSON line per measurement, then the card's name and power
limit (nvidia-smi). Two groups, at the probe geometry with the probe's
own inputs (ops/healthcheck.py):

First use, host ms around a synchronised call, in the order the first
probe of a process meets them (the probe's ``compile_ms`` phase); with
``--thread`` they run on a worker thread, as the daemon's and the label
engine's probes do:

- ``first_cuda_context``: the first allocation on the device;
- ``first_workspace``: generating the burn-in inputs;
- ``first_burnin``: the first ``burnin_step`` (cuBLAS set-up);
- ``first_graph``: capturing the probe's CUDA graph of the pass
  (``ops/healthcheck.py:_burnin_graph``, a side-stream warm pass
  included);
- ``first_hbm``: the first ``hbm_stream_sum`` (library load; the nvcc
  build runs before, untimed);
- ``first_nccl``: the first one-device ``torch.cuda.nccl.all_reduce``.

Steady state, device ms by CUDA events after warm-up, per pass or call:

- ``probe_window``: one eager pass between an event pair;
- ``probe_replay``: one replay of the probe's CUDA graph of the pass
  between an event pair, as the probe times it;
- ``back_to_back``: many eager passes between one event pair;
- ``host_enqueue``: host time to queue one eager pass (no synchronisation);
- ``graph_replay``: many replays of the probe's graph between one event
  pair;
- ``mm_f32_out`` / ``mm_bf16_out``: one product alone, f32 and bf16 out;
- ``epilogue``: the RMS normalisation of one layer alone.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck  # noqa: E402

REPS = 20


def events_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call, ``reps`` calls between one event pair, after
    ``warmup`` untimed calls (the first call of an op pays its set-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def window_ms(fn, reps: int) -> float:
    """Median device ms of ``reps`` single-call event windows."""
    return statistics.median(events_ms(fn, 1, warmup=0) for _ in range(reps))


def host_ms(fn) -> float:
    """Host ms of one call, synchronised."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def emit(name: str, ms: float, flops: float = 0.0) -> None:
    print(json.dumps({"measure": name, "ms": ms,
                      "tflops": flops / (ms / 1e3) / 1e12 if flops else None}))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=healthcheck.CUDA_PROBE_SIZE)
    parser.add_argument("--depth", type=int, default=healthcheck.CUDA_PROBE_DEPTH)
    parser.add_argument("--thread", action="store_true",
                        help="run the first-use measures on a worker thread")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    size, depth = args.size, args.depth
    pass_flops = healthcheck.burnin_flops(size, depth)
    mm_flops = 2.0 * size**3

    hbm.build_kernel()

    def first_use():
        with torch.cuda.device(dev):
            emit("first_cuda_context", host_ms(lambda: torch.empty(1, device=dev)))
            buf = hbm.stream_pattern(hbm.probe_rows(healthcheck.PROBE_HBM_MIB), dev)
            emit("first_workspace", host_ms(lambda: healthcheck._burnin_workspace(
                dev, size, depth, torch.bfloat16)))
            x, ws = healthcheck._burnin_workspace(dev, size, depth, torch.bfloat16)
            emit("first_burnin", host_ms(lambda: healthcheck.burnin_step(x, ws)))
            emit("first_graph", host_ms(
                lambda: healthcheck._burnin_graph(dev, size, depth)))
            emit("first_hbm", host_ms(lambda: hbm.hbm_stream_sum(buf)))
            import torch.cuda.nccl as nccl

            emit("first_nccl", host_ms(lambda: nccl.all_reduce(
                [torch.ones(1, dtype=torch.int32, device=dev)])))

    if args.thread:
        worker = threading.Thread(target=first_use)
        worker.start()
        worker.join()
    else:
        first_use()
    x, ws = healthcheck._burnin_workspace(dev, size, depth, torch.bfloat16)
    step = lambda: healthcheck.burnin_step(x, ws)  # noqa: E731

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    emit("probe_window", window_ms(step, REPS), pass_flops)
    emit("back_to_back", events_ms(step, REPS), pass_flops)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / REPS
    torch.cuda.synchronize()
    emit("host_enqueue", enqueue_ms)

    graph, _, _ = healthcheck._burnin_graph(dev, size, depth)
    emit("probe_replay", window_ms(graph.replay, REPS), pass_flops)
    emit("graph_replay", events_ms(graph.replay, REPS), pass_flops)

    w = ws[0]
    emit("mm_f32_out", events_ms(
        lambda: torch.mm(x, w, out_dtype=torch.float32), REPS), mm_flops)
    emit("mm_bf16_out", events_ms(lambda: torch.mm(x, w), REPS), mm_flops)
    y = torch.mm(x, w, out_dtype=torch.float32)

    def epilogue():
        rms = torch.sqrt(torch.mean(torch.square(y)) + 1e-6)
        return (y / rms).to(torch.bfloat16)

    emit("epilogue", events_ms(epilogue, REPS))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
