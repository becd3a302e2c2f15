#!/usr/bin/env python3
"""The chaos matrix's ``reconcile:broker-death`` row on a CUDA card, N
times in one process, with the card's memory at each step.

Run from the repo root on a CUDA card that nothing else uses:

    python3 tools/torch_reconcile_repeat.py N

As chip_smoke.py's ``chaos`` phase runs the row: this process warms its
own probe on a thread first, then each repetition runs the event-mode
daemon on a thread of this process (``tests/torch_chaos_run.py``
``run_reconcile_chaos``, the default 30 s ``--probe-timeout``, the
broker's health wait raised to 25 s), SIGKILLs its broker worker once it
served, and waits for the fresh full labels of the ``worker_died`` wake.
The card's steady ``memory.used`` is read before the row, with the old
worker just before the kill, with the new one at the recovery and 3 s
later, and after SIGTERM; each worker reports its own memory (the
broker's ``memory`` op: the caching allocator's reserve and allocation,
and its context's share of the card before its first allocation). The
phase checks the new worker against the old within 16 MiB; this tool
repeats the row to see how often that holds, and which process and pool
hold a difference.

Prints one JSON line per repetition, then the card's name and power
limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("repetitions", type=int)
    args = parser.parse_args()

    import torch

    import chip_smoke as smoke
    from gpu_feature_discovery_tpu_torch import sandbox
    from gpu_feature_discovery_tpu_torch.ops import hbm, healthcheck
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    if not torch.cuda.is_available():
        print("torch_reconcile_repeat: no CUDA device", file=sys.stderr)
        return 2
    info = smoke.phase_device()
    smoke.phase_build()
    driver = smoke._chaos_driver()
    # This process's own first use, on a thread as the phase pays it.
    warm = threading.Thread(target=healthcheck.measure_node_health,
                            kwargs={"devices": [torch.device("cuda", 0)], "per_chip": True})
    warm.start()
    warm.join()
    logging.getLogger("tfd").setLevel(logging.INFO)
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    for i in range(args.repetitions):
        healthcheck.release_probe_memory()
        hbm.hbm_stream_sum.launches = 0
        row = {"repetition": i, "base_mib": smoke._steady_used_mib()}
        base_used = smoke.card_used_bytes()

        def observe(stage, info, row=row, base_used=base_used):
            if stage == "before_kill":
                row["before_kill_mib"] = smoke._steady_used_mib()
                row["killed_worker_memory"] = smoke.worker_memory_mib(base_used)
            else:
                row["recovered_mib"] = smoke._steady_used_mib()
                row["new_worker_memory"] = smoke.worker_memory_mib(base_used)
                row["killed_gone"] = smoke._gone(info["killed_pid"])
                time.sleep(3.0)
                row["recovered_3s_mib"] = smoke._steady_used_mib()

        wait_s, broker.HEALTH_WAIT_S = broker.HEALTH_WAIT_S, smoke.CHAOS_HEALTH_WAIT_S
        try:
            with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
                result = driver.run_reconcile_chaos(
                    "broker-death", tmp, timeout_s=smoke.CHAOS_ROW_TIMEOUT_S, backend="gpu",
                    probe_timeout_s=smoke.CHAOS_DAEMON_PROBE_TIMEOUT_S,
                    extra_cli={"with-burnin": True, "burnin-interval": "1"}, scrape=True,
                    observe=observe)
        finally:
            broker.HEALTH_WAIT_S = wait_s
            sandbox.close_broker()
        row["after_mib"] = smoke._steady_used_mib()
        row["kill_to_full_s"] = result["kill_to_full_s"]
        row["new_minus_old_mib"] = row["recovered_mib"] - row["before_kill_mib"]
        print(json.dumps(row), flush=True)
    print(info["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
