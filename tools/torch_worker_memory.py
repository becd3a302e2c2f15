#!/usr/bin/env python3
"""A broker worker's card memory after its first probe, by when its first
health request comes; and two probes on threads of one process.

Run from the repo root on a CUDA card that nothing else uses:

    python3 tools/torch_worker_memory.py N

First, in fresh processes, two probes (``measure_node_health``) on two
threads: one after the other, and the second while the first thread
still lives; each prints the card memory the process took. Then N times
each, a broker worker with ``--with-burnin``: its first health request
at once after the spawn (it meets the pre-warm, as the reconcile wake's
does) and 12 s after it (the pre-warm done); each prints the worker's
steady ``memory.used`` above the card's before. Then the card's name and
power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# Run in a fresh process per mode: the card memory two probes on threads
# take, the second after the first thread ended or while it lives.
_THREAD_PAIR = '''
import json, sys, threading, torch
from gpu_feature_discovery_tpu_torch.ops import healthcheck

mode, devices = sys.argv[1], [torch.device("cuda", 0)]
torch.cuda.init()
free0, _ = torch.cuda.mem_get_info()


def probe():
    healthcheck.measure_node_health(devices=devices)


if mode == "one-after-the-other":
    for _ in range(2):
        t = threading.Thread(target=probe)
        t.start()
        t.join()
else:
    probed, hold = threading.Event(), threading.Event()
    a = threading.Thread(target=lambda: (probe(), probed.set(), hold.wait()))
    a.start()
    probed.wait()
    b = threading.Thread(target=probe)
    b.start()
    b.join()
    hold.set()
    a.join()
torch.cuda.synchronize()
free1, _ = torch.cuda.mem_get_info()
print(json.dumps({"threads": mode, "used_mib": (free0 - free1) >> 20,
                  "reserved_mib": torch.cuda.memory_reserved() >> 20}), flush=True)
'''


def _used_mib() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return int(out.split()[0])


def _steady_mib() -> int:
    """memory.used once two readings 0.5 s apart agree within 2 MiB."""
    last = _used_mib()
    while True:
        time.sleep(0.5)
        now = _used_mib()
        if abs(now - last) <= 2:
            return now
        last = now


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("repetitions", type=int)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_worker_memory: no CUDA device", file=sys.stderr)
        return 2
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    for mode in ("one-after-the-other", "second-while-first-lives") * 2:
        subprocess.run([sys.executable, "-c", _THREAD_PAIR, mode], env=env, check=True)

    broker.HEALTH_WAIT_S = 25.0
    base = _steady_mib()
    for mode in ("at-once", "after-prewarm") * args.repetitions:
        with tempfile.TemporaryDirectory() as tmp:
            config = new_config(cli_values={
                "backends": "gpu", "with-burnin": True, "burnin-interval": "1",
                "output-file": os.path.join(tmp, "tfd"), "probe-timeout": "60s"}, environ={})
            client = broker.BrokerClient(config)
            t0 = time.monotonic()
            client.ping()
            if mode == "after-prewarm":
                time.sleep(12)
            outcome = client.health()
            worker = _steady_mib() - base
            client.close()
            print(json.dumps({"first_health": mode, "status": outcome.get("status"),
                              "worker_mib": worker,
                              "seconds": time.monotonic() - t0}), flush=True)
            time.sleep(1)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
