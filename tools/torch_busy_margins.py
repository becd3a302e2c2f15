#!/usr/bin/env python3
"""Where the PyTorch port's health probe fails on a busy CUDA card, and
what the failed attempt keeps.

Run from the repo root on a CUDA card that nothing else uses:

    python3 tools/torch_busy_margins.py MARGIN_MIB [MARGIN_MIB ...]

For each margin a holder process takes the card's free memory less the
margin and keeps it. A fresh process pinned to the card (as a MIG
device's probe child is) then warms the probe as the daemon does
(``ops/healthcheck.py:warm_probe_kernels_for``) and reports the error it
met: the exception chain's types and texts, the frames it was raised
in, the card's free memory as it was raised, whether the port reads it
as a busy device (``is_busy_error``), and the card's use by the process
after ``release_probe_memory``. The holder then exits; the card's use
against the baseline is what the failed attempt kept, and the same
process probes again (its verdict and kernel launches).

The probe is of one device, which builds no NCCL communicator
(``ops/healthcheck.py:_warm_collectives``): NCCL's room check and its own
failure apply only over several devices, which this tool does not probe.

Prints one JSON line per margin, then the card's name and power limit
(nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HOLDER = r"""
import json, sys, torch
margin = int(sys.argv[1]) << 20
free, _ = torch.cuda.mem_get_info()
held = torch.empty(free - margin, dtype=torch.uint8, device="cuda")
torch.cuda.synchronize()
after, _ = torch.cuda.mem_get_info()
print(json.dumps({"held_mib": held.numel() / 2**20, "free_mib": after / 2**20}), flush=True)
sys.stdin.read()
"""

_PROBE = r"""
import json, sys, traceback, torch
from gpu_feature_discovery_tpu_torch.ops import healthcheck as hc

dev = torch.device("cuda", 0)
out = {}

def read(fn):
    # fn(), or where the process has no CUDA context the error's text.
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - reported
        return str(e).splitlines()[0]

def free_mib():
    return torch.cuda.mem_get_info(dev)[0] / 2**20

try:
    torch.cuda.init()
    out["free_after_context_mib"] = free_mib()
    hc.warm_probe_kernels_for((dev,), per_chip=True)
    out["warm"] = "ok"
except Exception as e:  # noqa: BLE001 - reported
    chain, x = [], e
    while x is not None and len(chain) < 4:
        chain.append([type(x).__module__ + "." + type(x).__name__, str(x)[:400]])
        x = x.__cause__ or x.__context__
    out["chain"] = chain
    out["frames"] = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                     for f in traceback.extract_tb(e.__traceback__)][-4:]
    out["free_at_error_mib"] = read(free_mib)
    out["busy"] = hc.is_busy_error(e)
    out["capturing"] = read(torch.cuda.is_current_stream_capturing)
    out["on_default_stream"] = read(
        lambda: torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev))
    hc.release_probe_memory(e)
print(json.dumps(out), flush=True)
sys.stdin.readline()
report = hc.measure_node_health(devices=[dev], per_chip=True)
print(json.dumps({"healthy": report["healthy"],
                  "launches": report["phases"]["hbm_stream_sum_launches_process"]}), flush=True)
"""


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def _used_mib() -> int:
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def _steady_used_mib() -> int:
    """memory.used once two readings half a second apart agree within 2 MiB."""
    last = _used_mib()
    for _ in range(40):
        time.sleep(0.5)
        now = _used_mib()
        if abs(now - last) <= 2:
            return now
        last = now
    return now


def _card_uuid() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.split()[0]


def margin_run(margin_mib: int, uuid: str) -> dict:
    """One margin: the holder, the pinned probe's failed warm-up, what it
    kept once the holder left, and its probe after."""
    baseline = _steady_used_mib()
    holder = subprocess.Popen([sys.executable, "-c", _HOLDER, str(margin_mib)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                              env=_env())
    out = {"margin_mib": margin_mib, "holder": json.loads(holder.stdout.readline())}
    probe = subprocess.Popen([sys.executable, "-c", _PROBE],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                             env=_env(CUDA_VISIBLE_DEVICES=uuid))
    try:
        out["attempt"] = json.loads(probe.stdout.readline())
        holder.stdin.close()
        holder.wait(timeout=60)
        out["kept_mib"] = _steady_used_mib() - baseline
        probe.stdin.write("go\n")
        probe.stdin.flush()
        out["after_holder"] = json.loads(probe.stdout.readline())
    finally:
        for proc in (holder, probe):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    out["card_drift_mib"] = _steady_used_mib() - baseline
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("margins", type=int, nargs="+", metavar="MARGIN_MIB")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    from gpu_feature_discovery_tpu_torch.ops import hbm

    hbm.build_kernel()
    uuid = _card_uuid()
    for margin in args.margins:
        print(json.dumps(margin_run(margin, uuid)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
