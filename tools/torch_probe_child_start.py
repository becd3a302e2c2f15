"""How long the one-shot probe child of the ``probe.timeout:fail:2`` chaos
row takes, spawn to answer, against its 0.5 s ``--probe-timeout``; and the
twin's child on the same row.

The row's daemon (``tests/torch_chaos_run.py``, ``--probe-broker=off``,
subprocess isolation) acquires its backend through
``sandbox/probe.py:acquire_snapshot_manager``: one child per acquisition
runs ``select+snapshot`` on ``mock-gpu:4``. The port's child is a fresh
interpreter (``python -m ...sandbox.worker_main probe``); the twin's is a
fork of the daemon. The budget bounds the whole child, its start
included, so a slow start under load is a real kill.

    python3 tools/torch_probe_child_start.py [--n 40] [--load K]
        [--port-root DIR] [--twin]

``--load K`` runs K busy-loop processes beside the measurement (a loaded
host); ``--port-root`` imports the port from another checkout (a parent
commit unpacked with ``git archive``); ``--twin`` also times the twin's
forked child. The stages of the port's child are timed apart in fresh
interpreters: the interpreter alone, the child's imports, the op. Prints
one JSON line per measurement, with the host's CPU count. Runs on the
CPU; touches no device."""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUDGET_S = 0.5  # the row's --probe-timeout

STAGES = r"""
import time, sys, json
t0 = time.perf_counter()
import gpu_feature_discovery_tpu_torch.sandbox.worker_main as wm
from gpu_feature_discovery_tpu_torch.config.spec import config_from_dict, config_to_dict
t1 = time.perf_counter()
from gpu_feature_discovery_tpu_torch.config.flags import new_config
doc = config_to_dict(new_config(cli_values={"oneshot": False}, environ={"TFD_BACKEND": "mock-gpu:4"}))
t2 = time.perf_counter()
config = config_from_dict(doc)
wm._select_and_snapshot(config, {"backend": None})
t3 = time.perf_counter()
print(json.dumps({"imports_s": t1 - t0, "op_s": t3 - t2, "modules": len(sys.modules)}))
"""


def _burn():
    while True:
        pass


def _summary(name, samples, **extra):
    samples = sorted(samples)
    return {"what": name, "n": len(samples), "median_s": statistics.median(samples),
            "p90_s": samples[max(0, int(0.9 * len(samples)) - 1)], "max_s": samples[-1],
            "over_budget": sum(s > BUDGET_S for s in samples), "budget_s": BUDGET_S, **extra}


def port_child(n: int) -> list:
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.sandbox.probe import run_probe

    os.environ["TFD_BACKEND"] = "mock-gpu:4"
    config = new_config(cli_values={"oneshot": False}, environ={})
    out = []
    for _ in range(n):
        result = run_probe("select+snapshot", config, 10.0)
        assert result.status == "ok", result
        out.append(result.duration_s)
    return out


def twin_child(n: int) -> list:
    from gpu_feature_discovery_tpu.config import new_config
    from gpu_feature_discovery_tpu.sandbox.probe import acquire_snapshot_manager

    os.environ["TFD_BACKEND"] = "mock:v4-8"
    config = new_config(cli_values={"oneshot": False}, environ={})
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        acquire_snapshot_manager(config, 10.0)
        out.append(time.perf_counter() - t0)
    return out


def stages(n: int, env: dict) -> dict:
    bare, staged = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "pass"], check=True, env=env, cwd="/")
        bare.append(time.perf_counter() - t0)
        staged.append(json.loads(subprocess.run(
            [sys.executable, "-c", STAGES], check=True, env=env, capture_output=True,
            text=True, cwd="/").stdout))
    return {"what": "port child stages", "n": n,
            "interpreter_s": statistics.median(bare),
            "imports_s": statistics.median(s["imports_s"] for s in staged),
            "op_s": statistics.median(s["op_s"] for s in staged),
            "modules": staged[0]["modules"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=40)
    parser.add_argument("--load", type=int, default=0, help="busy-loop processes beside")
    parser.add_argument("--port-root", default=str(REPO),
                        help="the checkout whose gpu_feature_discovery_tpu_torch to time")
    parser.add_argument("--twin", action="store_true", help="also time the twin's child")
    args = parser.parse_args(argv)
    root = str(Path(args.port_root).resolve())
    sys.path.insert(0, root)
    if args.twin:
        sys.path.insert(1, str(REPO))
    env = dict(os.environ, PYTHONPATH=root)
    os.environ["PYTHONPATH"] = root  # the spawned probe child's import root
    burners = [multiprocessing.Process(target=_burn, daemon=True) for _ in range(args.load)]
    for p in burners:
        p.start()
    try:
        common = {"load": args.load, "cpus": os.cpu_count(), "port_root": root}
        print(json.dumps(_summary("port child, spawn to answer", port_child(args.n), **common)))
        print(json.dumps(dict(stages(max(3, args.n // 8), env), **common)))
        if args.twin:
            print(json.dumps(_summary("twin child, fork to answer", twin_child(args.n), **common)))
    finally:
        for p in burners:
            p.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
