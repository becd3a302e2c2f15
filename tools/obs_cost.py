#!/usr/bin/env python3
"""What the observability plane costs the daemon on a CUDA card, for any
checkout of the port (this one, or an older one without ``obs/``).

Run from the repo root on a machine with a CUDA card:

    python3 tools/obs_cost.py cycles [--checkout DIR] [--cycles 40]
    python3 tools/obs_cost.py memory [--checkout DIR] [--serve] [--scrapes 20]

- ``cycles``: ``cmd.main.run`` of the checkout in this process with the
  probe in process (``--probe-broker off --with-burnin --backends gpu
  --burnin-interval 2 --sleep-interval 0.2s``), as ``chip_smoke.py``'s
  ``daemon`` phase runs it, for ``--cycles`` cycles; the wall ms of each
  probing and each cached cycle after the first probe (which pays first
  use; the cycles before it acquire the backend and wait for it), from
  the "Cycle timings" line. A checkout that
  has the introspection server serves on a free port of 127.0.0.1, as a
  deployed daemon serves.
- ``memory``: the checkout's CLI at its defaults (through the broker
  worker), until health labels are on disk; with ``--serve`` its
  introspection server on a free port of 127.0.0.1, scraped
  ``--scrapes`` times, else ``--metrics-port 0`` where the checkout has
  the flag. Then the CLI process's VmRSS, RssAnon and RssFile (KiB) and
  the shared libraries it maps.

Each prints one JSON line, then the card's name and power limit
(nvidia-smi). Compare checkouts only within one call, in turns.
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import queue
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _read_labels(path: str) -> dict:
    try:
        with open(path) as f:
            return dict(l.rstrip("\n").split("=", 1) for l in f if "=" in l)
    except FileNotFoundError:
        return {}


def _wait_for(cond, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.02)
    raise SystemExit(f"obs_cost: {what} within {timeout}s")


class _Cycles(logging.Handler):
    """Wall ms per cycle from the "Cycle timings" line, with the cycle's
    mode: probing (a probe report came back) or cached."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.cycles = []
        self._probe = False

    def emit(self, record):
        msg = str(record.msg)
        if msg.startswith("burn-in probe timing="):
            self._probe = True
        elif msg.startswith("Cycle timings: "):
            stages = dict(p.split("=", 1) for p in str(record.args[0]).split())
            self.cycles.append(("probing" if self._probe else "cached",
                                float(stages["labelgen.total"].rstrip("ms"))))
            self._probe = False


def cycles(checkout: Path, n: int) -> dict:
    sys.path.insert(0, str(checkout))
    from gpu_feature_discovery_tpu_torch.cmd.main import run
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
    from gpu_feature_discovery_tpu_torch.config import flags
    from gpu_feature_discovery_tpu_torch.resource import factory

    capture = _Cycles()
    logging.getLogger("tfd").setLevel(logging.INFO)
    logging.getLogger("tfd.lm").setLevel(logging.DEBUG)
    logging.getLogger("tfd").addHandler(capture)
    serves = any(fd.name == "metrics-port" for fd in flags.FLAG_DEFS)
    with tempfile.TemporaryDirectory() as tmp:
        values = {"with-burnin": "true", "backends": "gpu", "burnin-interval": "2",
                  "sleep-interval": "0.2s", "probe-broker": "off",
                  "output-file": os.path.join(tmp, "tfd")}
        if serves:
            values.update({"metrics-addr": "127.0.0.1", "metrics-port": str(_free_port())})
        config = flags.new_config(cli_values=values, environ=dict(os.environ))
        sigs = queue.SimpleQueue()
        thread = threading.Thread(target=lambda: run(
            lambda: factory.build_manager(config), config, sigs,
            supervisor=Supervisor(config)), daemon=True)
        thread.start()
        _wait_for(lambda: len(capture.cycles) >= n, 60.0 + n, f"{n} cycles")
        sigs.put(signal.SIGTERM)
        thread.join(15)
    done = list(capture.cycles[:n])
    # Steady state: the cycles after the first probe (which pays first
    # use; the cycles before it acquire the backend and wait for it).
    first = next(i for i, (mode, _) in enumerate(done) if mode == "probing")
    probing = [ms for mode, ms in done[first + 1:] if mode == "probing"]
    cached = [ms for mode, ms in done[first + 1:] if mode == "cached"]
    return {"tool": "cycles", "checkout": str(checkout), "serves_metrics": serves,
            "cycles": len(done), "probing_wall_ms": probing, "cached_wall_ms": cached,
            "probing_median_ms": statistics.median(probing),
            "cached_median_ms": statistics.median(cached)}


def memory(checkout: Path, serve: bool, scrapes: int) -> dict:
    has_flag = "metrics-port" in (checkout / "gpu_feature_discovery_tpu_torch" / "config"
                                  / "flags.py").read_text()
    port = _free_port()
    extra = []
    if has_flag:
        extra = (["--metrics-addr", "127.0.0.1", "--metrics-port", str(port)] if serve
                 else ["--metrics-port", "0"])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tfd")
        with open(os.path.join(tmp, "log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--with-burnin",
                 "--sleep-interval", "1s", "--output-file", out, *extra],
                cwd=checkout, stdout=log, stderr=subprocess.STDOUT)
        try:
            _wait_for(lambda: _read_labels(out).get("nvidia.com/gpu.health.ok"), 120.0,
                      "health labels")
            scraped = 0
            if serve and has_flag:
                for _ in range(scrapes):
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
                    conn.request("GET", "/metrics")
                    if conn.getresponse().read():
                        scraped += 1
                    conn.close()
            with open(f"/proc/{proc.pid}/status") as f:
                status = dict(l.split(":", 1) for l in f if ":" in l)
            with open(f"/proc/{proc.pid}/maps") as f:
                libs = sorted({os.path.basename(l.split()[-1]) for l in f
                               if ".so" in l.split()[-1]})
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(30)
    kib = {k: int(status[k].split()[0]) if k in status else None
           for k in ("VmRSS", "RssAnon", "RssFile")}
    return {"tool": "memory", "checkout": str(checkout), "serves_metrics": serve and has_flag,
            "scrapes": scraped, "kib": kib, "libraries": libs}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("cycles", "memory"))
    parser.add_argument("--checkout", type=Path, default=REPO)
    parser.add_argument("--cycles", type=int, default=40)
    parser.add_argument("--serve", action="store_true")
    parser.add_argument("--scrapes", type=int, default=20)
    args = parser.parse_args()
    checkout = args.checkout.resolve()
    if args.what == "cycles":
        result = cycles(checkout, args.cycles)
    else:
        result = memory(checkout, args.serve, args.scrapes)
    print(json.dumps(result))
    print(_nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
