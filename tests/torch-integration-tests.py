#!/usr/bin/env python3
"""Tier-3 integration test of the PyTorch port: run the real daemon of
``gpu_feature_discovery_tpu_torch`` end to end and diff its whole output
file against a golden regex file in both directions (no missing label,
no unexpected label).

The port's counterpart of tests/integration-tests.py, with the same
contract: the daemon runs once (``--oneshot``), the script waits for the
label file, then every written line must consume exactly one golden
regex and every golden regex must be consumed (tests/golden_utils.py).
By default the daemon runs as a subprocess, over a mock backend on any
machine or over ``--backend gpu`` on a GPU node; ``--image`` runs the
port's container image (deployments/torch/container/) instead.

It imports neither JAX, the JAX package nor yaml, so it runs as it is on
a GPU machine that has none of them.

Usage:
  python tests/torch-integration-tests.py                    # mock-nvml:none, two H100s
  python tests/torch-integration-tests.py --backend mock-nvml:mixed \\
      --strategy mixed --golden tests/torch-expected-output-mig-mixed.txt
  python tests/torch-integration-tests.py --backend gpu --with-burnin \\
      --hostenv "ACCELERATOR_TYPE=h100-1;TOPOLOGY=1x1;WRAP=false,false;WORKER_ID=0;WORKER_HOSTNAMES=localhost" \\
      --golden tests/torch-expected-output-live-h100.txt    # on one H100
  python tests/torch-integration-tests.py --image IMG         # docker mode
"""

import argparse
import contextlib
import io
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FEATURES_D = "/etc/kubernetes/node-feature-discovery/features.d"

sys.path.insert(0, HERE)
from golden_utils import check_labels, load_golden_regexs  # noqa: E402

# The host keys hostinfo/gpu_env.py reads (the twin's unprefixed
# spellings): scrubbed from the caller's environment, so a GPU node's own
# slice facts never leak into the golden diff; --hostenv sets them.
HOST_KEYS = frozenset({
    "ACCELERATOR_TYPE", "TOPOLOGY", "WORKER_ID", "WORKER_HOSTNAMES",
    "HOST_BOUNDS", "CHIPS_PER_HOST_BOUNDS", "WRAP", "MACHINE_TYPE",
    "AGENT_WORKER_NUMBER",
})
# The made-up host of the live scenario on one GPU, as the twin's live
# test makes up a one-host v5litepod-4 (tests/test_pjrt_live.py:252-262):
# one worker, so no multi-host labels, and the deployment's own topology.
LIVE_HOSTENV = ("ACCELERATOR_TYPE=h100-1;TOPOLOGY=1x1;WRAP=false,false;"
                "WORKER_ID=0;WORKER_HOSTNAMES=localhost")
# The probe's test-only opt-ins pass through the scrub of TFD_*: the CPU
# burn-in (TFD_BURNIN_ALLOW_CPU) and its geometry.
PASS_THROUGH = ("TFD_BURNIN_",)


def parse_hostenv(hostenv):
    """"K=V;K2=V2" -> {K: V, K2: V2}."""
    out = {}
    for pair in (hostenv or "").split(";"):
        key, _, value = pair.partition("=")
        if key.strip():
            out[key.strip()] = value.strip()
    return out


def wait_for_file(path, timeout_s, proc=None):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return True
        if proc is not None and proc.poll() is not None:
            return os.path.exists(path)
        time.sleep(0.2)
    return False


def daemon_flags(args):
    flags = ["--oneshot", "true", "--tpu-topology-strategy", args.strategy]
    if args.with_burnin:
        flags.append("--with-burnin")
    return flags


def read_labels(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def golden_diff(regexs, labels):
    """tests/golden_utils.py's bidirectional diff, its report kept:
    (ok, the label lines no regex matched, the regexs no line matched)."""
    report = io.StringIO()
    with contextlib.redirect_stderr(report):
        ok = check_labels(regexs, labels)
    lines = report.getvalue().splitlines()
    unexpected = [l.split(": ", 1)[1] for l in lines if l.startswith("Unexpected label: ")]
    missing = [l.split(": ", 1)[1] for l in lines
               if l.startswith("Missing label matching regex: ")]
    return ok, unexpected, missing


def run_subprocess_mode(args, out_dir, extra_env=None):
    env = {
        k: v
        for k, v in os.environ.items()
        if not (k.startswith("TFD_") and not k.startswith(PASS_THROUGH))
        and k not in HOST_KEYS
    }
    env["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    env["TFD_BACKENDS"] = args.backend
    if args.hostenv:
        # A made-up slice host: the fixture's keys replace the scrubbed
        # ones, and synthesized NVIDIA PCI functions stand in for the bus
        # on a mock backend (a real GPU node reads its own sysfs).
        if args.backend != "gpu":
            env["TFD_MOCK_PCI"] = "1"
        env.update(parse_hostenv(args.hostenv))
    else:
        env["TFD_HERMETIC"] = "1"
    env.update(extra_env or {})
    out_file = os.path.join(out_dir, "tfd")
    cmd = [sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
           "--output-file", out_file, *daemon_flags(args)]
    if args.config:
        cmd += ["--config-file", os.path.abspath(args.config)]
    # Its own process group, so a hang is killed as a unit with any child.
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)
    ok = wait_for_file(out_file, args.timeout, proc)
    try:
        rc = proc.wait(timeout=args.timeout)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        proc.wait()
        print("Daemon hung; killed", file=sys.stderr)
        return None
    if rc != 0:
        print(f"Daemon exited {rc}", file=sys.stderr)
        return None
    if not ok:
        print("Daemon never wrote the output file", file=sys.stderr)
        return None
    return read_labels(out_file)


def run_docker_mode(args, out_dir):
    out_file = os.path.join(out_dir, "tfd")
    cmd = ["docker", "run", "--rm", "--privileged",
           "-v", f"{out_dir}:{FEATURES_D}",
           "-e", f"TFD_BACKENDS={args.backend}",
           "-e", "TFD_HERMETIC=1"]
    if args.backend in ("gpu", "auto", "native"):
        cmd += ["--gpus", "all"]
    cmd += [args.image, *daemon_flags(args)]
    subprocess.run(cmd, check=True, timeout=args.timeout)
    if not os.path.exists(out_file):
        print("Container never wrote the output file", file=sys.stderr)
        return None
    return read_labels(out_file)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", help="docker image (default: subprocess mode)")
    parser.add_argument("--backend", default="mock-nvml:none",
                        help="the daemon's --backends value")
    parser.add_argument("--strategy", default="none",
                        help="the daemon's --tpu-topology-strategy value")
    parser.add_argument(
        "--hostenv",
        help="semicolon-separated KEY=VALUE host facts of a slice worker "
        "(WORKER_ID, WORKER_HOSTNAMES, ...; subprocess mode only)",
    )
    parser.add_argument("--config", help="config file passed as --config-file")
    parser.add_argument("--with-burnin", action="store_true",
                        help="run the daemon with --with-burnin")
    parser.add_argument(
        "--golden", default=os.path.join(HERE, "torch-expected-output-h100x2.txt"))
    parser.add_argument("--timeout", type=float, default=120.0)
    args = parser.parse_args(argv)
    if args.image and args.hostenv:
        parser.error("--hostenv requires subprocess mode (no --image)")
    if args.image and args.config:
        parser.error("--config requires subprocess mode (no --image)")
    return args


def run(argv=None, extra_env=None, extra_regexs=()):
    """One scenario: {"ok", "labels" (None when the daemon failed),
    "unexpected", "missing", "seconds"}. ``extra_env`` goes to the
    daemon last (subprocess mode); ``extra_regexs`` join the golden's."""
    args = parse_args(argv)
    regexs = load_golden_regexs(args.golden) + list(extra_regexs)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as out_dir:
        if args.image:
            labels = run_docker_mode(args, out_dir)
        else:
            labels = run_subprocess_mode(args, out_dir, extra_env)
    result = {"ok": False, "labels": labels, "unexpected": [], "missing": [],
              "seconds": time.monotonic() - t0}
    if labels is not None:
        result["ok"], result["unexpected"], result["missing"] = golden_diff(regexs, labels)
    return result


def main(argv=None):
    print("Running integration tests for the PyTorch port")
    result = run(argv)
    if result["labels"] is None:
        return 1
    print(f"{len(result['labels'])} labels written")
    for label in result["unexpected"]:
        print(f"Unexpected label: {label}", file=sys.stderr)
    for pattern in result["missing"]:
        print(f"Missing label matching regex: {pattern}", file=sys.stderr)
    if not result["ok"]:
        print("Integration tests failed", file=sys.stderr)
        return 1
    print("Integration tests done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
