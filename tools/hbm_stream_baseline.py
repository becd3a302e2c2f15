#!/usr/bin/env python3
"""The HBM stream sum's two designs on a CUDA card, timed in turns.

Run from the repo root on a CUDA card:

    python3 tools/hbm_stream_baseline.py [--rounds 5]

Builds the first, two-launch design (``tools/csrc/hbm_stream_sum_two_pass.cu``)
and the kernel the probe runs (``ops/csrc/hbm_stream_sum.cu`` through
``ops/hbm.py``), and times them on the probe's 256 MiB pattern buffer
with ``chip_smoke.in_turns`` (windows of 20 back-to-back calls between
CUDA events, in turns and then in reverse, medians over the rounds):

- ``two_pass``: both launches of the first design;
- ``pass1``: its first launch alone (``pass2_ms`` is the difference);
- ``kernel``: ``hbm_stream_sum``, the probe's kernel;
- ``torch_sum_f32``: ``torch.sum(buf)``, the yardstick.

Prints one JSON line with ptxas's report, the medians beside the bound
(256 MiB over 3.35 TB/s), then the card's name and power limit
(nvidia-smi). Exits 1 if a design's sum is not exact.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from chip_smoke import HBM_BYTES_PER_S, in_turns  # noqa: E402
from gpu_feature_discovery_tpu_torch.ops import hbm, kernel_cache  # noqa: E402

TWO_PASS_SOURCE = REPO / "tools" / "csrc" / "hbm_stream_sum_two_pass.cu"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lib_path, two_pass_log = kernel_cache.build_library(TWO_PASS_SOURCE)
    lib = ctypes.CDLL(str(lib_path))
    lib.two_pass_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.two_pass_launch.restype = ctypes.c_int
    _, kernel_log = hbm.build_kernel()

    rows = hbm.probe_rows(256)  # the probe's buffer (ops/healthcheck.py)
    buf = hbm.stream_pattern(rows, dev)
    num_chunks = rows // hbm.CHUNK_ROWS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(num_chunks, 4 * sms)
    partials = torch.empty(blocks, dtype=torch.float64, device=dev)
    out = torch.empty((1, 1), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(final):
        """Pass 1, and pass 2 after it when ``final`` (out = None)."""
        def launch():
            rc = lib.two_pass_launch(buf.data_ptr(), num_chunks, partials.data_ptr(),
                                     blocks, out.data_ptr() if final else None, stream)
            if rc:
                raise RuntimeError(f"two_pass_launch: cudaError {rc}")
        return launch

    expected = hbm.expected_stream_sum(rows)
    launcher(True)()
    sums = {"two_pass": out.item(), "kernel": hbm.hbm_stream_sum(buf).item(),
            "torch_sum_f32": torch.sum(buf).item()}
    inexact = sorted(name for name, v in sums.items() if v != expected)
    if inexact:
        print(f"not exact: {inexact} in {sums}, want {expected}", file=sys.stderr)
        return 1
    turns = in_turns({"two_pass": launcher(True), "pass1": launcher(False),
                      "kernel": lambda: hbm.hbm_stream_sum(buf),
                      "torch_sum_f32": lambda: torch.sum(buf)}, rounds=args.rounds)
    med = turns["median_ms"]
    bound_ms = (buf.numel() * 4 + 4) / HBM_BYTES_PER_S * 1e3
    print(json.dumps({
        "ptxas": {name: [line for line in log.splitlines() if "ptxas" in line]
                  for name, log in (("two_pass", two_pass_log), ("kernel", kernel_log))},
        "shape": list(buf.shape), "blocks_two_pass": blocks, "sms": sms,
        "median_ms": med, "pass2_ms": med["two_pass"] - med["pass1"],
        "bound_ms": bound_ms,
        "pct_of_bound": {name: 100 * bound_ms / ms for name, ms in med.items()},
        "samples_ms": turns["samples_ms"], "sums": sums,
    }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
