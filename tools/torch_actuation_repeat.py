#!/usr/bin/env python3
"""chip_smoke.py's ``actuation`` phase on a CUDA card, N times in one
process.

Run from the repo root on a CUDA card that nothing else uses:

    python3 tools/torch_actuation_repeat.py N

Each repetition runs the phase as the script does (three CLI daemons as
one slice, worker 1 SIGKILLed and restarted on its state) with all of its
checks. Prints the phase's line and then one JSON line per repetition:
whether it passed (or the check that failed), its seconds, and
``dead_file_samples_after_restart``, the samples taken between worker 1's
restart and its new process's first write, when its file was still the
killed process's last one. Then the card's name and power limit
(nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("repetitions", type=int)
    args = parser.parse_args()

    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("torch_actuation_repeat: no CUDA device", file=sys.stderr)
        return 2
    info = smoke.phase_device()
    for i in range(args.repetitions):
        t0 = time.monotonic()
        row = {"repetition": i}
        try:
            out = smoke.phase_actuation({"hbm_stream_sum": {}}, info["nvidia_smi"])
            row.update(ok=True, dead_file_samples_after_restart=out[
                "dead_file_samples_after_restart"],
                restart_to_first_write_s=out["restart_to_first_write_s"])
        except SystemExit as e:
            row.update(ok=False, error=str(e))
        row["seconds"] = time.monotonic() - t0
        print(json.dumps(row), flush=True)
    print(info["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
