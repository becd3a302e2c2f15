"""The control of a cell's burn-in comparison: the plain reference put in
the program's place one precision step below the probe's bfloat16
(float8 e4m3 operands and carry, float32 sums), read against the
reference at the configuration's geometry. Its gaps must exceed the
configuration's limits, so the comparison that decides ``correct`` could
not pass a probe computed that way.

    python3 portbench/control.py --config h100x1-daemonset [--device cpu] [--repeats 3]

On the card the inputs come from the card's generator, as the probe's
do; on the CPU from the CPU's, at the same geometry.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import catalog  # noqa: E402
from reference import burnin  # noqa: E402


def readings(config: dict, device: str) -> dict:
    import torch

    probe = config["probe"]
    x, ws = burnin.inputs(probe["size"], probe["depth"], device)
    ref = burnin.run(x, ws)
    control = burnin.run(x, ws, lower=torch.float8_e4m3fn)
    gaps = burnin.gaps(control["checksum"], control["rms"], ref)
    limits = config["limits"]
    return {
        "device": device,
        "gaps": gaps,
        "fails": [k for k, v in gaps.items() if v > limits[k]],
        "limits": {k: limits[k] for k in gaps},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    config = catalog.config(args.config)
    failed_all = True
    for _ in range(args.repeats):
        out = readings(config, args.device)
        failed_all &= bool(out["fails"])
        print(json.dumps(out))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
