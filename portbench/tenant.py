"""A tenant of the card for traffic with a ``tenant`` entry: a job that
fills the card before the daemon starts, as a TensorFlow process (which
maps nearly all of a GPU's memory by default) or a PyTorch job's caching
allocator at its peak does. Plain ``torch``, nothing of the port or of the
JAX package, and never the benchmark's start-up hook.

    python3 portbench/tenant.py --margin-mib 1157

It takes every CUDA device's free memory less ``--margin-mib`` (one
allocation a device, which runs no kernel), then prints one JSON line:
``pid``, per device ``held_bytes``, ``free_bytes`` (what is left to the
daemon) and ``total_bytes``, and ``forbidden_modules`` (JAX or the JAX
package, if anything loaded them). It then waits for a line on standard
input; at ``release`` (or end of input) it frees the memory, prints
``{"released": true}`` and exits 0. Without a CUDA device it prints
nothing and exits 2.
"""

import argparse
import json
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_feature_discovery_tpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--margin-mib", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("tenant: no CUDA device\n")
        return 2
    margin = args.margin_mib << 20
    held = []
    for i in range(torch.cuda.device_count()):
        free, _ = torch.cuda.mem_get_info(i)
        held.append(torch.empty(max(0, free - margin), dtype=torch.uint8, device=f"cuda:{i}"))
    info = [torch.cuda.mem_get_info(i) for i in range(len(held))]
    sys.stdout.write(json.dumps({
        "pid": os.getpid(),
        "held_bytes": [t.numel() for t in held],
        "free_bytes": [free for free, _ in info],
        "total_bytes": [total for _, total in info],
        "forbidden_modules": sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN)),
    }) + "\n")
    sys.stdout.flush()
    sys.stdin.readline()
    del held
    torch.cuda.empty_cache()
    sys.stdout.write(json.dumps({"released": True}) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
