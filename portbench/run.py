"""Run one cell of the benchmark of ``gpu_feature_discovery_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine whose CUDA devices the cell
asks for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, when
traced, ``breakdown``; and last ``checks``: each number compared with its
limit, also the last lines of standard error. Without the cell's CUDA
devices, or when any process of the run held JAX or the JAX package or
left no record of the modules it held, it exits non-zero and prints no
result.

``--config``, ``--traffic`` and ``--chips`` in place of ``--workload`` run
a pairing that ``BENCHMARK.json`` does not list (a trial).

The daemon's workload is a closed loop of its own labeling cycles, so no
input is drawn: ``--seed`` is recorded in the result and changes nothing
(the probe's inputs are the program's, drawn on the card from seed 0, and
the reference draws them again).
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import catalog  # noqa: E402
import cell as cell_mod  # noqa: E402
import work  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--chips", type=int, default=1)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if (args.workload is None) == (args.config is None or args.traffic is None):
        p.error("give --workload, or --config and --traffic")
    return args


def _device(chips: int) -> str:
    """The CUDA devices' name, or an exit without a result."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"portbench: the cell needs {chips} CUDA device(s), found {count}\n")
        sys.exit(2)
    return torch.cuda.get_device_name(0)


def forbidden_here() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(cell_mod.FORBIDDEN))


def breakdown(traces: list) -> dict:
    ops = {}
    gaps = {}
    for t in traces:
        for name, (seconds, _count) in t["ops"].items():
            ops[name] = ops.get(name, 0.0) + seconds
        for name, seconds in t["gaps"]:
            gaps[name] = gaps.get(name, 0.0) + seconds
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    bench = catalog.load_benchmark(root)
    if args.workload is not None:
        cell = catalog.workload(bench, args.workload)
    else:
        cell = {"name": f"{args.config}.{args.traffic}", "config": args.config,
                "traffic": args.traffic, "chips": args.chips}
    config = catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    specs = catalog.metrics_for(bench, cell["name"], bool(args.trace))
    kind = _device(cell["chips"])
    from reference import labels as ref_labels
    from reference.nvml import Nvml, power_line, smi_query

    with Nvml() as nvml:
        node = nvml.node()
    want = ref_labels.expected(node, smi_query("name,driver_version,memory.total"))
    sys.stderr.write(f"portbench: {power_line()}\n")
    try:
        run = cell_mod.run_cell(root, cell, config, mix, args.seconds, bool(args.trace), kind)
    except cell_mod.RunError as e:
        sys.stderr.write(f"portbench: {e}\n")
        return 1
    metrics = {}
    for spec in specs:
        value = catalog.read_metric(spec, run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    ref = cell_mod.reference_readings(config, cell["chips"], "cuda")
    checks = cell_mod.judge(run, ref, want)
    leaked = forbidden_here()
    if leaked:
        sys.stderr.write(f"portbench: this process holds {leaked}\n")
        return 3
    non_full = (run.delta('tfd_cycles_total{outcome="degraded"}')
                + run.delta('tfd_cycles_total{outcome="failed"}'))
    result = {
        "correct": cell_mod.correct(checks),
        "attempted": run.cycles,
        "failed": int(max(0, run.cycles - len(run.probes)) + non_full),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": run.memory_peak},
    }
    if args.trace:
        devices = [d for t in run.traces for d in t["devices"].values()]
        result["device"]["busy_s"] = sum(d["busy_s"] for d in devices) / max(1, len(devices))
        result["device"]["window_s"] = max(t["host_window_s"] for t in run.traces)
        result["breakdown"] = breakdown(run.traces)
    result["checks"] = checks
    sys.stderr.write(
        f"portbench: {cell['name']} seed {args.seed} setup_s {run.setup_s} cycles {run.cycles} "
        f"probes {len(run.probes)} cpu_s {run.cpu_s} used {run.used_base} -> {run.used_end} "
        f"apps {run.apps}\n")
    if run.tenant is not None:
        fill = [u / g.memory_total_bytes for u, g in zip(run.used_tenant or [], node.gpus)]
        sys.stderr.write(
            f"portbench: tenant held {[b >> 20 for b in run.tenant['held_bytes']]} MiB, left "
            f"{[b >> 20 for b in run.tenant['free_bytes']]} MiB; used {run.used_tenant} -> "
            f"{run.busy_used} at {len(run.busy_stamps)} busy heartbeats, the fullest card "
            f"{max(fill, default=0.0)} used; released at {run.release_t}, recover_s "
            f"{run.recover_s}\n")
        if any(labels.get(mix["ready_label"]) == "true" for labels in run.busy_labels):
            # A probe that passes beside the tenant found room in its margin:
            # the traffic no longer makes the card busy for this program.
            sys.stderr.write(
                f"portbench: a probe passed beside the tenant: margin_mib "
                f"{mix['tenant']['margin_mib']} now holds the whole probe, so the busy checks "
                f"fail a sound program; the margin is re-read in a benchmark PR (PERF.md)\n")
    for t in run.traces:
        stream = work.kernel_time([t], "stream_sum")
        sys.stderr.write(f"portbench: trace of pid {t['pid']}: {t['graph']} graph, "
                         f"stream_sum {stream}, window {t['host_window_s']} s\n")
    for line in ref_labels.mismatches(run.labels, want, cell["chips"])[:10]:
        sys.stderr.write(f"portbench: label {line}\n")
    for name, c in checks.items():
        sys.stderr.write(f"check {name} {c['value']} limit {c['limit']}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
