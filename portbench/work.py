"""The yardstick's arithmetic: the work each probe kernel must do at the
configuration's geometry, the chip's published peaks, and the statistics
the end-to-end metrics take. A roofline share reads the same work
whatever implements it."""

import re
import statistics
from typing import Dict, List, Optional, Tuple

# Published peaks (NVIDIA H100 SXM data sheet, at its 700 W limit): dense
# bf16 tensor FLOP/s, HBM3 bytes/s, and NVLink 4's bytes/s per direction
# (900 GB/s both ways).
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12,
                              "nvlink_bytes": 450e9},
}

# NCCL's kernels, and among them the float32 all-reduce's, whose name
# carries the element type (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``;
# ``..._Sum_float`` before NCCL 2.19).
NCCL_KERNEL = re.compile(r"^nccl")
NCCL_ALLREDUCE_F32 = re.compile(r"^nccl\w*AllReduce\w*?_(?:f32|float)(?=_|\(|$)")


def burnin_flops(size: int, depth: int) -> float:
    """One burn-in pass: ``depth`` products of two (size, size) matrices."""
    return 2.0 * depth * size ** 3


def burnin_bytes(size: int, depth: int) -> float:
    """One pass reads its bf16 input and weights once."""
    return 2.0 * (1 + depth) * size * size


def stream_bytes(hbm_mib: int) -> float:
    """One stream launch reads the whole float32 buffer once."""
    from reference.stream import LANES, rows_for

    return float(rows_for(hbm_mib) * LANES * 4)


def ring_bus_bytes(n: int, mib: int) -> float:
    """One ring all-reduce of ``mib`` MiB per card over ``n`` cards: each
    card sends 2(n-1)/n of its payload (and receives as much)."""
    return 2.0 * (n - 1) / n * (mib << 20)


def bound_s(flops: float, nbytes: float, peaks: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])


def p95(values: List[float]) -> float:
    """The 95th percentile, interpolated between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def spread(values: List[float]) -> float:
    """The distance between the first and the third quartile over the
    median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def share(bound: float, measured: Optional[float]) -> Optional[float]:
    """A roofline share in %, or None when nothing was measured."""
    if not measured:
        return None
    return 100.0 * bound / measured


def kernel_time(traces: List[dict], function: str) -> Tuple[float, int]:
    """Device seconds and launches of every kernel whose function is
    named ``function`` (its name up to the argument list, any namespace
    before it), over the traces."""
    return ops_time(traces, re.compile(r"(^|::|\s)" + re.escape(function) + r"(\(|<|$)"))


def ops_time(traces: List[dict], pattern: "re.Pattern") -> Tuple[float, int]:
    """Device seconds and launches of every operation whose name
    ``pattern`` finds, over the traces (each device's launch counted)."""
    seconds, count = 0.0, 0
    for trace in traces:
        for name, (s, n) in trace["ops"].items():
            if pattern.search(name):
                seconds += s
                count += n
    return seconds, count


def per_probe_ms(run, seconds: float) -> Optional[float]:
    """Device seconds over the probes that ended inside a trace's window,
    in ms; None where no probe did or no device second was read."""
    probes = sum(1 for t in run.traces for r in run.records if t["t0"] <= r["t"] <= t["t1"])
    return seconds / probes * 1e3 if probes and seconds > 0 else None
