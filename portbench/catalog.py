"""What the harness finds by name: ``BENCHMARK.json`` at the checkout's
root, each configuration in ``portbench/configs/<name>.json``, each
traffic mix in ``portbench/traffic/<name>.json`` and each metric's reader
in ``portbench/metrics/<name>.py``. A new configuration, mix or metric is
a new file; no file of the harness names one."""

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class CatalogError(ValueError):
    pass


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise CatalogError(f"not a name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise CatalogError(f"not a unit: {unit!r}")
    return unit


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise CatalogError(f"no {path}")
    return json.loads(path.read_text())


def _load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise CatalogError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("traffic", name)


def workload(bench: dict, name: str) -> dict:
    for w in bench.get("workloads", []):
        if w["name"] == name:
            return w
    raise CatalogError(f"no workload named {name!r} in BENCHMARK.json")


def reader(name: str) -> Callable:
    """The ``read(run)`` of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{check_name(name)}.py"
    if not path.is_file():
        raise CatalogError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end metrics with ``trace``
    off, its per-layer metrics with it on. A metric with a ``workloads``
    list is reported only in those cells; a per-layer metric without one
    in every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def read_metric(spec: dict, run) -> Optional[float]:
    value = reader(spec["name"])(run)
    return None if value is None else float(value)
