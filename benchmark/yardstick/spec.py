"""Finds what a cell needs by the names in ``BENCHMARK.json``.

* a configuration: ``configs/<config>.json`` (the deployment's sizes);
* a traffic mix: ``traffic/<traffic>.json`` (parameters of the one
  generator in :mod:`.traffic`);
* a metric: ``metrics/<name>.py``, a reader with ``read(run)`` that returns
  a number or None (nothing to read: the metric is left out of the line);
* a kernel: ``kernels/<name>.py``, its profiler symbol, the roofline group
  it counts in, and ``work(item)``, the bytes and operations it needs;
* a correctness check: ``checks/<name>.json``, its numbers and limits.

Adding a cell, a mix, a metric or a kernel adds files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]       # the benchmark's folder
REPO = ROOT.parent                                # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(REPO / c["file"])
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def check_limits(name: str) -> dict:
    return load_json(ROOT / "checks" / f"{name}.json")


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> ModuleType:
    return _module(ROOT / "metrics" / f"{name}.py")


def kernels() -> List[ModuleType]:
    return [_module(p) for p in sorted((ROOT / "kernels").glob("*.py"))]


def _applies(metric: dict, cell_name: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def metrics_of(bench: dict, cell_name: str) -> Dict[str, List[dict]]:
    """The cell's end-to-end metrics (reported with ``--trace 0``) and
    per-layer metrics (``--trace 1``)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, cell_name, names)]
    return {"end_to_end": e2e, "per_layer": layer}
