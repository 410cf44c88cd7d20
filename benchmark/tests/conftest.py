"""Shared set-up of the benchmark's own tests (run from the repository
root: ``python -m pytest benchmark/tests -q``).

Tests that need a card carry the ``card`` marker and take the ``card``
fixture, which skips them when ``torch.cuda.is_available()`` is false;
nothing is decided while a module is imported.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


# A cell left out of BENCHMARK.json (PERF.md, Open questions), whose
# configuration and traffic mix stay, and stay tested, for its return.
LEFT_OUT = {"hannover1536-exhaustive": ("hannover-1536x1024",
                                        "exhaustive-50")}


def parts(cell: str) -> dict:
    """A cell's configuration, traffic mix and metrics, by name."""
    import run as bench_run
    from yardstick import spec
    if cell not in LEFT_OUT:
        return bench_run.load(cell)
    bench = spec.benchmark()
    cfg, traffic = LEFT_OUT[cell]
    return dict(cfg_file=spec.config(bench, cfg),
                traffic=spec.traffic(traffic),
                wanted=spec.metrics_of(bench, cell))


def tiny_parts(cell: str) -> dict:
    """A cell's configuration and traffic at a size the CPU runs in
    seconds: small frames, few images, few buffers."""
    p = copy.deepcopy(parts(cell))
    t = p["traffic"]
    if t["images"]["kind"] == "oxford_sets":
        p["cfg_file"]["frame"] = {"width": 160, "height": 120}
        t["images"]["sets"] = 1
    else:
        p["cfg_file"]["frame"] = {"width": 192, "height": 128}
        t["images"]["count"] = 5
        if t["setup"] == "detect_all":
            t["buffers"] = 5
            t["check"]["match_items"] = 3
    t["traced_items"] = 2
    t["warmup_seconds"] = 0.5
    return p


@pytest.fixture
def tiny():
    return tiny_parts
