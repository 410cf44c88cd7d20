"""``run.py`` fails, and prints no result, where it cannot measure the
card: no card, or a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CMD = [sys.executable, "benchmark/run.py", "--workload",
       "hannover1536-video", "--seed", str(2 ** 31 + 9), "--seconds", "1",
       "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(CMD, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_fails_without_a_result():
    p = _run(REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")


def test_forbidden_names_compared_whole():
    import run as bench_run
    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["vulkansift_tpu_torch_fake"] = object()
        assert "vulkansift_tpu" not in bench_run.forbidden_modules()
        sys.modules["vulkansift_tpu.config"] = object()
        assert bench_run.forbidden_modules() == ["vulkansift_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_result_line_shape(tiny):
    import run as bench_run
    out = bench_run.measure(**tiny("hannover1536-video"), seed=5,
                            seconds=3, trace=False, device="cpu")
    res = json.loads(json.dumps(out["result"]))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, out["why"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(v["limit"] is not None for v in res["checks"].values())


def test_warmup_runs_the_loop_before_the_window(tiny):
    """Set-up runs the closed loop for the traffic's ``warmup_seconds``
    after the warm-up items; the window's items come after."""
    import time

    import vulkansift_tpu_torch as vt
    from yardstick import loop

    matches = []

    class Counting(vt.SiftInstance):
        def match_features(self, a, b):
            matches.append((a, b))
            return super().match_features(a, b)

    p = tiny("hannover1536-exhaustive")
    p["traffic"]["warmup_seconds"] = 1.0
    t0 = time.perf_counter()
    c = loop.Cell(p["cfg_file"], p["traffic"], 5, "cpu", Counting)
    assert time.perf_counter() - t0 >= 1.0
    assert len(matches) > loop.WARMUP_ITEMS
    before = len(matches)
    run = loop.Run(device="cpu")
    c.window(0.2, run)
    assert len(matches) - before == run.attempted
    c.close()
