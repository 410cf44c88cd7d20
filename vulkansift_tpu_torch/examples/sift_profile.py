"""Profiler-attachable loop (port of ``examples/sift_profile.py``; parity:
src/examples/test_sift_gpu_debug.cpp — upload/detect/download round-trips
with timing prints; the reference's DebugPresenter frame-delimiter hack
becomes a ``torch.profiler`` trace through ``SiftInstance.start_trace`` /
``stop_trace``).

Usage: python -m vulkansift_tpu_torch.examples.sift_profile [IMAGE]
       [--iters N] [--trace-dir DIR] [--device cuda|cpu]
Synthesizes a 1024x768 image when IMAGE is omitted.
"""

import argparse
import sys
import time
from typing import Optional

import numpy as np
from .. import SiftConfig, SiftInstance
from ..utils.device import DeviceLike
from .common import load_or_synthesize


def profile(img: np.ndarray, device: DeviceLike = "cuda", iters: int = 20,
            trace_dir: Optional[str] = None) -> dict:
    """``iters`` detect + count + download round-trips of ``img`` after one
    warm-up detect, traced into ``trace_dir`` when given. Returns each
    iteration's (detect+count ms, download ms, features) and the trace's
    path (None without ``trace_dir``)."""
    rows, trace = [], None
    with SiftInstance(SiftConfig(
            max_nb_sift_per_buffer=16384,
            input_image_max_size=4096 * 4096), device=device) as inst:
        inst.detect_features(img, 0)  # build, first-call allocations
        inst.get_features_number(0)
        if trace_dir:
            inst.start_trace(trace_dir)
        for _ in range(iters):
            t0 = time.perf_counter()
            inst.detect_features(img, 0)
            n = inst.get_features_number(0)
            t1 = time.perf_counter()
            inst.download_features(0)
            t2 = time.perf_counter()
            rows.append((1e3 * (t1 - t0), 1e3 * (t2 - t1), n))
        if trace_dir:
            trace = inst.stop_trace()
    return dict(iters=rows, trace=trace)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler Chrome trace (the "
                         "DebugPresenter analogue)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    img = load_or_synthesize(args.image, 768, 1024, seed=3)
    res = profile(img, args.device, args.iters, args.trace_dir)
    for i, (det_ms, dl_ms, n) in enumerate(res["iters"]):
        print(f"iter {i}: detect+count {det_ms:.1f} ms, "
              f"download {dl_ms:.1f} ms, {n} features")
    if res["trace"]:
        print(f"trace written to {res['trace']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
