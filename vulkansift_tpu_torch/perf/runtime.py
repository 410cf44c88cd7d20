"""CLI: runtime benchmark (parity: src/perf/perf_runtime.cpp).

Usage: python -m vulkansift_tpu_torch.perf.runtime IMAGE_PATH DETECTOR_NAME
       [--warmup N] [--iters N] [--out-dir DIR] [--device cuda|cpu]

PGM/PPM images are read by the port's native IO (no ``cv2`` needed); other
formats need ``cv2``.
"""

import argparse
import sys

from .harness import (DETECTORS, NB_ITER_MEAS, NB_ITER_WARMUP,
                      make_detector, read_image, run_runtime_benchmark)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image")
    ap.add_argument("detector", choices=sorted(DETECTORS))
    ap.add_argument("--warmup", type=int, default=NB_ITER_WARMUP)
    ap.add_argument("--iters", type=int, default=NB_ITER_MEAS)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="device of the port's detector (cuda or cpu)")
    args = ap.parse_args(argv)

    image = read_image(args.image)
    if image is None:
        print(f"Failed to read image {args.image}", file=sys.stderr)
        return 1
    det = make_detector(args.detector, args.device)
    det.init()
    mean_ms, nb = run_runtime_benchmark(
        image, det, warmup=args.warmup, iters=args.iters,
        out_dir=args.out_dir)
    print(f"{args.detector}: {mean_ms:.3f} ms mean, {nb} features")
    det.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
