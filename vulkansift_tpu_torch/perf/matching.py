"""CLI: Oxford matching benchmark (parity: src/perf/perf_matching.cpp).

Usage: python -m vulkansift_tpu_torch.perf.matching DATASET_PATH DETECTOR_NAME
       python -m vulkansift_tpu_torch.perf.matching --synthetic DETECTOR_NAME
       [--out-dir DIR] [--device cuda|cpu]

Both the Oxford dataset and the synthetic pairs need ``cv2``.
"""

import argparse
import sys

from .harness import DETECTORS, make_detector, run_matching_benchmark


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset_or_detector")
    ap.add_argument("detector", nargs="?")
    ap.add_argument("--synthetic", action="store_true",
                    help="use synthesized homography pairs (no dataset)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--device", default="cuda",
                    help="device of the port's detector and matcher "
                         "(cuda or cpu)")
    args = ap.parse_args(argv)

    if args.detector is None:
        detector_name, dataset = args.dataset_or_detector, None
        if not args.synthetic:
            print("provide DATASET_PATH or --synthetic", file=sys.stderr)
            return 1
    else:
        dataset, detector_name = args.dataset_or_detector, args.detector
    if detector_name not in DETECTORS:
        print(f"unknown detector {detector_name}; options: "
              f"{sorted(DETECTORS)}", file=sys.stderr)
        return 1
    det = make_detector(detector_name, args.device)
    det.init()
    lines = run_matching_benchmark(det, dataset_path=dataset,
                                   out_dir=args.out_dir, device=args.device)
    for line in lines:
        print(line)
    det.terminate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
