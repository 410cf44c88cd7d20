"""Detect-and-draw demo (port of ``examples/sift_detect.py``; parity:
src/examples/test_sift_detect.cpp).

Usage: python -m vulkansift_tpu_torch.examples.sift_detect [IMAGE]
       [--out out.png] [--device cuda|cpu]
Synthesizes an image when IMAGE is omitted. Drawing needs ``cv2``.
"""

import argparse
import sys

import numpy as np

from .. import SiftConfig, SiftInstance
from ..utils.device import DeviceLike
from .common import load_or_synthesize


def detect(img: np.ndarray, device: DeviceLike = "cuda") -> np.ndarray:
    """The features of ``img`` as a ``FEATURE_DTYPE`` array."""
    with SiftInstance(SiftConfig(
            max_nb_sift_per_buffer=16384,
            input_image_max_size=4096 * 4096), device=device) as inst:
        inst.detect_features(img, 0)
        return inst.download_features(0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?")
    ap.add_argument("--out", default="sift_detect_out.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    img = load_or_synthesize(args.image, 480, 640, seed=0)
    feats = detect(img, args.device)
    print(f"detected {len(feats)} features")

    import cv2
    vis = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    for f in feats:
        cv2.circle(vis, (int(f["x"]), int(f["y"])),
                   max(1, int(f["sigma"])), (0, 255, 0), 1)
    cv2.imwrite(args.out, vis)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
