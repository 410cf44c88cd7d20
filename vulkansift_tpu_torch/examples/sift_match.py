"""Match + cross-check demo (port of ``examples/sift_match.py``; parity:
src/examples/test_sift_match.cpp:66-107 — detect two images, 2-NN match on
the device, cross-check both directions, Lowe ratio 0.75, draw match
lines).

Usage: python -m vulkansift_tpu_torch.examples.sift_match [IMG1 IMG2]
       [--out matches.png] [--device cuda|cpu]
Synthesizes a warped pair when images are omitted. Drawing needs ``cv2``.
"""

import argparse
import sys
from typing import Dict

import numpy as np

from .. import SiftConfig, SiftInstance
from ..utils.device import DeviceLike
from .common import load_or_synthesize, synthetic_image, warp_perspective

HOMOGRAPHY = np.array([[0.95, -0.1, 30], [0.1, 0.95, -10], [0, 0, 1.0]])


def match(img1: np.ndarray, img2: np.ndarray,
          device: DeviceLike = "cuda") -> Dict[str, np.ndarray]:
    """Features of both images (``f1``, ``f2``) and the indices of the
    cross-checked Lowe-0.75 matches (``ia`` into f1, ``ib`` into f2)."""
    with SiftInstance(SiftConfig(
            max_nb_sift_per_buffer=16384, sift_buffer_count=2,
            input_image_max_size=4096 * 4096), device=device) as inst:
        inst.detect_features(img1, 0)
        inst.detect_features(img2, 1)
        f1 = inst.download_features(0)
        f2 = inst.download_features(1)
        # A->B with Lowe ratio.
        inst.match_features(0, 1)
        m_ab = inst.download_matches()
        # B->A for the cross-check (the reference does both directions).
        inst.match_features(1, 0)
        m_ba = inst.download_matches()

    ratio_ok = m_ab["dist_a_b1"] < 0.75 * np.maximum(m_ab["dist_a_b2"], 1e-9)
    back = m_ba["idx_b1"][m_ab["idx_b1"]]
    mutual = back == m_ab["idx_a"]
    keep = ratio_ok & mutual
    return dict(f1=f1, f2=f2, ia=m_ab["idx_a"][keep], ib=m_ab["idx_b1"][keep])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("img1", nargs="?")
    ap.add_argument("img2", nargs="?")
    ap.add_argument("--out", default="sift_match_out.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.img1 and args.img2:
        img1 = load_or_synthesize(args.img1, 0, 0, seed=0)
        img2 = load_or_synthesize(args.img2, 0, 0, seed=0)
    else:
        img1 = synthetic_image(480, 640, seed=1)
        img2 = warp_perspective(img1, HOMOGRAPHY)

    res = match(img1, img2, args.device)
    f1, f2, ia, ib = res["f1"], res["f2"], res["ia"], res["ib"]
    print(f"features: {len(f1)} / {len(f2)}; "
          f"cross-checked Lowe matches: {len(ia)}")

    import cv2
    vis = np.concatenate([cv2.cvtColor(img1, cv2.COLOR_GRAY2BGR),
                          cv2.cvtColor(img2, cv2.COLOR_GRAY2BGR)], axis=1)
    w = img1.shape[1]
    rng = np.random.default_rng(0)
    for a, b in zip(ia[:500], ib[:500]):
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        cv2.line(vis, (int(f1["x"][a]), int(f1["y"][a])),
                 (int(f2["x"][b]) + w, int(f2["y"][b])), color, 1,
                 cv2.LINE_AA)
    cv2.imwrite(args.out, vis)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
