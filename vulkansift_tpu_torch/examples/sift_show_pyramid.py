"""Scale-space / DoG introspection demo (port of
``examples/sift_show_pyramid.py``; parity: src/examples/
test_sift_show_pyr.cpp — dumps every gaussian and DoG pyramid level).

Usage: python -m vulkansift_tpu_torch.examples.sift_show_pyramid [IMAGE]
       [--out-dir pyr_out] [--device cuda|cpu]
Writing the levels as pictures needs ``cv2``.
"""

import argparse
import os
import sys

import numpy as np

from .. import SiftConfig, SiftInstance
from ..utils.device import DeviceLike
from .common import load_or_synthesize


def pyramid(img: np.ndarray, device: DeviceLike = "cuda") -> dict:
    """The retained scale space of one detect of ``img``: each octave's
    (width, height) and its gaussian and DoG levels as float32 arrays."""
    cfg = SiftConfig(retain_pyramid=True, max_nb_sift_per_buffer=16384,
                     input_image_max_size=4096 * 4096)
    octaves, gaussians, dogs = [], [], []
    with SiftInstance(cfg, device=device) as inst:
        inst.detect_features(img, 0)
        for o in range(inst.get_scale_space_nb_octaves(0)):
            octaves.append(inst.get_scale_space_octave_resolution(o, 0))
            gaussians.append([inst.download_scale_space_image(o, s, 0)
                              for s in range(cfg.nb_scales_per_octave + 3)])
            dogs.append([inst.download_dog_image(o, s, 0)
                         for s in range(cfg.nb_scales_per_octave + 2)])
    return dict(octaves=octaves, gaussians=gaussians, dogs=dogs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("image", nargs="?")
    ap.add_argument("--out-dir", default="pyr_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    img = load_or_synthesize(args.image, 480, 640, seed=2)
    res = pyramid(img, args.device)
    print(f"{len(res['octaves'])} octaves")
    for o, (w, h) in enumerate(res["octaves"]):
        print(f"octave {o}: {w}x{h}")

    import cv2
    os.makedirs(args.out_dir, exist_ok=True)
    for o in range(len(res["octaves"])):
        for s, g in enumerate(res["gaussians"][o]):
            cv2.imwrite(os.path.join(args.out_dir, f"gauss_o{o}_s{s}.png"),
                        (255 * np.clip(g, 0, 1)).astype(np.uint8))
        for s, d in enumerate(res["dogs"][o]):
            dn = (d - d.min()) / max(d.max() - d.min(), 1e-9)
            cv2.imwrite(os.path.join(args.out_dir, f"dog_o{o}_s{s}.png"),
                        (255 * dn).astype(np.uint8))
    print(f"wrote pyramid levels to {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
