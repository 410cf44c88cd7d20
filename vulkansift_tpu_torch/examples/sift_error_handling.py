"""Error-callback/exception demo (port of
``examples/sift_error_handling.py``; parity: src/examples/
test_sift_error_handling.cpp — deliberately triggers invalid inputs and
shows that errors surface through the callback and exceptions while the
instance stays usable).

Usage: python -m vulkansift_tpu_torch.examples.sift_error_handling
       [--device cuda|cpu]
"""

import argparse
import sys

import numpy as np

from .. import InvalidInputError, SiftConfig, SiftInstance
from ..utils.device import DeviceLike


def run(img: np.ndarray, device: DeviceLike = "cuda") -> dict:
    """Four invalid calls, then a valid detect of ``img`` on the same
    instance. Returns the message of each ``InvalidInputError`` caught
    (None where a call did not raise), the error callback's results by
    name, and the feature count of the valid detect."""
    seen = []
    inst = SiftInstance(
        SiftConfig(sift_buffer_count=2, max_nb_sift_per_buffer=4096),
        on_error=lambda r: seen.append(r), device=device)
    caught = []
    # Invalid buffer index (reference: test_sift_error_handling.cpp:49-69).
    for bad_call in (
            lambda: inst.detect_features(img, 99),
            lambda: inst.detect_features(img.astype(np.float32), 0),
            lambda: inst.detect_features(np.zeros((4, 4), np.uint8), 0),
            lambda: inst.download_matches(),
    ):
        try:
            bad_call()
            caught.append(None)
        except InvalidInputError as e:
            caught.append(str(e))
    callbacks = [r.name for r in seen]
    # The instance remains fully usable after INVALID_INPUT errors.
    inst.detect_features(img, 0)
    features = inst.get_features_number(0)
    inst.close()
    return dict(caught=caught, callbacks=callbacks, features=features)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    img = (rng.random((128, 128)) * 255).astype(np.uint8)
    res = run(img, args.device)
    for msg in res["caught"]:
        if msg is None:
            print("ERROR: expected an exception")
        else:
            print(f"caught InvalidInputError: {msg}")
    print(f"error callback fired {len(res['callbacks'])} times "
          f"({res['callbacks']})")
    print(f"instance still works: {res['features']} features")
    return 0


if __name__ == "__main__":
    sys.exit(main())
