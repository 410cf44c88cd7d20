"""Benchmark harness with reference-compatible protocols and file formats.

Port of ``vulkansift_tpu/perf/harness.py``: the same protocols, constants
and result files, with the port's detector and matcher. It mirrors the
reference's perf programs (reference: src/perf/perf_runtime.cpp,
perf_matching.cpp, perf_common.cpp) so its plotting scripts
(scripts/plot_matching_results.py, oxford_runtime_perf.py) work unchanged:

* runtime: NB_ITER_WARMUP warmup + NB_ITER_MEAS timed full detections
  (upload + detect + feature download) -> ``runtime_results_<det>.txt``
  containing one ``mean_ms;nb_feats`` line (perf_runtime.cpp:5-6, :85-89).
* matching: Oxford homography-dataset pairs img1->imgN, Lowe-ratio-0.75
  2-NN matching, metrics repeatability / putative match ratio / precision /
  matching score with a 2.5 px correctness threshold ->
  ``matching_results_<det>.txt`` lines
  ``dataset;1;N;rep;pmr;precision;score`` (perf_matching.cpp:5, :30-79,
  :204-206).

Detectors: ``vulkansift_tpu_torch`` (this port, on ``device``, default
``"cuda"``), ``OpenCV`` (differential baseline, like the reference's
cross-implementation wrappers, src/perf/wrappers/*) and ``GoldenNumpy``
(the port's float64 oracle). The 2-NN matching of every detector's
descriptors runs through the port's matcher on ``device``: on a card it
launches ``csrc/match_2nn.cu``. When the Oxford dataset is unavailable the
matching benchmark can synthesize homography pairs (--synthetic),
preserving the protocol. ``cv2`` is imported only where it is needed: to
synthesize pairs, to read the Oxford dataset and images other than
PGM/PPM, and by the OpenCV detector.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

OXFORD_SETS = ("bark", "bikes", "boat", "graf", "leuven", "trees", "ubc",
               "wall")
PIXEL_DIST_THRESHOLD = 2.5   # perf_matching.cpp:5
LOWES_RATIO = 0.75           # perf_common.h:8
NB_ITER_WARMUP = 50          # perf_runtime.cpp:5
NB_ITER_MEAS = 500           # perf_runtime.cpp:6


@dataclasses.dataclass
class DetectResult:
    xy: np.ndarray          # (N, 2) keypoint positions
    size: np.ndarray        # (N,) keypoint scale (sigma)
    descriptors: np.ndarray  # (N, 128) float32 or uint8


class Detector:
    """AbstractSiftDetector analogue (reference: src/perf/wrappers/
    wrapper.h:9-20)."""

    name = "abstract"

    def init(self) -> None:  # pragma: no cover - interface
        pass

    def detect(self, image: np.ndarray) -> DetectResult:
        raise NotImplementedError

    def terminate(self) -> None:
        pass


class VulkanSiftTpuTorchDetector(Detector):
    """The port's ``SiftInstance`` on ``device``, configured as the JAX
    package's ``VulkanSiftTpuDetector``."""

    name = "vulkansift_tpu_torch"

    def __init__(self, max_features: int = 32768, upsampling: bool = True,
                 device: DeviceLike = "cuda"):
        self._max_features = max_features
        self._upsampling = upsampling
        self._device = device
        self._inst = None

    def init(self) -> None:
        from .. import SiftConfig, SiftInstance
        self._cfg = SiftConfig(
            use_input_upsampling=self._upsampling,
            max_nb_sift_per_buffer=self._max_features,
            sift_buffer_count=1,
            input_image_max_size=4096 * 4096)
        self._inst = SiftInstance(self._cfg, device=self._device)

    def detect(self, image: np.ndarray) -> DetectResult:
        self._inst.detect_features(image, 0)
        f = self._inst.download_features(0)
        return DetectResult(
            xy=np.stack([f["x"], f["y"]], 1),
            size=f["sigma"],
            descriptors=f["descriptor"])

    def terminate(self) -> None:
        if self._inst is not None:
            self._inst.close()


class OpenCvDetector(Detector):
    name = "OpenCV"

    def init(self) -> None:
        import cv2
        self._sift = cv2.SIFT_create()

    def detect(self, image: np.ndarray) -> DetectResult:
        kps, desc = self._sift.detectAndCompute(image, None)
        if desc is None:
            desc = np.zeros((0, 128), np.float32)
        return DetectResult(
            xy=np.asarray([k.pt for k in kps], np.float32).reshape(-1, 2),
            size=np.asarray([k.size for k in kps], np.float32),
            descriptors=desc)


class GoldenNumpyDetector(Detector):
    """Independent float64 NumPy SIFT (vulkansift_tpu_torch.golden) —
    the offline stand-in for the reference harness's VLFeat CPU slot
    (src/perf/perf_common.cpp:42-61): a third implementation whose metric
    agreement hardens the cross-implementation oracle. Slow (seconds per
    image); defaults to no upsampling like VLFeat's common benchmarking
    configuration."""

    name = "GoldenNumpy"

    def __init__(self, upsampling: bool = False, max_features: int = 16384):
        self._upsampling = upsampling
        self._max_features = max_features

    def init(self) -> None:
        from ..config import SiftConfig
        from ..golden import reference
        self._gold = reference
        self._cfg = SiftConfig(use_input_upsampling=self._upsampling,
                               max_nb_sift_per_buffer=self._max_features,
                               sift_buffer_count=1,
                               input_image_max_size=4096 * 4096)

    def detect(self, image: np.ndarray) -> DetectResult:
        feats = self._gold.detect_np(image, self._cfg,
                                     max_features=self._max_features)
        if not feats:
            return DetectResult(xy=np.zeros((0, 2), np.float32),
                                size=np.zeros((0,), np.float32),
                                descriptors=np.zeros((0, 128), np.uint8))
        return DetectResult(
            xy=np.asarray([(f["x"], f["y"]) for f in feats], np.float32),
            size=np.asarray([f["sigma"] for f in feats], np.float32),
            descriptors=np.stack([f["descriptor"] for f in feats]))


DETECTORS: Dict[str, Callable[[], Detector]] = {
    "vulkansift_tpu_torch": VulkanSiftTpuTorchDetector,
    "OpenCV": OpenCvDetector,
    "GoldenNumpy": GoldenNumpyDetector,
}


def make_detector(name: str, device: DeviceLike = "cuda") -> Detector:
    """A detector of :data:`DETECTORS` by name; the port's runs on
    ``device``."""
    if name == VulkanSiftTpuTorchDetector.name:
        return VulkanSiftTpuTorchDetector(device=device)
    return DETECTORS[name]()


def read_image(path: str) -> Optional[np.ndarray]:
    """An image file as (H, W) uint8 grayscale: PGM/PPM through the port's
    ``utils.native_io``, any other format through ``cv2`` (which must then
    be installed). None when the file cannot be read or decoded, as
    ``cv2.imread`` answers."""
    if path.lower().endswith((".pgm", ".ppm")):
        from ..utils import native_io
        try:
            return native_io.read_image_gray(path)
        except (IOError, ValueError):
            return None
    import cv2
    return cv2.imread(path, 0)


# ---------------------------------------------------------------------------
# Runtime benchmark (perf_runtime.cpp)
# ---------------------------------------------------------------------------

def run_runtime_benchmark(image: np.ndarray, detector: Detector, *,
                          warmup: int = NB_ITER_WARMUP,
                          iters: int = NB_ITER_MEAS,
                          out_dir: str = ".") -> Tuple[float, int]:
    """Full-detection latency (upload + detect + download); writes
    ``runtime_results_<det>.txt``. Returns (mean_ms, nb_features)."""
    for _ in range(warmup):
        res = detector.detect(image)
    t0 = time.perf_counter()
    for _ in range(iters):
        res = detector.detect(image)
    mean_ms = (time.perf_counter() - t0) / iters * 1e3
    path = os.path.join(out_dir, f"runtime_results_{detector.name}.txt")
    with open(path, "w") as f:
        f.write(f"{mean_ms:.6f};{len(res.xy)}\n")
    return mean_ms, len(res.xy)


# ---------------------------------------------------------------------------
# Matching metrics (perf_matching.cpp:30-79, perf_common.cpp:110-175)
# ---------------------------------------------------------------------------

def _project(h: np.ndarray, xy: np.ndarray) -> np.ndarray:
    p = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ h.T
    return p[:, :2] / p[:, 2:3]


def repeatability_score(img_shape1, img_shape2, h: np.ndarray,
                        xy1: np.ndarray, xy2: np.ndarray,
                        thr: float = PIXEL_DIST_THRESHOLD) -> float:
    """Fraction of mutually-visible keypoints with a correspondence within
    ``thr`` px (the cv::evaluateFeatureDetector protocol, simplified to
    center distance)."""
    h2, w2 = img_shape2[:2]
    h1, w1 = img_shape1[:2]
    if len(xy1) == 0 or len(xy2) == 0:
        return 0.0
    proj1 = _project(h, xy1)
    vis1 = ((proj1[:, 0] >= 0) & (proj1[:, 0] < w2)
            & (proj1[:, 1] >= 0) & (proj1[:, 1] < h2))
    back2 = _project(np.linalg.inv(h), xy2)
    vis2 = ((back2[:, 0] >= 0) & (back2[:, 0] < w1)
            & (back2[:, 1] >= 0) & (back2[:, 1] < h1))
    if vis1.sum() == 0 or vis2.sum() == 0:
        return 0.0
    d = np.linalg.norm(proj1[vis1][:, None, :] - xy2[vis2][None, :, :],
                       axis=2)
    matched = (d.min(axis=1) < thr).sum()
    return float(matched) / float(min(vis1.sum(), vis2.sum()))


def lowe_matches(desc1: np.ndarray, desc2: np.ndarray,
                 ratio: float = LOWES_RATIO,
                 device: DeviceLike = "cuda") -> np.ndarray:
    """Indices (M, 2) of Lowe-ratio-filtered 2-NN matches, through the
    port's matcher on ``device`` (on a card, ``csrc/match_2nn.cu``)."""
    from ..ops.match import lowe_ratio_mask, match_2nn_fused
    if len(desc1) < 2 or len(desc2) < 2:
        return np.zeros((0, 2), np.int32)
    dev = resolve_device(device)
    d1 = np.ascontiguousarray(desc1)
    d2 = np.ascontiguousarray(desc2)
    if d1.dtype != np.uint8:
        d1 = np.clip(d1, 0, 255).astype(np.uint8)
        d2 = np.clip(d2, 0, 255).astype(np.uint8)
    m = match_2nn_fused(torch.from_numpy(d1).to(dev), len(d1),
                        torch.from_numpy(d2).to(dev), len(d2))
    keep = lowe_ratio_mask(m, ratio).cpu().numpy()
    ia = m.idx_a.cpu().numpy()[keep]
    ib = m.idx_b1.cpu().numpy()[keep]
    return np.stack([ia, ib], 1).astype(np.int32)


def compute_metrics(img1: np.ndarray, img2: np.ndarray, h: np.ndarray,
                    r1: DetectResult, r2: DetectResult,
                    device: DeviceLike = "cuda"
                    ) -> Tuple[float, float, float, float]:
    """(repeatability, putative_match_ratio, precision, matching_score)
    exactly as perf_matching.cpp:30-79; the matching runs on ``device``."""
    rep = repeatability_score(img1.shape, img2.shape, h, r1.xy, r2.xy)
    matches = lowe_matches(r1.descriptors, r2.descriptors, device=device)
    if len(r1.xy) == 0:
        return rep, 0.0, 0.0, 0.0
    if len(matches) == 0:
        return rep, 0.0, 0.0, 0.0
    gt = _project(h, r1.xy[matches[:, 0]])
    dist = np.linalg.norm(gt - r2.xy[matches[:, 1]], axis=1)
    inliers = int((dist < PIXEL_DIST_THRESHOLD).sum())
    pmr = len(matches) / len(r1.xy)
    precision = inliers / len(matches)
    score = inliers / len(r1.xy)
    return rep, pmr, precision, score


# ---------------------------------------------------------------------------
# Datasets and the matching benchmark
# ---------------------------------------------------------------------------

def read_homography_file(path: str) -> np.ndarray:
    """Oxford H1toNp file: 3 rows of 3 floats (perf_matching.cpp:7-28)."""
    vals = []
    with open(path) as f:
        for _ in range(3):
            vals.extend(float(v) for v in f.readline().split()[:3])
    return np.asarray(vals, np.float64).reshape(3, 3)


def load_oxford_pairs(dataset_path: str, set_name: str):
    """Yield (img1, imgN, H1toN) for N in 2..6 from the Oxford layout."""
    import cv2
    ext = ".pgm" if set_name == "boat" else ".ppm"
    img1 = cv2.imread(os.path.join(dataset_path, set_name, "img1" + ext), 0)
    if img1 is None:
        raise FileNotFoundError(f"{set_name}/img1{ext}")
    for n in range(2, 7):
        imgn = cv2.imread(
            os.path.join(dataset_path, set_name, f"img{n}{ext}"), 0)
        h = read_homography_file(
            os.path.join(dataset_path, set_name, f"H1to{n}p"))
        if imgn is None:
            continue
        yield n, img1, imgn, h


def synthesize_pairs(set_name: str, seed: int, w: int = 640, h: int = 480):
    """Offline fallback: textured image + 5 progressively stronger
    homography warps (Oxford-protocol-preserving)."""
    import cv2
    rng = np.random.default_rng(seed)
    img = rng.random((h // 8, w // 8))
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)
    img += 0.5 * cv2.resize(rng.random((h // 32, w // 32)), (w, h),
                            interpolation=cv2.INTER_CUBIC)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    img1 = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    for n in range(2, 7):
        k = n - 1
        ang = np.radians(4.0 * k)
        s = 1.0 - 0.05 * k
        c, si = np.cos(ang), np.sin(ang)
        cx, cy = w / 2, h / 2
        t1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
        r = np.array([[s * c, -s * si, 0], [s * si, s * c, 0], [0, 0, 1.0]])
        t2 = np.array([[1, 0, cx + 6 * k], [0, 1, cy - 4 * k], [0, 0, 1.0]])
        hmat = t2 @ r @ t1
        imgn = cv2.warpPerspective(img1, hmat, (w, h))
        yield n, img1, imgn, hmat


def run_matching_benchmark(detector: Detector, *,
                           dataset_path: Optional[str] = None,
                           sets: Sequence[str] = OXFORD_SETS,
                           out_dir: str = ".",
                           device: DeviceLike = "cuda") -> List[str]:
    """Run the full matching benchmark; writes
    ``matching_results_<det>.txt`` (plot_matching_results.py-compatible).
    Uses the real Oxford dataset when ``dataset_path`` is given, otherwise
    synthetic homography pairs; the matching runs on ``device``. Returns
    the result lines."""
    lines = []
    for set_i, set_name in enumerate(sets):
        if dataset_path:
            pairs = load_oxford_pairs(dataset_path, set_name)
        else:
            pairs = synthesize_pairs(set_name, seed=set_i)
        first = True
        r1 = None
        for n, img1, imgn, h in pairs:
            if first:
                r1 = detector.detect(img1)
                first = False
            rn = detector.detect(imgn)
            rep, pmr, prec, score = compute_metrics(img1, imgn, h, r1, rn,
                                                    device=device)
            lines.append(f"{set_name};1;{n};{rep:.6f};{pmr:.6f};"
                         f"{prec:.6f};{score:.6f}")
    path = os.path.join(out_dir, f"matching_results_{detector.name}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines
