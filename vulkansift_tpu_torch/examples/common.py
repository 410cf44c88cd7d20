"""Input images of the examples, made without ``cv2``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..perf.harness import read_image


def _bilinear(src: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """``src`` sampled at (ys[:, None], xs[None, :]) or at the points
    (ys, xs) of equal shape, bilinearly; coordinates are clamped inside."""
    h, w = src.shape
    ys = np.clip(ys, 0, h - 1.0)
    xs = np.clip(xs, 0, w - 1.0)
    y0 = np.minimum(ys.astype(int), h - 2)
    x0 = np.minimum(xs.astype(int), w - 2)
    fy, fx = ys - y0, xs - x0
    return ((1 - fy) * (1 - fx) * src[y0, x0] + (1 - fy) * fx * src[y0, x0 + 1]
            + fy * (1 - fx) * src[y0 + 1, x0] + fy * fx * src[y0 + 1, x0 + 1])


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth random texture: a (h/8, w/8) random grid resized
    bilinearly to (h, w) and stretched to 0..255 (the JAX examples resize
    with ``cv2`` cubic interpolation)."""
    grid = np.random.default_rng(seed).random((h // 8, w // 8))
    ys = (np.arange(h) + 0.5) * grid.shape[0] / h - 0.5
    xs = (np.arange(w) + 0.5) * grid.shape[1] / w - 0.5
    img = _bilinear(grid, *np.meshgrid(ys, xs, indexing="ij"))
    img -= img.min()
    return (255 * img / max(img.max(), 1e-12)).astype(np.uint8)


def warp_perspective(img: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """``img`` warped by the homography ``hmat`` (output pixel p takes the
    input at hmat^-1 p, bilinearly; 0 outside), like
    ``cv2.warpPerspective`` with its default flags (which also blends the
    border into the pixels at the image's edge)."""
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    p = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(hmat).T
    sx, sy = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    out = _bilinear(img.astype(np.float64), sy, sx)
    return np.where(inside, np.rint(out), 0).astype(np.uint8)


def load_or_synthesize(path: Optional[str], h: int, w: int,
                       seed: int) -> np.ndarray:
    """The image at ``path``, or a synthetic (h, w) one when ``path`` is
    empty; exits with a message when the file cannot be read."""
    if not path:
        return synthetic_image(h, w, seed)
    img = read_image(path)
    if img is None:
        raise SystemExit(f"failed to read {path}")
    return img
