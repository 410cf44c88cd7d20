"""Frames made from the seed with NumPy.

Frozen copies, kept here so that later changes to the program cannot move
the yardstick:

* :func:`bench_image` is ``chip_smoke.py::bench_image`` (the repository
  bench's multi-scale texture, cells of 8, 16, 32 and 64 px);
* :func:`oxford_homography` is the warp of
  ``vulkansift_tpu_torch/perf/harness.py::synthesize_pairs`` (rotation
  4 deg k, scale 1 - 0.05 k, shift (6 k, -4 k) px about the centre,
  k = n - 1 for image n = 2..6), and :func:`warp_perspective` its
  ``cv2.warpPerspective`` (bilinear, zero outside) rewritten in NumPy,
  since the card's machine has no ``cv2``.
"""

from __future__ import annotations

from typing import List

import numpy as np


def bench_image(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Deterministic multi-scale textured u8 image."""
    img = np.zeros((h, w))
    for cell in (8, 16, 32, 64):
        small = rng.random((h // cell + 1, w // cell + 1))
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        yi, xi = ys.astype(int), xs.astype(int)
        fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
        img += ((1 - fy) * (1 - fx) * small[yi][:, xi]
                + (1 - fy) * fx * small[yi][:, xi + 1]
                + fy * (1 - fx) * small[yi + 1][:, xi]
                + fy * fx * small[yi + 1][:, xi + 1])
    img -= img.min()
    return (255 * img / img.max()).astype(np.uint8)


def pan(w: int, h: int, count: int, step, rng) -> List[np.ndarray]:
    """``count`` (h, w) crops of one textured canvas, crop i at
    (i * step[0], i * step[1]): a camera panning right and down."""
    sx, sy = step
    canvas = bench_image(h + sy * (count - 1), w + sx * (count - 1), rng)
    return [np.ascontiguousarray(canvas[i * sy:i * sy + h, i * sx:i * sx + w])
            for i in range(count)]


def oxford_homography(n: int, w: int, h: int, rot_deg: float,
                      scale_step: float, shift) -> np.ndarray:
    """img1 -> imgN homography of the synthetic Oxford protocol."""
    k = n - 1
    ang = np.radians(rot_deg * k)
    s = 1.0 - scale_step * k
    c, si = np.cos(ang), np.sin(ang)
    cx, cy = w / 2, h / 2
    t1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    r = np.array([[s * c, -s * si, 0], [s * si, s * c, 0], [0, 0, 1.0]])
    t2 = np.array([[1, 0, cx + shift[0] * k], [0, 1, cy + shift[1] * k],
                   [0, 0, 1.0]])
    return t2 @ r @ t1


def warp_perspective(img: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """``dst(x, y) = src(H^-1 (x, y))``, bilinear, zero outside the source,
    rounded to u8."""
    h, w = img.shape
    inv = np.linalg.inv(hmat)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    den = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    u = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) / den
    v = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) / den
    x0, y0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    fx, fy = u - x0, v - y0
    src = np.pad(img.astype(np.float64), 1)

    def at(yy, xx):
        ok = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
        return np.where(ok, src[np.clip(yy + 1, 0, h + 1),
                                np.clip(xx + 1, 0, w + 1)], 0.0)
    out = ((1 - fy) * (1 - fx) * at(y0, x0) + (1 - fy) * fx * at(y0, x0 + 1)
           + fy * (1 - fx) * at(y0 + 1, x0) + fy * fx * at(y0 + 1, x0 + 1))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def oxford_sets(w: int, h: int, sets: int, rot_deg: float, scale_step: float,
                shift, rng) -> List[List[np.ndarray]]:
    """``sets`` lists [img1, img2, ..., img6]: a textured img1 each and its
    five warps."""
    out = []
    for _ in range(sets):
        img1 = bench_image(h, w, rng)
        out.append([img1] + [warp_perspective(img1, oxford_homography(
            n, w, h, rot_deg, scale_step, shift)) for n in range(2, 7)])
    return out
