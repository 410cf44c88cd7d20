"""Pure-NumPy golden SIFT reference (test oracle).

Port of ``vulkansift_tpu/golden/reference.py``, the same code on the
port's own ``config`` constants and ``ops/gaussian`` taps. A slow,
loop-based, independently-written implementation of every pipeline stage,
used to golden-test the fast paths. It mirrors the *semantics* of
the reference's GLSL kernels (cited per function) in plain float64 NumPy so
any vectorization bug in the fast path shows up as a numeric mismatch.

This module is deliberately unoptimized; run it on small images only.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..config import (DESC_SIZE, LAMBDA_DESCRIPTOR, LAMBDA_ORIENTATION,
                      NB_HIST, NB_ORI, NB_ORI_HIST_BINS,
                      NB_REFINEMENT_STEPS, ORI_PEAK_RATIO,
                      L2_NORM_THRESHOLD, SiftConfig)
from ..ops import gaussian

_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Scale space (parity: shaders/GaussianBlur.comp, DifferenceOfGaussian.comp,
# and the blit semantics in sift_detector.c:906-953, :1003-1024)
# ---------------------------------------------------------------------------

def conv1d_symmetric_np(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """Symmetric-kernel 1-D convolution with mirror boundary handling."""
    x = np.asarray(x, np.float64)
    k = len(taps) - 1
    if k == 0:
        return x * taps[0]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (k, k)
    xp = np.pad(x, pad, mode="symmetric")
    n = x.shape[axis]

    def sl(off):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(k + off, k + off + n)
        return xp[tuple(idx)]

    acc = sl(0) * taps[0]
    for j in range(1, k + 1):
        acc = acc + (sl(-j) + sl(j)) * taps[j]
    return acc


def blur_np(img: np.ndarray, taps: np.ndarray) -> np.ndarray:
    return conv1d_symmetric_np(conv1d_symmetric_np(img, taps, 1), taps, 0)


def upsample2x_np(img: np.ndarray) -> np.ndarray:
    """2x bilinear upsample, half-pixel centers, clamp-to-edge."""
    h, w = img.shape
    out = np.empty((2 * h, 2 * w), np.float64)
    xp = np.pad(img, 1, mode="edge")
    for y in range(2 * h):
        sy = (y + 0.5) / 2.0 - 0.5
        y0 = math.floor(sy)
        fy = sy - y0
        for x in range(2 * w):
            sx = (x + 0.5) / 2.0 - 0.5
            x0 = math.floor(sx)
            fx = sx - x0
            out[y, x] = ((1 - fy) * (1 - fx) * xp[y0 + 1, x0 + 1]
                         + (1 - fy) * fx * xp[y0 + 1, x0 + 2]
                         + fy * (1 - fx) * xp[y0 + 2, x0 + 1]
                         + fy * fx * xp[y0 + 2, x0 + 2])
    return out


def downsample2x_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest downsample picking odd source texels (VK_FILTER_NEAREST with
    half-pixel centers, sift_detector.c:1003-1024)."""
    return img[1::2, 1::2][:out_h, :out_w]


def build_pyramid_np(image: np.ndarray, config: SiftConfig
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(gaussians, dogs) per octave; gaussians[o] is (S+3, H, W) float64."""
    s = config.nb_scales_per_octave
    img = np.asarray(image, np.float64)
    kernels = [gaussian.half_kernel(sig).astype(np.float64)
               for sig in gaussian.kernel_sigmas(config)]
    h0, w0 = img.shape
    oct_res = config.octave_resolutions(w0, h0)

    seed = upsample2x_np(img) if config.use_input_upsampling else img
    base = blur_np(seed, kernels[0])
    gaussians, dogs = [], []
    for o, (ow, oh) in enumerate(oct_res):
        if o > 0:
            base = downsample2x_np(gaussians[o - 1][s], oh, ow)
        scales = [base]
        for i in range(1, s + 3):
            scales.append(blur_np(scales[i - 1], kernels[i]))
        g = np.stack(scales)
        gaussians.append(g)
        dogs.append(g[1:] - g[:-1])
    return gaussians, dogs


# ---------------------------------------------------------------------------
# Extrema + refinement (parity: shaders/ExtractKeypoints.comp)
# ---------------------------------------------------------------------------

def extrema_np(dog: np.ndarray, dog_threshold: float) -> List[Tuple[int, int, int]]:
    """Strict 26-neighbor extrema with |v| > 0.8*thr pre-filter
    (ExtractKeypoints.comp:57-116). Returns (s, y, x) in raster order."""
    ns, h, w = dog.shape
    out = []
    for s in range(1, ns - 1):
        for y in range(1, h - 1):
            for x in range(1, w - 1):
                v = dog[s, y, x]
                if abs(v) <= dog_threshold * 0.8:
                    continue
                nb = dog[s - 1:s + 2, y - 1:y + 2, x - 1:x + 2].copy()
                nb[1, 1, 1] = -np.inf if v > 0 else np.inf
                if (v > nb.max()) or (v < nb.min()):
                    out.append((s, y, x))
    return out


def refine_np(dog: np.ndarray, s: int, y: int, x: int, *, nb_scales: int,
              width: int, height: int, dog_threshold: float,
              edge_threshold: float, seed_sigma: float, octave_idx: int):
    """5-step iterative 3x3 Hessian-solve refinement
    (ExtractKeypoints.comp:124-231). Returns None if rejected, else a dict."""
    off = np.zeros(3)  # (s, x, y)
    grad = np.zeros(3)
    for it in range(NB_REFINEMENT_STEPS):
        n = dog[s - 1:s + 2, y - 1:y + 2, x - 1:x + 2].astype(np.float64)
        g = np.array([0.5 * (n[2, 1, 1] - n[0, 1, 1]),
                      0.5 * (n[1, 1, 2] - n[1, 1, 0]),
                      0.5 * (n[1, 2, 1] - n[1, 0, 1])])
        c = n[1, 1, 1]
        H = np.empty((3, 3))
        H[0, 0] = n[2, 1, 1] + n[0, 1, 1] - 2 * c
        H[1, 1] = n[1, 1, 2] + n[1, 1, 0] - 2 * c
        H[2, 2] = n[1, 2, 1] + n[1, 0, 1] - 2 * c
        H[0, 1] = H[1, 0] = 0.25 * (n[2, 1, 2] - n[2, 1, 0] - n[0, 1, 2] + n[0, 1, 0])
        H[0, 2] = H[2, 0] = 0.25 * (n[2, 2, 1] - n[2, 0, 1] - n[0, 2, 1] + n[0, 0, 1])
        H[1, 2] = H[2, 1] = 0.25 * (n[1, 2, 2] - n[1, 0, 2] - n[1, 2, 0] + n[1, 0, 0])
        det = np.linalg.det(H)
        if det == 0.0:
            return None
        off = -np.linalg.inv(H) @ g  # (ds, dx, dy)
        grad = g
        if (abs(off) < 0.6).all():
            break
        if it == NB_REFINEMENT_STEPS - 1:
            break
        if off[1] >= 0.6 and x < width - 2:
            x += 1
        if off[1] <= -0.6 and x > 1:
            x -= 1
        if off[2] >= 0.6 and y < height - 2:
            y += 1
        if off[2] <= -0.6 and y > 1:
            y -= 1
        if off[0] >= 0.6 and s < nb_scales:
            s += 1
        if off[0] <= -0.6 and s > 1:
            s -= 1

    n = dog[s - 1:s + 2, y - 1:y + 2, x - 1:x + 2].astype(np.float64)
    c = n[1, 1, 1]
    new_val = c + 0.5 * float(grad @ off)
    if abs(new_val) <= dog_threshold:
        return None
    if (np.abs(off) >= 1.5).any():
        return None
    sx, sy, ss = x + off[1], y + off[2], s + off[0]
    if not (0 <= sx < width and 0 <= sy < height and 0 <= ss <= nb_scales + 1):
        return None
    h11 = n[1, 1, 2] + n[1, 1, 0] - 2 * c
    h22 = n[1, 2, 1] + n[1, 0, 1] - 2 * c
    h12 = 0.25 * (n[1, 2, 2] - n[1, 0, 2] - n[1, 2, 0] + n[1, 0, 0])
    det2 = h11 * h22 - h12 * h12
    if det2 == 0.0:
        return None
    edgeness = (h11 + h22) ** 2 / det2
    e = edge_threshold
    if not (0 <= edgeness < (e + 1.0) ** 2 / e):
        return None
    scale_factor = 2.0 ** octave_idx
    return dict(scale_x=sx, scale_y=sy, subpix_s=ss,
                scale_idx=int(round(ss)),
                sigma=seed_sigma * 2.0 ** (ss / nb_scales) * scale_factor,
                intensity=new_val,
                x=sx * scale_factor, y=sy * scale_factor)


# ---------------------------------------------------------------------------
# Orientation (parity: shaders/ComputeOrientation.comp)
# ---------------------------------------------------------------------------

def orientations_np(gauss: np.ndarray, scale_x: float, scale_y: float,
                    sigma_oct: float, max_nb: int) -> List[Tuple[float, float]]:
    """Orientation histogram peaks for one keypoint on one gaussian layer.

    Returns [(angle, peak_value)] sorted by descending peak value, capped at
    max_nb. Float accumulation replaces the shader's fixed-point atomics.
    """
    h, w = gauss.shape
    cx, cy = int(round(scale_x)), int(round(scale_y))
    scaled_lambda = LAMBDA_ORIENTATION * sigma_oct
    box_r = int(math.floor(3.0 * scaled_lambda))
    expf_scale = -1.0 / (2.0 * scaled_lambda * scaled_lambda)
    hist = np.zeros(NB_ORI_HIST_BINS)
    for dy in range(-box_r, box_r + 1):
        for dx in range(-box_r, box_r + 1):
            px, py = cx + dx, cy + dy
            if not (1 <= px < w - 1 and 1 <= py < h - 1):
                continue
            gx = 0.5 * (gauss[py, px + 1] - gauss[py, px - 1])
            gy = 0.5 * (gauss[py + 1, px] - gauss[py - 1, px])
            sdx = dx - (scale_x - cx)
            sdy = dy - (scale_y - cy)
            mag = math.exp((sdx * sdx + sdy * sdy) * expf_scale) * math.hypot(gx, gy)
            theta = math.atan2(gy, gx)
            if theta < 0:
                theta += _TWO_PI
            b = min(int(theta * NB_ORI_HIST_BINS / _TWO_PI), NB_ORI_HIST_BINS - 1)
            hist[b] += mag
    for _ in range(6):
        hist = (np.roll(hist, 1) + hist + np.roll(hist, -1)) / 3.0
    hmax = hist.max()
    peaks = []
    for i in range(NB_ORI_HIST_BINS):
        p, nx = hist[i - 1], hist[(i + 1) % NB_ORI_HIST_BINS]
        v = hist[i]
        if v >= ORI_PEAK_RATIO * hmax and v > p and v > nx:
            denom = p - 2 * v + nx
            interp = 0.0 if denom == 0 else 0.5 * (p - nx) / denom
            angle = (i + interp + 0.5) * (_TWO_PI / NB_ORI_HIST_BINS)
            peaks.append((angle, v))
    peaks.sort(key=lambda t: -t[1])
    return peaks[:max_nb]


# ---------------------------------------------------------------------------
# Descriptor (parity: shaders/ComputeDescriptors.comp)
# ---------------------------------------------------------------------------

def descriptor_np(gauss: np.ndarray, scale_x: float, scale_y: float,
                  sigma_oct: float, orientation: float,
                  use_vlfeat: bool) -> np.ndarray:
    """128-D u8 descriptor for one keypoint; trilinear soft binning in
    float64, then the shader's normalize/clamp/quantize chain."""
    h, w = gauss.shape
    cx, cy = int(round(scale_x)), int(round(scale_y))
    scaled_lambda = LAMBDA_DESCRIPTOR * sigma_oct
    radius = math.sqrt(2.0) * scaled_lambda * (NB_HIST + 1) * 0.5
    int_r = int(math.floor(radius + 0.5))
    kcos = math.cos(orientation) / scaled_lambda
    ksin = math.sin(orientation) / scaled_lambda
    expf_scale = -1.0 / (2.0 * (NB_HIST / 2) * (NB_HIST / 2))
    hist = np.zeros((NB_HIST, NB_HIST, NB_ORI))
    fx = scale_x - cx
    fy = scale_y - cy
    for dy in range(-int_r, int_r + 1):
        for dx in range(-int_r, int_r + 1):
            px, py = cx + dx, cy + dy
            if not (1 <= px < w - 1 and 1 <= py < h - 1):
                continue
            sdx, sdy = dx - fx, dy - fy
            ox = kcos * sdx + ksin * sdy
            oy = kcos * sdy - ksin * sdx
            gx = 0.5 * (gauss[py, px + 1] - gauss[py, px - 1])
            gy = 0.5 * (gauss[py + 1, px] - gauss[py - 1, px])
            mag = math.exp(expf_scale * (ox * ox + oy * oy)) * math.hypot(gx, gy)
            theta = math.atan2(gy, gx)
            if theta < 0:
                theta += _TWO_PI
            rel = (theta - orientation) % _TWO_PI
            if use_vlfeat:
                fbin = rel * NB_ORI / _TWO_PI
            else:
                fbin = ((-rel) % _TWO_PI) * NB_ORI / _TWO_PI
            ty = oy + NB_HIST / 2 - 0.5
            tx = ox + NB_HIST / 2 - 0.5
            for yy in range(NB_HIST):
                wy = 1.0 - abs(yy - ty)
                if wy <= 0:
                    continue
                for xx in range(NB_HIST):
                    wx = 1.0 - abs(xx - tx)
                    if wx <= 0:
                        continue
                    for oo in range(NB_ORI):
                        od = abs(oo - fbin)
                        wo = 1.0 - min(od, NB_ORI - od)
                        if wo <= 0:
                            continue
                        hist[yy, xx, oo] += mag * wy * wx * wo
    raw = hist.reshape(DESC_SIZE)
    norm = math.sqrt(float(raw @ raw))
    clipped = np.minimum(raw, L2_NORM_THRESHOLD * norm)
    norm2 = math.sqrt(float(clipped @ clipped))
    if norm2 == 0:
        norm2 = 1.0
    vals = np.floor(clipped * (512.0 / norm2))
    return np.clip(vals, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Matching (parity: shaders/Get2NearestNeighbors.comp)
# ---------------------------------------------------------------------------

def match_2nn_np(desc_a: np.ndarray, desc_b: np.ndarray) -> np.ndarray:
    """Serial-scan 2-NN with earliest-index tie-breaking
    (Get2NearestNeighbors.comp:43-96). Returns (NA, 4): i1, i2, d1, d2."""
    a = desc_a.astype(np.float64)
    b = desc_b.astype(np.float64)
    out = np.zeros((a.shape[0], 4))
    for i in range(a.shape[0]):
        d1 = d2 = np.inf
        i1 = i2 = 0
        for j in range(b.shape[0]):
            d = float(((a[i] - b[j]) ** 2).sum())
            if d < d1:
                d2, i2 = d1, i1
                d1, i1 = d, j
            elif d < d2:
                d2, i2 = d, j
        out[i] = (i1, i2, math.sqrt(d1), math.sqrt(d2))
    return out


# ---------------------------------------------------------------------------
# Full-image detection (composition of the stages above)
# ---------------------------------------------------------------------------

def _extrema_dense_np(dog: np.ndarray, dog_threshold: float) -> np.ndarray:
    """Vectorized strict 26-neighbor extremum mask; same semantics as
    :func:`extrema_np` (kept separate: the scalar version is the oracle the
    kernel tests cite; this one exists so full-image detection is usable as
    a perf-harness wrapper). Returns (K, 3) int (s, y, x), raster order."""
    d = dog.astype(np.float64)
    ns, h, w = d.shape
    c = d[1:-1, 1:-1, 1:-1]
    nb_max = np.full_like(c, -np.inf)
    nb_min = np.full_like(c, np.inf)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                nb = d[1 + ds:ns - 1 + ds, 1 + dy:h - 1 + dy,
                       1 + dx:w - 1 + dx]
                np.maximum(nb_max, nb, out=nb_max)
                np.minimum(nb_min, nb, out=nb_min)
    mask = (np.abs(c) > dog_threshold * 0.8) & ((c > nb_max) | (c < nb_min))
    s, y, x = np.nonzero(mask)
    return np.stack([s + 1, y + 1, x + 1], axis=1)


def detect_np(image: np.ndarray, config: SiftConfig,
              max_features: Optional[int] = None) -> List[dict]:
    """Full float64 SIFT detection: pyramid -> extrema -> refine ->
    orientations -> descriptors. Returns a list of feature dicts with the
    vksift_Feature fields. Slow (reference oracle, not a product path);
    used by the perf harness as an independent CPU implementation
    (the VLFeat-slot analogue in src/perf/perf_common.cpp:42-61)."""
    cfg = config
    s_per = cfg.nb_scales_per_octave
    gaussians, dogs = build_pyramid_np(image, cfg)
    thr = cfg.dog_threshold / s_per
    feats: List[dict] = []
    for o, (g, d) in enumerate(zip(gaussians, dogs)):
        octave_idx = o - (1 if cfg.use_input_upsampling else 0)
        _, oh, ow = d.shape
        for (s, y, x) in _extrema_dense_np(d, thr):
            r = refine_np(d, int(s), int(y), int(x), nb_scales=s_per,
                          width=ow, height=oh, dog_threshold=thr,
                          edge_threshold=cfg.edge_threshold,
                          seed_sigma=cfg.seed_scale_sigma,
                          octave_idx=octave_idx)
            if r is None:
                continue
            sigma_oct = cfg.seed_scale_sigma * 2.0 ** (
                r["subpix_s"] / s_per)
            layer = int(np.clip(r["scale_idx"], 0, s_per + 1))
            oris = orientations_np(g[layer], r["scale_x"], r["scale_y"],
                                   sigma_oct, cfg.orientation_capacity)
            for angle, _peak in oris:
                desc = descriptor_np(
                    g[layer], r["scale_x"], r["scale_y"], sigma_oct, angle,
                    use_vlfeat=cfg.descriptor_format.value == 1)
                feats.append(dict(r, orientation=angle, descriptor=desc,
                                  octave_idx=octave_idx))
                if max_features and len(feats) >= max_features:
                    return feats
    return feats
