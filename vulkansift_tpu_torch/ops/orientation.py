"""Keypoint orientation assignment.

Port of ``vulkansift_tpu/ops/orientation.py`` (the reference's
ComputeOrientation shader):

* :func:`raw_histograms` -- the histogram half of the JAX package's
  ``compute_orientations``, and the plain version of kernel 3
  (:func:`.backhalf.orientation_hist`): gaussian-weighted (lambda = 1.5)
  gradient magnitudes over the box of radius ``floor(3*1.5*sigma)`` into a
  raw 36-bin histogram, out-of-image gradient stencils excluded;
* :func:`peaks_from_histograms` -- PyTorch glue: 6x circular [1,1,1]/3
  smoothing, strict local maxima >= 0.8*max with parabolic interpolation,
  strongest first, up to ``capacity`` per keypoint.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import LAMBDA_ORIENTATION, NB_ORI_HIST_BINS, ORI_PEAK_RATIO
from .patches import (REC_CX, REC_CY, REC_SIG, REC_SX, REC_SY, SampleRecords,
                      window_gradients)

_TWO_PI = 2.0 * math.pi


class Orientations(NamedTuple):
    angles: torch.Tensor  # f32[K, CAP] radians
    valid: torch.Tensor   # bool[K, CAP]


def raw_histograms(flat: torch.Tensor, recs: SampleRecords, count: torch.Tensor,
                   *, ori_radius: int) -> torch.Tensor:
    """Raw 36-bin histograms (K, 36) of the records; rows >= ``count`` are
    zero. ``ori_radius`` is the static window bound
    (:func:`.patches.max_orientation_radius`)."""
    k = recs.rec.shape[0]
    if flat.device.type == "cpu" and int(count) < k:
        # On the CPU the count costs nothing to read: the rows past it are
        # zero, so only the live ones are computed.
        n = max(int(count), 0)
        zeros = recs.rec.new_zeros((k - n, NB_ORI_HIST_BINS))
        if n == 0:
            return zeros
        live = raw_histograms(flat, SampleRecords(recs.base[:n], recs.rec[:n]),
                              count, ori_radius=ori_radius)
        return torch.cat([live, zeros])
    rec = recs.rec
    gx, gy, dx, dy, in_img = window_gradients(flat, recs, ori_radius)
    sig = rec[:, REC_SIG]
    slam = LAMBDA_ORIENTATION * sig
    br = torch.floor(3.0 * slam)[:, None, None]
    expf_scale = (-1.0 / (2.0 * slam * slam))[:, None, None]
    fx = (rec[:, REC_SX] - rec[:, REC_CX])[:, None, None]
    fy = (rec[:, REC_SY] - rec[:, REC_CY])[:, None, None]
    sdx = dx - fx
    sdy = dy - fy
    sqrdist = sdx * sdx + sdy * sdy
    mask = (torch.abs(dx) <= br) & (torch.abs(dy) <= br) & in_img
    mag = torch.exp(sqrdist * expf_scale) * torch.sqrt(gx * gx + gy * gy)
    mag = torch.where(mask, mag, 0.0).reshape(k, -1)
    theta = torch.atan2(gy, gx)
    theta = torch.where(theta < 0, theta + _TWO_PI, theta)
    bins = torch.floor(theta * (NB_ORI_HIST_BINS / _TWO_PI)).to(torch.int64)
    bins = bins.clamp(0, NB_ORI_HIST_BINS - 1).reshape(k, -1)
    hist = torch.stack(
        [torch.where(bins == b, mag, 0.0).sum(-1)
         for b in range(NB_ORI_HIST_BINS)], dim=-1)
    live = torch.arange(k, device=flat.device) < count
    return torch.where(live[:, None], hist, 0.0)


def _smooth_shift_matrix(device) -> torch.Tensor:
    """(36, 108) matrix computing [smoothed, prev, next] in one product:
    the 6x circular [1,1,1]/3 smoothing and its two circular shifts, built
    in float64 on ``device`` (no host-to-device copy)."""
    eye = torch.eye(NB_ORI_HIST_BINS, dtype=torch.float64, device=device)
    up, down = torch.roll(eye, 1, 1), torch.roll(eye, -1, 1)
    m6 = torch.linalg.matrix_power((up + eye + down) / 3.0, 6)
    return torch.cat([m6, m6 @ up, m6 @ down], dim=1).to(torch.float32)


def peaks_from_histograms(hist: torch.Tensor, capacity: int) -> Orientations:
    """Smooth + peak-pick a batch of raw 36-bin histograms
    (ComputeOrientation.comp:130-168), strongest peak first."""
    nb = NB_ORI_HIST_BINS
    hp = hist.to(torch.float32) @ _smooth_shift_matrix(hist.device)
    hist, prev, nxt = hp[:, :nb], hp[:, nb:2 * nb], hp[:, 2 * nb:]
    hmax = hist.amax(-1, keepdim=True)
    is_peak = (hist >= ORI_PEAK_RATIO * hmax) & (hist > prev) & (hist > nxt)
    denom = prev - 2.0 * hist + nxt
    interp = torch.where(denom == 0.0, 0.0, 0.5 * (prev - nxt)
                         / torch.where(denom == 0.0, 1.0, denom))
    bin_idx = torch.arange(nb, dtype=torch.float32, device=hist.device)
    angles_all = (bin_idx[None, :] + interp + 0.5) * (_TWO_PI / nb)
    peak_vals = torch.where(is_peak, hist, -torch.inf)
    top_vals, top_idx = torch.topk(peak_vals, capacity, dim=1)
    angles = torch.gather(angles_all, 1, top_idx)
    return Orientations(angles=angles, valid=torch.isfinite(top_vals))

