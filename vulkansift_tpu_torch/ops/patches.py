"""Keypoint sampling geometry shared by the orientation and descriptor
stages.

Port of ``vulkansift_tpu/ops/patches.py``. Instead of gathering a static
patch per keypoint, the port describes where each keypoint samples the
gaussian pyramid with a :class:`SampleRecords` row: the element offset of
its gaussian layer in the flat pyramid buffer (``ScaleSpace.flat``) and the
sampling scalars. The kernels read their window straight from that layer;
the plain versions gather the same pixels with index arithmetic.

Sigma-scaled sampling (the JAX package's ``sigma_remap_enabled`` default)
is always on, with no switch: keypoints refined to an octave's top
scales (``scale_idx >= nb_scales``) sample the NEXT octave's layer
``scale_idx - nb_scales`` at half resolution, where hi-res coordinate u
lands at lo-res ``(u - 1) / 2`` (the next octave is seeded with the odd
texels of this one).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import LAMBDA_DESCRIPTOR, LAMBDA_ORIENTATION, NB_HIST, SiftConfig

# Record columns (f32): sampling x, y (octave pixels of the sampled
# octave), sigma in those pixels (>= 1e-6), window centre cx, cy, the
# sampled octave's width and height, and the orientation (descriptors).
REC_SX, REC_SY, REC_SIG, REC_CX, REC_CY, REC_W, REC_H, REC_ANGLE = range(8)
REC_COLS = 8


def max_sigma_octave_pixels(config: SiftConfig) -> float:
    """Worst-case keypoint sigma in octave pixel units."""
    s = config.nb_scales_per_octave
    return config.seed_scale_sigma * 2.0 ** ((s + 1) / s)


def max_descriptor_radius(config: SiftConfig) -> int:
    sig = max_sigma_octave_pixels(config)
    return int(math.floor(math.sqrt(2.0) * LAMBDA_DESCRIPTOR * sig
                          * (NB_HIST + 1) * 0.5 + 0.5))


def max_orientation_radius(config: SiftConfig) -> int:
    sig = max_sigma_octave_pixels(config)
    return int(math.floor(3.0 * LAMBDA_ORIENTATION * sig))


def patch_size(config: SiftConfig) -> int:
    """Descriptor window edge including the gradient ring."""
    return 2 * (max_descriptor_radius(config) + 1) + 1


class SampleRecords(NamedTuple):
    """Where each keypoint (or pair) samples the pyramid."""

    base: torch.Tensor  # i64[K] offset of the sampled layer in the flat buffer
    rec: torch.Tensor   # f32[K, REC_COLS]


def window_gradients(flat: torch.Tensor, recs: SampleRecords, radius: int):
    """Plain gather of the (K, 2r+1, 2r+1) window around each record's
    centre: central-difference gradients (gx, gy), the integer offsets
    (dx, dy) as f32 and the in-image mask (gradient stencil inside the
    sampled octave). Pixels outside the image read offset 0 and are
    masked."""
    rec = recs.rec
    dev = flat.device
    d = torch.arange(-radius, radius + 1, device=dev)
    cx = rec[:, REC_CX].to(torch.int64)[:, None, None]
    cy = rec[:, REC_CY].to(torch.int64)[:, None, None]
    w = rec[:, REC_W].to(torch.int64)[:, None, None]
    h = rec[:, REC_H].to(torch.int64)[:, None, None]
    px = cx + d[None, None, :]
    py = cy + d[None, :, None]
    in_img = (px >= 1) & (px < w - 1) & (py >= 1) & (py < h - 1)
    at = recs.base[:, None, None] + py * w + px
    at = torch.where(in_img, at, 0)
    dw = torch.where(in_img, w, 0)
    dx1 = torch.where(in_img, 1, 0)
    gx = 0.5 * (flat[at + dx1] - flat[at - dx1])
    gy = 0.5 * (flat[at + dw] - flat[at - dw])
    df = d.to(torch.float32)
    return gx, gy, df[None, None, :], df[None, :, None], in_img
