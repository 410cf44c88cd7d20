"""128-D SIFT descriptors.

Port of ``vulkansift_tpu/ops/descriptor.py`` (the reference's
ComputeDescriptors shader) in its hat-product form:

    desc[y, x, o] = sum_p wy_p[y] * (wx_p[x] * wo_p[o] * mag_p)
    wy_p[i] = relu(1 - |i - ty_p|)                 (ty = oy + 2 - 0.5)
    wo_p[o] = relu(1 - circdist_8(o, fbin_p))

* :func:`raw_descriptors` -- the plain version of kernel 4
  (:func:`.backhalf.descriptor`): the rotated, gaussian-weighted
  (lambda = 3) gradient window of radius
  ``floor(sqrt(2)*3*sigma*(NB_HIST+1)/2 + 0.5)``, trilinear weights into
  4x4 cells x 8 bins, UBC or VLFeat bin direction;
* :func:`normalize_descriptor` -- PyTorch glue: L2 normalise, clamp at
  0.2*norm, renormalise, *512, floor, saturate to u8.
"""

from __future__ import annotations

import math

import torch

from ..config import (DESC_SIZE, L2_NORM_THRESHOLD, LAMBDA_DESCRIPTOR,
                      NB_HIST, NB_ORI)
from .patches import (REC_ANGLE, REC_CX, REC_CY, REC_SIG, REC_SX, REC_SY,
                      SampleRecords, window_gradients)

_TWO_PI = 2.0 * math.pi


def _raw_chunk(flat: torch.Tensor, recs: SampleRecords, *, desc_radius: int,
               use_vlfeat: bool) -> torch.Tensor:
    rec = recs.rec
    k = rec.shape[0]
    gx, gy, dx, dy, in_img = window_gradients(flat, recs, desc_radius)
    sig = rec[:, REC_SIG]
    ori = rec[:, REC_ANGLE][:, None, None]
    slam = LAMBDA_DESCRIPTOR * sig
    radius = math.sqrt(2.0) * slam * (NB_HIST + 1) * 0.5
    ir = torch.floor(radius + 0.5)[:, None, None]
    fx = (rec[:, REC_SX] - rec[:, REC_CX])[:, None, None]
    fy = (rec[:, REC_SY] - rec[:, REC_CY])[:, None, None]
    sdx = dx - fx
    sdy = dy - fy
    mask = (torch.abs(dx) <= ir) & (torch.abs(dy) <= ir) & in_img

    inv_lambda = 1.0 / slam
    kcos = (torch.cos(rec[:, REC_ANGLE]) * inv_lambda)[:, None, None]
    ksin = (torch.sin(rec[:, REC_ANGLE]) * inv_lambda)[:, None, None]
    ox = kcos * sdx + ksin * sdy
    oy = kcos * sdy - ksin * sdx
    expf_scale = -1.0 / (2.0 * (NB_HIST / 2) * (NB_HIST / 2))
    mag = torch.exp(expf_scale * (ox * ox + oy * oy)) * torch.sqrt(
        gx * gx + gy * gy)
    mag = torch.where(mask, mag, 0.0)

    theta = torch.atan2(gy, gx)
    theta = torch.where(theta < 0, theta + _TWO_PI, theta)
    rel = torch.remainder(theta - ori, _TWO_PI)
    if use_vlfeat:
        fbin = rel * (NB_ORI / _TWO_PI)
    else:
        fbin = torch.remainder(-rel, _TWO_PI) * (NB_ORI / _TWO_PI)

    ty = oy + NB_HIST / 2 - 0.5
    tx = ox + NB_HIST / 2 - 0.5
    cells = torch.arange(NB_HIST, dtype=torch.float32, device=flat.device)
    wy = torch.clamp(1.0 - torch.abs(cells - ty[..., None]), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(cells - tx[..., None]), min=0.0)
    obins = torch.arange(NB_ORI, dtype=torch.float32, device=flat.device)
    od = torch.abs(obins - fbin[..., None])
    wo = torch.clamp(1.0 - torch.minimum(od, NB_ORI - od), min=0.0)

    n = mag.shape[1] * mag.shape[2]
    wy = wy.reshape(k, n, NB_HIST)
    wxo = (wx[..., :, None] * wo[..., None, :]).reshape(k, n, NB_HIST * NB_ORI)
    wxo = wxo * mag.reshape(k, n, 1)
    desc = torch.einsum("kpy,kpz->kyz", wy, wxo)
    return desc.reshape(k, DESC_SIZE)


def raw_descriptors(flat: torch.Tensor, recs: SampleRecords,
                    count: torch.Tensor, *, desc_radius: int,
                    use_vlfeat: bool, chunk: int = 256) -> torch.Tensor:
    """Raw (unnormalised) descriptors (K, 128) of the pair records (the
    angle in column REC_ANGLE); rows >= ``count`` are zero. Work runs in
    chunks of ``chunk`` pairs to bound the (chunk, window, 32)
    intermediate."""
    k = recs.rec.shape[0]
    # On the CPU the count costs nothing to read, so the chunks wholly past
    # it (zero in the result) are skipped; on a device it stays there.
    stop = min(k, int(count)) if flat.device.type == "cpu" else k
    parts = [_raw_chunk(flat, SampleRecords(recs.base[i:i + chunk],
                                            recs.rec[i:i + chunk]),
                        desc_radius=desc_radius, use_vlfeat=use_vlfeat)
             for i in range(0, stop, chunk)]
    done = min(k, -(-stop // chunk) * chunk)
    parts.append(recs.rec.new_zeros((k - done, DESC_SIZE)))
    raw = torch.cat(parts)
    live = torch.arange(k, device=flat.device) < count
    return torch.where(live[:, None], raw, 0.0)


def normalize_descriptor(raw: torch.Tensor) -> torch.Tensor:
    """L2 normalise / clamp at 0.2*norm / renormalise / *512 / floor / u8
    (ComputeDescriptors.comp:201-265)."""
    norm = torch.sqrt(torch.sum(raw * raw, dim=-1, keepdim=True))
    clipped = torch.minimum(raw, L2_NORM_THRESHOLD * norm)
    norm2 = torch.sqrt(torch.sum(clipped * clipped, dim=-1, keepdim=True))
    safe = torch.where(norm2 == 0.0, 1.0, norm2)
    vals = torch.floor(clipped * (512.0 / safe))
    return torch.clamp(vals, 0.0, 255.0).to(torch.uint8)
