"""What a traced item's work needs at the card's peaks.

A kernel's bound is the larger of its bytes over the memory bandwidth and
its operations over the published peak of their kind
(``peaks.json``); its roofline share is the bound over the kernel's
device time. The work counted is what the algorithm needs at these inputs:
every pyramid layer read once and written once, the DoG stacks read once,
the distinct pixels of the live keypoints' and orientation pairs' sampling
windows, and NA x NB x 128 products at the live counts. Each kernel's own
formula is in ``kernels/<name>.py``; this module holds the geometry they
share, taken from the configuration, the frame size and the features the
program returned (frozen from ``chip_smoke.py``'s ``blur_bound``,
``frontend_bound``, ``_window_work`` and ``match_bounds``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from reference import sift as ref_sift

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / ops_per_s)


@dataclasses.dataclass
class Frame:
    """One detect's inputs: the configuration, the frame size and the
    features it returned."""

    cfg: dict
    width: int
    height: int
    features: Dict[str, np.ndarray]

    @property
    def sizes(self):
        return ref_sift.octave_sizes(self.cfg, self.width, self.height)

    @property
    def scales(self) -> int:
        return self.cfg["nb_scales_per_octave"]


@dataclasses.dataclass
class Item:
    """A traced item: the detects it ran and its match's live counts."""

    frames: List[Frame]
    na: Optional[int] = None
    nb: Optional[int] = None


def _records(frame: Frame, per_pair: bool):
    """(octave, layer, sx, sy, sigma) in the sampled octave's pixels, one
    per orientation pair or one per keypoint (pairs at one place and scale
    share a keypoint), with the program's sigma-scaled sampling."""
    f = frame.features
    up = 1 if frame.cfg["use_input_upsampling"] else 0
    s = frame.scales
    n_oct = len(frame.sizes)
    o = np.asarray(f["octave_idx"], np.int64) + up
    si = np.asarray(f["scale_idx"], np.int64)
    sx = np.asarray(f["scale_x"], np.float64)
    sy = np.asarray(f["scale_y"], np.float64)
    sig = np.asarray(f["sigma"], np.float64) / 2.0 ** (o - up)
    if not per_pair:
        _, first = np.unique(np.stack([o, si, sx, sy], 1), axis=0,
                             return_index=True)
        o, si, sx, sy, sig = (a[first] for a in (o, si, sx, sy, sig))
    remap = (si >= s) & (o + 1 < n_oct)
    return (np.where(remap, o + 1, o),
            np.clip(np.where(remap, si - s, si), 0, s + 2),
            np.where(remap, (sx - 1) * 0.5, sx),
            np.where(remap, (sy - 1) * 0.5, sy),
            np.maximum(np.where(remap, sig * 0.5, sig), 1e-6))


def window_work(frame: Frame, per_pair: bool,
                radius: Callable[[np.ndarray], np.ndarray], device):
    """(distinct pyramid pixels read, window cells, records) of the live
    sampling windows: each cell inside the layer's border reads its four
    gradient taps; a pixel read by several windows counts once."""
    sizes = frame.sizes
    layers = frame.scales + 3
    offs = np.cumsum([0] + [layers * w * h for w, h in sizes])
    o, layer, sx, sy, sig = _records(frame, per_pair)
    n = len(o)
    if n == 0:
        return 0, 0, 0
    w = np.array([sizes[k][0] for k in o], np.int64)
    h = np.array([sizes[k][1] for k in o], np.int64)
    cx = np.minimum(np.maximum(np.rint(sx), 0), w).astype(np.int64)
    cy = np.minimum(np.maximum(np.rint(sy), 0), h).astype(np.int64)
    base = offs[o] + layer * w * h
    rad = radius(sig).astype(np.int64)
    r_max = int(rad.max())
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    d = torch.arange(-r_max, r_max + 1, device=device)
    dy, dx = (g.reshape(1, -1) for g in torch.meshgrid(d, d, indexing="ij"))
    read = torch.zeros(int(offs[-1]), dtype=torch.bool, device=device)
    cells = 0
    for i in range(0, n, 256):
        sl = slice(i, i + 256)
        r, ww, hh = t(rad[sl])[:, None], t(w[sl])[:, None], t(h[sl])[:, None]
        px, py = t(cx[sl])[:, None] + dx, t(cy[sl])[:, None] + dy
        ok = ((dx.abs() <= r) & (dy.abs() <= r) & (px >= 1) & (px < ww - 1)
              & (py >= 1) & (py < hh - 1))
        at = (t(base[sl])[:, None] + py * ww + px)[ok]
        row = ww.expand_as(ok)[ok]
        cells += int(at.numel())
        for tap in (at - 1, at + 1, at - row, at + row):
            read[tap] = True
    return int(read.sum()), cells, n


def ori_radius(sig: np.ndarray) -> np.ndarray:
    return np.floor(3.0 * (ref_sift.LAMBDA_ORI * sig))


def desc_radius(sig: np.ndarray) -> np.ndarray:
    return np.floor(math.sqrt(2.0) * (ref_sift.LAMBDA_DESC * sig)
                    * (ref_sift.NB_HIST + 1) * 0.5 + 0.5)
