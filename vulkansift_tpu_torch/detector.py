"""The staged debug detector: three stages around two host readbacks.

Port of ``vulkansift_tpu/detector.py`` (the reference's SiftDetector and
its recorded command buffer, sift_detector.c:1313-1410). Where the JAX
package compiles each stage per power-of-two bucket of the readback
counts, eager PyTorch runs every stage at the exact counts, so the buckets
have no counterpart; they never changed a result.

* **S1**: pyramid (kernel 1, the blur) and per-octave candidates (kernel
  2, the frontend), compacted in raster order at each octave's section
  capacity.
* readback: per-octave candidate counts.
* **S2**: per-octave refinement, then one orientation-histogram launch
  (kernel 3) over the live keypoints of every octave, the peaks, and the
  keypoint-major (keypoint, orientation) pairs of each octave, clamped to
  that octave's section capacity.
* readback: per-octave pair counts and totals.
* **S3**: one descriptor launch (kernel 4) over the kept pairs of every
  octave, normalisation, and the pack into a :class:`~.types.Features`
  buffer at ``max_nb_sift_per_buffer``.

Capacity semantics are the JAX ``SiftDetector``'s, not the main path's
(:func:`.ops.backhalf.run_backhalf` follows ``run_atlas``): pairs are
clamped per octave, and ``lost`` is the sum over octaves of pairs found
minus pairs kept (sift_memory.c:1088-1102).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DescriptorFormat, SiftConfig
from .ops import backhalf, extract, frontend, scale_space
from .ops.descriptor import normalize_descriptor
from .ops.extract import Candidates, rank_select
from .ops.orientation import peaks_from_histograms
from .ops.patches import (REC_ANGLE, SampleRecords, max_descriptor_radius,
                          max_orientation_radius)
from .types import Features
from .utils.device import DeviceLike, resolve_device
from .utils.logging import logger


def _head(c: Candidates, n: int) -> Candidates:
    """The first ``n`` slots of a candidate set (its live ones)."""
    return Candidates(s=c.s[:n], y=c.y[:n], x=c.x[:n], count=c.count,
                      code0=None if c.code0 is None else c.code0[:n])


class SiftDetector:
    """The staged detector for one configuration on one device (default
    ``"cuda"``; ``device="cpu"`` runs the kernels' plain versions)."""

    def __init__(self, config: SiftConfig, *, device: DeviceLike = "cuda"):
        self.config = config
        # Features lost to the per-octave clamp by the last detect (the JAX
        # detector only logs it).
        self.lost = 0
        self.device = resolve_device(device, config.device_index)
        self.ori_radius = max_orientation_radius(config)
        self.desc_radius = max_descriptor_radius(config)
        self.ori_capacity = config.orientation_capacity

    # -- S1: pyramid + candidates ---------------------------------------
    def _stage1(self, image_u8: torch.Tensor, oct_res, caps):
        cfg = self.config
        img = image_u8.to(torch.float32) * (1.0 / 255.0)
        ss = scale_space.build_pyramid(img, cfg,
                                       tuple((h, w) for (w, h) in oct_res))
        cands, codes = [], []
        for o in range(len(oct_res)):
            c, code = frontend.frontend_candidates(
                ss.dogs[o], cfg.dog_threshold, caps[o])
            cands.append(c)
            codes.append(code)
        counts = (torch.stack([c.count for c in cands]) if cands
                  else torch.zeros(0, dtype=torch.int32, device=self.device))
        return ss, cands, codes, counts

    # -- S2: refine + orientations + per-octave pair clamp ----------------
    def _stage2(self, ss, cands, codes, cand_counts: Sequence[int],
                oct_res):
        cfg = self.config
        s = cfg.nb_scales_per_octave
        up = 1 if cfg.use_input_upsampling else 0
        refined = [extract.refine_candidates(
            ss.dogs[o], _head(cands[o], cand_counts[o]), nb_scales=s,
            width=ow, height=oh, dog_threshold=cfg.dog_threshold,
            edge_threshold=cfg.edge_threshold,
            seed_sigma=cfg.seed_scale_sigma, octave_idx=o - up,
            code=codes[o]) for o, (ow, oh) in enumerate(oct_res)]
        recs, kp = backhalf.keypoint_records(
            refined, config=cfg, oct_res=oct_res, offsets=ss.offsets)

        # One histogram launch over the live keypoints of every octave, in
        # octave then raster order.
        nslots = recs.rec.shape[0]
        kidx, kcnt = rank_select(kp["valid"], nslots)
        kidx = kidx.to(torch.int64)
        recs_k = SampleRecords(recs.base[kidx].contiguous(),
                               recs.rec[kidx].contiguous())
        if nslots:
            hist = backhalf.orientation_hist(ss.flat, recs_k, kcnt,
                                             ori_radius=self.ori_radius)
        else:
            hist = torch.zeros((0, 36), dtype=torch.float32,
                               device=self.device)
        ori = peaks_from_histograms(hist, self.ori_capacity)

        # Keypoint-major pairs: a keypoint's valid orientations are a
        # prefix of its row, so its pairs are slots [start, start + nori).
        live = torch.arange(nslots, device=self.device) < kcnt
        nori = (ori.valid & live[:, None]).sum(1, dtype=torch.int64)
        cs = torch.cumsum(nori, 0)
        totals = torch.zeros(len(oct_res), dtype=torch.int64,
                             device=self.device).index_add_(
            0, kp["octave"][kidx].to(torch.int64), nori)
        return dict(recs_k=recs_k, kidx=kidx, kp=kp,
                    angles=ori.angles, cs=cs, start=cs - nori), totals

    # -- S3: descriptors + pack ------------------------------------------
    def _stage3(self, ss, st2, pair_totals: Sequence[int],
                caps: Sequence[int]) -> Tuple[Features, List[int]]:
        cfg = self.config
        dev = self.device
        kept = [min(t, c) for t, c in zip(pair_totals, caps)]
        first = np.concatenate([[0], np.cumsum(pair_totals)[:-1]]).astype(
            np.int64)
        # Global pair ids of the kept pairs: the first kept[o] pairs of
        # octave o, the octaves' pairs being contiguous in pair order.
        pid = torch.cat([torch.arange(int(f), int(f) + k, device=dev)
                         for f, k in zip(first, kept)]
                        + [torch.zeros(0, dtype=torch.int64, device=dev)])
        slot = torch.searchsorted(st2["cs"], pid, right=True)
        oidx = pid - st2["start"][slot]
        angle = st2["angles"][slot, oidx]
        rec = st2["recs_k"].rec[slot].clone()
        rec[:, REC_ANGLE] = angle
        recs_p = SampleRecords(st2["recs_k"].base[slot].contiguous(),
                               rec.contiguous())
        npairs = int(pid.shape[0])
        if npairs:
            raw = backhalf.descriptor(
                ss.flat, recs_p,
                torch.full((), npairs, dtype=torch.int32, device=dev),
                desc_radius=self.desc_radius,
                use_vlfeat=cfg.descriptor_format == DescriptorFormat.VLFEAT)
        else:
            raw = torch.zeros((0, 128), dtype=torch.float32, device=dev)

        capacity = cfg.max_nb_sift_per_buffer
        n = min(npairs, capacity)
        src = st2["kidx"][slot[:n]]
        kp = st2["kp"]
        up = 1 if cfg.use_input_upsampling else 0
        vals = dict(
            x=kp["x"][src], y=kp["y"][src], scale_x=kp["scale_x"][src],
            scale_y=kp["scale_y"][src], scale_idx=kp["scale_idx"][src],
            octave_idx=(kp["octave"][src] - up).to(torch.int32),
            sigma=kp["sigma"][src], orientation=angle[:n],
            intensity=kp["intensity"][src],
            descriptor=normalize_descriptor(raw[:n]))
        feats = Features.empty(capacity, dev)
        for name, v in vals.items():
            getattr(feats, name)[:n] = v
        feats.count = torch.full((), n, dtype=torch.int32, device=dev)
        return feats, kept

    def detect(self, image, width: int, height: int):
        """Run the three stages on one (height, width) uint8 image.

        Returns ``(features, gaussians, dogs, per_octave)``: the packed
        :class:`~.types.Features`, the per-octave gaussian and DoG stacks
        (None unless ``config.retain_pyramid``) and the per-octave kept
        pair counts as a host list."""
        cfg = self.config
        img = image if isinstance(image, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(image))
        img = img.to(self.device)
        if img.shape != (height, width) or img.dtype != torch.uint8:
            raise ValueError(f"expected a ({height}, {width}) uint8 image")
        oct_res = cfg.octave_resolutions(width, height)
        caps = cfg.octave_section_capacities(len(oct_res))

        ss, cands, codes, cand_counts = self._stage1(img, oct_res, caps)
        host_counts = [int(c) for c in cand_counts.cpu()]
        st2, totals = self._stage2(ss, cands, codes, host_counts, oct_res)
        pair_totals = [int(t) for t in totals.cpu()]
        features, kept = self._stage3(ss, st2, pair_totals, caps)
        lost = sum(t - k for t, k in zip(pair_totals, kept))
        self.lost = lost
        if lost > 0:
            logger.warning("Buffer too small to store all detected features "
                           "(%d features lost)", lost)
        gaussians: Optional[tuple] = ss.gaussians if cfg.retain_pyramid \
            else None
        dogs: Optional[tuple] = ss.dogs if cfg.retain_pyramid else None
        return features, gaussians, dogs, kept
