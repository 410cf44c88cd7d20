"""The staged debug detector: three stages around two host readbacks.

Port of ``vulkansift_tpu/detector.py`` (the reference's SiftDetector and
its recorded command buffer, sift_detector.c:1313-1410). As the JAX
package does, S2 and S3 run at power-of-two *buckets* of the readback
counts (:func:`_bucket`), so that the number of shapes, and of recorded
programs, stays bounded:

* **S1** (per input resolution): pyramid (kernel 1, the blur) and
  per-octave candidates (kernel 2, the frontend), compacted in raster
  order at each octave's section capacity.
* readback: per-octave candidate counts; S2's profile is their buckets.
* **S2** (per resolution x profile): per-octave refinement of the first
  ``profile[o]`` candidate slots, then one orientation-histogram launch
  (kernel 3) over the live keypoints of every octave, the peaks, and the
  keypoint-major (keypoint, orientation) pairs of each octave.
* readback: per-octave pair totals; an octave keeps at most its section
  capacity, and S3's profile is the buckets of the kept counts.
* **S3** (per resolution x both profiles): one descriptor launch (kernel
  4) over the kept pairs of every octave, whose ids are built on the
  device at the S3 profile's size, normalisation, and the pack into a
  :class:`~.types.Features` buffer at ``max_nb_sift_per_buffer``.

On a card each stage is a recorded :class:`~.compiled.StageProgram` (the
counterpart of the JAX stage's compiled program) in one graph pool a
detector; S2 and S3 read their parent stages' static outputs in place,
and only the detect's results (the Features, and the pyramid under
``retain_pyramid``) are copied out. The S3 key holds the resolution,
where the JAX one does not, because S3 reads S1's pyramid buffer. The
resolutions' programs are held in an LRU of ``config.detect_cache_size``
(the JAX detector's caches have no bound); evicting a resolution frees
its S2 and S3 programs with it. On the CPU the same stage functions run
eagerly under the same keys.

Capacity semantics are the JAX ``SiftDetector``'s, not the main path's
(:func:`.ops.backhalf.run_backhalf` follows ``run_atlas``): pairs are
clamped per octave, and ``lost`` is the sum over octaves of pairs found
minus pairs kept (sift_memory.c:1088-1102).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .compiled import EagerStage, GraphPool, ProgramCache, StageProgram
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

_MIN_BUCKET = 64

Stage = Union[StageProgram, EagerStage]
Profile = Tuple[int, ...]


def _bucket(n: int, cap: int) -> int:
    """Power-of-two bucket >= n, floored at _MIN_BUCKET, capped at cap."""
    n = max(int(n), 1)
    b = 1 << max(int(math.ceil(math.log2(n))), 0)
    return max(min(max(b, _MIN_BUCKET), max(cap, _MIN_BUCKET)), 1)


def _head(c: Candidates, n: int) -> Candidates:
    """The first ``n`` slots of a candidate set, its count clamped to
    them."""
    return Candidates(s=c.s[:n], y=c.y[:n], x=c.x[:n],
                      count=torch.clamp(c.count, max=n),
                      code0=None if c.code0 is None else c.code0[:n])


class _Resolution:
    """The stages of one input resolution: S1, and the S2 and S3 stages
    that read its outputs, by profile."""

    def __init__(self, s1: Stage):
        self.s1 = s1
        self.s2: Dict[Profile, Stage] = {}
        self.s3: Dict[Tuple[Profile, Profile], Stage] = {}

    def close(self) -> None:
        for stage in (*self.s3.values(), *self.s2.values(), self.s1):
            stage.close()


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
        self._pool = GraphPool()
        # (width, height) -> _Resolution, least recently used first; an
        # evicted resolution closes its S1, S2 and S3 stages.
        self._programs = ProgramCache(config.detect_cache_size)

    def close(self) -> None:
        """Free every recorded stage (a later detect records anew)."""
        self._programs.close()

    def _stage(self, fn, inputs: Sequence[torch.Tensor] = ()) -> Stage:
        if self.device.type == "cuda":
            return StageProgram(fn, inputs=inputs, device=self.device,
                                pool=self._pool)
        return EagerStage(fn, inputs=inputs)

    def _resolution(self, width: int, height: int, oct_res,
                    caps) -> _Resolution:
        def build() -> _Resolution:
            image = torch.zeros((height, width), dtype=torch.uint8,
                                device=self.device)
            return _Resolution(self._stage(
                lambda: self._stage1(image, oct_res, caps), (image,)))

        return self._programs.get((width, height), build)

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
        return dict(ss=ss, cands=cands, codes=codes, counts=counts)

    # -- S2: refine + orientations at the candidate profile ---------------
    def _stage2(self, st1, profile: Profile, oct_res):
        cfg = self.config
        ss = st1["ss"]
        s = cfg.nb_scales_per_octave
        up = 1 if cfg.use_input_upsampling else 0
        refined = [extract.refine_candidates(
            ss.dogs[o], _head(st1["cands"][o], profile[o]), nb_scales=s,
            width=ow, height=oh, dog_threshold=cfg.dog_threshold,
            edge_threshold=cfg.edge_threshold,
            seed_sigma=cfg.seed_scale_sigma, octave_idx=o - up,
            code=st1["codes"][o]) for o, (ow, oh) in enumerate(oct_res)]
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
        return dict(recs_k=recs_k, kidx=kidx, kp=kp, angles=ori.angles,
                    cs=cs, start=cs - nori, totals=totals)

    # -- S3: descriptors + pack at the pair profile -----------------------
    def _stage3(self, st1, st2, dprofile: Profile,
                caps: Sequence[int]) -> Features:
        cfg = self.config
        dev = self.device
        capacity = cfg.max_nb_sift_per_buffer
        nslots = st2["cs"].shape[0]
        npad = sum(dprofile)
        if nslots == 0 or npad == 0:
            return Features.empty(capacity, dev)
        # The kept pairs of octave o are its first min(total, cap) pairs,
        # the octaves' pairs being contiguous in pair order. Kept pair q
        # (of npad slots, the live ones first) is pair first[o] + q -
        # kstart[o] of the octave o whose kept range holds q.
        tot = st2["totals"]
        kept = torch.stack([tot[o].clamp(max=c) for o, c in enumerate(caps)])
        kend = torch.cumsum(kept, 0)
        npairs = kend[-1]
        q = torch.arange(npad, device=dev)
        o = torch.searchsorted(kend, q, right=True).clamp(max=len(caps) - 1)
        live = q < npairs
        pid = torch.where(live, (torch.cumsum(tot, 0) - tot)[o] + q
                          - (kend - kept)[o], 0)
        slot = torch.searchsorted(st2["cs"], pid, right=True).clamp(
            max=nslots - 1)
        oidx = (pid - st2["start"][slot]).clamp(0, self.ori_capacity - 1)
        angle = st2["angles"][slot, oidx]
        rec = st2["recs_k"].rec[slot].clone()
        rec[:, REC_ANGLE] = angle
        recs_p = SampleRecords(st2["recs_k"].base[slot].contiguous(),
                               rec.contiguous())
        raw = backhalf.descriptor(
            st1["ss"].flat, recs_p, npairs.to(torch.int32),
            desc_radius=self.desc_radius,
            use_vlfeat=cfg.descriptor_format == DescriptorFormat.VLFEAT)

        # The pack: the first min(npairs, capacity) slots, the tail zero.
        rows = min(npad, capacity)
        n = torch.clamp(npairs, max=capacity)
        keep = torch.arange(rows, device=dev) < n
        src = st2["kidx"][slot[:rows]]
        kp = st2["kp"]
        up = 1 if cfg.use_input_upsampling else 0
        vals = dict(
            x=kp["x"][src], y=kp["y"][src], scale_x=kp["scale_x"][src],
            scale_y=kp["scale_y"][src], scale_idx=kp["scale_idx"][src],
            octave_idx=(kp["octave"][src] - up).to(torch.int32),
            sigma=kp["sigma"][src], orientation=angle[:rows],
            intensity=kp["intensity"][src],
            descriptor=normalize_descriptor(raw[:rows]))
        feats = Features.empty(capacity, dev)
        for name, v in vals.items():
            m = keep if v.dim() == 1 else keep[:, None]
            getattr(feats, name)[:rows] = torch.where(
                m, v, torch.zeros((), dtype=v.dtype, device=dev))
        feats.count = n.to(torch.int32)
        return feats

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

        res = self._resolution(width, height, oct_res, caps)
        st1 = res.s1(img)
        profile = tuple(_bucket(int(c), caps[o])
                        for o, c in enumerate(st1["counts"].cpu()))
        s2 = res.s2.get(profile)
        if s2 is None:
            s2 = res.s2[profile] = self._stage(
                lambda: self._stage2(res.s1.outputs, profile, oct_res))
        st2 = s2()
        pair_totals = [int(t) for t in st2["totals"].cpu()]
        kept = [min(t, c) for t, c in zip(pair_totals, caps)]
        dprofile = tuple(
            _bucket(k, min(profile[o] * self.ori_capacity, caps[o]))
            for o, k in enumerate(kept))
        s3 = res.s3.get((profile, dprofile))
        if s3 is None:
            s3 = res.s3[(profile, dprofile)] = self._stage(
                lambda: self._stage3(res.s1.outputs, res.s2[profile].outputs,
                                     dprofile, caps))
        feats = s3()
        # The results outlive the stages' buffers.
        features = Features(**{f.name: getattr(feats, f.name).clone()
                               for f in dataclasses.fields(Features)})
        gaussians: Optional[tuple] = None
        dogs: Optional[tuple] = None
        if cfg.retain_pyramid:
            ss = st1["ss"]
            gaussians = tuple(g.clone() for g in ss.gaussians)
            dogs = tuple(d.clone() for d in ss.dogs)
        if self.device.type == "cuda":
            self._pool.record_done(torch.cuda.current_stream(self.device))

        lost = sum(t - k for t, k in zip(pair_totals, kept))
        self.lost = lost
        if lost > 0:
            logger.warning("Buffer too small to store all detected features "
                           "(%d features lost)", lost)
        return features, gaussians, dogs, kept
