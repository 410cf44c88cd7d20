"""The detect path: one function per static resolution that takes a u8
image and returns a packed fixed-capacity :class:`~.types.Features`
buffer, with no host synchronisation between its stages.

Port of ``vulkansift_tpu/pipeline.py`` with the back half of
``pallas_backhalf.run_atlas``:

1. ScaleSpace: u8 -> f32, optional 2x upsample, per-octave blur + DoG
   (kernel 1), 2x downsample to seed the next octave.
2. ExtractKeypoints: per octave, the dense frontend (kernel 2), the
   raster-order compaction at the octave's section capacity, the walk and
   the final Newton tests.
3. Back half: orientation histograms (kernel 3), peaks, descriptors
   (kernel 4), normalisation, and the pack at the buffer capacity.

Every data-dependent size runs at its static capacity; the live counts stay
on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import SiftConfig
from .ops import backhalf, extract, frontend, scale_space
from .types import Features
from .utils.device import DeviceLike, resolve_device


class DetectOutput(NamedTuple):
    features: Features
    lost: torch.Tensor               # i32[] features dropped at the clamp
    per_octave_counts: torch.Tensor  # i32[nb_octaves]


def _empty_output(capacity: int, nb_oct: int, device) -> DetectOutput:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return DetectOutput(Features.empty(capacity, device), z,
                        torch.zeros(nb_oct, dtype=torch.int32, device=device))


def octave_plan(config: SiftConfig, width: int, height: int,
                bucket: int = 1) -> Tuple[Tuple[int, int], ...]:
    """The per-octave (width, height) sizes the detect function runs for
    this (possibly bucket-padded) resolution (parity:
    ``pipeline.octave_plan``). Under bucketing (``bucket > 1``) the octave
    count comes from the smallest resolution that pads to this one (one
    program serves the whole bucket), so it can be one less than the
    exact resolution's; the instance records this plan per buffer."""
    oct_res = config.octave_resolutions(width, height)
    if bucket > 1:
        n_cap = config.max_octaves_for(max(width - bucket + 1, 32),
                                       max(height - bucket + 1, 32))
        oct_res = oct_res[:n_cap]
    return oct_res


def make_detect_fn(config: SiftConfig, width: int, height: int, *,
                   return_pyramid: bool = False, device: DeviceLike = "cuda",
                   bucket: int = 1):
    """Build the detect function for one static resolution.

    Returns ``detect(image_u8, valid_w=None, valid_h=None, capture=None)
    -> DetectOutput`` (or ``(DetectOutput, gaussians, dogs)`` with
    ``return_pyramid``). The image is an (H, W) uint8 array or tensor; it
    is moved to the function's device. ``capture``, a dict, receives the
    back half's kernel inputs (see :func:`.ops.backhalf.run_backhalf`), for
    comparisons on the card.

    ``bucket > 1`` builds the function of a resolution bucket (parity:
    ``pipeline.make_detect_fn(bucket=...)``): the image is the bucket-sized
    (edge-padded) frame, the octave plan is :func:`octave_plan`'s for the
    bucket, and ``valid_w`` / ``valid_h`` (Python numbers or scalar tensors
    on the device, so that one recorded program serves every size in the
    bucket) drop the keypoints found in the padding before the back half.
    """
    cfg = config
    dev = resolve_device(device, cfg.device_index)
    s = cfg.nb_scales_per_octave
    bucketed = bucket > 1
    oct_res = octave_plan(cfg, width, height, bucket)
    nb_oct = len(oct_res)
    caps = cfg.octave_section_capacities(nb_oct)
    oct_shapes = tuple((h, w) for (w, h) in oct_res)
    capacity = cfg.max_nb_sift_per_buffer

    def detect(image_u8, valid_w=None, valid_h=None,
               capture: Optional[Dict] = None):
        img = image_u8 if isinstance(image_u8, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(image_u8))
        if img.device.type == "cpu" and dev.type == "cuda":
            # Pinned staging: the upload does not wait for earlier frames.
            img = img.pin_memory()
        img = img.to(dev, non_blocking=True)
        if img.shape != (height, width) or img.dtype != torch.uint8:
            raise ValueError(f"expected a ({height}, {width}) uint8 image")
        if nb_oct == 0 or sum(caps) == 0:
            out = _empty_output(capacity, nb_oct, dev)
            return (out, (), ()) if return_pyramid else out

        img = img.to(torch.float32) * (1.0 / 255.0)
        ss = scale_space.build_pyramid(img, cfg, oct_shapes)

        refined = []
        for o, (ow, oh) in enumerate(oct_res):
            dog = ss.dogs[o]
            cand, code = frontend.frontend_candidates(
                dog, cfg.dog_threshold, caps[o])
            refined.append(extract.refine_candidates(
                dog, cand, nb_scales=s, width=ow, height=oh,
                dog_threshold=cfg.dog_threshold,
                edge_threshold=cfg.edge_threshold,
                seed_sigma=cfg.seed_scale_sigma,
                octave_idx=o - (1 if cfg.use_input_upsampling else 0),
                code=code))
        if bucketed and valid_w is not None:
            # Drop the keypoints found in the bucket's padding.
            refined = [r._replace(valid=r.valid & (r.x < valid_w)
                                  & (r.y < valid_h)) for r in refined]

        fields, count, per_octave, lost = backhalf.run_backhalf(
            ss.flat, ss.offsets, refined, config=cfg, oct_res=oct_res,
            capacity=capacity, capture=capture)
        out = DetectOutput(Features(count=count, **fields), lost, per_octave)
        if return_pyramid:
            return out, ss.gaussians, ss.dogs
        return out

    return detect


def make_detect_batched(config: SiftConfig, width: int, height: int, *,
                        device: DeviceLike = "cuda"):
    """Batched detect: (B, H, W) uint8 images -> :class:`DetectOutput` whose
    every tensor has a leading batch dimension (parity:
    ``pipeline.make_detect_batched``). A loop over the single-image
    function, as the JAX package's ``lax.map`` is a scan of it; the outputs
    are stacked."""
    detect = make_detect_fn(config, width, height, device=device)

    def detect_batched(images) -> DetectOutput:
        outs = [detect(img) for img in images]

        def stack(get):
            return torch.stack([get(o) for o in outs])

        feats = Features(**{f.name: stack(lambda o, n=f.name:
                                          getattr(o.features, n))
                            for f in dataclasses.fields(Features)})
        return DetectOutput(feats, stack(lambda o: o.lost),
                            stack(lambda o: o.per_octave_counts))

    return detect_batched
