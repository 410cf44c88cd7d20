"""Back half: orientation histograms (kernel 3), descriptors (kernel 4) and
the orchestration around them.

Wrappers:

* :func:`orientation_hist` -- ``csrc/orientation_hist.cu`` (replaces
  ``vulkansift_tpu/ops/pallas_backhalf.py::orientation_hist_tpu``); plain
  version :func:`.orientation.raw_histograms`;
* :func:`descriptor` -- ``csrc/descriptor.cu`` (replaces
  ``pallas_backhalf.descriptor_tpu`` and ``descriptor_tpu_packed``); plain
  version :func:`.descriptor.raw_descriptors`.

Both read the live count from device memory, so the count never crosses
to the host: each launches as a persistent grid sized to the card that
takes keypoints (pairs) up to the count. The histogram kernel writes
every row of its output, those past the count as zeros; the descriptor
kernel takes pairs from a work counter held after the rows of its
zero-filled output.

:func:`run_backhalf` is the port of ``pallas_backhalf.run_atlas`` as plain
PyTorch at full capacity: one record per keypoint with sigma-scaled
sampling, a histogram per live keypoint, peaks, keypoint-major pair
bookkeeping, a descriptor per live pair, normalisation and the Features
pack. Capacity semantics are run_atlas's: one global capacity, ``lost =
pair_total - count``. The TPU's atlas, window alignment, roll addressing,
sigma buckets and ``lax.switch`` live-count buckets have no counterpart:
the kernels read each window straight out of the keypoint's layer of the
per-octave gaussian stacks.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import DESC_SIZE, NB_ORI_HIST_BINS, DescriptorFormat, SiftConfig
from . import cuda_lib
from .descriptor import normalize_descriptor, raw_descriptors
from .extract import RefinedKeypoints, rank_select
from .orientation import peaks_from_histograms, raw_histograms
from .patches import (REC_ANGLE, REC_COLS, SampleRecords,
                      max_descriptor_radius, max_orientation_radius)


def _check_records(flat: torch.Tensor, recs: SampleRecords,
                   count: torch.Tensor) -> None:
    cuda_lib.require(flat, "flat", torch.float32, 1)
    cuda_lib.require(recs.base, "base", torch.int64, 1)
    cuda_lib.require(recs.rec, "rec", torch.float32, 2)
    cuda_lib.require(count, "count", torch.int32)
    cap = recs.rec.shape[0]
    if recs.rec.shape[1] != REC_COLS or recs.base.shape[0] != cap \
            or count.numel() != 1:
        raise ValueError("records: expected base (K,), rec (K, 8), count ()")
    for t in (recs.base, recs.rec, count):
        if t.device != flat.device:
            raise ValueError("records and pyramid must share a device")


# vks_orientation_hist(flat, base, rec, count, hist, capacity, max_radius,
# stream)
_HIST_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _launch_orientation_hist(fn, flat: torch.Tensor, recs: SampleRecords,
                             count: torch.Tensor, ori_radius: int, name: str,
                             hist: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Call the histogram entry point ``fn`` into ``hist`` and return it: a
    (K, 36) float32 output, by default a new one that is not filled,
    because ``csrc/orientation_hist.cu`` writes every row, those past the
    count as zeros."""
    shape = (recs.rec.shape[0], NB_ORI_HIST_BINS)
    if hist is None:
        hist = torch.empty(shape, dtype=torch.float32, device=flat.device)
    elif (hist.shape != shape or hist.dtype != torch.float32
          or hist.device != flat.device or not hist.is_contiguous()):
        raise ValueError(f"hist: expected contiguous float32 {shape} on "
                         f"{flat.device}")
    cuda_lib.launch(fn, flat, name, flat.data_ptr(), recs.base.data_ptr(),
                    recs.rec.data_ptr(), count.data_ptr(), hist.data_ptr(),
                    hist.shape[0], ori_radius)
    return hist


@cuda_lib.counted
def orientation_hist(flat: torch.Tensor, recs: SampleRecords,
                     count: torch.Tensor, *, ori_radius: int) -> torch.Tensor:
    """Raw (K, 36) histograms of the first ``count`` records (rows past it
    are zero). A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`.orientation.raw_histograms`."""
    if not cuda_lib.use_kernel(flat):
        return raw_histograms(flat, recs, count, ori_radius=ori_radius)
    _check_records(flat, recs, count)
    hist = _launch_orientation_hist(
        cuda_lib.entry("orientation_hist", "vks_orientation_hist",
                       _HIST_ARGTYPES), flat, recs, count, ori_radius,
        "orientation_hist")
    cuda_lib.count_launch(orientation_hist)
    return hist


# vks_descriptor(flat, base, rec, count, desc, capacity, max_radius, vlfeat,
# stream)
_DESC_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch_descriptor(fn, flat: torch.Tensor, recs: SampleRecords,
                       count: torch.Tensor, desc_radius: int,
                       use_vlfeat: bool, name: str) -> torch.Tensor:
    """Call the descriptor entry point ``fn`` into a new output and return
    its (K, 128) rows. One zero fill holds the rows (those past the count
    stay zero) and, in the element after them, the kernel's int32 work
    counter (0), where ``csrc/descriptor.cu`` looks for it."""
    cap = recs.rec.shape[0]
    buf = torch.zeros(cap * DESC_SIZE + 1, dtype=torch.float32,
                      device=flat.device)
    cuda_lib.launch(fn, flat, name, flat.data_ptr(), recs.base.data_ptr(),
                    recs.rec.data_ptr(), count.data_ptr(), buf.data_ptr(),
                    cap, desc_radius, 1 if use_vlfeat else 0)
    return buf[:cap * DESC_SIZE].view(cap, DESC_SIZE)


@cuda_lib.counted
def descriptor(flat: torch.Tensor, recs: SampleRecords, count: torch.Tensor,
               *, desc_radius: int, use_vlfeat: bool) -> torch.Tensor:
    """Raw (K, 128) descriptors of the first ``count`` pair records (rows
    past it are zero). A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`.descriptor.raw_descriptors`."""
    if not cuda_lib.use_kernel(flat):
        return raw_descriptors(flat, recs, count, desc_radius=desc_radius,
                               use_vlfeat=use_vlfeat)
    _check_records(flat, recs, count)
    desc = _launch_descriptor(
        cuda_lib.entry("descriptor", "vks_descriptor", _DESC_ARGTYPES), flat,
        recs, count, desc_radius, use_vlfeat, "descriptor")
    cuda_lib.count_launch(descriptor)
    return desc


def keypoint_records(refined_list: Sequence[RefinedKeypoints], *,
                     config: SiftConfig, oct_res: Sequence[Tuple[int, int]],
                     offsets: Sequence[int]) -> Tuple[SampleRecords, dict]:
    """One sampling record per refined keypoint slot (all octaves
    concatenated) and the per-slot output fields.

    Sigma-scaled sampling (see :mod:`.patches`): keypoints with
    ``scale_idx >= nb_scales`` sample layer ``scale_idx - nb_scales`` of
    the next octave at ``(u - 1) / 2`` with half the sigma."""
    s = config.nb_scales_per_octave
    layers = s + 3
    nb_oct = len(oct_res)
    dev = refined_list[0].x.device
    caps = [r.x.shape[0] for r in refined_list]

    def cat(field):
        return torch.cat([getattr(r, field) for r in refined_list])

    def per_kp(vals, dtype):
        return torch.cat([torch.full((caps[o],), vals[o], dtype=dtype,
                                     device=dev) for o in range(nb_oct)])

    nxt = [min(o + 1, nb_oct - 1) for o in range(nb_oct)]
    scale_idx = cat("scale_idx")
    scale_x, scale_y = cat("scale_x"), cat("scale_y")
    remap = (per_kp([o + 1 < nb_oct for o in range(nb_oct)], torch.bool)
             & (scale_idx >= s))
    i64 = torch.int64
    ow = torch.where(remap, per_kp([oct_res[n][0] for n in nxt], i64),
                     per_kp([w for w, _ in oct_res], i64))
    oh = torch.where(remap, per_kp([oct_res[n][1] for n in nxt], i64),
                     per_kp([h for _, h in oct_res], i64))
    off = torch.where(remap, per_kp([offsets[n] for n in nxt], i64),
                      per_kp(list(offsets), i64))
    sig = config.seed_scale_sigma * torch.exp2(cat("subpix_s") / s)
    sx = torch.where(remap, (scale_x - 1.0) * 0.5, scale_x)
    sy = torch.where(remap, (scale_y - 1.0) * 0.5, scale_y)
    sig = torch.clamp(torch.where(remap, sig * 0.5, sig), min=1e-6)
    layer = torch.where(remap, scale_idx - s, scale_idx).clamp(0, layers - 1)
    cx = torch.minimum(torch.clamp(torch.round(sx), min=0), ow.to(sx.dtype))
    cy = torch.minimum(torch.clamp(torch.round(sy), min=0), oh.to(sy.dtype))
    base = off + layer.to(i64) * oh * ow
    rec = torch.stack([sx, sy, sig, cx, cy,
                       ow.to(torch.float32), oh.to(torch.float32),
                       torch.zeros_like(sx)], dim=-1)
    fields = dict(
        valid=cat("valid"), x=cat("x"), y=cat("y"), scale_x=scale_x,
        scale_y=scale_y, scale_idx=scale_idx, sigma=cat("sigma"),
        intensity=cat("intensity"),
        octave=per_kp(list(range(nb_oct)), torch.int32))
    return SampleRecords(base, rec.contiguous()), fields


def run_backhalf(flat: torch.Tensor, offsets: Sequence[int],
                 refined_list: Sequence[RefinedKeypoints], *,
                 config: SiftConfig, oct_res: Sequence[Tuple[int, int]],
                 capacity: int, capture: Optional[Dict] = None):
    """Orientation + descriptors for every octave, then the pack.

    Returns (fields dict at ``capacity``, count i32[], per-octave pair
    counts i32[O], lost i32[]); every one a device tensor. ``capture``, when
    given, receives the kernels' inputs (for comparisons on the card)."""
    s = config.nb_scales_per_octave
    dev = flat.device
    ori_cap = config.orientation_capacity
    use_vlfeat = config.descriptor_format == DescriptorFormat.VLFEAT
    nb_oct = len(oct_res)
    ori_radius = max_orientation_radius(config)
    desc_radius = max_descriptor_radius(config)

    recs, kp = keypoint_records(refined_list, config=config, oct_res=oct_res,
                                offsets=offsets)
    total_cap = recs.rec.shape[0]
    if total_cap == 0:
        raise ValueError("run_backhalf needs at least one keypoint slot")

    # Histograms of the live keypoints, compacted in raster/octave order.
    kidx, kcnt = rank_select(kp["valid"], total_cap)
    kidx = kidx.to(torch.int64)
    recs_k = SampleRecords(recs.base[kidx].contiguous(),
                           recs.rec[kidx].contiguous())
    hist = orientation_hist(flat, recs_k, kcnt, ori_radius=ori_radius)
    ori = peaks_from_histograms(hist, ori_cap)

    # Keypoint-major pairs: each keypoint's valid orientations are a prefix
    # of its row (strongest first), so its pairs are the contiguous slots
    # [start_k, start_k + nori_k).
    live_k = torch.arange(total_cap, device=dev) < kcnt
    nori = (ori.valid & live_k[:, None]).sum(1, dtype=torch.int32)
    cs_n = torch.cumsum(nori, 0, dtype=torch.int32)
    start_k = cs_n - nori
    pair_total = cs_n[-1]
    count = torch.clamp(pair_total, max=capacity)
    lost = pair_total - count

    # pslot[i] = keypoint owning pair slot i: each keypoint's index at its
    # segment start, then a running max.
    slot = torch.where((nori > 0) & (start_k < capacity), start_k, capacity)
    seg = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    seg.scatter_reduce_(0, slot.to(torch.int64),
                        torch.arange(total_cap, device=dev), reduce="amax")
    pslot = torch.cummax(seg[:capacity], 0).values
    oidx = (torch.arange(capacity, device=dev) - start_k[pslot]).clamp(
        0, ori_cap - 1)
    angle = ori.angles[pslot, oidx]
    rec_p = recs_k.rec[pslot].clone()
    rec_p[:, REC_ANGLE] = angle
    recs_p = SampleRecords(recs_k.base[pslot].contiguous(),
                           rec_p.contiguous())
    raw = descriptor(flat, recs_p, count, desc_radius=desc_radius,
                     use_vlfeat=use_vlfeat)
    desc_u8 = normalize_descriptor(raw)
    if capture is not None:
        capture.update(flat=flat, hist_records=recs_k, hist_count=kcnt,
                       ori_radius=ori_radius, desc_records=recs_p,
                       desc_count=count, desc_radius=desc_radius,
                       use_vlfeat=use_vlfeat)

    # Pack: pair slots past the count are zeroed.
    in_count = torch.arange(capacity, device=dev) < count
    src = kidx[pslot]
    pair_oct = kp["octave"][src]
    per_octave = torch.stack([(in_count & (pair_oct == o)).sum(
        dtype=torch.int32) for o in range(nb_oct)])

    def msk(a):
        m = in_count if a.dim() == 1 else in_count[:, None]
        return torch.where(m, a, torch.zeros((), dtype=a.dtype, device=dev))

    octave_idx = pair_oct - (1 if config.use_input_upsampling else 0)
    fields = dict(
        x=msk(kp["x"][src]), y=msk(kp["y"][src]),
        scale_x=msk(kp["scale_x"][src]), scale_y=msk(kp["scale_y"][src]),
        scale_idx=msk(kp["scale_idx"][src]),
        octave_idx=msk(octave_idx.to(torch.int32)),
        sigma=msk(kp["sigma"][src]), orientation=msk(angle),
        intensity=msk(kp["intensity"][src]), descriptor=msk(desc_u8))
    return fields, count.to(torch.int32), per_octave, lost.to(torch.int32)
