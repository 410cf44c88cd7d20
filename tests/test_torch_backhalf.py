"""The PyTorch port's back half (plain versions of the orientation
histogram and descriptor kernels, peaks, normalisation) against the JAX
package's XLA back half on the CPU, on the same refined keypoints.

Tolerances: raw histogram bins to atol=1e-4 (the sums of up to ~1400
weighted magnitudes in another order; a bin flip from the two frameworks'
atan2 would show as a larger error); orientations to 1e-4 rad where both
find the same peaks; u8 descriptors at least 99.5 % of bins within +-1
and none off by more than 8 (the JAX package's bar for its descriptor
kernel, tests/test_pallas_backhalf.py).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_image
from vulkansift_tpu.config import DescriptorFormat, SiftConfig
from vulkansift_tpu.ops import descriptor as jdesc
from vulkansift_tpu.ops import extract as jex
from vulkansift_tpu.ops import orientation as jori
from vulkansift_tpu.ops import patches as jpatch
from vulkansift_tpu.ops import scale_space as jss
from vulkansift_tpu_torch.config import from_reference_dict
from vulkansift_tpu_torch.ops import backhalf as tbh
from vulkansift_tpu_torch.ops import descriptor as tdesc
from vulkansift_tpu_torch.ops import extract as tex
from vulkansift_tpu_torch.ops import orientation as tori
from vulkansift_tpu_torch.ops import patches as tpatch
from vulkansift_tpu_torch.ops import scale_space as tss
from torch_threads import one_torch_thread  # noqa: F401


def _setup():
    """JAX pyramid + refined keypoints for both octaves of a blob image
    (upsampled, so top-scale keypoints of octave 0 sample octave 1), and the
    port's pyramid and sampling records for the same keypoints."""
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg = SiftConfig(use_input_upsampling=True, nb_octaves=2)
    tcfg = from_reference_dict(dataclasses.asdict(cfg))
    oct_res = cfg.octave_resolutions(128, 96)
    shapes = tuple((h, w) for w, h in oct_res)
    x = jnp.asarray(img).astype(jnp.float32) * (1.0 / 255.0)
    jg, jd = jss.build_pyramid_jit(x, cfg, shapes)
    refined = []
    for o, (w, h) in enumerate(oct_res):
        c, code = jax.jit(jex.dense_frontend, static_argnums=(1, 2))(
            jd[o], cfg.dog_threshold, 256)
        refined.append(jex.refine_candidates(
            jd[o], c, nb_scales=3, width=w, height=h,
            dog_threshold=cfg.dog_threshold, edge_threshold=10.0,
            seed_sigma=1.6, octave_idx=o - 1, code=code))
    ss = tss.build_pyramid(
        torch.from_numpy(img).to(torch.float32) * (1.0 / 255.0), tcfg, shapes)
    t_refined = [tex.RefinedKeypoints(*[torch.from_numpy(np.array(a))
                                        for a in r]) for r in refined]
    recs, _ = tbh.keypoint_records(t_refined, config=tcfg, oct_res=oct_res,
                                   offsets=ss.offsets)
    patchsets = [jpatch.build_patchset(jg, o, refined[o], cfg, oct_res,
                                       jpatch.patch_size(cfg))
                 for o in range(len(oct_res))]
    return cfg, tcfg, refined, ss, recs, patchsets


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _octave_rows(refined, o):
    start = sum(r.valid.shape[0] for r in refined[:o])
    return slice(start, start + refined[o].valid.shape[0])


@pytest.mark.parametrize("octave", [0, 1])
def test_orientation_histograms_match_jax(setup, monkeypatch, octave):
    cfg, tcfg, refined, ss, recs, patchsets = setup
    radius = jpatch.max_orientation_radius(cfg)
    kw = dict(ori_radius=radius, capacity=cfg.orientation_capacity)
    j_ori = jori.compute_orientations(patchsets[octave], **kw)
    # The JAX raw histograms: its orientation function with the peak step
    # replaced by the identity.
    monkeypatch.setattr(jori, "peaks_from_histograms", lambda h, c: h)
    j_hist = np.asarray(jax.jit(
        lambda ps: jori.compute_orientations.__wrapped__(ps, **kw))(
        patchsets[octave]))
    rows = _octave_rows(refined, octave)
    sub = tpatch.SampleRecords(recs.base[rows].contiguous(),
                               recs.rec[rows].contiguous())
    n = torch.tensor(sub.rec.shape[0], dtype=torch.int32)
    hist = tbh.orientation_hist(ss.flat, sub, n, ori_radius=radius)
    valid = np.asarray(refined[octave].valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(hist.numpy()[valid], j_hist[valid],
                               rtol=0, atol=1e-4)
    t_ori = tori.peaks_from_histograms(hist, cfg.orientation_capacity)
    same = t_ori.valid.numpy() == np.asarray(j_ori.valid)
    assert same[valid].all()
    both = np.asarray(j_ori.valid) & valid[:, None]
    np.testing.assert_allclose(t_ori.angles.numpy()[both],
                               np.asarray(j_ori.angles)[both], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("fmt", [DescriptorFormat.UBC, DescriptorFormat.VLFEAT])
def test_descriptors_match_jax(setup, fmt):
    """Every (keypoint, orientation) pair of both octaves, with the JAX
    orientations fed to both sides."""
    cfg, tcfg, refined, ss, recs, patchsets = setup
    vlfeat = fmt == DescriptorFormat.VLFEAT
    radius = jpatch.max_descriptor_radius(cfg)
    ps_parts, angles, rows = [], [], []
    for o, ps in enumerate(patchsets):
        j_ori = jori.compute_orientations(
            ps, ori_radius=jpatch.max_orientation_radius(cfg),
            capacity=cfg.orientation_capacity)
        pv = np.asarray(j_ori.valid) & np.asarray(refined[o].valid)[:, None]
        parent, slot = np.nonzero(pv)
        ps_parts.append(jpatch.PatchSet(*[a[jnp.asarray(parent)] for a in ps]))
        angles.append(np.asarray(j_ori.angles)[parent, slot])
        rows.append(_octave_rows(refined, o).start + parent)
    angle = np.concatenate(angles)
    rows = torch.from_numpy(np.concatenate(rows))
    assert angle.shape[0] > 10
    ps_pairs = jpatch.PatchSet(*[jnp.concatenate(f) for f in zip(*ps_parts)])
    j_desc = np.asarray(jdesc.compute_descriptors(
        ps_pairs, jnp.asarray(angle), desc_radius=radius, use_vlfeat=vlfeat))
    rec = recs.rec[rows].clone()
    rec[:, tpatch.REC_ANGLE] = torch.from_numpy(angle)
    pairs = tpatch.SampleRecords(recs.base[rows], rec)
    raw = tbh.descriptor(ss.flat, pairs,
                         torch.tensor(len(rows), dtype=torch.int32),
                         desc_radius=radius, use_vlfeat=vlfeat)
    t_desc = tdesc.normalize_descriptor(raw).numpy()
    d = np.abs(t_desc.astype(np.int32) - j_desc.astype(np.int32))
    assert np.mean(d <= 1) >= 0.995
    assert d.max() <= 8


def test_raw_rows_past_count_are_zero(setup):
    cfg, tcfg, refined, ss, recs, patchsets = setup
    count = torch.tensor(5, dtype=torch.int32)
    hist = tbh.orientation_hist(ss.flat, recs, count,
                                ori_radius=tpatch.max_orientation_radius(tcfg))
    assert torch.count_nonzero(hist[5:]) == 0
    raw = tbh.descriptor(ss.flat, tpatch.SampleRecords(recs.base[:40],
                                                       recs.rec[:40]),
                         count, desc_radius=tpatch.max_descriptor_radius(tcfg),
                         use_vlfeat=False)
    assert torch.count_nonzero(raw[5:]) == 0


@pytest.mark.parametrize("live", [0, 1, 33, None])
def test_cpu_plain_versions_skip_dead_rows_exactly(setup, live):
    """On the CPU the plain histogram and descriptor compute only the rows
    below the count (the descriptor in whole chunks): the live rows equal
    those of a run over every row, bit for bit, and the rest are zero."""
    cfg, tcfg, refined, ss, recs, patchsets = setup
    k = recs.rec.shape[0]
    live = k if live is None else live
    full_n = torch.tensor(k, dtype=torch.int32)
    count = torch.tensor(live, dtype=torch.int32)
    kw = dict(ori_radius=tpatch.max_orientation_radius(tcfg))
    full = tori.raw_histograms(ss.flat, recs, full_n, **kw)
    hist = tori.raw_histograms(ss.flat, recs, count, **kw)
    assert torch.equal(hist[:live], full[:live])
    assert torch.count_nonzero(hist[live:]) == 0
    kw = dict(desc_radius=tpatch.max_descriptor_radius(tcfg),
              use_vlfeat=False, chunk=16)
    full = tdesc.raw_descriptors(ss.flat, recs, full_n, **kw)
    raw = tdesc.raw_descriptors(ss.flat, recs, count, **kw)
    assert torch.equal(raw[:live], full[:live])
    assert torch.count_nonzero(raw[live:]) == 0
