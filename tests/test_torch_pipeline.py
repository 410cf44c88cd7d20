"""The PyTorch port's detect path and instance API end to end against the
JAX package's XLA pipeline (``make_detect_fn(backhalf="xla")``) on the
CPU, plus the port's buffer contract.

End-to-end criterion, the JAX package's own for its Pallas back half
(tests/test_pallas_backhalf.py::_match_pairs): at least 95 % of the port's
features at a position the reference also has, at least 85 % of features
in angle-matched pairs, and for pairs whose orientations agree to 1e-3 rad
at least 99.5 % of descriptor bins within +-1 u8 and none off by more than
8.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import make_blob_image
import vulkansift_tpu as jvs
from vulkansift_tpu.config import DescriptorFormat, SiftConfig
from vulkansift_tpu.ops import extract as jex
from vulkansift_tpu.ops import scale_space as jss
from vulkansift_tpu.pipeline import make_detect_fn as jax_make_detect_fn
import torch
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.ops import extract as tex
from vulkansift_tpu_torch.ops import frontend as tfront
from vulkansift_tpu_torch.errors import InvalidConfigError, InvalidInputError
from vulkansift_tpu_torch.pipeline import make_detect_fn
from torch_threads import one_torch_thread  # noqa: F401


class _Feats:
    """Host view of a feature buffer, either package's."""

    def __init__(self, arr):
        self.x, self.y = arr["x"], arr["y"]
        self.orientation = arr["orientation"]
        self.descriptor = arr["descriptor"]


def _match_pairs(fa, n_a, fb, n_b, ang_tol=0.02):
    pos_b = {}
    for j in range(n_b):
        pos_b.setdefault((round(float(fb.x[j]), 2),
                          round(float(fb.y[j]), 2)), []).append(j)
    pairs, pos_hit = [], 0
    for i in range(n_a):
        cands = pos_b.get((round(float(fa.x[i]), 2),
                           round(float(fa.y[i]), 2)), [])
        if cands:
            pos_hit += 1
        da = [(abs(((float(fa.orientation[i]) - float(fb.orientation[j])
                     + np.pi) % (2 * np.pi)) - np.pi), j) for j in cands]
        if da:
            d, j = min(da)
            if d < ang_tol:
                pairs.append((i, j))
    return pairs, pos_hit


def _compare(img, cfg):
    h, w = img.shape
    j_out = jax.jit(jax_make_detect_fn(cfg, w, h, backhalf="xla"))(
        jnp.asarray(img))
    tcfg = vt.from_reference_dict(dataclasses.asdict(cfg))
    t_out = make_detect_fn(tcfg, w, h, device="cpu")(img)
    ja = jvs.features_to_numpy(j_out.features)
    ta = vt.features_to_numpy(t_out.features)
    n_j, n_t = len(ja), len(ta)
    assert n_t > 10
    assert int(t_out.lost) == int(j_out.lost) == 0
    np.testing.assert_array_equal(t_out.per_octave_counts.numpy(),
                                  np.asarray(j_out.per_octave_counts))
    fj, ft = _Feats(ja), _Feats(ta)
    pairs, pos_hit = _match_pairs(ft, n_t, fj, n_j)
    assert pos_hit >= 0.95 * n_t
    assert len(pairs) >= 0.85 * max(n_t, n_j)
    tight = [(i, j) for i, j in pairs
             if abs(float(ft.orientation[i]) - float(fj.orientation[j])) < 1e-3]
    d = np.concatenate([np.abs(ft.descriptor[i].astype(np.int32)
                               - fj.descriptor[j].astype(np.int32))
                        for i, j in tight])
    assert np.mean(d <= 1) >= 0.995
    assert d.max() <= 8
    return ta


def _frontend_matches_jax(img, cfg):
    """Every octave's DoG stack (from the JAX pyramid) through both
    frontends: codes and candidates bit-exact."""
    h, w = img.shape
    shapes = tuple((oh, ow) for ow, oh in cfg.octave_resolutions(w, h))
    x = jnp.asarray(img).astype(jnp.float32) * (1.0 / 255.0)
    _, dogs = jss.build_pyramid_jit(x, cfg, shapes)
    thr = cfg.dog_threshold
    for dog in dogs:
        dog = np.array(dog)
        assert dog.shape[0] == cfg.nb_scales_per_octave + 2
        ref_c, ref_code = jax.jit(jex.dense_frontend, static_argnums=(1, 2))(
            jnp.asarray(dog), thr, dog.size)
        code, counts = tfront.frontend(torch.from_numpy(dog), thr)
        np.testing.assert_array_equal(code.numpy().astype(np.int32) % 128,
                                      np.asarray(ref_code).astype(np.int32))
        n = int(ref_c.count)
        assert int(counts.sum()) == int((code.numpy() >= 128).sum()) == n
        c = tex.compact_candidates(code, counts, dog.size)
        for a, b in ((c.s, ref_c.s), (c.y, ref_c.y), (c.x, ref_c.x)):
            np.testing.assert_array_equal(a[:n].numpy(), np.asarray(b)[:n])


@pytest.mark.parametrize("case", ["no_upsampling_ubc",
                                  "upsampling_vlfeat_2_octaves",
                                  "15_scales_per_octave"])
def test_detect_matches_jax(case):
    if case == "no_upsampling_ubc":
        img = make_blob_image(96, 128, seed=5, nb_blobs=14)
        cfg = SiftConfig(use_input_upsampling=False,
                         max_nb_sift_per_buffer=512,
                         input_image_max_size=128 * 96)
    elif case == "15_scales_per_octave":
        # 17 DoG layers an octave, more than the frontend kernel's old
        # limit of 16.
        img = make_blob_image(64, 96, seed=11, nb_blobs=12)
        cfg = SiftConfig(use_input_upsampling=False, nb_scales_per_octave=15,
                         max_nb_sift_per_buffer=1024,
                         input_image_max_size=96 * 64)
        _frontend_matches_jax(img, cfg)
    else:
        img = make_blob_image(128, 160, seed=7, nb_blobs=16)
        cfg = SiftConfig(use_input_upsampling=True, nb_octaves=2,
                         descriptor_format=DescriptorFormat.VLFEAT,
                         max_nb_sift_per_buffer=512,
                         input_image_max_size=160 * 128)
    _compare(img, cfg)


def test_one_octave_plan_matches_jax():
    img = make_blob_image(40, 48, seed=3, nb_blobs=20)
    cfg = SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=256,
                     input_image_max_size=48 * 40)
    assert len(cfg.octave_resolutions(48, 40)) == 1
    # Few features at this size: check the pack against the reference.
    h, w = img.shape
    j_out = jax.jit(jax_make_detect_fn(cfg, w, h, backhalf="xla"))(
        jnp.asarray(img))
    t_out = make_detect_fn(vt.from_reference_dict(dataclasses.asdict(cfg)),
                           w, h, device="cpu")(img)
    n = int(t_out.features.count)
    assert n == int(j_out.features.count) > 0
    np.testing.assert_allclose(t_out.features.x.numpy()[:n],
                               np.asarray(j_out.features.x)[:n], atol=1e-3)


def test_empty_octave_plan():
    # A one-feature buffer gives every octave section capacity 0.
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=1,
                        input_image_max_size=64 * 64)
    assert sum(cfg.octave_section_capacities(2)) == 0
    img = make_blob_image(64, 64, seed=1)
    out, gauss, dogs = make_detect_fn(cfg, 64, 64, return_pyramid=True,
                                      device="cpu")(img)
    assert int(out.features.count) == 0 and int(out.lost) == 0
    assert out.features.capacity == 1
    assert out.per_octave_counts.shape == (2,)


def test_capacity_clamp_and_lost():
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    big = vt.SiftConfig(use_input_upsampling=False,
                        max_nb_sift_per_buffer=512,
                        input_image_max_size=128 * 96)
    full = make_detect_fn(big, 128, 96, device="cpu")(img)
    n = int(full.features.count)
    assert n > 8
    cap = n // 2
    small = dataclasses.replace(big, max_nb_sift_per_buffer=cap)
    out = make_detect_fn(small, 128, 96, device="cpu")(img)
    n_c = int(out.features.count)
    assert n_c <= cap
    assert int(out.lost) > 0 or n_c < n
    # One global capacity: the per-octave counts add up to the count and
    # the slots past it are zero.
    assert int(out.per_octave_counts.sum()) == n_c
    assert not out.features.descriptor[n_c:].any()


def test_feature_bytes_round_trip_between_packages():
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                        input_image_max_size=128 * 96)
    out = make_detect_fn(cfg, 128, 96, device="cpu")(img)
    arr = vt.features_to_numpy(out.features)
    assert vt.FEATURE_DTYPE == jvs.FEATURE_DTYPE
    assert vt.FEATURE_DTYPE.itemsize == 36 + 128
    j_back = jvs.features_to_numpy(jvs.features_from_numpy(arr, 512))
    assert j_back.tobytes() == arr.tobytes()
    t_back = vt.features_to_numpy(vt.features_from_numpy(j_back, 512,
                                                         device="cpu"))
    assert t_back.tobytes() == arr.tobytes()
    with pytest.raises(ValueError):
        vt.features_from_numpy(arr, len(arr) - 1, device="cpu")


def test_config_round_trip():
    cfg = SiftConfig(descriptor_format=DescriptorFormat.VLFEAT,
                     nb_octaves=3, max_nb_sift_per_buffer=777)
    tcfg = vt.from_reference_dict(dataclasses.asdict(cfg))
    assert tcfg.descriptor_format == vt.DescriptorFormat.VLFEAT
    assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(cfg).keys()
    assert tcfg.octave_section_capacities(5) == cfg.octave_section_capacities(5)
    with pytest.raises(InvalidConfigError):
        vt.from_reference_dict({"no_such_field": 1})


def test_instance_buffers_and_errors():
    errors = []
    cfg = vt.SiftConfig(max_nb_sift_per_buffer=512,
                        input_image_max_size=128 * 96)
    inst = vt.SiftInstance(cfg, on_error=errors.append, device="cpu")
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    inst.detect_features(img, 1)
    n = inst.get_features_number(1)
    assert n > 0 and inst.is_buffer_available(1)
    arr = inst.download_features(1)
    assert arr.dtype == vt.FEATURE_DTYPE and len(arr) == n
    assert inst.get_features_number(0) == 0
    inst.upload_features(arr[:5], 0)
    assert inst.get_features_number(0) == 5
    np.testing.assert_array_equal(inst.download_features(0), arr[:5])

    bad = [
        lambda: inst.detect_features(img, 2),                  # buffer index
        lambda: inst.get_features_number(-1),
        lambda: inst.detect_features(img.astype(np.float32), 0),  # dtype
        lambda: inst.detect_features(img[None], 0),            # ndim
        lambda: inst.detect_features(np.zeros((97, 128), np.uint8), 0),
        lambda: inst.detect_features(np.zeros((31, 64), np.uint8), 0),
        lambda: inst.upload_features(np.zeros(3, np.float32), 0),
        lambda: inst.upload_features(np.zeros(513, vt.FEATURE_DTYPE), 0),
    ]
    for fn in bad:
        with pytest.raises(InvalidInputError):
            fn()
    assert errors == [vt.Result.INVALID_INPUT_ERROR] * len(bad)
    # A failed call leaves the instance usable.
    assert inst.get_features_number(1) == n
    inst.close()
    with pytest.raises(InvalidInputError):
        inst.get_features_number(0)
    with pytest.raises(InvalidConfigError):
        vt.SiftInstance(vt.SiftConfig(sift_buffer_count=0), device="cpu")
