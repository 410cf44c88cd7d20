"""The port's ``SiftInstance`` beyond detection, on the CPU, against the
JAX package's instance: matching (``download_matches`` bytes and the count
snapshot), the scale-space debug APIs, the runtime probe, the lost-feature
warning, and the batched detect."""

import dataclasses
import logging

import numpy as np
import pytest

from conftest import make_blob_image
import vulkansift_tpu as jvs
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.errors import InvalidInputError
from vulkansift_tpu_torch.ops import match
from vulkansift_tpu_torch.pipeline import make_detect_batched, make_detect_fn


def _features(rng, n):
    f = np.zeros(n, vt.FEATURE_DTYPE)
    f["x"] = rng.random(n) * 640
    f["y"] = rng.random(n) * 480
    f["descriptor"] = rng.integers(0, 256, (n, 128), dtype=np.uint8)
    return f


def test_match_dtype_equals_jax():
    assert vt.MATCH_DTYPE == jvs.MATCH_DTYPE
    assert vt.MATCH_DTYPE.itemsize == 20
    for name in jvs.MATCH_DTYPE.names:
        assert vt.MATCH_DTYPE.fields[name] == jvs.MATCH_DTYPE.fields[name]


@pytest.mark.parametrize("n_a,n_b", [(300, 257), (40, 1)])
def test_download_matches_bytes_equal_jax_instance(n_a, n_b):
    """The same FEATURE_DTYPE arrays uploaded into both packages' instances
    match to the same bytes (n_b == 1: every second slot is +inf)."""
    rng = np.random.default_rng(21)
    fa, fb = _features(rng, n_a), _features(rng, n_b)
    fb["descriptor"][: n_b // 3] = fa["descriptor"][5]  # ties
    cfg = dict(max_nb_sift_per_buffer=512, sift_buffer_count=2)
    j = jvs.SiftInstance(jvs.SiftConfig(**cfg))
    t = vt.SiftInstance(vt.SiftConfig(**cfg), device="cpu")
    for inst in (j, t):
        inst.upload_features(fa, 0)
        inst.upload_features(fb, 1)
        inst.match_features(0, 1)
        assert inst.get_matches_number() == n_a
    mj, mt = j.download_matches(), t.download_matches()
    assert mt.dtype == vt.MATCH_DTYPE and len(mt) == n_a
    assert mt.tobytes() == mj.tobytes()
    if n_b == 1:
        assert np.isinf(mt["dist_a_b2"]).all()
    # And the other way round.
    for inst in (j, t):
        inst.match_features(1, 0)
    assert t.download_matches().tobytes() == j.download_matches().tobytes()


def test_match_errors_and_self_match():
    errors = []
    inst = vt.SiftInstance(vt.SiftConfig(max_nb_sift_per_buffer=64),
                           on_error=errors.append, device="cpu")
    assert inst.get_matches_number() == 0
    with pytest.raises(InvalidInputError):
        inst.download_matches()
    with pytest.raises(InvalidInputError):
        inst.match_features(0, 2)
    assert errors == [vt.Result.INVALID_INPUT_ERROR] * 2
    f = _features(np.random.default_rng(3), 50)
    inst.upload_features(f, 0)
    inst.upload_features(f, 1)
    inst.match_features(0, 1)
    m = inst.download_matches()
    np.testing.assert_array_equal(m["idx_b1"], m["idx_a"])
    np.testing.assert_array_equal(m["dist_a_b1"], 0.0)
    assert (m["dist_a_b2"] > 0).all()
    inst.close()
    with pytest.raises(InvalidInputError):
        inst.download_matches()


def test_match_count_snapshot_immune_to_redetect():
    """The match count is a snapshot of buffer A's count at dispatch:
    detecting a much smaller image into A before the download must not
    change it."""
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                        input_image_max_size=128 * 96)
    inst = vt.SiftInstance(cfg, device="cpu")
    inst.detect_features(img, 0)
    n_a = inst.get_features_number(0)
    inst.detect_features(img[::-1].copy(), 1)
    inst.match_features(0, 1)
    inst.detect_features(make_blob_image(40, 48, seed=3, nb_blobs=3), 0)
    assert inst.get_features_number(0) != n_a  # precondition
    assert inst.get_matches_number() == n_a
    m = inst.download_matches()
    assert m.shape == (n_a,)
    assert (m["idx_b1"] < inst.get_features_number(1)).all()


@pytest.fixture(scope="module")
def scale_space_pair():
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    kw = dict(use_input_upsampling=False, max_nb_sift_per_buffer=512,
              input_image_max_size=128 * 96)
    j = jvs.SiftInstance(jvs.SiftConfig(**kw))
    t = vt.SiftInstance(vt.SiftConfig(**kw), device="cpu")
    j.detect_features(img, 0)
    t.detect_features(img, 0)
    return j, t, img


def test_scale_space_apis_match_jax(scale_space_pair):
    j, t, img = scale_space_pair
    nb = t.get_scale_space_nb_octaves(0)
    assert nb == j.get_scale_space_nb_octaves(0) >= 2
    h, w = img.shape
    assert t.get_scale_space_octave_resolution(0, 0) == (w, h)
    for o in range(nb):
        res = t.get_scale_space_octave_resolution(o, 0)
        assert res == tuple(j.get_scale_space_octave_resolution(o, 0))
        cfg = t.config
        for s in range(cfg.nb_scales_per_octave + 3):
            g = t.download_scale_space_image(o, s, 0)
            assert g.dtype == np.float32 and g.shape == (res[1], res[0])
            np.testing.assert_allclose(
                g, j.download_scale_space_image(o, s, 0), atol=1e-6)
        for s in range(cfg.nb_scales_per_octave + 2):
            np.testing.assert_allclose(t.download_dog_image(o, s, 0),
                                       j.download_dog_image(o, s, 0),
                                       atol=1e-6)
    for inst, err in ((t, InvalidInputError), (j, jvs.InvalidInputError)):
        with pytest.raises(err):
            inst.download_scale_space_image(nb + 1, 0, 0)
        with pytest.raises(err):
            inst.download_dog_image(0, 99, 0)
        with pytest.raises(err):
            inst.get_scale_space_octave_resolution(nb, 0)
    # A buffer never detected into has no scale-space.
    assert t.get_scale_space_nb_octaves(1) == 0
    with pytest.raises(InvalidInputError):
        t.download_scale_space_image(0, 0, 1)


def test_upload_invalidates_scale_space(scale_space_pair):
    _, t, img = scale_space_pair
    t.detect_features(img, 1)
    assert t.get_scale_space_nb_octaves(1) >= 2
    feats = t.download_features(1)
    t.upload_features(feats, 1)
    assert t.get_features_number(1) == len(feats)
    assert t.get_scale_space_nb_octaves(1) == 0
    with pytest.raises(InvalidInputError):
        t.get_scale_space_octave_resolution(0, 1)
    with pytest.raises(InvalidInputError):
        t.download_scale_space_image(0, 0, 1)
    with pytest.raises(InvalidInputError):
        t.download_dog_image(0, 0, 1)


def test_retain_pyramid_off():
    img = make_blob_image(64, 64, seed=2, nb_blobs=6)
    cfg = vt.SiftConfig(use_input_upsampling=False, retain_pyramid=False,
                        max_nb_sift_per_buffer=256,
                        input_image_max_size=64 * 64)
    inst = vt.SiftInstance(cfg, device="cpu")
    inst.detect_features(img, 0)
    assert inst.get_scale_space_nb_octaves(0) == 2
    with pytest.raises(InvalidInputError):
        inst.download_scale_space_image(0, 0, 0)


def test_runtime_probe_without_a_card():
    assert vt.load_runtime() == vt.Result.DEVICE_ERROR
    assert vt.get_available_devices() == []
    vt.unload_runtime()


def test_lost_features_warn(caplog):
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=16,
                        input_image_max_size=128 * 96)
    inst = vt.SiftInstance(cfg, device="cpu")
    inst.detect_features(img, 0)
    with caplog.at_level(logging.WARNING, logger="vulkansift_tpu_torch"):
        n = inst.get_features_number(0)
    lost = inst.get_lost_features_number(0)
    assert n == 16 and lost > 0
    assert f"({lost} features lost)" in caplog.text


def test_detect_batched_equals_single_detects():
    imgs = np.stack([make_blob_image(64, 80, seed=s, nb_blobs=10)
                     for s in (1, 2)])
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=256,
                        input_image_max_size=80 * 64)
    out = make_detect_batched(cfg, 80, 64, device="cpu")(imgs)
    single = make_detect_fn(cfg, 80, 64, device="cpu")
    assert out.features.count.shape == (2,)
    assert out.per_octave_counts.shape == (2, 2)
    for i in range(2):
        ref = single(imgs[i])
        for f in dataclasses.fields(vt.Features):
            got = getattr(out.features, f.name)[i]
            assert got.equal(getattr(ref.features, f.name)), f.name
        assert out.lost[i].equal(ref.lost)
        assert out.per_octave_counts[i].equal(ref.per_octave_counts)
    assert int(out.features.count[0]) > 0


def test_plain_matcher_on_instance_buffers():
    """match_features on the CPU runs the kernel's plain version: its result
    is match_2nn's on the same buffers."""
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                        input_image_max_size=128 * 96)
    inst = vt.SiftInstance(cfg, device="cpu")
    inst.detect_features(img, 0)
    inst.detect_features(np.ascontiguousarray(img[:, ::-1]), 1)
    inst.match_features(0, 1)
    got = inst.download_matches()
    fa, fb = inst._buffers[0].features, inst._buffers[1].features
    want = match.match_2nn(fa.descriptor, fa.count, fb.descriptor, fb.count)
    assert got.tobytes() == vt.matches_to_numpy(want).tobytes()
    assert len(got) == inst.get_features_number(0) > 0
