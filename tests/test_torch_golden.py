"""The port's float64 NumPy oracle (``vulkansift_tpu_torch.golden``)
against the JAX package's (``vulkansift_tpu.golden``): the same code on
each package's own config constants and gaussian taps, so every output is
held equal exactly, on a 64x64 image."""

import dataclasses

import numpy as np
import pytest

from conftest import make_blob_image
from vulkansift_tpu.config import DescriptorFormat, SiftConfig
from vulkansift_tpu.golden import reference as jref
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.golden import reference as tref

IMG = make_blob_image(64, 64, seed=9, nb_blobs=10)
CASES = {
    "ubc_upsampled": SiftConfig(),
    "vlfeat": SiftConfig(use_input_upsampling=False,
                         descriptor_format=DescriptorFormat.VLFEAT),
}


def _configs(name):
    cfg = CASES[name]
    return cfg, vt.from_reference_dict(dataclasses.asdict(cfg))


def _equal_feature_lists(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]),
                                          np.asarray(fb[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_pyramid_np_equals_jax(name):
    jcfg, tcfg = _configs(name)
    jg, jd = jref.build_pyramid_np(IMG, jcfg)
    tg, td = tref.build_pyramid_np(IMG, tcfg)
    assert len(tg) == len(jg) > 1
    for a, b in zip(tg + td, jg + jd):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_detect_np_equals_jax(name):
    jcfg, tcfg = _configs(name)
    feats = tref.detect_np(IMG, tcfg)
    assert len(feats) > 0
    _equal_feature_lists(feats, jref.detect_np(IMG, jcfg))
    capped = tref.detect_np(IMG, tcfg, max_features=3)
    _equal_feature_lists(capped, feats[:3])


def test_match_2nn_np_equals_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (40, 128), dtype=np.uint8)
    b = rng.integers(0, 256, (50, 128), dtype=np.uint8)
    b[7] = b[3]                 # a tie: the earlier index wins
    a[5] = b[3]
    out = tref.match_2nn_np(a, b)
    np.testing.assert_array_equal(out, jref.match_2nn_np(a, b))
    assert out[5, 0] == 3 and out[5, 1] == 7 and out[5, 2] == 0.0
