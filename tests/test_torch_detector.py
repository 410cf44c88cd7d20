"""The port's staged detector (``vulkansift_tpu_torch.detector``) against
the JAX package's ``SiftDetector`` on the CPU, and the instance's trace
hooks.

Tolerances, those ``tests/test_torch_pipeline.py`` applies to a detect
(the JAX package's own for its Pallas back half): at least 95 % of the
port's features at a position the reference also has (to 0.01 px), at
least 85 % in angle-matched pairs, and for pairs whose orientations agree
to 1e-3 rad at least 99.5 % of descriptor bins within +-1 u8 and none off
by more than 8. ``per_octave`` and ``lost`` are equal, also when an
octave overflows its section capacity. Against the port's own main path
(no overflow), the JAX package's bar for its staged detector
(``tests/test_pipeline_parallel.py:31-52``): the same count, the sorted
(x, y, sigma, orientation) within 1e-5 and the descriptors equal after a
lexsort.
"""

import dataclasses
import json
import logging
import os
import re

import numpy as np
import pytest

from conftest import make_blob_image
from test_torch_pipeline import _Feats, _match_pairs
import vulkansift_tpu as jvs
from vulkansift_tpu.config import DescriptorFormat, SiftConfig
from vulkansift_tpu.detector import SiftDetector as JaxSiftDetector
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.pipeline import make_detect_fn
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "no_upsampling_ubc": (make_blob_image(96, 128, seed=5, nb_blobs=14),
                          SiftConfig(use_input_upsampling=False,
                                     max_nb_sift_per_buffer=512,
                                     input_image_max_size=128 * 96)),
    "upsampling_vlfeat_2_octaves": (
        make_blob_image(128, 160, seed=7, nb_blobs=16),
        SiftConfig(use_input_upsampling=True, nb_octaves=2,
                   descriptor_format=DescriptorFormat.VLFEAT,
                   max_nb_sift_per_buffer=512,
                   input_image_max_size=160 * 128)),
    # Section capacities (16, 8): octave 0 finds 23 pairs and keeps 16.
    "octave_overflow": (make_blob_image(96, 128, seed=5, nb_blobs=14),
                        SiftConfig(use_input_upsampling=False,
                                   max_nb_sift_per_buffer=24,
                                   input_image_max_size=128 * 96)),
}


def _jax_lost(records) -> int:
    """``lost`` as the JAX detector reports it: in its warning."""
    for r in records:
        m = re.search(r"\((\d+) features lost\)", r.getMessage())
        if m and r.name == "vulkansift_tpu":
            return int(m.group(1))
    return 0


def _sorted_rows(arr):
    return sorted(zip(*[arr[f].tolist()
                        for f in ("x", "y", "sigma", "orientation")]))


def _lexsorted_desc(arr):
    k = np.lexsort((arr["orientation"], arr["y"], arr["x"]))
    return arr["descriptor"][k]


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_detector_matches_jax(case, caplog):
    img, cfg = CASES[case]
    h, w = img.shape
    with caplog.at_level(logging.WARNING):
        jf, _, _, j_per = JaxSiftDetector(cfg).detect(img, w, h)
    j_lost = _jax_lost(caplog.records)
    det = vt.detector.SiftDetector(
        vt.from_reference_dict(dataclasses.asdict(cfg)), device="cpu")
    tf, gauss, dogs, t_per = det.detect(img, w, h)
    assert t_per == list(j_per)
    assert det.lost == j_lost
    assert (j_lost > 0) == (case == "octave_overflow")
    ja, ta = jvs.features_to_numpy(jf), vt.features_to_numpy(tf)
    n_t, n_j = len(ta), len(ja)
    assert n_t == sum(t_per) and n_t > 10
    assert len(gauss) == len(dogs) == len(t_per)
    assert not tf.descriptor[n_t:].any() and not tf.x[n_t:].any()
    ft, fj = _Feats(ta), _Feats(ja)
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


@pytest.mark.parametrize("case", ["no_upsampling_ubc",
                                  "upsampling_vlfeat_2_octaves"])
def test_staged_detector_equals_main_path(case):
    img, cfg = CASES[case]
    h, w = img.shape
    tcfg = vt.from_reference_dict(dataclasses.asdict(cfg))
    det = vt.SiftDetector(tcfg, device="cpu")
    staged = vt.features_to_numpy(det.detect(img, w, h)[0])
    out = make_detect_fn(tcfg, w, h, device="cpu")(img)
    main = vt.features_to_numpy(out.features)
    assert det.lost == int(out.lost) == 0
    assert len(staged) == len(main) > 10
    np.testing.assert_allclose(np.asarray(_sorted_rows(staged)),
                               np.asarray(_sorted_rows(main)), atol=1e-5)
    np.testing.assert_array_equal(_lexsorted_desc(staged),
                                  _lexsorted_desc(main))


def test_staged_detector_drops_pyramid_unless_retained():
    img, cfg = CASES["no_upsampling_ubc"]
    tcfg = vt.from_reference_dict(dataclasses.asdict(
        dataclasses.replace(cfg, retain_pyramid=False)))
    feats, gauss, dogs, per = vt.SiftDetector(tcfg, device="cpu").detect(
        img, 128, 96)
    assert gauss is None and dogs is None and int(feats.count) == sum(per)


def test_staged_detector_with_no_slots():
    # A one-feature buffer gives every octave section capacity 0: no
    # candidate, no kernel launch, an empty buffer.
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=1,
                        input_image_max_size=64 * 64)
    det = vt.SiftDetector(cfg, device="cpu")
    feats, _, _, per = det.detect(make_blob_image(64, 64, seed=1), 64, 64)
    assert int(feats.count) == 0 and det.lost == 0 and per == [0, 0]
    assert feats.capacity == 1


def test_trace_writes_chrome_trace(tmp_path):
    inst = vt.SiftInstance(vt.SiftConfig(max_nb_sift_per_buffer=256,
                                         input_image_max_size=64 * 48),
                           device="cpu")
    with pytest.raises(RuntimeError):
        inst.stop_trace()
    log_dir = tmp_path / "trace"
    inst.start_trace(str(log_dir))
    with pytest.raises(RuntimeError):
        inst.start_trace(str(log_dir))
    inst.detect_features(make_blob_image(48, 64, seed=2), 0)
    inst.get_features_number(0)
    path = inst.stop_trace()
    assert os.path.dirname(path) == str(log_dir)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with pytest.raises(RuntimeError):
        inst.stop_trace()
