"""The roofline formulas against hand counts at small shapes, and the
readers that fold them with a trace."""

import math

import numpy as np
import pytest

from yardstick import loop, readers, roofline, spec

CFG = {"use_input_upsampling": False, "nb_octaves": 0,
       "nb_scales_per_octave": 3, "input_image_blur_level": 0.5,
       "seed_scale_sigma": 1.6}


def _kernel(name):
    return next(k for k in spec.kernels() if k.SYMBOL == name + "_kernel")


def _feats(**kw):
    base = dict(octave_idx=[0], scale_idx=[1], scale_x=[20.0],
                scale_y=[16.0], sigma=[1.0])
    base.update(kw)
    return {k: np.asarray(v) for k, v in base.items()}


def test_match_work_hand_count():
    (b, o, rate), = _kernel("match_2nn").work(roofline.Item([], 10, 20))
    assert b == 128 * 30 + 16 * 10 + 8
    assert o == 2 * 128 * 10 * 20
    assert rate == roofline.PEAKS["int8_ops_per_s"]
    assert _kernel("match_2nn").work(roofline.Item([])) == []


def test_blur_work_hand_count():
    # 64x32: 2 octaves (log2(32) - 4 = 1 -> at least 1; log2 -> 5 - 4 = 1).
    fr = roofline.Frame(CFG, 64, 32, _feats())
    assert fr.sizes == [(64, 32)]
    work = _kernel("blur_dog").work(roofline.Item([fr]))
    # Octave 0: the seed's blur (no DoG) and five blurs with their DoG.
    assert len(work) == 6
    from reference import sift
    taps = [len(t) for t in sift.blur_taps(CFG)]
    npx = 64 * 32
    assert work[0][:2] == (8 * npx, npx * 2 * (1 + 3 * (taps[0] - 1)))
    assert work[1][:2] == (12 * npx, npx * (2 * (1 + 3 * (taps[1] - 1)) + 1))


def test_frontend_work_hand_count():
    fr = roofline.Frame(CFG, 64, 32, _feats())
    (b, o, _), = _kernel("frontend").work(roofline.Item([fr]))
    cells = 3 * 30 * 62
    assert b == 4 * 5 * 32 * 64 + cells + 4 * 3 * 30
    assert o == 147 * cells


def test_window_work_counts_distinct_pixels():
    # sigma 1 -> orientation radius floor(4.5) = 4: a 9x9 window well inside
    # the layer; its four taps cover an 11x11 square without its corners.
    fr = roofline.Frame(CFG, 64, 32, _feats())
    px, cells, n = roofline.window_work(fr, False, roofline.ori_radius, "cpu")
    assert (px, cells, n) == (11 * 11 - 4, 81, 1)
    # The same keypoint twice (two orientations) counts once as a keypoint
    # and twice as pairs, with the same pixels.
    fr2 = roofline.Frame(CFG, 64, 32, _feats(
        octave_idx=[0, 0], scale_idx=[1, 1], scale_x=[20.0, 20.0],
        scale_y=[16.0, 16.0], sigma=[1.0, 1.0]))
    assert roofline.window_work(fr2, False, roofline.ori_radius, "cpu") \
        == (117, 81, 1)
    assert roofline.window_work(fr2, True, roofline.ori_radius, "cpu") \
        == (117, 162, 2)


def test_window_clipped_at_the_border():
    # Centre (1, 1): only cells with 1 <= x, y < w - 1 count.
    fr = roofline.Frame(CFG, 64, 32, _feats(scale_x=[1.0], scale_y=[1.0]))
    _, cells, _ = roofline.window_work(fr, False, roofline.ori_radius, "cpu")
    assert cells == 5 * 5


class _Run:
    def __init__(self, trace, items, window_s=0.0, done=0):
        self.trace, self.work_items = trace, items
        self.kernels, self.device = spec.kernels(), "cpu"
        self.window_s = window_s
        self.spans = loop.Spans(names=[], latencies_ns=[1] * done)


def test_roofline_share_and_glue():
    item = roofline.Item([], 1000, 1000)
    bound = roofline.bound_s(*_kernel("match_2nn").work(item)[0][:2],
                             roofline.PEAKS["int8_ops_per_s"])
    # Busy 2 bound a pair traced; the untraced window's 10 pairs took 40.
    run = _Run({"items": [0, 1], "busy_s": 4 * bound, "window_s": 8 * bound,
                "device_s": {"match_2nn_kernel": 4 * bound}}, [item, item],
               window_s=40 * bound, done=10)
    assert readers.roofline_share(run, "match") == pytest.approx(50.0)
    assert readers.idle_share(run) == pytest.approx(50.0)
    assert readers.glue_ms(run, "match") == pytest.approx(0.0)
    assert readers.device_ms(run) == pytest.approx(2 * bound * 1e3)
    # A kernel the trace did not see leaves its share silent.
    run.trace["device_s"] = {}
    assert readers.roofline_share(run, "match") is None
    assert readers.roofline_share(_Run(None, []), "match") is None


def test_bound_takes_the_larger_time():
    p = roofline.PEAKS
    assert roofline.bound_s(p["hbm_bytes_per_s"], 0, 1.0) == pytest.approx(1)
    assert roofline.bound_s(0, 2 * p["f32_ops_per_s"], p["f32_ops_per_s"]) \
        == pytest.approx(2)
    assert math.isclose(roofline.bound_s(0, 0, 1.0), 0.0)
