"""The ``hannover-3456x2304`` deployment (``benchmark/configs/``) on the
CPU, held to the benchmark's plain reference (``benchmark/reference/
sift.py``) and its comparison (``benchmark/yardstick/check.py``), both
loaded by path as ``benchmark/run.py`` loads them.

* The octave plan at the published size, with no image: 8 octaves from the
  2x upsampled 6912x4608 seed down to 54x36, and the section capacities
  that split the 32768 features eight ways, as the reference works them
  out (the 1536x1024 deployment beside it: 7 octaves).
* ``SiftInstance`` with the configuration's own ``sift_config`` on seeded
  frames cut to 432x288, the published frame over 8 a side (the same 3:2
  aspect), against the reference within ``checks/detect.json``'s limits.
* The clamp path: a buffer small enough that sections overflow. The port
  keeps the reference's features in the reference's raster order, and
  ``get_lost_features_number`` is what the reference drops at the buffer's
  end. The pan frames' texture (cells of 8 to 64 px) leaves the upsampled
  octave 0 without candidates at every size, so their clamp falls on
  octaves 1 and 2; a seeded frame of one-pixel noise fills octave 0's
  section and overflows the buffer.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vulkansift_tpu_torch as vt
from torch_threads import one_torch_thread  # noqa: F401

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference import sift as ref_sift  # noqa: E402
from yardstick import check, images, loop  # noqa: E402

SEED = 2 ** 31 + 18
CUT = 8                     # the test frame is the published one over 8


def _config_file(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def _limits() -> dict:
    with open(BENCH / "checks" / "detect.json") as f:
        return {k: v for k, v in json.load(f).items()
                if not k.startswith("_")}


CFG = _config_file("hannover-3456x2304")
W, H = CFG["frame"]["width"] // CUT, CFG["frame"]["height"] // CUT


@pytest.mark.parametrize("name,octaves", [("hannover-3456x2304", 8),
                                          ("hannover-1536x1024", 7)])
def test_octave_plan_at_the_published_size(name, octaves):
    cfg_file = _config_file(name)
    w, h = cfg_file["frame"]["width"], cfg_file["frame"]["height"]
    ref_cfg = cfg_file["sift_config"]
    sc = loop.sift_config(cfg_file, {"buffers": 1})
    plan = sc.octave_resolutions(w, h)
    assert plan == tuple(ref_sift.octave_sizes(ref_cfg, w, h))
    assert len(plan) == octaves
    assert plan[0] == (2 * w, 2 * h)
    assert plan[-1] == (2 * w >> (octaves - 1), 2 * h >> (octaves - 1))
    caps = sc.octave_section_capacities(octaves)
    assert caps == tuple(ref_sift.section_capacities(
        ref_cfg["max_nb_sift_per_buffer"], octaves))
    assert sum(caps) <= ref_cfg["max_nb_sift_per_buffer"]
    if name == "hannover-3456x2304":
        assert plan[0] == (6912, 4608) and plan[-1] == (54, 36)
        assert caps[0] == 16448


def _frame(kind: str) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    if kind == "pan":
        return images.pan(W, H, 2, (7, 5), rng)[1]
    return (rng.random((H, W)) * 255).astype(np.uint8)


def _candidates(img: np.ndarray, cfg: dict) -> list:
    """Each octave's extremum candidates in the reference, uncapped."""
    sizes = ref_sift.octave_sizes(cfg, W, H)
    _, dogs = ref_sift.build_pyramid(
        torch.as_tensor(img).to(torch.float32) / 255.0, cfg, sizes)
    thr = cfg["intensity_threshold"] / cfg["nb_scales_per_octave"]
    return [len(ref_sift._candidates(d, thr, d.numel())) for d in dogs]


# (frame, buffer size, octaves whose section overflows, features lost)
CASES = {
    "pan_full_buffer": ("pan", None, (), False),
    "pan_sections_clamp": ("pan", 512, (1, 2), False),
    "noise_buffer_overflows": ("noise", 384, (0,), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cut_frame_against_the_reference(case, monkeypatch):
    kind, buffer, clamped, lost = CASES[case]
    img = _frame(kind)
    assert img.shape == (H, W) == (288, 432)
    cfg = dict(CFG["sift_config"])
    if buffer is not None:
        cfg["max_nb_sift_per_buffer"] = buffer
    n = cfg["max_nb_sift_per_buffer"]
    caps = ref_sift.section_capacities(n, len(ref_sift.octave_sizes(
        cfg, W, H)))
    over = [o for o, (c, cap) in enumerate(zip(_candidates(img, cfg), caps))
            if c > cap]
    assert tuple(over) == clamped

    inst = vt.SiftInstance(loop.sift_config(dict(CFG, sift_config=cfg),
                                            {"buffers": 1}), device="cpu")
    inst.detect_features(img, 0)
    count = inst.get_features_number(0)
    got = inst.download_features(0)
    ref = ref_sift.detect(img, cfg)
    numbers = check.compare_features(got, ref)
    assert check.verdict(numbers, _limits(), check.DETECT_NUMBERS) is None, \
        numbers
    assert count == len(got) == len(ref["x"]) <= n
    assert sum(inst.get_per_octave_counts(0)) == count

    # The reference with the same sections and no end to the buffer: the
    # features the buffer's end drops.
    monkeypatch.setattr(ref_sift, "section_capacities",
                        lambda total, nb_oct: caps)
    whole = ref_sift.detect(img, dict(cfg, max_nb_sift_per_buffer=10 * n))
    assert inst.get_lost_features_number(0) == len(whole["x"]) - count
    assert (inst.get_lost_features_number(0) > 0) == lost
    # In raster order: feature i of the port is the reference's feature i.
    for k in ("octave_idx", "scale_idx"):
        np.testing.assert_array_equal(got[k], whole[k][:count])
    for k in ("scale_x", "scale_y"):
        assert np.abs(got[k] - whole[k][:count]).max() <= check.PAIR_PX
    da = np.abs(got["orientation"] - whole["orientation"][:count]) \
        % (2 * np.pi)
    assert np.minimum(da, 2 * np.pi - da).max() <= check.PAIR_RAD
    inst.close()
