"""The port's examples (``vulkansift_tpu_torch.examples``) on the CPU:
each ``main([...])`` at ``--device cpu`` on a small PGM in a tmp dir, what
it prints against its compute function, and the compute functions against
the port's instance (the detect and match paths themselves are held to
the JAX package by the other ``test_torch_*`` files)."""

import json
from pathlib import Path

import numpy as np
import pytest

from conftest import make_blob_image
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.examples import (common, sift_detect,
                                           sift_error_handling, sift_match,
                                           sift_profile, sift_show_pyramid)
from torch_threads import one_torch_thread  # noqa: F401

IMG = make_blob_image(96, 128, seed=21, nb_blobs=16)


def _pgm(path: Path, img: np.ndarray) -> str:
    path.write_bytes(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0])
                     + img.tobytes())
    return str(path)


def test_sift_detect_main_and_compute(tmp_path, capsys):
    src = _pgm(tmp_path / "a.pgm", IMG)
    assert sift_detect.main([src, "--out", str(tmp_path / "port.png"),
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert (tmp_path / "port.png").exists()
    feats = sift_detect.detect(IMG, "cpu")
    assert out == [f"detected {len(feats)} features",
                   f"wrote {tmp_path / 'port.png'}"]
    assert len(feats) > 10
    inst = vt.SiftInstance(vt.SiftConfig(max_nb_sift_per_buffer=16384),
                           device="cpu")
    inst.detect_features(IMG, 0)
    assert inst.download_features(0).tobytes() == feats.tobytes()


def test_sift_error_handling_main_and_compute(capsys):
    """The four invalid calls of ``examples/sift_error_handling.py`` each
    raise ``InvalidInputError`` and fire the error callback with
    ``INVALID_INPUT_ERROR``, and the instance detects afterwards."""
    assert sift_error_handling.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6
    assert all(l.startswith("caught InvalidInputError: ") for l in out[:4])
    assert out[4] == ("error callback fired 4 times (['INVALID_INPUT_ERROR', "
                      "'INVALID_INPUT_ERROR', 'INVALID_INPUT_ERROR', "
                      "'INVALID_INPUT_ERROR'])")
    res = sift_error_handling.run(IMG, "cpu")
    assert None not in res["caught"] and len(res["caught"]) == 4
    assert res["features"] == len(sift_detect.detect(IMG, "cpu")) > 0
    assert out[5].startswith("instance still works: ")


def test_sift_match_main_and_compute(tmp_path, capsys):
    img2 = np.ascontiguousarray(
        np.pad(IMG, ((3, 0), (4, 0)), mode="edge")[:IMG.shape[0],
                                                    :IMG.shape[1]])
    a, b = _pgm(tmp_path / "a.pgm", IMG), _pgm(tmp_path / "b.pgm", img2)
    assert sift_match.main([a, b, "--out", str(tmp_path / "m.png"),
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    res = sift_match.match(IMG, img2, "cpu")
    assert out[0] == (f"features: {len(res['f1'])} / {len(res['f2'])}; "
                      f"cross-checked Lowe matches: {len(res['ia'])}")
    assert (tmp_path / "m.png").exists()
    f1, f2, ia, ib = res["f1"], res["f2"], res["ia"], res["ib"]
    err = np.hypot(f2["x"][ib] - f1["x"][ia] - 4, f2["y"][ib] - f1["y"][ia] - 3)
    assert len(ia) > 10 and np.mean(err < 1.5) >= 0.9


def test_sift_profile_main_writes_a_trace(tmp_path, capsys):
    src = _pgm(tmp_path / "a.pgm", IMG)
    assert sift_profile.main([src, "--iters", "2", "--device", "cpu",
                              "--trace-dir", str(tmp_path / "tr")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0] for l in out[:2]] == ["iter 0", "iter 1"]
    assert out[2].startswith("trace written to ")
    trace = Path(out[2][len("trace written to "):])
    assert trace.parent == tmp_path / "tr"
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert len(names) > 10
    n = int(out[0].split(", ")[-1].split()[0])
    assert n == len(sift_detect.detect(IMG, "cpu"))


def test_sift_show_pyramid_main_and_compute(tmp_path, capsys):
    src = _pgm(tmp_path / "a.pgm", IMG)
    assert sift_show_pyramid.main([src, "--out-dir", str(tmp_path / "pyr"),
                                   "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    cfg = vt.SiftConfig()
    plan = vt.octave_plan(cfg, IMG.shape[1], IMG.shape[0])
    assert out[0] == f"{len(plan)} octaves"
    assert out[1:1 + len(plan)] == [f"octave {o}: {w}x{h}"
                                    for o, (w, h) in enumerate(plan)]
    s = cfg.nb_scales_per_octave
    assert len(list((tmp_path / "pyr").glob("*.png"))) == len(plan) * (2 * s + 5)
    res = sift_show_pyramid.pyramid(IMG, "cpu")
    assert res["octaves"] == list(plan)
    for o, (w, h) in enumerate(plan):
        assert all(g.shape == (h, w) for g in res["gaussians"][o] + res["dogs"][o])
        np.testing.assert_allclose(res["dogs"][o][0],
                                   res["gaussians"][o][1] - res["gaussians"][o][0],
                                   rtol=0, atol=1e-6)


def test_example_images_without_cv2():
    cv2 = pytest.importorskip("cv2")
    img = common.synthetic_image(96, 128, seed=4)
    assert img.dtype == np.uint8 and img.min() == 0 and img.max() == 255
    np.testing.assert_array_equal(img, common.synthetic_image(96, 128, seed=4))
    hmat = np.array([[0.95, -0.1, 10], [0.1, 0.95, -4], [0, 0, 1.0]])
    ours = common.warp_perspective(img, hmat).astype(int)
    ref = cv2.warpPerspective(img, hmat, (128, 96)).astype(int)
    # Away from the edge of the warped image both interpolate bilinearly.
    inner = np.zeros_like(ours, bool)
    inner[8:-8, 8:-8] = True
    inner &= cv2.warpPerspective(np.full_like(img, 255), hmat, (128, 96),
                                 flags=cv2.INTER_NEAREST) > 0
    inner[1:-1, 1:-1] &= (inner[:-2, 1:-1] & inner[2:, 1:-1]
                          & inner[1:-1, :-2] & inner[1:-1, 2:])
    assert inner.sum() > 4000
    assert np.abs(ours - ref)[inner].max() <= 1
