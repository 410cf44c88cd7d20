"""The port's benchmark harness (``vulkansift_tpu_torch.perf``) against
the JAX package's (``vulkansift_tpu.perf``) on the CPU, at 160x128.

The same inputs go through both packages' functions: the synthetic pairs
are equal exactly, ``repeatability_score`` and ``lowe_matches`` (indices)
exactly, ``compute_metrics`` to 1e-12, and the matching benchmark's result
lines equal on one Oxford-layout set. The detectors, each package's on its
own, agree in count and to 1e-3 px. The runtime protocol, the plots (read
from the JAX package's committed ``results/`` files, written to a tmp
dir), the parity protocol under a budget and the runtime CLI run end to
end."""

import os
from pathlib import Path

import numpy as np
import pytest

from vulkansift_tpu.perf import harness as jh
from vulkansift_tpu_torch.errors import InvalidConfigError
from vulkansift_tpu_torch.perf import harness as th
from vulkansift_tpu_torch.perf import matching, parity, plot, runtime
from torch_threads import one_torch_thread  # noqa: F401

W, H = 160, 128
RESULTS = Path(__file__).resolve().parent.parent / "results"


class _Cached(th.Detector):
    """One detector's results by image bytes, so both packages' benchmark
    functions see the same detections without detecting twice."""

    def __init__(self, det):
        self._det, self._seen = det, {}
        self.name = det.name

    def detect(self, image):
        key = image.tobytes()
        if key not in self._seen:
            self._seen[key] = self._det.detect(image)
        return self._seen[key]


@pytest.fixture(scope="module")
def port_det():
    det = th.VulkanSiftTpuTorchDetector(max_features=2048, device="cpu")
    det.init()
    yield _Cached(det)
    det.terminate()


@pytest.fixture(scope="module")
def pair():
    return next(iter(th.synthesize_pairs("bark", seed=0, w=W, h=H)))


@pytest.fixture(scope="module")
def results(port_det, pair):
    _, img1, img2, _ = pair
    jdet = jh.VulkanSiftTpuDetector(max_features=2048)
    jdet.init()
    out = dict(port=(port_det.detect(img1), port_det.detect(img2)),
               jax=(jdet.detect(img1), jdet.detect(img2)))
    jdet.terminate()
    return out


def test_synthesize_pairs_equal_jax():
    for a, b in zip(th.synthesize_pairs("wall", seed=3, w=W, h=H),
                    jh.synthesize_pairs("wall", seed=3, w=W, h=H)):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_metrics_equal_jax(results, pair, source):
    _, img1, img2, hmat = pair
    r1, r2 = results[source]
    assert len(r1.xy) > 20 and len(r2.xy) > 20
    assert (th.repeatability_score(img1.shape, img2.shape, hmat, r1.xy, r2.xy)
            == jh.repeatability_score(img1.shape, img2.shape, hmat, r1.xy,
                                      r2.xy))
    m = th.lowe_matches(r1.descriptors, r2.descriptors, device="cpu")
    assert len(m) > 10
    np.testing.assert_array_equal(m, jh.lowe_matches(r1.descriptors,
                                                     r2.descriptors))
    np.testing.assert_allclose(
        th.compute_metrics(img1, img2, hmat, r1, r2, device="cpu"),
        jh.compute_metrics(img1, img2, hmat, r1, r2), rtol=0, atol=1e-12)


def test_lowe_matches_float_descriptors_and_tiny_sets():
    rng = np.random.default_rng(2)
    a = rng.normal(100, 80, (30, 128)).astype(np.float32)
    b = np.concatenate([a[::-1] + 1, rng.normal(100, 80, (9, 128))]
                       ).astype(np.float32)
    m = th.lowe_matches(a, b, device="cpu")
    np.testing.assert_array_equal(m, jh.lowe_matches(a, b))
    assert th.lowe_matches(a[:1], b, device="cpu").shape == (0, 2)


def test_detectors_agree_with_jax(results, pair):
    (r1, r2), (q1, q2) = results["port"], results["jax"]
    for r, q in ((r1, q1), (r2, q2)):
        assert len(r.xy) == len(q.xy)
        np.testing.assert_allclose(r.xy, q.xy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(r.size, q.size, rtol=0, atol=1e-3)


def test_runtime_benchmark_writes_result_file(port_det, pair, tmp_path):
    img1 = pair[1]
    mean_ms, nb = th.run_runtime_benchmark(img1, port_det, warmup=0, iters=1,
                                           out_dir=str(tmp_path))
    assert nb == len(port_det.detect(img1).xy) > 0 and mean_ms >= 0
    text = (tmp_path / "runtime_results_vulkansift_tpu_torch.txt").read_text()
    ms, feats = text.strip().split(";")
    assert float(ms) == pytest.approx(mean_ms, abs=1e-6)
    assert int(feats) == nb


def _oxford_set(root: Path, name: str):
    """An Oxford-layout set at 160x128: img1..img6 as PPM (gray in all
    three channels) and the H1toNp files, from the synthetic pairs."""
    d = root / name
    d.mkdir(parents=True)
    for n, img1, imgn, hmat in th.synthesize_pairs(name, seed=1, w=W, h=H):
        for k, img in ((1, img1), (n, imgn)):
            with open(d / f"img{k}.ppm", "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (W, H))
                f.write(np.repeat(img[..., None], 3, 2).tobytes())
        (d / f"H1to{n}p").write_text(
            "\n".join(" ".join(f"{v:.17g}" for v in row) for row in hmat))


def test_matching_benchmark_equals_jax_on_oxford_layout(port_det, tmp_path):
    _oxford_set(tmp_path / "data", "bark")
    kw = dict(dataset_path=str(tmp_path / "data"), sets=("bark",))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    lines = th.run_matching_benchmark(port_det, out_dir=str(tmp_path / "port"),
                                      device="cpu", **kw)
    assert len(lines) == 5 and all(l.startswith("bark;1;") for l in lines)
    assert lines == jh.run_matching_benchmark(
        port_det, out_dir=str(tmp_path / "jax"), **kw)
    assert ((tmp_path / "port" / "matching_results_vulkansift_tpu_torch.txt")
            .read_text().splitlines() == lines)


def test_plot_reads_committed_results(tmp_path):
    before = sorted(os.listdir(RESULTS))
    sets = set()
    for name in before:
        if "matching_results" in name:
            sets |= {l.split(";")[0] for l in
                     (RESULTS / name).read_text().splitlines() if l}
    n = plot.plot_matching(str(RESULTS), str(tmp_path))
    assert n == 4 * len(sets) > 0
    assert len(list(tmp_path.glob("*.png"))) == n
    runs = tmp_path / "runtime"
    runs.mkdir()
    for name in before:
        if name.startswith("runtime_results_"):
            det = name[len("runtime_results_"):]
            (runs / f"oxford_runtime_points_{det}").write_text(
                (RESULTS / name).read_text())
    assert plot.plot_runtime(str(runs), str(runs)) == 2
    assert (runs / "runtime_vs_features.png").exists()
    assert sorted(os.listdir(RESULTS)) == before


def test_parity_runs_on_cpu_within_its_budget(tmp_path):
    summary = parity.run_parity(out_dir=str(tmp_path), quick=True,
                                size=(H, W), modes=("ubc_f32",),
                                budget_s=60.0, device="cpu")
    assert summary["pairs_total"] == 14
    assert summary["recall_OpenCV"] > 0
    done = summary["pairs_ubc_f32"]
    assert 1 <= done <= 14
    assert 0 < summary["parity_ubc_f32"]
    rows = [l.split(";") for l in
            (tmp_path / "recall_parity.txt").read_text().splitlines()
            if not l.startswith("#")]
    assert sum(r[0] == "OpenCV" for r in rows) == 14
    assert sum(r[0] == "vulkansift_tpu_torch_ubc_f32" for r in rows) == done


@pytest.mark.parametrize("mode", ["ubc_f32_noremap", "vlfeat_fp16_noremap"])
def test_noremap_modes_raise(tmp_path, mode):
    with pytest.raises(InvalidConfigError, match="VKSIFT_NO_SIGMA_REMAP"):
        parity.run_parity(out_dir=str(tmp_path), modes=("ubc_f32", mode),
                          device="cpu")
    assert not list(tmp_path.iterdir())


def test_runtime_cli_reads_pgm_natively(pair, tmp_path, capsys):
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P5\n%d %d\n255\n" % (W, H) + pair[1].tobytes())
    rc = runtime.main([str(p), "vulkansift_tpu_torch", "--warmup", "0",
                       "--iters", "1", "--device", "cpu",
                       "--out-dir", str(tmp_path)])
    assert rc == 0
    nb = int((tmp_path / "runtime_results_vulkansift_tpu_torch.txt")
             .read_text().split(";")[1])
    assert f"{nb} features" in capsys.readouterr().out
    assert runtime.main([str(tmp_path / "missing.pgm"), "OpenCV"]) == 1
    assert "Failed to read image" in capsys.readouterr().err


def test_matching_cli_argument_errors(capsys):
    assert matching.main(["OpenCV"]) == 1
    assert matching.main(["/nonexistent", "no_such_detector"]) == 1
    assert "unknown detector" in capsys.readouterr().err
