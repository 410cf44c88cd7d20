"""The port's native IO (``vulkansift_tpu_torch.utils.native_io``): the
JAX package's ``tests/test_native_io.py`` cases against the port's module,
files written by one package read by the other, and the port's own build
(into the git-ignored ``build/``, raising when ``g++`` fails, the
pure-Python paths without ``g++``). Skips where ``g++`` is missing, as the
JAX tests do."""

import shutil

import numpy as np
import pytest

from vulkansift_tpu.types import FEATURE_DTYPE as JAX_FEATURE_DTYPE
from vulkansift_tpu.utils import native_io as jnio
from vulkansift_tpu_torch.types import FEATURE_DTYPE
from vulkansift_tpu_torch.utils import native_io as tnio


@pytest.fixture(scope="module")
def nio():
    if shutil.which("g++") is None and not tnio.lib_path().exists():
        pytest.skip("no g++ toolchain")
    assert tnio.available()
    return tnio


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n# comment\n%d %d\n255\n" % (img.shape[1],
                                                  img.shape[0]))
        f.write(img.tobytes())


def _write_ppm(path, rgb):
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
        f.write(rgb.tobytes())


def _features(n, seed):
    rng = np.random.default_rng(seed)
    f = np.zeros(n, FEATURE_DTYPE)
    f["x"] = rng.random(n).astype(np.float32)
    f["sigma"] = rng.random(n).astype(np.float32)
    f["octave_idx"] = rng.integers(-1, 5, n)
    f["scale_idx"] = rng.integers(0, 6, n)
    f["descriptor"] = rng.integers(0, 256, (n, 128))
    return f


def test_library_builds_into_build_dir(nio):
    path = nio.lib_path()
    assert path.exists() and path.parent == nio.BUILD_DIR
    assert path.parent.name == "build"


def test_pgm_roundtrip(nio, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64), np.uint8)
    p = str(tmp_path / "a.pgm")
    _write_pgm(p, img)
    out = nio.read_image_gray(p)
    np.testing.assert_array_equal(out, img)


def test_ppm_grayscale_conversion(nio, tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (24, 32, 3), np.uint8)
    p = str(tmp_path / "a.ppm")
    _write_ppm(p, rgb)
    out = nio.read_image_gray(p)
    r64 = rgb.astype(np.int64)
    ref = (299 * r64[..., 0] + 587 * r64[..., 1] + 114 * r64[..., 2]) // 1000
    assert np.abs(out.astype(int) - ref).max() <= 1
    np.testing.assert_array_equal(out, jnio.read_image_gray(p))


def test_decode_failure_raises(nio, tmp_path):
    p = str(tmp_path / "bad.pgm")
    with open(p, "wb") as f:
        f.write(b"NOTPNM")
    with pytest.raises(IOError):
        nio.read_image_gray(p)


def test_prefetch_loader_order_and_content(nio, tmp_path):
    paths = []
    for i in range(16):
        img = np.full((8, 8), i * 3, np.uint8)
        p = str(tmp_path / f"i{i:02d}.pgm")
        _write_pgm(p, img)
        paths.append(p)
    loader = nio.ImageLoader(paths, nb_threads=3, prefetch=5)
    vals = [int(im[0, 0]) for im in loader]
    loader.close()
    assert vals == [i * 3 for i in range(16)]


def test_feature_file_roundtrip(nio, tmp_path):
    f = _features(7, 2)
    p = str(tmp_path / "f.vft")
    nio.save_features(p, f)
    out = nio.load_features(p)
    assert (out == f).all()
    # Empty set round-trips too.
    nio.save_features(p, np.zeros(0, FEATURE_DTYPE))
    assert len(nio.load_features(p)) == 0
    with pytest.raises(ValueError):
        nio.save_features(p, np.zeros(3, np.float32))


def test_python_fallback_matches_native(nio, tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (20, 30), np.uint8)
    p = str(tmp_path / "a.pgm")
    _write_pgm(p, img)
    native = nio.read_image_gray(p)
    fallback = nio._read_pnm_python(p)
    np.testing.assert_array_equal(native, fallback)
    np.testing.assert_array_equal(fallback, jnio._read_pnm_python(p))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_feature_files_cross_packages(nio, tmp_path, writer):
    assert FEATURE_DTYPE == JAX_FEATURE_DTYPE
    f = _features(11, 5)
    p = str(tmp_path / "f.vft")
    save, load = ((nio.save_features, jnio.load_features) if writer == "port"
                  else (jnio.save_features, nio.load_features))
    save(p, f)
    back = load(p)
    assert back.tobytes() == f.tobytes()


def test_without_gxx_the_python_paths_run(monkeypatch, tmp_path):
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setattr(tnio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnio.shutil, "which", lambda name: None)
    assert not tnio.available()
    img = np.random.default_rng(6).integers(0, 256, (9, 13), np.uint8)
    p = str(tmp_path / "a.pgm")
    _write_pgm(p, img)
    np.testing.assert_array_equal(tnio.read_image_gray(p), img)
    f = _features(4, 7)
    tnio.save_features(str(tmp_path / "f.vft"), f)
    assert tnio.load_features(str(tmp_path / "f.vft")).tobytes() == f.tobytes()
    with pytest.raises(RuntimeError):
        tnio.ImageLoader([p])
    assert not (tmp_path / "build").exists()


def test_failed_build_raises(nio, monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setattr(tnio, "SOURCE", bad)
    monkeypatch.setattr(tnio, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        tnio.available()
    assert not list((tmp_path / "build").glob("*.so"))
