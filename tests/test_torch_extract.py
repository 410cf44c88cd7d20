"""The PyTorch port's keypoint extraction (plain version of the frontend
kernel, compaction, refinement) against the JAX package on the CPU, from
the same seeded numpy inputs.

Tolerances: frontend codes and candidates bit-exact (the JAX package's bar
for its frontend kernel, tests/test_pallas_frontend.py); refinement
validity exact and subpixel positions to 1e-5 px (the final Newton solve
divides, and the two frameworks may round the reciprocal chain
differently).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_image
from vulkansift_tpu.config import SiftConfig
from vulkansift_tpu.ops import extract as jex
from vulkansift_tpu.ops import pallas_frontend as jpf
from vulkansift_tpu.ops import scale_space as jss
from vulkansift_tpu_torch.ops import extract as tex
from vulkansift_tpu_torch.ops import frontend as tfront
from torch_threads import one_torch_thread  # noqa: F401

THR = 0.04 / 3


def _rand_dog(shape, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32) * scale


def _blob_dogs():
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg = SiftConfig(use_input_upsampling=True)
    shapes = tuple((h, w) for w, h in cfg.octave_resolutions(128, 96))
    x = jnp.asarray(img).astype(jnp.float32) * (1.0 / 255.0)
    _, dogs = jss.build_pyramid_jit(x, cfg, shapes)
    return [np.array(d) for d in dogs]


def _tuples(s, y, x, n):
    return list(zip(np.asarray(s)[:n].tolist(), np.asarray(y)[:n].tolist(),
                    np.asarray(x)[:n].tolist()))


@pytest.mark.parametrize("case", ["rand_64x128", "rand_48x200", "blob_oct0",
                                  "blob_oct1"])
def test_dense_frontend_matches_jax(case):
    if case.startswith("rand"):
        shape = (5, 64, 128) if case == "rand_64x128" else (5, 48, 200)
        dog = _rand_dog(shape)
    else:
        dog = _blob_dogs()[int(case[-1])]
    cap = 8192  # above every case's candidate count
    ref_c, ref_code = jax.jit(jex.dense_frontend, static_argnums=(1, 2))(
        jnp.asarray(dog), THR, cap)
    code, counts = tfront.frontend(torch.from_numpy(dog), THR)
    # Port layout = JAX dense_frontend layout (S, H-2, W-2) plus bit 128.
    np.testing.assert_array_equal(code.numpy().astype(np.int32) % 128,
                                  np.asarray(ref_code).astype(np.int32))
    n = int(ref_c.count)
    cand = code.numpy() >= 128
    assert int(cand.sum()) == n
    np.testing.assert_array_equal(counts.numpy(), cand.sum(axis=2))
    c = tex.compact_candidates(code, counts, cap)
    assert int(c.count) == n
    assert _tuples(c.s, c.y, c.x, n) == _tuples(ref_c.s, ref_c.y, ref_c.x, n)
    # code0 is each candidate's own walk code.
    idx = (c.s[:n] - 1, c.y[:n] - 1, c.x[:n] - 1)
    np.testing.assert_array_equal(c.code0[:n].numpy(),
                                  code[idx].numpy().astype(np.int32) % 128)


def test_frontend_matches_pallas_kernel_interpret(monkeypatch):
    """The TPU kernel itself, through the Pallas interpreter, against the
    port's frontend. The kernel's code layout is code[s-1, y-1, x]."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interpret(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpf.pl, "pallas_call", interpret)
    dog = _rand_dog((5, 40, 128), seed=3)
    ref_c, ref_code = jpf.frontend_tpu(jnp.asarray(dog), dog_threshold=THR,
                                       capacity=256)
    code, counts = tfront.frontend(torch.from_numpy(dog), THR)
    s, h, w = dog.shape
    k_code = np.asarray(ref_code)[:, :h - 2, 1:w - 1].astype(np.int32)
    np.testing.assert_array_equal(code.numpy().astype(np.int32), k_code)
    n = int(ref_c.count)
    c = tex.compact_candidates(code, counts, 256)
    assert int(c.count) == n > 0
    assert _tuples(c.s, c.y, c.x, n) == _tuples(ref_c.s, ref_c.y, ref_c.x, n)
    np.testing.assert_array_equal(c.code0[:n].numpy(),
                                  np.asarray(ref_c.code0)[:n])


def test_exact_kernels_build_without_fused_multiply_add(monkeypatch):
    """The kernels held bit for bit against their plain versions (blur,
    frontend walk code) and those kept as measured build with
    --fmad=false; only the descriptor, held to a u8 tolerance, may fuse.
    The flags are part of each library's cache key."""
    from vulkansift_tpu_torch.ops import cuda_lib
    for name in cuda_lib.SOURCES:
        flags = cuda_lib.nvcc_flags(name)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert ("--fmad=false" in flags) == (name != "descriptor"), name
    exact = cuda_lib._lib_path("frontend")
    monkeypatch.setattr(cuda_lib, "NO_FMAD", ())
    assert cuda_lib._lib_path("frontend") != exact


def test_compaction_capacity_clamp():
    dog = _rand_dog((5, 64, 128), seed=1)
    code, counts = tfront.frontend(torch.from_numpy(dog), 0.001)
    full = tex.compact_candidates(code, counts, 4096)
    n = int(full.count)
    assert n > 64
    cap = n // 2
    c = tex.compact_candidates(code, counts, cap)
    assert int(c.count) == cap
    # Raster-order prefix of the full compaction.
    for a, b in ((c.s, full.s), (c.y, full.y), (c.x, full.x)):
        np.testing.assert_array_equal(a.numpy(), b[:cap].numpy())


def test_rank_select_matches_jax():
    rng = np.random.default_rng(4)
    mask = rng.random(3000) < 0.1
    for cap in (1000, 100):
        ri, rc = jex.rank_select(jnp.asarray(mask), cap)
        ti, tc = tex.rank_select(torch.from_numpy(mask), cap)
        assert int(rc) == int(tc)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


@pytest.mark.parametrize("octave", [0, 1])
def test_refine_matches_jax(octave):
    dog = _blob_dogs()[octave]
    _, h, w = dog.shape
    kw = dict(nb_scales=3, width=w, height=h, dog_threshold=THR,
              edge_threshold=10.0, seed_sigma=1.6, octave_idx=octave - 1)
    jc, jcode = jax.jit(jex.dense_frontend, static_argnums=(1, 2))(
        jnp.asarray(dog), THR, 256)
    jr = jex.refine_candidates(jnp.asarray(dog), jc, code=jcode, **kw)
    code, counts = tfront.frontend(torch.from_numpy(dog), THR)
    c = tex.compact_candidates(code, counts, 256)
    tr = tex.refine_candidates(torch.from_numpy(dog), c, code=code, **kw)
    valid = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), valid)
    assert valid.sum() > 0
    for name in ("scale_x", "scale_y", "subpix_s", "x", "y", "sigma",
                 "intensity"):
        np.testing.assert_allclose(
            getattr(tr, name).numpy()[valid],
            np.asarray(getattr(jr, name))[valid], rtol=0, atol=1e-5,
            err_msg=name)
    np.testing.assert_array_equal(tr.scale_idx.numpy()[valid],
                                  np.asarray(jr.scale_idx)[valid])


def test_walk_classify_agrees_with_newton_step():
    """The division-free classification the kernel uses against the
    explicit Newton offsets, on random neighbourhoods."""
    nb = list(torch.from_numpy(_rand_dog((27, 20000), seed=7)))
    cs, cx, cy, conv, sing = tex._walk_classify(*nb)
    off_s, off_x, off_y, *_, singular = tex._newton_step(*nb)

    def sign_code(off):
        return torch.where(off >= 0.6, 2, torch.where(off <= -0.6, 0, 1))

    agree = ((cs == sign_code(off_s)) & (cx == sign_code(off_x))
             & (cy == sign_code(off_y)))
    assert torch.equal(sing, singular)
    assert agree.float().mean() > 0.999
