"""The PyTorch port's scale space (vulkansift_tpu_torch.ops.scale_space and
the plain version of the blur kernel) against the JAX package's XLA path
on the CPU, from the same seeded numpy inputs.

Tolerances: the blur and the pyramid to atol=1e-6 (the JAX package's own
bar for its blur kernel, tests/test_pallas_blur.py); the resampling
operations exactly (each output is one fixed expression of the inputs).
"""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_image
from vulkansift_tpu.config import PyramidPrecision, SiftConfig
from vulkansift_tpu.ops import gaussian as jgauss
from vulkansift_tpu.ops import scale_space as jss
from vulkansift_tpu_torch.config import from_reference_dict
from vulkansift_tpu_torch.errors import DeviceError
from vulkansift_tpu_torch.ops import blur, cuda_lib
from vulkansift_tpu_torch.ops import gaussian as tgauss
from vulkansift_tpu_torch.ops import scale_space as tss
from torch_threads import one_torch_thread  # noqa: F401


def _cfgs(**kw):
    cfg = SiftConfig(**kw)
    return cfg, from_reference_dict(dataclasses.asdict(cfg))


def test_gaussian_taps_match():
    cfg, tcfg = _cfgs()
    assert tgauss.kernel_sigmas(tcfg) == jgauss.kernel_sigmas(cfg)
    for sig in jgauss.kernel_sigmas(cfg):
        np.testing.assert_array_equal(tgauss.half_kernel(sig),
                                      jgauss.half_kernel(sig))


@pytest.mark.parametrize("shape,sigma", [((40, 56), 1.25), ((33, 70), 2.6),
                                         ((24, 31), 3.3)])
def test_blur_separable_matches_jax(shape, sigma):
    rng = np.random.default_rng(1)
    x = rng.random(shape).astype(np.float32)
    taps = jgauss.half_kernel(sigma)
    ref = np.asarray(jax.jit(lambda v: jss.blur_separable(v, taps))(
        jnp.asarray(x)))
    y, dog = blur.blur_dog(torch.from_numpy(x), taps)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dog.numpy(), ref - x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,sigma", [((960, 1280), 3.2), ((41, 75), 3.2),
                                         ((41, 75), 5.0), ((7, 5), 3.2),
                                         ((5, 7), 3.2), ((5, 7), 5.0)])
def test_blur_ragged_and_small_layers_match_jax(shape, sigma):
    """The ragged and smaller-than-the-half-kernel layers (n < k) on which
    chip_smoke holds the kernel's border path against this plain version."""
    rng = np.random.default_rng(3)
    x = rng.random(shape).astype(np.float32)
    taps = jgauss.half_kernel(sigma)  # 14 taps at 3.2, 20 at 5.0
    ref = np.asarray(jax.jit(lambda v: jss.blur_separable(v, taps))(
        jnp.asarray(x)))
    y, dog = blur.blur_dog_plain(torch.from_numpy(x), taps)
    np.testing.assert_allclose(y.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dog.numpy(), ref - x, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,k", [(10, 3), (5, 13), (3, 7)])
def test_symmetric_index_matches_numpy_pad(n, k):
    a = np.arange(n)
    ref = np.pad(a, (k, k), mode="symmetric")
    np.testing.assert_array_equal(blur._symmetric_index(n, k, "cpu").numpy(),
                                  ref)


def test_resampling_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.random((21, 34)).astype(np.float32)
    up_ref = np.asarray(jss.upsample2x_linear(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tss.upsample2x_linear(torch.from_numpy(x)).numpy(), up_ref)
    dn_ref = np.asarray(jss.downsample2x_nearest(jnp.asarray(x), 10, 17))
    np.testing.assert_array_equal(
        tss.downsample2x_nearest(torch.from_numpy(x), 10, 17).numpy(), dn_ref)


@pytest.mark.parametrize("up,precision", [
    (False, PyramidPrecision.FLOAT32), (True, PyramidPrecision.FLOAT32),
    (True, PyramidPrecision.FLOAT16)])
def test_build_pyramid_matches_jax(up, precision):
    img = make_blob_image(96, 128, seed=5, nb_blobs=14)
    cfg, tcfg = _cfgs(use_input_upsampling=up, pyramid_precision=precision)
    shapes = tuple((h, w) for w, h in cfg.octave_resolutions(128, 96))
    x = jnp.asarray(img).astype(jnp.float32) * (1.0 / 255.0)
    jg, jd = jss.build_pyramid_jit(x, cfg, shapes)
    ss = tss.build_pyramid(
        torch.from_numpy(img).to(torch.float32) * (1.0 / 255.0), tcfg, shapes)
    assert len(ss.gaussians) == len(jg) == len(shapes)
    # FLOAT16 stores round values that agree to 1e-6 in float32, so a stored
    # value may land one fp16 step (2^-10 relative at worst) apart.
    rtol = 2.0 ** -10 if precision == PyramidPrecision.FLOAT16 else 0.0
    for o in range(len(shapes)):
        np.testing.assert_allclose(
            ss.gaussians[o].numpy(), np.asarray(jg[o], np.float32),
            rtol=rtol, atol=1e-6)
        np.testing.assert_allclose(
            ss.dogs[o].numpy(), np.asarray(jd[o], np.float32),
            rtol=rtol, atol=1e-6)
        # The stacks are views of the flat buffer the back half reads.
        n = ss.gaussians[o].numel()
        np.testing.assert_array_equal(
            ss.flat[ss.offsets[o]:ss.offsets[o] + n].numpy(),
            ss.gaussians[o].reshape(-1).numpy())


def test_cpu_tensor_takes_plain_version():
    x = torch.rand(20, 30)
    before = blur.blur_dog.launches
    y, dog = blur.blur_dog(x, tgauss.half_kernel(1.6))
    y_p, dog_p = blur.blur_dog_plain(x, tgauss.half_kernel(1.6))
    assert torch.equal(y, y_p) and torch.equal(dog, dog_p)
    assert blur.blur_dog.launches == before


def test_dispatch_rule():
    class Fake:
        def __init__(self, dev):
            self.device = torch.device(dev)

    assert cuda_lib.use_kernel(Fake("cuda")) is True
    assert cuda_lib.use_kernel(Fake("cpu")) is False
    other = []
    with cuda_lib.force_plain():
        assert cuda_lib.use_kernel(Fake("cuda")) is False
        # The switch holds for its own thread only.
        t = threading.Thread(
            target=lambda: other.append(cuda_lib.use_kernel(Fake("cuda"))))
        t.start()
        t.join()
    assert other == [True]
    assert cuda_lib.use_kernel(Fake("cuda")) is True
    with pytest.raises(DeviceError):
        cuda_lib.use_kernel(Fake("meta"))
