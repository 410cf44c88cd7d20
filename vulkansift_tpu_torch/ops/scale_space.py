"""Gaussian scale-space pyramid construction.

Port of ``vulkansift_tpu/ops/scale_space.py`` (the reference's
GaussianBlur/DifferenceOfGaussian shaders and blit-based octave seeding):

* each octave is one ``(nb_scales+3, H, W)`` gaussian stack and one
  ``(nb_scales+2, H, W)`` DoG stack;
* the separable blur and the DoG subtraction are kernel 1
  (:func:`.blur.blur_dog`), writing straight into the stacks;
* the 2x upsample matches ``vkCmdBlitImage`` with VK_FILTER_LINEAR
  (half-pixel centres, clamp-to-edge), the 2x downsample VK_FILTER_NEAREST,
  which picks the odd source texels (a strided slice).

All gaussian stacks are views into ONE flat f32 buffer (``ScaleSpace.flat``)
so the back-half kernels address any keypoint's layer by an element offset.
FLOAT16 pyramid precision keeps the whole arithmetic chain in float32 and
rounds values to fp16 only where they are stored (the stacks hold the
fp16-rounded values, in float32 storage).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..config import PyramidPrecision, SiftConfig
from . import gaussian
from .blur import blur_dog, blur_separable  # noqa: F401  (re-exported)


def upsample2x_linear(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample matching vkCmdBlitImage(VK_FILTER_LINEAR):
    ``dst[2k] = 0.25*src[k-1] + 0.75*src[k]``,
    ``dst[2k+1] = 0.75*src[k] + 0.25*src[k+1]`` with clamp-to-edge, applied
    to rows then columns."""

    def up1d(x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim]
        idx = torch.arange(-1, n + 1, device=x.device).clamp(0, n - 1)
        xp = x.index_select(dim, idx)
        prev = xp.narrow(dim, 0, n)
        cur = xp.narrow(dim, 1, n)
        nxt = xp.narrow(dim, 2, n)
        even = 0.25 * prev + 0.75 * cur
        odd = 0.75 * cur + 0.25 * nxt
        shape = list(x.shape)
        shape[dim] = 2 * n
        return torch.stack([even, odd], dim=dim + 1).reshape(shape)

    img = up1d(img, img.dim() - 2)
    return up1d(img, img.dim() - 1)


def downsample2x_nearest(img: torch.Tensor, out_h: int,
                         out_w: int) -> torch.Tensor:
    """2x nearest downsample matching vkCmdBlitImage(VK_FILTER_NEAREST):
    destination texel x samples source texel 2x+1."""
    return img[..., 1::2, 1::2][..., :out_h, :out_w]


class ScaleSpace(NamedTuple):
    """Per-octave gaussian and DoG stacks; the gaussian stacks are views of
    ``flat`` starting at ``offsets[o]``."""

    gaussians: Tuple[torch.Tensor, ...]
    dogs: Tuple[torch.Tensor, ...]
    flat: torch.Tensor
    offsets: Tuple[int, ...]


def stack_offsets(octave_shapes: Sequence[Tuple[int, int]],
                  layers: int) -> Tuple[Tuple[int, ...], int]:
    """Element offsets of each octave's (layers, H, W) stack in one flat
    buffer, and the buffer's length."""
    offs = []
    total = 0
    for h, w in octave_shapes:
        offs.append(total)
        total += layers * h * w
    return tuple(offs), total


def build_pyramid(image: torch.Tensor, config: SiftConfig,
                  octave_shapes: Sequence[Tuple[int, int]]) -> ScaleSpace:
    """Construct the gaussian + DoG pyramids.

    Args:
      image: (H, W) float32 grayscale in [0, 1].
      config: SIFT configuration.
      octave_shapes: per-octave (height, width) sizes.
    """
    s = config.nb_scales_per_octave
    dev = image.device
    fp16 = config.pyramid_precision == PyramidPrecision.FLOAT16
    taps = [gaussian.half_kernel(sig) for sig in gaussian.kernel_sigmas(config)]

    g_offs, g_total = stack_offsets(octave_shapes, s + 3)
    _, d_total = stack_offsets(octave_shapes, s + 2)
    gflat = torch.empty(g_total, dtype=torch.float32, device=dev)
    dflat = torch.empty(d_total, dtype=torch.float32, device=dev)

    def store(dst: torch.Tensor, v: torch.Tensor) -> None:
        dst.copy_(v.to(torch.float16) if fp16 else v)

    gaussians: List[torch.Tensor] = []
    dogs: List[torch.Tensor] = []
    d_off = 0
    base_top = None
    for o, (h, w) in enumerate(octave_shapes):
        gs = gflat[g_offs[o]:g_offs[o] + (s + 3) * h * w].view(s + 3, h, w)
        ds = dflat[d_off:d_off + (s + 2) * h * w].view(s + 2, h, w)
        d_off += (s + 2) * h * w
        if o == 0:
            seed = upsample2x_linear(image) if config.use_input_upsampling \
                else image
            seed = seed.to(torch.float32).contiguous()
            if fp16:
                base, _ = blur_dog(seed, taps[0], with_dog=False)
                store(gs[0], base)
            else:
                base, _ = blur_dog(seed, taps[0], with_dog=False, out=gs[0])
        else:
            base = downsample2x_nearest(base_top, h, w)
            store(gs[0], base)
            base = base.contiguous() if fp16 else gs[0]
        prev = base
        for i in range(1, s + 3):
            if fp16:
                y, dg = blur_dog(prev, taps[i])
                store(gs[i], y)
                store(ds[i - 1], dg)
            else:
                y, _ = blur_dog(prev, taps[i], out=gs[i], dog_out=ds[i - 1])
            prev = y
            if i == s:
                base_top = y
        gaussians.append(gs)
        dogs.append(ds)
    return ScaleSpace(tuple(gaussians), tuple(dogs), gflat, g_offs)
