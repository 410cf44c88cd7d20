"""Kernel 1: separable gaussian blur with the fused DoG layer.

:func:`blur_dog` is the wrapper of ``csrc/blur_dog.cu`` (which replaces the
TPU kernel ``vulkansift_tpu/ops/pallas_blur.py::blur_dog_tpu``);
:func:`blur_dog_plain` is its plain PyTorch version, built on
:func:`blur_separable`, the port of ``scale_space.blur_separable``.

Semantics: symmetric (MIRRORED_REPEAT) borders, H pass then V pass, with
the tap order of the reference blur shader: ``acc = x*t0``, then
``acc = acc + (x[i-j] + x[i+j])*tj`` for j = 1..k.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_lib

# vks_blur_dog(x, y, dog, taps, ntaps, H, W, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def _symmetric_index(n: int, k: int, device) -> torch.Tensor:
    """Source indices of positions -k .. n+k-1 under symmetric padding
    (period-2n reflection, numpy's ``symmetric`` mode)."""
    i = torch.arange(-k, n + k, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _conv1d_symmetric(x: torch.Tensor, taps: Sequence[float],
                      dim: int) -> torch.Tensor:
    """``y[i] = t0*x[i] + sum_j tj*(x[i-j] + x[i+j])`` along ``dim`` with
    symmetric borders, in float32, in the shader's accumulation order."""
    k = len(taps) - 1
    x = x.to(torch.float32)
    t = [float(v) for v in np.asarray(taps, np.float32)]
    if k == 0:
        return x * t[0]
    n = x.shape[dim]
    xp = x.index_select(dim, _symmetric_index(n, k, x.device))

    def shifted(off: int) -> torch.Tensor:
        return xp.narrow(dim, k + off, n)

    acc = shifted(0) * t[0]
    for j in range(1, k + 1):
        acc = acc + (shifted(-j) + shifted(j)) * t[j]
    return acc


def blur_separable(img: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """Separable gaussian blur of (..., H, W) with a half-kernel: the
    horizontal pass, then the vertical one."""
    img = _conv1d_symmetric(img, taps, img.dim() - 1)
    return _conv1d_symmetric(img, taps, img.dim() - 2)


def blur_dog_plain(x: torch.Tensor, taps: Sequence[float],
                   with_dog: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the kernel: (blurred, blurred - x or None)."""
    y = blur_separable(x, taps)
    return y, ((y - x) if with_dog else None)


@cuda_lib.counted
def blur_dog(x: torch.Tensor, taps: Sequence[float], with_dog: bool = True,
             out: Optional[torch.Tensor] = None,
             dog_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Blur one (H, W) f32 layer and, when ``with_dog``, its DoG layer.

    ``out``/``dog_out`` are optional contiguous (H, W) f32 destinations
    (views into the pyramid stacks), which must not overlap ``x``. A CUDA
    tensor launches the kernel; a CPU tensor runs :func:`blur_dog_plain`.
    """
    if not cuda_lib.use_kernel(x):
        y, dog = blur_dog_plain(x, taps, with_dog)
        if out is not None:
            y = out.copy_(y)
        if dog is not None and dog_out is not None:
            dog = dog_out.copy_(dog)
        return y, dog
    cuda_lib.require(x, "x", torch.float32, 2)
    h, w = x.shape
    y = torch.empty_like(x) if out is None else out
    dog = None
    if with_dog:
        dog = torch.empty_like(x) if dog_out is None else dog_out
    for name, t in (("out", y), ("dog_out", dog)):
        if t is not None:
            cuda_lib.require(t, name, torch.float32, 2)
            if t.shape != x.shape or t.device != x.device:
                raise ValueError(f"{name}: expected {tuple(x.shape)} on {x.device}")
    t_np = np.ascontiguousarray(taps, np.float32)
    fn = cuda_lib.entry("blur_dog", "vks_blur_dog", _ARGTYPES)
    cuda_lib.launch(fn, x, "blur_dog", x.data_ptr(), y.data_ptr(),
                    0 if dog is None else dog.data_ptr(),
                    t_np.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    len(t_np), h, w)
    cuda_lib.count_launch(blur_dog)
    return y, dog
