"""Kernel 2: the dense keypoint frontend.

:func:`frontend` is the wrapper of ``csrc/frontend.cu`` (which replaces the
TPU kernel ``vulkansift_tpu/ops/pallas_frontend.py::frontend_tpu``); its
plain version is :func:`.extract.dense_frontend`. :func:`frontend_candidates`
adds the raster-order compaction into :class:`.extract.Candidates`, which
stays PyTorch glue (a row-count cumsum and one scatter), as the JAX package
also leaves it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import cuda_lib
from .extract import Candidates, compact_candidates, dense_frontend

# vks_frontend(dog, code, counts, ns, H, W, thr08, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
             + (ctypes.c_float, ctypes.c_void_p))


@cuda_lib.counted
def frontend(dog: torch.Tensor, dog_threshold: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(code u8 (S, H-2, W-2), row counts i32 (S, H-2)) of one octave's
    contiguous (S+2, H, W) f32 DoG stack, any S >= 1; see :mod:`.extract`
    for the layout. A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`.extract.dense_frontend`."""
    if not cuda_lib.use_kernel(dog):
        return dense_frontend(dog, dog_threshold)
    cuda_lib.require(dog, "dog", torch.float32, 3)
    ns, h, w = dog.shape
    code = torch.empty((ns - 2, h - 2, w - 2), dtype=torch.uint8,
                       device=dog.device)
    counts = torch.zeros((ns - 2, h - 2), dtype=torch.int32,
                         device=dog.device)
    thr08 = float(np.float32(dog_threshold * 0.8))
    fn = cuda_lib.entry("frontend", "vks_frontend", _ARGTYPES)
    cuda_lib.launch(fn, dog, "frontend", dog.data_ptr(), code.data_ptr(),
                    counts.data_ptr(), ns, h, w, thr08)
    cuda_lib.count_launch(frontend)
    return code, counts


def frontend_candidates(dog: torch.Tensor, dog_threshold: float,
                        capacity: int) -> Tuple[Candidates, torch.Tensor]:
    """Candidates of one octave at ``capacity`` (raster order, with each
    candidate's own walk code) and the code field for the refinement."""
    code, counts = frontend(dog, dog_threshold)
    return compact_candidates(code, counts, capacity), code
