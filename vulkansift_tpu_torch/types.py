"""Feature and 2-NN match buffers as torch tensors.

The same structure-of-arrays layout as the JAX package's ``Features`` and
``Matches2NN``: a static capacity N and a device-resident valid count, the
replacement for the reference's atomic-append buffers.
:func:`features_to_numpy` and :func:`features_from_numpy` convert to and
from a NumPy structured array with exactly the ``vksift_Feature`` field
layout (``FEATURE_DTYPE``), and :func:`matches_to_numpy` to the
``vksift_Match_2NN`` layout (``MATCH_DTYPE``); both are byte-compatible with
the JAX package's, so a buffer downloaded from one package uploads into the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import DESC_SIZE
from .utils.device import DeviceLike, resolve_device

# NumPy structured dtype bit-compatible with vksift_Feature
# (reference: include/vulkansift/vulkansift_types.h:17-31).
FEATURE_DTYPE = np.dtype([
    ("x", np.float32),
    ("y", np.float32),
    ("scale_x", np.float32),
    ("scale_y", np.float32),
    ("scale_idx", np.uint32),
    ("octave_idx", np.int32),
    ("sigma", np.float32),
    ("orientation", np.float32),
    ("intensity", np.float32),
    ("descriptor", np.uint8, (DESC_SIZE,)),
])

# NumPy structured dtype bit-compatible with vksift_Match_2NN
# (reference: include/vulkansift/vulkansift_types.h:33-41).
MATCH_DTYPE = np.dtype([
    ("idx_a", np.uint32),
    ("idx_b1", np.uint32),
    ("idx_b2", np.uint32),
    ("dist_a_b1", np.float32),
    ("dist_a_b2", np.float32),
])

_FIELDS = ("x", "y", "scale_x", "scale_y", "scale_idx", "octave_idx",
           "sigma", "orientation", "intensity", "descriptor")


@dataclasses.dataclass
class Features:
    """A fixed-capacity feature set; entries [0, count) are valid."""

    x: torch.Tensor            # f32[N] position in the input image
    y: torch.Tensor            # f32[N]
    scale_x: torch.Tensor      # f32[N] position in the pyramid octave image
    scale_y: torch.Tensor      # f32[N]
    scale_idx: torch.Tensor    # i32[N] gaussian scale image index
    octave_idx: torch.Tensor   # i32[N] octave (-1 = upscaled octave)
    sigma: torch.Tensor        # f32[N] blur level
    orientation: torch.Tensor  # f32[N] radians
    intensity: torch.Tensor    # f32[N] refined DoG value at the keypoint
    descriptor: torch.Tensor   # u8[N, 128]
    count: torch.Tensor        # i32[] number of valid entries

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @staticmethod
    def empty(capacity: int, device: torch.device) -> "Features":
        def z(dtype, *shape):
            return torch.zeros((capacity,) + shape, dtype=dtype, device=device)
        f32, i32 = torch.float32, torch.int32
        return Features(
            x=z(f32), y=z(f32), scale_x=z(f32), scale_y=z(f32),
            scale_idx=z(i32), octave_idx=z(i32),
            sigma=z(f32), orientation=z(f32), intensity=z(f32),
            descriptor=z(torch.uint8, DESC_SIZE),
            count=torch.zeros((), dtype=i32, device=device))


@dataclasses.dataclass
class Matches2NN:
    """2-nearest-neighbour match set; entries [0, count) are valid.
    Distances are L2 in u8 descriptor space, +inf where a row has no such
    neighbour (the reference's Get2NearestNeighbors output)."""

    idx_a: torch.Tensor      # i32[N]
    idx_b1: torch.Tensor     # i32[N] nearest neighbour in set B
    idx_b2: torch.Tensor     # i32[N] second nearest neighbour in set B
    dist_a_b1: torch.Tensor  # f32[N]
    dist_a_b2: torch.Tensor  # f32[N]
    count: torch.Tensor      # i32[]

    @property
    def capacity(self) -> int:
        return self.idx_a.shape[-1]


def features_to_numpy(feats: Features,
                      count: Optional[int] = None) -> np.ndarray:
    """Pack the valid features into a ``FEATURE_DTYPE`` structured array.
    Blocking: reads the count (when not given) and copies the valid prefix
    to the host."""
    n = int(feats.count) if count is None else int(count)
    out = np.zeros((n,), FEATURE_DTYPE)
    for name in _FIELDS:
        out[name] = getattr(feats, name)[:n].cpu().numpy()
    return out


def features_from_numpy(arr: np.ndarray, capacity: int,
                        device: DeviceLike = "cuda") -> Features:
    """Load a ``FEATURE_DTYPE`` structured array into a fixed-capacity set
    on ``device`` (parity: vksift_uploadFeatures). Like every entry point
    it defaults to the card and raises :class:`DeviceError` without one;
    ``device="cpu"`` places the set on the CPU."""
    if arr.dtype != FEATURE_DTYPE:
        raise ValueError("expected FEATURE_DTYPE structured array")
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} features exceed capacity {capacity}")
    device = resolve_device(device)

    def pad(v: np.ndarray, dtype) -> torch.Tensor:
        out = np.zeros((capacity,) + v.shape[1:], dtype)
        out[:n] = v
        return torch.from_numpy(out).to(device)

    return Features(
        x=pad(arr["x"], np.float32), y=pad(arr["y"], np.float32),
        scale_x=pad(arr["scale_x"], np.float32),
        scale_y=pad(arr["scale_y"], np.float32),
        scale_idx=pad(arr["scale_idx"].astype(np.int32), np.int32),
        octave_idx=pad(arr["octave_idx"], np.int32),
        sigma=pad(arr["sigma"], np.float32),
        orientation=pad(arr["orientation"], np.float32),
        intensity=pad(arr["intensity"], np.float32),
        descriptor=pad(arr["descriptor"], np.uint8),
        count=torch.tensor(n, dtype=torch.int32, device=device))


def matches_to_numpy(m: Matches2NN, count: Optional[int] = None) -> np.ndarray:
    """Pack the valid matches into a ``MATCH_DTYPE`` structured array.
    Blocking: reads the count (when not given) and copies only the valid
    prefix to the host."""
    n = int(m.count) if count is None else int(count)
    out = np.zeros((n,), MATCH_DTYPE)
    for name in ("idx_a", "idx_b1", "idx_b2"):
        out[name] = getattr(m, name)[:n].cpu().numpy().astype(np.uint32)
    for name in ("dist_a_b1", "dist_a_b2"):
        out[name] = getattr(m, name)[:n].cpu().numpy()
    return out
