"""Data-parallel batched detection over a device mesh.

Port of ``vulkansift_tpu/parallel/dp.py``: the batch of images is split
over the mesh's data axis, every rank runs the batched detect
(:func:`..pipeline.make_detect_batched`, a loop over the single-image
path) on its own sub-batch, and the outputs stay on the rank that made
them, ready for the sharded matcher (:mod:`.ring_match`) or a gathered
download. No collective runs in the forward pass.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import SiftConfig
from ..pipeline import make_detect_batched
from ..utils.device import DeviceLike, resolve_device
from .mesh import DATA_AXIS, mesh_device, mesh_rank


def make_dp_detect_fn(config: SiftConfig, width: int, height: int,
                      mesh: DeviceMesh, axis_name: str = DATA_AXIS, *,
                      device: DeviceLike = "cuda"):
    """The data-parallel detect of this rank over ``mesh``.

    Returns ``fn(local_images u8[b, H, W]) -> DetectOutput`` with a leading
    batch dimension on every tensor, run on this rank's device; feed it
    :func:`shard_batch` of the global batch. ``device`` (default
    ``"cuda"``, raising without a card) must be of the mesh's type."""
    dev = resolve_device(device, config.device_index)
    mesh_rank(mesh, axis_name)
    return make_detect_batched(config, width, height,
                               device=mesh_device(mesh, dev))


def shard_batch(images, mesh: DeviceMesh, axis_name: str = DATA_AXIS, *,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """This rank's contiguous slice of a (B, H, W) batch along the data
    axis, on its device. B must divide by the mesh size."""
    dev = mesh_device(mesh, device)
    n = mesh.size()
    b = len(images)
    if b % n:
        raise ValueError(f"batch {b} is not divisible by the mesh size {n}")
    per = b // n
    r = mesh_rank(mesh, axis_name)
    part = images[r * per:(r + 1) * per]
    if not isinstance(part, torch.Tensor):
        part = torch.as_tensor(part)
    return part.to(dev)
