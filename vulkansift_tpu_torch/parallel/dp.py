"""Data-parallel batched detection over a device mesh.

Port of ``vulkansift_tpu/parallel/dp.py``: the batch of images is split
over the mesh's data axis, every rank runs the single-image detect
(:func:`..pipeline.make_detect_fn`) over its own sub-batch, and the
outputs stay on the rank that made them, ready for the sharded matcher
(:mod:`.ring_match`) or a gathered download. No collective runs in the
forward pass.

The JAX package compiles one program a resolution that maps the detect
over the sub-batch. On a card each frame here replays one recorded
:class:`..compiled.DetectProgram` (the detect of one frame: the JAX
``lax.map`` runs one frame at a time too, and one frame's working set is
all the program holds); on the CPU the same function runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..compiled import DetectProgram
from ..config import SiftConfig
from ..pipeline import (DetectOutput, _empty_output, make_detect_fn,
                        octave_plan)
from ..types import Features
from ..utils.device import DeviceLike, resolve_device
from .mesh import DATA_AXIS, mesh_device, mesh_rank

_FIELDS = tuple(f.name for f in dataclasses.fields(Features))


def _batch_output(capacity: int, nb_oct: int, b: int,
                  device: torch.device) -> DetectOutput:
    """Uninitialised outputs of ``b`` frames (each frame's row is written
    whole)."""
    one = _empty_output(capacity, nb_oct, torch.device("meta"))

    def e(t: torch.Tensor) -> torch.Tensor:
        return torch.empty((b, *t.shape), dtype=t.dtype, device=device)

    return DetectOutput(
        Features(**{f: e(getattr(one.features, f)) for f in _FIELDS}),
        e(one.lost), e(one.per_octave_counts))


def _frame(out: DetectOutput, i: int) -> DetectOutput:
    return DetectOutput(
        Features(**{f: getattr(out.features, f)[i] for f in _FIELDS}),
        out.lost[i], out.per_octave_counts[i])


def _tensors(out: DetectOutput) -> list:
    return ([getattr(out.features, f) for f in _FIELDS]
            + [out.lost, out.per_octave_counts])


class DpDetect:
    """This rank's data-parallel detect (see :func:`make_dp_detect_fn`)."""

    def __init__(self, config: SiftConfig, width: int, height: int,
                 device: torch.device):
        self.config, self.width, self.height = config, width, height
        self.device = device
        self._nb_oct = len(octave_plan(config, width, height))
        self._detect = None if device.type == "cuda" else make_detect_fn(
            config, width, height, device=device)
        # Recorded at the first call on a card.
        self.program: Optional[DetectProgram] = None

    def __call__(self, images) -> DetectOutput:
        if self._detect is None and self.program is None:
            self.program = DetectProgram(self.config, self.width, self.height,
                                         device=self.device)
        out = _batch_output(self.config.max_nb_sift_per_buffer, self._nb_oct,
                            len(images), self.device)
        for i, img in enumerate(images):
            if self.program is not None:
                self.program(img, out=_frame(out, i))
                continue
            for dst, src in zip(_tensors(_frame(out, i)),
                                _tensors(self._detect(img))):
                dst.copy_(src)
        return out

    def close(self) -> None:
        """Free the recorded program (a later call records it anew)."""
        if self.program is not None:
            self.program.close()
            self.program = None


def make_dp_detect_fn(config: SiftConfig, width: int, height: int,
                      mesh: DeviceMesh, axis_name: str = DATA_AXIS, *,
                      device: DeviceLike = "cuda") -> DpDetect:
    """The data-parallel detect of this rank over ``mesh``.

    Returns ``fn(local_images u8[b, H, W]) -> DetectOutput`` with a leading
    batch dimension on every tensor, run on this rank's device; feed it
    :func:`shard_batch` of the global batch. ``device`` (default
    ``"cuda"``, raising without a card) must be of the mesh's type.

    On a card the first call records a :class:`..compiled.DetectProgram`
    (with a graph pool of its own) and every frame replays it, its outputs
    copied straight into the batch; ``fn.close()`` frees the program."""
    dev = mesh_device(mesh, resolve_device(device, config.device_index))
    mesh_rank(mesh, axis_name)
    return DpDetect(config, width, height, dev)


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
