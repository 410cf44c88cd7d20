"""Public instance API (the detect half of the reference's C ABI).

Port of ``vulkansift_tpu/instance.py``: a :class:`SiftInstance` owns
``config.sift_buffer_count`` feature buffers on one device.
``detect_features`` leaves its result and counts on the device and returns
without waiting; ``get_features_number`` and ``download_features`` block
until the data is there, like the reference's fence waits;
``is_buffer_available`` polls without blocking. Matching and the
scale-space debug APIs (which need ``config.retain_pyramid``) come with
later slices; until then no pyramid is kept per buffer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .config import SiftConfig, get_default_config
from .errors import DeviceError, InvalidInputError, Result
from .pipeline import make_detect_fn
from .types import (FEATURE_DTYPE, Features, features_from_numpy,
                    features_to_numpy)
from .utils.device import DeviceLike, resolve_device


@dataclasses.dataclass
class _BufferState:
    """Host-side bookkeeping of one device feature buffer. ``count`` is
    None while it is still only on the device."""

    features: Features
    count: Optional[int] = 0
    per_octave_counts: object = ()
    lost: object = None
    done: Optional[torch.cuda.Event] = None

    def sync_counts(self) -> None:
        if self.count is None:
            host = torch.stack([self.features.count, self.lost]).cpu()
            self.count = int(host[0])
            self.per_octave_counts = tuple(
                int(c) for c in self.per_octave_counts.cpu())
            self.lost = int(host[1])


class SiftInstance:
    """SIFT detection engine bound to one device (default ``"cuda"``; pass
    ``device="cpu"`` to run the plain versions on the CPU)."""

    def __init__(self, config: Optional[SiftConfig] = None,
                 on_error: Optional[Callable[[Result], None]] = None, *,
                 device: DeviceLike = "cuda"):
        config = config or get_default_config()
        self._on_error = on_error
        try:
            config.validate()
        except InvalidInputError:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise
        self.config = config
        try:
            self.device = resolve_device(device, config.device_index)
        except InvalidInputError:
            self._dispatch_error(Result.INVALID_INPUT_ERROR)
            raise
        except DeviceError:
            self._dispatch_error(Result.DEVICE_ERROR)
            raise
        self._detect_fns: Dict[Tuple[int, int], object] = {}
        self._buffers = [
            _BufferState(features=Features.empty(
                config.max_nb_sift_per_buffer, self.device))
            for _ in range(config.sift_buffer_count)]
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Parity: vksift_destroyInstance."""
        self._buffers = []
        self._detect_fns = {}
        self._closed = True

    def __enter__(self) -> "SiftInstance":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _dispatch_error(self, result: Result) -> None:
        if self._on_error is not None:
            self._on_error(result)

    def _invalid(self, msg: str) -> InvalidInputError:
        self._dispatch_error(Result.INVALID_INPUT_ERROR)
        return InvalidInputError(msg)

    def _check_buffer(self, buffer_id: int) -> _BufferState:
        if self._closed:
            raise self._invalid("instance is closed")
        if not 0 <= buffer_id < len(self._buffers):
            raise self._invalid(
                f"buffer index {buffer_id} out of range "
                f"({len(self._buffers)} buffers reserved)")
        return self._buffers[buffer_id]

    # -- detection ------------------------------------------------------
    def detect_features(self, image: np.ndarray, buffer_id: int) -> None:
        """Detect the features of an (H, W) uint8 grayscale image into a
        buffer (parity: vksift_detectFeatures). Returns without waiting
        for the device."""
        buf = self._check_buffer(buffer_id)
        image = np.asarray(image)
        if image.ndim != 2 or image.dtype != np.uint8:
            raise self._invalid("image must be 2-D uint8 grayscale")
        height, width = image.shape
        if width * height > self.config.input_image_max_size:
            raise self._invalid(
                f"image size {width}x{height} exceeds input_image_max_size "
                f"{self.config.input_image_max_size}")
        if min(width, height) < 32:
            raise self._invalid("image dimensions must be >= 32")
        key = (width, height)
        try:
            if key not in self._detect_fns:
                self._detect_fns[key] = make_detect_fn(
                    self.config, width, height, device=self.device)
            out = self._detect_fns[key](image)
        except (RuntimeError, OSError) as e:
            self._dispatch_error(Result.DEVICE_ERROR)
            raise DeviceError("detection pipeline failure") from e
        buf.features = out.features
        buf.count = None
        buf.per_octave_counts = out.per_octave_counts
        buf.lost = out.lost
        buf.done = None
        if self.device.type == "cuda":
            buf.done = torch.cuda.Event()
            buf.done.record(torch.cuda.current_stream(self.device))

    # -- data transfer (blocking) ---------------------------------------
    def get_features_number(self, buffer_id: int) -> int:
        """Parity: vksift_getFeaturesNumber; blocks until the detection into
        the buffer has finished."""
        buf = self._check_buffer(buffer_id)
        buf.sync_counts()
        return buf.count

    def get_lost_features_number(self, buffer_id: int) -> int:
        """Features the last detection dropped at the buffer capacity."""
        buf = self._check_buffer(buffer_id)
        buf.sync_counts()
        return int(buf.lost or 0)

    def get_per_octave_counts(self, buffer_id: int) -> Tuple[int, ...]:
        buf = self._check_buffer(buffer_id)
        buf.sync_counts()
        return tuple(buf.per_octave_counts)

    def download_features(self, buffer_id: int) -> np.ndarray:
        """Blocking download of the packed features as a ``FEATURE_DTYPE``
        structured array (parity: vksift_downloadFeatures)."""
        buf = self._check_buffer(buffer_id)
        buf.sync_counts()
        return features_to_numpy(buf.features, buf.count)

    def upload_features(self, feats: np.ndarray, buffer_id: int) -> None:
        """Parity: vksift_uploadFeatures."""
        buf = self._check_buffer(buffer_id)
        if getattr(feats, "dtype", None) != FEATURE_DTYPE:
            raise self._invalid(
                "features must be a FEATURE_DTYPE structured array")
        if feats.shape[0] > self.config.max_nb_sift_per_buffer:
            raise self._invalid("too many features for the buffer")
        buf.features = features_from_numpy(
            feats, self.config.max_nb_sift_per_buffer, self.device)
        buf.count = int(feats.shape[0])
        buf.lost = 0
        buf.done = None
        buf.per_octave_counts = ()

    def is_buffer_available(self, buffer_id: int) -> bool:
        """Non-blocking poll: True when no device work on the buffer is in
        flight (parity: vksift_isBufferAvailable)."""
        buf = self._check_buffer(buffer_id)
        return buf.done is None or buf.done.query()
