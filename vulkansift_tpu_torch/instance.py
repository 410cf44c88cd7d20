"""Public instance API: the reference's C ABI (vulkansift.h:23-111) as a
Python class plus module-level helpers.

Port of ``vulkansift_tpu/instance.py``. A :class:`SiftInstance` owns
``config.sift_buffer_count`` feature buffers on one device.
``detect_features`` and ``match_features`` leave their results and counts
on the device and return without waiting; ``get_features_number``,
``get_matches_number`` and the downloads block until the data is there,
like the reference's fence waits; ``is_buffer_available`` polls without
blocking. With ``config.retain_pyramid`` each buffer keeps the gaussian and
DoG stacks of its last detect for the scale-space debug APIs.
``load_runtime``, ``unload_runtime`` and ``get_available_devices`` probe
``torch.cuda``. ``start_trace`` / ``stop_trace``, the JAX package's XProf
hooks, run ``torch.profiler`` and write a Chrome trace.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import SiftConfig, get_default_config
from .errors import DeviceError, InvalidInputError, Result
from .ops.match import match_2nn_fused
from .pipeline import make_detect_fn, octave_plan
from .types import (FEATURE_DTYPE, Features, Matches2NN, features_from_numpy,
                    features_to_numpy, matches_to_numpy)
from .utils.device import DeviceLike, resolve_device
from .utils.logging import logger


def load_runtime() -> Result:
    """Probe the CUDA runtime (parity: vksift_loadVulkan). Returns
    ``Result.SUCCESS`` when a card is usable and ``Result.DEVICE_ERROR``,
    without raising, when none is, so that a caller can turn to CPU SIFT."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return Result.SUCCESS
    logger.error("load_runtime() failure: no usable CUDA device")
    return Result.DEVICE_ERROR


def unload_runtime() -> None:
    """Parity: vksift_unloadVulkan; a no-op, PyTorch owns the CUDA
    context."""


def get_available_devices() -> List[str]:
    """Parity: vksift_getAvailableGPUs: ``"cuda:<name>"`` per card."""
    if not torch.cuda.is_available():
        return []
    return [f"cuda:{torch.cuda.get_device_name(i)}"
            for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class _BufferState:
    """Host-side bookkeeping of one device feature buffer. ``count`` is
    None while it is still only on the device."""

    features: Features
    count: Optional[int] = 0
    per_octave_counts: object = ()
    lost: object = None
    done: Optional[torch.cuda.Event] = None
    # The octave plan and pyramid of the last detect, for the debug APIs.
    octave_resolutions: Tuple[Tuple[int, int], ...] = ()
    gaussians: Optional[tuple] = None
    dogs: Optional[tuple] = None

    def sync_counts(self) -> None:
        if self.count is None:
            host = torch.stack([self.features.count, self.lost]).cpu()
            self.count = int(host[0])
            self.per_octave_counts = tuple(
                int(c) for c in self.per_octave_counts.cpu())
            self.lost = int(host[1])
            if self.lost > 0:
                logger.warning(
                    "Buffer too small to store all detected features "
                    "(%d features lost)", self.lost)


class SiftInstance:
    """SIFT detection and matching engine bound to one device (default
    ``"cuda"``; pass ``device="cpu"`` to run the plain versions on the
    CPU)."""

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
        self._matches: Optional[Matches2NN] = None
        self._matches_count: Optional[int] = 0
        self._trace: Optional[Tuple[torch.profiler.profile, str]] = None
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Parity: vksift_destroyInstance."""
        self._buffers = []
        self._detect_fns = {}
        self._matches = None
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
                    self.config, width, height,
                    return_pyramid=self.config.retain_pyramid,
                    device=self.device)
            out = self._detect_fns[key](image)
        except InvalidInputError:
            raise
        except Exception as e:  # noqa: BLE001
            self._dispatch_error(Result.DEVICE_ERROR)
            raise DeviceError("detection pipeline failure") from e
        gauss = dogs = None
        if self.config.retain_pyramid:
            out, gauss, dogs = out
        buf.features = out.features
        buf.count = None
        buf.per_octave_counts = out.per_octave_counts
        buf.lost = out.lost
        buf.octave_resolutions = octave_plan(self.config, width, height)
        buf.gaussians, buf.dogs = gauss, dogs
        buf.done = None
        if self.device.type == "cuda":
            buf.done = torch.cuda.Event()
            buf.done.record(torch.cuda.current_stream(self.device))

    # -- matching -------------------------------------------------------
    def match_features(self, buffer_id_a: int, buffer_id_b: int) -> None:
        """2-NN match buffer A's features against buffer B's (parity:
        vksift_matchFeatures). Returns without waiting: the live counts
        stay on the device and the matcher reads them there."""
        buf_a = self._check_buffer(buffer_id_a)
        buf_b = self._check_buffer(buffer_id_b)
        try:
            self._matches = match_2nn_fused(
                buf_a.features.descriptor, buf_a.features.count,
                buf_b.features.descriptor, buf_b.features.count)
        except InvalidInputError:
            raise
        except Exception as e:  # noqa: BLE001
            self._dispatch_error(Result.DEVICE_ERROR)
            raise DeviceError("matching pipeline failure") from e
        self._matches_count = None

    def _sync_matches_count(self) -> int:
        # Matches2NN.count is a copy of A's count taken at dispatch, so a
        # later detect or upload into A cannot change it.
        if self._matches_count is None:
            self._matches_count = int(self._matches.count)
        return self._matches_count

    def get_matches_number(self) -> int:
        """Parity: vksift_getMatchesNumber; blocks until the match count is
        on the host (first call only)."""
        if self._closed:
            raise self._invalid("instance is closed")
        return self._sync_matches_count()

    def download_matches(self) -> np.ndarray:
        """Blocking download of the matches as a ``MATCH_DTYPE`` structured
        array (parity: vksift_downloadMatches)."""
        if self._closed:
            raise self._invalid("instance is closed")
        if self._matches is None:
            raise self._invalid("no matches computed yet")
        return matches_to_numpy(self._matches, self._sync_matches_count())

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
        # Uploaded features carry no scale-space: the debug APIs must not
        # answer for an earlier detect into this buffer.
        buf.per_octave_counts = ()
        buf.octave_resolutions = ()
        buf.gaussians = buf.dogs = None

    def is_buffer_available(self, buffer_id: int) -> bool:
        """Non-blocking poll: True when no device work on the buffer is in
        flight (parity: vksift_isBufferAvailable)."""
        buf = self._check_buffer(buffer_id)
        return buf.done is None or buf.done.query()

    # -- scale-space access (debug) ---------------------------------------
    def get_scale_space_nb_octaves(self, buffer_id: int = 0) -> int:
        """Parity: vksift_getScaleSpaceNbOctaves (0 after an upload)."""
        return len(self._check_buffer(buffer_id).octave_resolutions)

    def get_scale_space_octave_resolution(
            self, octave: int, buffer_id: int = 0) -> Tuple[int, int]:
        """Parity: vksift_getScaleSpaceOctaveResolution: (width, height)."""
        res = self._check_buffer(buffer_id).octave_resolutions
        if not 0 <= octave < len(res):
            raise self._invalid(f"octave {octave} out of range")
        return res[octave]

    def _pyramid_level(self, stacks: Optional[tuple], octave: int,
                       scale: int) -> np.ndarray:
        if stacks is None:
            raise self._invalid(
                "no pyramid retained (set config.retain_pyramid)")
        if not 0 <= octave < len(stacks):
            raise self._invalid(f"octave {octave} out of range")
        if not 0 <= scale < stacks[octave].shape[0]:
            raise self._invalid(f"scale {scale} out of range")
        return stacks[octave][scale].float().cpu().numpy()

    def download_scale_space_image(self, octave: int, scale: int,
                                   buffer_id: int = 0) -> np.ndarray:
        """Blocking download of a gaussian pyramid level as float32 (parity:
        vksift_downloadScaleSpaceImage; FP16 pyramids are converted)."""
        buf = self._check_buffer(buffer_id)
        return self._pyramid_level(buf.gaussians, octave, scale)

    def download_dog_image(self, octave: int, scale: int,
                           buffer_id: int = 0) -> np.ndarray:
        """Parity: vksift_downloadDoGImage."""
        buf = self._check_buffer(buffer_id)
        return self._pyramid_level(buf.dogs, octave, scale)

    # -- profiling hooks (the DebugPresenter analogue) --------------------
    def start_trace(self, log_dir: str) -> None:
        """Start a ``torch.profiler`` trace of CPU and, on a CUDA instance,
        CUDA activity (parity: ``start_trace``, the JAX package's XProf
        trace in place of the reference's DebugPresenter frame
        delimiters, vkenv/debug_presenter.c:139-185). :meth:`stop_trace`
        writes it into ``log_dir``. Raises if a trace is running."""
        if self._trace is not None:
            raise RuntimeError("a trace is already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._trace = (prof, log_dir)

    def stop_trace(self) -> str:
        """Stop the trace and write it into the ``log_dir`` given to
        :meth:`start_trace` as a Chrome trace (JSON); returns its path.
        Raises without a trace running, as ``jax.profiler.stop_trace``
        does."""
        if self._trace is None:
            raise RuntimeError("No profile started")
        prof, log_dir = self._trace
        self._trace = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        return path
