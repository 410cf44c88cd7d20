"""SIFT configuration.

A frozen dataclass mirroring the reference's ``vksift_Config`` field-for-field
(reference: include/vulkansift/vulkansift_types.h:97-162), with identical
defaults (reference: src/vulkansift/vulkansift.c:47-64) and the same central
validation conditions (reference: src/vulkansift/vulkansift.c:550-584).

This is the PyTorch port's own copy of ``vulkansift_tpu.config``: the same
fields, defaults and validation, so a configuration carries across the two
packages as a plain dict (:func:`from_reference_dict`).

Port notes:

* ``pyramid_precision`` FLOAT16 stores pyramids as IEEE fp16 values, exactly
  like the reference; the arithmetic chain stays in float32.
* ``use_hardware_interpolated_blur`` is accepted for compatibility but is a
  no-op: the separable blur kernel reads taps, not a linear sampler.
* ``device_index`` selects among the CUDA devices (``cuda:<index>``).
* ``resolution_bucket`` and ``detect_cache_size`` are accepted and validated
  but the port always runs at the exact resolution: they exist to bound XLA
  compiles, and PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

from .errors import InvalidConfigError


class DescriptorFormat(enum.Enum):
    """Descriptor orientation-bin convention.

    UBC (Lowe's binary / OpenCV / SiftGPU) and VLFeat (VLFeat / PopSift)
    differ by the direction in which the 8 orientation bins are traversed
    (reference: shaders/ComputeDescriptors.comp:167-172).
    """

    UBC = 0
    VLFEAT = 1


class PyramidPrecision(enum.Enum):
    FLOAT32 = 0
    FLOAT16 = 1  # IEEE fp16 storage (reference parity)


# Geometry constants fixed by the SIFT formulation (reference:
# shaders/ComputeDescriptors.comp:3-7, shaders/ComputeOrientation.comp:3-8).
NB_HIST = 4  # 4x4 spatial histogram grid
NB_ORI = 8  # 8 orientation bins per spatial cell
DESC_SIZE = NB_HIST * NB_HIST * NB_ORI  # 128
NB_ORI_HIST_BINS = 36  # orientation assignment histogram bins
LAMBDA_ORIENTATION = 1.5
LAMBDA_DESCRIPTOR = 3.0
L2_NORM_THRESHOLD = 0.2
ORI_PEAK_RATIO = 0.8  # LOCAL_EXTREMA_THRESHOLD in the reference
MAX_GAUSSIAN_KERNEL_SIZE = 20  # reference: src/vulkansift/sift_detector.h:9
NB_REFINEMENT_STEPS = 5  # reference: shaders/ExtractKeypoints.comp:5


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """Full configuration (parity: vksift_Config)."""

    # --- Input/Output configuration ---
    # Maximum size in pixels (w*h) for input grayscale images.
    input_image_max_size: int = 1920 * 1080
    # Number of independent on-device SIFT result buffers.
    sift_buffer_count: int = 2
    # Max number of SIFT features stored per buffer (static capacity).
    max_nb_sift_per_buffer: int = 100_000

    # --- SIFT algorithm configuration ---
    # Detect on a 2x-upscaled input (more features, slower).
    use_input_upsampling: bool = True
    # Number of octaves; 0 = derived from input resolution
    # (log2(min_dim) - 4, +1 when upsampling; reference: sift_memory.c:15-27).
    nb_octaves: int = 0
    # Scales per octave (Lowe: 3).
    nb_scales_per_octave: int = 3
    # Assumed blur level of the input image.
    input_image_blur_level: float = 0.5
    # Blur level of the scale-space seed scale (Lowe: 1.6).
    seed_scale_sigma: float = 1.6
    # DoG intensity threshold in [0,1] normalized intensity; divided by
    # nb_scales_per_octave at use (reference: sift_detector.c:1136).
    intensity_threshold: float = 0.04
    # Edge-response rejection threshold (Lowe: 10).
    edge_threshold: float = 10.0
    # Max orientations (=descriptors) per keypoint position; 0 = no limit
    # (we cap at an internal static bound, see orientation_capacity).
    max_nb_orientation_per_keypoint: int = 4
    # UBC (OpenCV/SiftGPU-compatible) or VLFeat descriptor layout.
    descriptor_format: DescriptorFormat = DescriptorFormat.UBC

    # --- Device and implementation configuration ---
    # Index among the CUDA devices; <0 = auto-select (the current device).
    device_index: int = -1
    # Accepted for reference compatibility; a no-op (see module docs).
    use_hardware_interpolated_blur: bool = True
    # FLOAT32 or FLOAT16 (IEEE fp16 storage) scale-space pyramid precision.
    pyramid_precision: PyramidPrecision = PyramidPrecision.FLOAT32

    # --- Knobs of the JAX package (no reference equivalent) ---
    # Keep the gaussian/DoG pyramids resident per buffer for the debug
    # APIs of a later slice.
    retain_pyramid: bool = True
    # Accepted and validated for compatibility; the port runs at the exact
    # resolution (these bound XLA compiles in the JAX package).
    resolution_bucket: int = 0
    detect_cache_size: int = 8

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Validate, raising InvalidConfigError with the failing condition.

        Parity with isConfigurationValid (vulkansift.c:550-584) including the
        cross-field seed-kernel constraint.
        """

        def check(cond: bool, msg: str) -> None:
            if not cond:
                raise InvalidConfigError(f"Invalid configuration: {msg}")

        check(self.input_image_max_size >= 1024,
              "input image size must be greater than or equal to 1024")
        check(self.sift_buffer_count > 0,
              "number of SIFT buffers must be greater than zero")
        check(self.max_nb_sift_per_buffer > 0,
              "number of SIFT features per buffer must be greater than zero")
        check(self.nb_scales_per_octave > 0,
              "number of scales per octave must be greater than zero")
        check(self.input_image_blur_level >= 0.0,
              "input image blur level cannot be negative")
        check(self.seed_scale_sigma >= 0.0,
              "seed scale blur level cannot be negative")
        upscale = 2.0 if self.use_input_upsampling else 1.0
        check(upscale * self.input_image_blur_level <= self.seed_scale_sigma,
              "the input image blur level (2x if upscaling activated) must be"
              " less than the seed scale blur level")
        check(self.intensity_threshold >= 0.0,
              "the DoG intensity threshold cannot be negative")
        check(self.edge_threshold >= 0.0,
              "the DoG edge threshold cannot be negative")
        check(isinstance(self.pyramid_precision, PyramidPrecision),
              "invalid scale-space pyramid format precision specified")
        check(isinstance(self.descriptor_format, DescriptorFormat),
              "invalid descriptor format specified")
        check(self.resolution_bucket >= 0,
              "resolution bucket must be >= 0 (0 = auto)")
        check(self.detect_cache_size >= 1,
              "detect cache size must be >= 1")

    # ------------------------------------------------------------------
    @property
    def dog_threshold(self) -> float:
        """Threshold actually applied to refined DoG values
        (reference: sift_detector.c:1136)."""
        return self.intensity_threshold / self.nb_scales_per_octave

    @property
    def orientation_capacity(self) -> int:
        """Static per-keypoint orientation capacity.

        The reference appends extra-orientation keypoints dynamically via
        atomics (shaders/ComputeOrientation.comp:170-184) with the config cap;
        0 means unlimited. Under XLA we need a static bound: with a 36-bin
        smoothed histogram, strict local maxima >= 0.8*max are rare beyond 4;
        we use 8 for "unlimited".
        """
        cap = self.max_nb_orientation_per_keypoint
        return int(cap) if cap > 0 else 8

    def max_octaves_for(self, width: int, height: int) -> int:
        """Octave count for a resolution (reference: sift_memory.c:15-27):
        log2(min_dim) - 4 (+1 when upsampling), capped by nb_octaves if set,
        so the smallest octave's min dimension stays >= 16 px."""
        lowest = min(width, height)
        n = int(math.log2(float(lowest))) - 4 + (1 if self.use_input_upsampling else 0)
        n = max(n, 1)
        if self.nb_octaves > 0:
            n = min(n, self.nb_octaves)
        return n

    def octave_resolutions(self, width: int, height: int) -> Tuple[Tuple[int, int], ...]:
        """Per-octave (width, height) image sizes
        (reference: sift_memory.c:29-38)."""
        n = self.max_octaves_for(width, height)
        scale0 = 2 if self.use_input_upsampling else 1
        res = []
        for o in range(n):
            d = 2 ** o
            res.append((scale0 * width // d, scale0 * height // d))
        return tuple(res)

    def octave_section_capacities(self, nb_octaves: int) -> Tuple[int, ...]:
        """Geometric-halves per-octave feature capacities summing to
        max_nb_sift_per_buffer (reference: sift_memory.c:40-87): octave o
        gets ~half the capacity of octave o-1, rescaled so the sum matches."""
        total = float(self.max_nb_sift_per_buffer)
        halves_sum = total - (0.5 ** nb_octaves) * total
        corrector = total / halves_sum
        return tuple(int(math.floor((0.5 ** (i + 1)) * total * corrector))
                     for i in range(nb_octaves))


def get_default_config() -> SiftConfig:
    """Parity: vksift_getDefaultConfig (vulkansift.c:66)."""
    return SiftConfig()


def from_reference_dict(d: dict) -> SiftConfig:
    """Build a :class:`SiftConfig` from a plain dict of the same fields
    (for example ``dataclasses.asdict`` of another package's SiftConfig).
    Enum fields may be given as enum members of any class or as their
    integer values; unknown keys raise."""
    names = {f.name for f in dataclasses.fields(SiftConfig)}
    unknown = set(d) - names
    if unknown:
        raise InvalidConfigError(f"unknown configuration fields {sorted(unknown)}")
    kw = dict(d)
    for key, enum_cls in (("descriptor_format", DescriptorFormat),
                          ("pyramid_precision", PyramidPrecision)):
        if key in kw:
            v = kw[key]
            kw[key] = enum_cls(getattr(v, "value", v))
    return SiftConfig(**kw)
