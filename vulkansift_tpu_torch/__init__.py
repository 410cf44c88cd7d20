"""vulkansift_tpu_torch -- the PyTorch/CUDA port of vulkansift_tpu.

SIFT detection (gaussian scale space, DoG extrema with subpixel
refinement, orientation assignment, 128-D UBC/VLFeat descriptors) in
PyTorch, with the four kernels of the detect path written by hand in CUDA
for Hopper (``csrc/``). The package imports torch and numpy only; it keeps
its own copies of what it shares with the JAX package.

Entry points run on the card by default (``device="cuda"``) and raise when
there is none; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""

from .config import (DESC_SIZE, DescriptorFormat, PyramidPrecision,
                     SiftConfig, from_reference_dict, get_default_config)
from .errors import (DeviceError, InvalidConfigError, InvalidInputError,
                     Result, VulkanSiftTpuError)
from .instance import SiftInstance
from .pipeline import DetectOutput, make_detect_fn
from .types import (FEATURE_DTYPE, Features, features_from_numpy,
                    features_to_numpy)

__version__ = "0.1.0"

__all__ = [
    "DESC_SIZE", "DescriptorFormat", "PyramidPrecision", "SiftConfig",
    "from_reference_dict", "get_default_config", "DeviceError",
    "InvalidConfigError", "InvalidInputError", "Result",
    "VulkanSiftTpuError", "SiftInstance", "DetectOutput", "make_detect_fn",
    "FEATURE_DTYPE", "Features", "features_from_numpy", "features_to_numpy",
]
