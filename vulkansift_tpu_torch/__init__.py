"""vulkansift_tpu_torch -- the PyTorch/CUDA port of vulkansift_tpu.

SIFT detection (gaussian scale space, DoG extrema with subpixel
refinement, orientation assignment, 128-D UBC/VLFeat descriptors), batched
detect and brute-force 2-NN descriptor matching in PyTorch, behind the
reference's instance API (``SiftInstance``: detect, match, feature and
match transfers, scale-space debug downloads, traces), the staged debug
detector (``SiftDetector``), multi-device detect and sharded matching
(``parallel``) and the SfM back end (``sfm``). The five kernels of the
detect and match paths are written by hand in CUDA for Hopper (``csrc/``).
The package imports torch and numpy only; it keeps its own copies of what
it shares with the JAX package.

Entry points run on the card by default (``device="cuda"``) and raise when
there is none; ``device="cpu"`` runs every kernel's plain PyTorch version.
"""

from .config import (DESC_SIZE, DescriptorFormat, PyramidPrecision,
                     SiftConfig, from_reference_dict, get_default_config)
from .detector import SiftDetector
from .errors import (DeviceError, InvalidConfigError, InvalidInputError,
                     Result, VulkanSiftTpuError)
from .instance import (SiftInstance, get_available_devices, load_runtime,
                       unload_runtime)
from .pipeline import (DetectOutput, make_detect_batched, make_detect_fn,
                       octave_plan)
from .types import (FEATURE_DTYPE, MATCH_DTYPE, Features, Matches2NN,
                    features_from_numpy, features_to_numpy, matches_to_numpy)
from .utils.logging import LogLevel, set_log_level

__version__ = "0.1.0"

__all__ = [
    "DESC_SIZE", "DescriptorFormat", "PyramidPrecision", "SiftConfig",
    "from_reference_dict", "get_default_config", "SiftDetector",
    "DeviceError",
    "InvalidConfigError", "InvalidInputError", "Result",
    "VulkanSiftTpuError", "SiftInstance", "get_available_devices",
    "load_runtime", "unload_runtime", "DetectOutput", "make_detect_batched",
    "make_detect_fn", "octave_plan", "FEATURE_DTYPE", "MATCH_DTYPE",
    "Features", "Matches2NN", "features_from_numpy", "features_to_numpy",
    "matches_to_numpy", "LogLevel", "set_log_level",
]
