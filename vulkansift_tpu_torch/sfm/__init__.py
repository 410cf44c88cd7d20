"""SfM back end: geometry, pose-graph optimisation, distributed bundle
adjustment and a sequential reconstruction pipeline (port of
``vulkansift_tpu/sfm``, float32 as there)."""

from .geometry import (Camera, SE3, decompose_essential, essential_8pt,
                       exp_so3, hat, log_so3, ransac_essential,
                       sampson_error, triangulate_linear)
from .bundle_adjustment import (BAProblem, BAResult, bundle_adjust,
                                make_distributed_ba)
from .pose_graph import PoseGraph, optimize_pose_graph, pose_graph_cost
from .reconstruction import Reconstruction, reconstruct_sequence
from .checkpoint import load_reconstruction, save_reconstruction
from .metrics import (absolute_trajectory_error, camera_centers,
                      umeyama_alignment)

__all__ = [
    "Camera", "SE3", "decompose_essential", "essential_8pt", "exp_so3",
    "hat", "log_so3", "ransac_essential", "sampson_error",
    "triangulate_linear", "BAProblem", "BAResult", "bundle_adjust",
    "make_distributed_ba", "PoseGraph", "optimize_pose_graph",
    "pose_graph_cost", "Reconstruction", "reconstruct_sequence",
    "load_reconstruction", "save_reconstruction",
    "absolute_trajectory_error", "camera_centers", "umeyama_alignment",
]
