"""SfM back end: geometry, pose-graph optimisation, distributed bundle
adjustment and a sequential reconstruction pipeline (port of
``vulkansift_tpu/sfm``, float32 as there).

On a card the matcher, RANSAC, the pose graph and BA replay recorded
programs (CUDA graphs) that each module keeps in an LRU (``PROGRAMS``),
as a jit cache keeps compiled programs; a call holds its cache's lock
from the lookup to the copy of its results, so that calls from several
threads do not share a program's buffers at once. :func:`close_programs`
frees them."""

import torch

from .geometry import (Camera, SE3, decompose_essential, essential_8pt,
                       exp_so3, hat, log_so3, ransac_essential,
                       sampson_error, triangulate_linear)
from .bundle_adjustment import (BAProblem, BAResult, bundle_adjust,
                                make_distributed_ba)
from .pose_graph import PoseGraph, optimize_pose_graph, pose_graph_cost
from .reconstruction import Reconstruction, reconstruct_sequence
from .checkpoint import load_reconstruction, save_reconstruction
from . import bundle_adjustment, geometry, pose_graph, reconstruction
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
    "close_programs",
]


def close_programs() -> None:
    """Close every recorded program the SfM functions keep and return their
    memory to the card (a later call records its program anew)."""
    for module in (reconstruction, geometry, pose_graph, bundle_adjustment):
        module.PROGRAMS.close()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()
