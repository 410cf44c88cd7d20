"""Trajectory evaluation metrics for the SfM back end.

Port of ``vulkansift_tpu/sfm/metrics.py``. ATE (absolute trajectory error)
follows the TUM-RGBD protocol: align the estimated camera centres to the
ground truth with a closed-form similarity (Umeyama alignment: monocular
reconstructions are defined up to Sim(3)), then report the RMSE of the
remaining centre distances (Umeyama 1991, Sturm et al. 2012).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .geometry import SE3


def camera_centers(pose_tangents: np.ndarray) -> np.ndarray:
    """(C, 6) world->cam SE(3) tangents -> (C, 3) camera centres (the
    rotations in float32, as the JAX package computes them)."""
    se3 = SE3.from_tangent(torch.as_tensor(np.asarray(pose_tangents),
                                           dtype=torch.float32))
    r, t = se3.r.numpy(), se3.t.numpy()
    return np.stack([-r[i].T @ t[i] for i in range(len(r))])


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True
                      ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Closed-form similarity (s, R, t) minimising ||dst - (s R src + t)||.

    Umeyama (1991), eq. 34-43. src/dst are (N, 3), N >= 3 non-degenerate.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    rot = u @ s_fix @ vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        scale = float(np.trace(np.diag(d) @ s_fix) / max(var_s, 1e-18))
    else:
        scale = 1.0
    trans = mu_d - scale * rot @ mu_s
    return scale, rot, trans


def absolute_trajectory_error(est_pose_tangents: np.ndarray,
                              gt_pose_tangents: np.ndarray,
                              with_scale: bool = True) -> float:
    """ATE RMSE (in ground-truth units) after Sim(3) (or SE(3)) alignment
    of the estimated camera-centre trajectory to the ground truth."""
    est = camera_centers(est_pose_tangents)
    gt = camera_centers(gt_pose_tangents)
    if len(est) != len(gt):
        raise ValueError("trajectory length mismatch")
    s, r, t = umeyama_alignment(est, gt, with_scale=with_scale)
    aligned = (s * (r @ est.T)).T + t
    return float(np.sqrt(((aligned - gt) ** 2).sum(axis=1).mean()))
