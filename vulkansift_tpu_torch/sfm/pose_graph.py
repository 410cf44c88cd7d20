"""Pose-graph optimisation on SE(3) (Gauss-Newton).

Port of ``vulkansift_tpu/sfm/pose_graph.py``. Nodes are camera poses,
edges relative-pose measurements. The residual of edge (i, j) with
measurement Z_ij is

    r_ij = log( Z_ij^{-1} . T_i^{-1} . T_j )   in R^6,

linearised with the exact Jacobian of ``torch.func.jacfwd`` and solved
densely: pose graphs are small (hundreds of nodes), so a (6N, 6N) solve
is the simple choice over a sparse factorisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from .geometry import SE3


class PoseGraph(NamedTuple):
    """Static-shape pose graph (padded edges masked by ``weight`` 0)."""

    poses: torch.Tensor   # f32 (N, 6) pose tangents [w, t] (world->cam)
    edge_i: torch.Tensor  # i64/i32 (E,)
    edge_j: torch.Tensor  # i64/i32 (E,)
    meas: torch.Tensor    # f32 (E, 6) measured relative tangents T_i^-1 T_j
    weight: torch.Tensor  # f32 (E,) information weight (0 masks an edge)


def _edge_residual(pose_i: torch.Tensor, pose_j: torch.Tensor,
                   meas: torch.Tensor) -> torch.Tensor:
    ti = SE3.from_tangent(pose_i)
    tj = SE3.from_tangent(pose_j)
    z = SE3.from_tangent(meas)
    return z.inverse().compose(ti.inverse().compose(tj)).log()


def optimize_pose_graph(graph: PoseGraph, *, nb_iters: int = 20,
                        damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton with the first pose gauge-fixed."""
    n = graph.poses.shape[0]
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    sw = torch.sqrt(graph.weight)[:, None]

    def res_fn(flat):
        ps = flat.reshape(n, 6)
        return (_edge_residual(ps[ei], ps[ej], graph.meas) * sw).reshape(-1)

    eye = torch.eye(6 * n, dtype=graph.poses.dtype,
                    device=graph.poses.device)
    flat = graph.poses.reshape(-1)
    for _ in range(nb_iters):
        r = res_fn(flat)
        jmat = jacfwd(res_fn)(flat).clone()      # (6E, 6N) dense
        jmat[:, :6] = 0.0                        # gauge fix: first pose
        h = jmat.T @ jmat + damping * eye
        dx = torch.linalg.solve(h, -(jmat.T @ r))
        flat = flat + dx
    return graph._replace(poses=flat.reshape(n, 6))


def pose_graph_cost(graph: PoseGraph) -> torch.Tensor:
    r = _edge_residual(graph.poses[graph.edge_i.long()],
                       graph.poses[graph.edge_j.long()], graph.meas)
    return torch.sum(graph.weight[:, None] * r * r)
