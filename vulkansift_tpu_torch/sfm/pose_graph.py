"""Pose-graph optimisation on SE(3) (Gauss-Newton).

Port of ``vulkansift_tpu/sfm/pose_graph.py``. Nodes are camera poses,
edges relative-pose measurements. The residual of edge (i, j) with
measurement Z_ij is

    r_ij = log( Z_ij^{-1} . T_i^{-1} . T_j )   in R^6,

linearised with the exact Jacobian of ``torch.func.jacfwd`` and solved
densely: pose graphs are small (hundreds of nodes), so a (6N, 6N) solve
is the simple choice over a sparse factorisation.

On a card one Gauss-Newton step is a recorded program
(:class:`..compiled.LoopProgram`), one per ``(N, E, damping)`` in an LRU
of ``POSE_GRAPH_PROGRAMS``, replayed ``nb_iters`` times: the counterpart
of the JAX package's jitted ``lax.scan``. The CPU runs the same step
eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from .. import compiled
from .geometry import SE3

# Recorded Gauss-Newton programs kept a device.
POSE_GRAPH_PROGRAMS = 4
PROGRAMS = compiled.ProgramCache(POSE_GRAPH_PROGRAMS)


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


def _gauss_newton_step(flat: torch.Tensor, graph: PoseGraph,
                       damping: float) -> torch.Tensor:
    """One Gauss-Newton step of the flat (6N,) poses, the first pose
    gauge-fixed; no host synchronisation (a recorded program replays
    it)."""
    n = flat.shape[0] // 6
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    sw = torch.sqrt(graph.weight)[:, None]

    def res_fn(f):
        ps = f.reshape(n, 6)
        return (_edge_residual(ps[ei], ps[ej], graph.meas) * sw).reshape(-1)

    r = res_fn(flat)
    jmat = jacfwd(res_fn)(flat).clone()      # (6E, 6N) dense
    jmat[:, :6] = 0.0                        # gauge fix: first pose
    h = jmat.T @ jmat + damping * torch.eye(6 * n, dtype=flat.dtype,
                                            device=flat.device)
    # solve_ex: solve checks its info on the host, which a capture refuses.
    return flat + torch.linalg.solve_ex(h, -(jmat.T @ r)).result


def _replayed(graph: PoseGraph, nb_iters: int,
              damping: float) -> PoseGraph:
    """The optimisation on a card: the recorded step of ``(N, E,
    damping)`` (built at its first use), replayed ``nb_iters`` times."""
    n = graph.poses.shape[0]
    flat = graph.poses.reshape(-1)
    static = (graph.edge_i.long(), graph.edge_j.long(), graph.meas,
              graph.weight)

    def step(state, static):
        return (_gauss_newton_step(state[0], PoseGraph(None, *static),
                                   damping),)

    dev = flat.device
    with PROGRAMS.lock:
        prog = PROGRAMS.get(
            (dev, n, graph.edge_i.shape[0], float(damping)),
            lambda: compiled.LoopProgram(step, (flat,), static,
                                         pool=PROGRAMS.pool(dev)))
        (flat,) = prog(nb_iters, (flat,), static)
    return graph._replace(poses=flat.reshape(n, 6))


def _iterate(graph: PoseGraph, nb_iters: int, damping: float) -> PoseGraph:
    """The optimisation run eagerly: ``nb_iters`` Gauss-Newton steps."""
    flat = graph.poses.reshape(-1)
    for _ in range(nb_iters):
        flat = _gauss_newton_step(flat, graph, damping)
    return graph._replace(poses=flat.reshape(graph.poses.shape))


def optimize_pose_graph(graph: PoseGraph, *, nb_iters: int = 20,
                        damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton with the first pose gauge-fixed. On a card the step is
    a recorded program, replayed ``nb_iters`` times; the CPU runs it
    eagerly."""
    if graph.poses.device.type == "cuda":
        return _replayed(graph, nb_iters, damping)
    return _iterate(graph, nb_iters, damping)


def pose_graph_cost(graph: PoseGraph) -> torch.Tensor:
    r = _edge_residual(graph.poses[graph.edge_i.long()],
                       graph.poses[graph.edge_j.long()], graph.meas)
    return torch.sum(graph.weight[:, None] * r * r)
