"""Schur-complement bundle adjustment (one device and distributed).

Port of ``vulkansift_tpu/sfm/bundle_adjustment.py``:

* Observations are a flat padded array (cam_idx, pt_idx, uv, valid).
  Jacobians are exact: ``torch.func.jacfwd`` of the reprojection residual,
  vmapped over observations.
* Levenberg-Marquardt normal equations are never formed globally: the
  reduced camera system ``S = U - W V^{-1} W^T`` is applied matrix-free
  inside conjugate gradients, from per-observation 6x3 blocks, 3x3
  landmark inverses and two segment sums (``index_add_``) an application.
* Distribution (:func:`make_distributed_ba`): observations are split over
  the ranks of a mesh, cameras and landmarks are replicated, and every
  segment sum, cost and count is summed over the ranks with
  ``all_reduce``.

``index_add_`` on CUDA adds with atomics, so its float sums, and with them
the results, vary in the last bits from run to run.

Gauge: like the JAX package, :func:`bundle_adjust` by default zeroes the
first camera's update after a solve over every camera. That solve still
holds the seven directions of the similarity gauge, along which the step
is rounding noise over the damping, and the monocular scale is never
pinned: on an 8-camera scene, sums taken in another order (as the card's
atomics take them) can move the poses by more than 1e-3.
``fix_scale=True`` (the port only; used by
:func:`..reconstruction.reconstruct_sequence`) holds the first camera and
one translation coordinate out of the solve instead, which removes the
whole gauge.

The Huber weight is recomputed at each outer iteration (IRLS).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.func import jacfwd, vmap

from ..utils.device import DeviceLike, resolve_device
from ..parallel.mesh import DATA_AXIS, mesh_device, mesh_rank
from .geometry import Camera, reproject


class BAProblem(NamedTuple):
    """Static-shape BA problem (padded; ``valid`` masks live
    observations)."""

    poses: torch.Tensor    # f32 (C, 6) camera tangents [w, t] (world->cam)
    points: torch.Tensor   # f32 (Pt, 3) landmarks
    cam_idx: torch.Tensor  # i32/i64 (N,) observation -> camera
    pt_idx: torch.Tensor   # i32/i64 (N,) observation -> landmark
    uv: torch.Tensor       # f32 (N, 2) pixel measurements
    valid: torch.Tensor    # bool (N,)
    camera: Camera         # shared intrinsics (scalars)


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor  # mean squared reprojection error (valid obs)
    final_cost: torch.Tensor


Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _residuals(problem: BAProblem) -> torch.Tensor:
    """Per-observation residual (N, 2)."""
    return (reproject(problem.poses[problem.cam_idx.long()],
                      problem.points[problem.pt_idx.long()], problem.camera)
            - problem.uv)


def _residuals_and_jacobians(problem: BAProblem):
    """Per-observation residual (2,), J_pose (2, 6), J_point (2, 3)."""
    cam = problem.camera

    def f(pw, pt, uv):
        return reproject(pw, pt, cam) - uv

    poses_o = problem.poses[problem.cam_idx.long()]
    points_o = problem.points[problem.pt_idx.long()]
    jp, jx = vmap(jacfwd(f, argnums=(0, 1)))(poses_o, points_o, problem.uv)
    return f(poses_o, points_o, problem.uv), jp, jx


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss given squared residual norms."""
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int,
                 psum: Reduce) -> torch.Tensor:
    out = x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)
    return psum(out) if psum else out


def _mean_sq(r: torch.Tensor, valid: torch.Tensor,
             psum: Reduce) -> torch.Tensor:
    """Mean squared residual norm over the valid observations."""
    total = torch.where(valid, torch.sum(r * r, -1), 0.0).sum()
    nvalid = valid.sum().to(total.dtype)
    if psum:
        total, nvalid = psum(total), psum(nvalid)
    return total / torch.clamp(nvalid, min=1)


def _cost(problem: BAProblem, psum: Reduce = None) -> torch.Tensor:
    """Mean squared reprojection error over the valid observations."""
    return _mean_sq(_residuals(problem), problem.valid, psum)


def _ba_step_terms(problem: BAProblem, huber_delta: float,
                   psum: Reduce = None):
    """All per-iteration quantities: blocks U, V, W and the right-hand
    sides. ``psum`` (optional) sums segment sums over ranks, the only hook
    distribution needs."""
    nc = problem.poses.shape[0]
    npt = problem.points.shape[0]
    cam_idx, pt_idx = problem.cam_idx.long(), problem.pt_idx.long()
    r, jp, jx = _residuals_and_jacobians(problem)
    w = torch.where(problem.valid,
                    _huber_weight(torch.sum(r * r, -1), huber_delta), 0.0)
    jp_w = jp * w[:, None, None]
    jx_w = jx * w[:, None, None]

    # IRLS normal-equation blocks: H = sum w J^T J, g = -sum w J^T r.
    utt = torch.einsum("nki,nkj->nij", jp_w, jp)        # (N, 6, 6)
    vtt = torch.einsum("nki,nkj->nij", jx_w, jx)        # (N, 3, 3)
    wtt = torch.einsum("nki,nkj->nij", jp_w, jx)        # (N, 6, 3)
    bc = -torch.einsum("nki,nk->ni", jp_w, r)           # (N, 6)
    bp = -torch.einsum("nki,nk->ni", jx_w, r)           # (N, 3)

    def seg_c(x):
        return _segment_sum(x, cam_idx, nc, psum)

    def seg_p(x):
        return _segment_sum(x, pt_idx, npt, psum)

    return dict(u=seg_c(utt), v=seg_p(vtt), wtt=wtt, g_c=seg_c(bc),
                g_p=seg_p(bp), cost=_mean_sq(r, problem.valid, psum),
                seg_c=seg_c, seg_p=seg_p)


def _gauge_free(poses: torch.Tensor) -> torch.Tensor:
    """(C, 6) 1 where the solve may move a camera parameter: every one but
    the first camera's and the largest translation coordinate among the
    others (its value pins the scale)."""
    free = torch.ones_like(poses)
    free[0] = 0.0
    k = int(torch.argmax(poses[1:, 3:].abs()))
    free[1 + k // 3, 3 + k % 3] = 0.0
    return free


def _solve_schur_cg(problem: BAProblem, terms, lam: torch.Tensor,
                    nb_cg_iters: int, free: Optional[torch.Tensor] = None):
    """Matrix-free CG on the reduced camera system.

    S dx = g with S = U + lam I - W (V + lam I)^{-1} W^T, then landmark
    back-substitution. ``free`` (optional, (C, 6) of 0 and 1) restricts
    the solve to the parameters marked 1; the others' updates are 0.
    Returns (d_poses (C, 6), d_points (Pt, 3))."""
    u, v, wtt = terms["u"], terms["v"], terms["wtt"]
    seg_c, seg_p = terms["seg_c"], terms["seg_p"]
    cam_idx, pt_idx = problem.cam_idx.long(), problem.pt_idx.long()
    dt, dev = u.dtype, u.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    u_d = u + lam * eye6
    v_inv = torch.linalg.inv(v + lam * eye3 + 1e-9 * eye3)

    def apply_s(x):  # x: (C, 6)
        y = torch.einsum("cij,cj->ci", u_d, x)
        wx = torch.einsum("nji,nj->ni", wtt, x[cam_idx])    # W^T x per obs
        z = torch.einsum("pij,pj->pi", v_inv, seg_p(wx))    # (Pt, 3)
        y = y - seg_c(torch.einsum("nij,nj->ni", wtt, z[pt_idx]))
        return y if free is None else y * free

    # rhs: g_c - W V^{-1} g_p
    z0 = torch.einsum("pij,pj->pi", v_inv, terms["g_p"])
    rhs = terms["g_c"] - seg_c(torch.einsum("nij,nj->ni", wtt, z0[pt_idx]))

    # Jacobi-preconditioned CG (held parameters: infinite diagonal).
    diag = torch.clamp(torch.diagonal(u_d, dim1=-2, dim2=-1), min=1e-6)
    if free is not None:
        rhs = rhs * free
        diag = torch.where(free > 0, diag, torch.inf)
    x = torch.zeros_like(rhs)
    r = rhs
    p = r / diag
    rz = torch.sum(r * p)
    for _ in range(nb_cg_iters):
        sp = apply_s(p)
        alpha = rz / torch.clamp(torch.sum(p * sp), min=1e-20)
        x = x + alpha * p
        r = r - alpha * sp
        z = r / diag
        rz_new = torch.sum(r * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-20)) * p
        rz = rz_new

    # Landmark back-substitution: dX = V^{-1} (g_p - W^T dx).
    tp = seg_p(torch.einsum("nji,nj->ni", wtt, x[cam_idx]))
    dpt = torch.einsum("pij,pj->pi", v_inv, terms["g_p"] - tp)
    return x, dpt


def _lm(problem: BAProblem, *, nb_iters: int, nb_cg_iters: int,
        huber_delta: float, init_lambda: float, fix_first_pose: bool,
        fix_scale: bool = False, psum: Reduce = None) -> BAResult:
    """Levenberg-Marquardt; acceptance and damping stay on the device."""
    poses, points = problem.poses, problem.points
    free = _gauge_free(poses) if fix_scale else None
    lam = torch.tensor(init_lambda, dtype=poses.dtype, device=poses.device)
    init_cost = _cost(problem, psum)
    for _ in range(nb_iters):
        p2 = problem._replace(poses=poses, points=points)
        terms = _ba_step_terms(p2, huber_delta, psum)
        dx, dpt = _solve_schur_cg(p2, terms, lam, nb_cg_iters, free)
        if fix_first_pose:
            dx[0] = 0.0
        new_poses, new_points = poses + dx, points + dpt
        new_cost = _cost(problem._replace(poses=new_poses,
                                          points=new_points), psum)
        accept = new_cost < terms["cost"]
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e4))
    return BAResult(poses=poses, points=points, initial_cost=init_cost,
                    final_cost=_cost(problem._replace(poses=poses,
                                                      points=points), psum))


def bundle_adjust(problem: BAProblem, *, nb_iters: int = 10,
                  nb_cg_iters: int = 20, huber_delta: float = 3.0,
                  init_lambda: float = 1e-3,
                  fix_first_pose: bool = True,
                  fix_scale: bool = False) -> BAResult:
    """Levenberg-Marquardt BA with the matrix-free Schur complement, on
    the device the problem's tensors lie on. The first camera is
    gauge-fixed (its update zeroed) by default. ``fix_scale`` holds the
    first camera and the largest translation coordinate of the others out
    of the solve (the module docstring says why); it needs
    ``fix_first_pose`` and two or more cameras."""
    if fix_scale and not (fix_first_pose and problem.poses.shape[0] > 1):
        raise ValueError("fix_scale needs fix_first_pose and two or more "
                         "cameras")
    return _lm(problem, nb_iters=nb_iters, nb_cg_iters=nb_cg_iters,
               huber_delta=huber_delta, init_lambda=init_lambda,
               fix_first_pose=fix_first_pose, fix_scale=fix_scale)


def make_distributed_ba(mesh: DeviceMesh, axis_name: str = DATA_AXIS, *,
                        nb_iters: int = 10, nb_cg_iters: int = 20,
                        huber_delta: float = 3.0,
                        fix_first_pose: bool = True,
                        device: DeviceLike = "cuda"):
    """Multi-device BA over ``mesh``: observations split over the ranks,
    poses and landmarks replicated, segment sums, costs and counts summed
    with ``all_reduce``.

    Returns ``fn(problem) -> BAResult``, which every rank of the mesh calls
    with the same whole problem; it moves this rank's contiguous share of
    the observations and the replicated state to its device (default
    ``"cuda"``, raising without a card). ``nb_obs`` must divide by the
    mesh size (pad with invalid observations)."""
    dev = mesh_device(mesh, resolve_device(device))
    n = mesh.size()
    me = mesh_rank(mesh, axis_name)
    group = mesh.get_group(axis_name)

    def psum(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    def run(problem: BAProblem) -> BAResult:
        nb_obs = problem.cam_idx.shape[0]
        if nb_obs % n:
            raise ValueError(f"{nb_obs} observations are not divisible by "
                             f"the mesh size {n}")
        per = nb_obs // n
        sl = slice(me * per, (me + 1) * per)

        def local(t):
            return t[sl].to(dev)

        cam = Camera(*(torch.as_tensor(c, dtype=torch.float32).to(dev)
                       for c in problem.camera))
        part = BAProblem(poses=problem.poses.to(dev),
                         points=problem.points.to(dev),
                         cam_idx=local(problem.cam_idx),
                         pt_idx=local(problem.pt_idx), uv=local(problem.uv),
                         valid=local(problem.valid), camera=cam)
        return _lm(part, nb_iters=nb_iters, nb_cg_iters=nb_cg_iters,
                   huber_delta=huber_delta, init_lambda=1e-3,
                   fix_first_pose=fix_first_pose, psum=psum)

    return run
