"""SE(3)/SO(3) primitives, projection, triangulation, two-view geometry.

Port of ``vulkansift_tpu/sfm/geometry.py`` in float32. Every function
takes leading batch dimensions where the JAX package vmaps it, so that
RANSAC runs its hypotheses and the reconstruction its tracks as one
batch.

Conventions:
* Rotations: axis-angle vectors ``w`` (3,) with ``R = exp([w]x)``;
  world-to-camera: ``x_cam = R @ x_world + t``.
* Pixels: pinhole ``(fx, fy, cx, cy)``; no distortion (rectified inputs).

The 8x9 and 3x3 SVDs and the 3x3 solves go to ``torch.linalg``, as the
JAX package leaves them to XLA's library calls.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

_EPS = 1e-12

Scalar = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1)], -2)


def _eye(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        *shape, 3, 3)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    # Taylor-safe coefficients sin(t)/t and (1-cos t)/t^2.
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    k = hat(w)
    return _eye(k.shape[:-2], k) + a * k + b * (k @ k)


def log_so3(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Differentiable at the identity (the pose-graph jacobians need it):
    theta comes from atan2 of a safe vee-norm, and the singular branch of
    the scale is guarded with the double-where pattern."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    vee = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                       r[..., 0, 2] - r[..., 2, 0],
                       r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_t = 0.5 * torch.sqrt(torch.sum(vee * vee, -1) + _EPS)
    cos_t = (trace - 1.0) * 0.5
    theta = torch.atan2(sin_t, cos_t)[..., None]
    small = theta < 1e-4
    sin_safe = torch.where(small, 1.0, sin_t[..., None])
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_safe))
    return vee * scale


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., 3, 3) x (..., 3)."""
    return (m @ v[..., None])[..., 0]


class SE3(NamedTuple):
    """Batchable rigid transform: x -> R @ x + t."""

    r: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch=(), device=None) -> "SE3":
        return SE3(torch.eye(3, device=device).expand(*batch, 3, 3),
                   torch.zeros(*batch, 3, device=device))

    @staticmethod
    def from_tangent(wt: torch.Tensor) -> "SE3":
        """(..., 6) [w, t] -> SE3 (R = exp(w), translation stored
        directly: the standard BA parameterisation)."""
        return SE3(exp_so3(wt[..., :3]), wt[..., 3:])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return _mv(self.r, x) + self.t

    def compose(self, other: "SE3") -> "SE3":
        """self o other: first other, then self."""
        return SE3(self.r @ other.r, _mv(self.r, other.t) + self.t)

    def inverse(self) -> "SE3":
        rt = self.r.transpose(-1, -2)
        return SE3(rt, -_mv(rt, self.t))

    def log(self) -> torch.Tensor:
        """(..., 6) [log R, t], consistent with from_tangent."""
        return torch.cat([log_so3(self.r), self.t], -1)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

class Camera(NamedTuple):
    fx: Scalar
    fy: Scalar
    cx: Scalar
    cy: Scalar

    def project(self, x_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2)."""
        # Width-1 slices, not 0-d ones: under torch.func.jacfwd a 0-d
        # tensor times a Python float gets a float64 tangent.
        z = torch.clamp(x_cam[..., 2:3], min=1e-9)
        return torch.cat([self.fx * x_cam[..., 0:1] / z + self.cx,
                          self.fy * x_cam[..., 1:2] / z + self.cy], -1)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> normalised rays (..., 3) with z = 1."""
        return torch.stack([(uv[..., 0] - self.cx) / self.fx,
                            (uv[..., 1] - self.cy) / self.fy,
                            torch.ones_like(uv[..., 0])], -1)


def reproject(pose_wt: torch.Tensor, point: torch.Tensor,
              cam: Camera) -> torch.Tensor:
    """Residual helper: project a world point under a pose tangent (6,)."""
    return cam.project(SE3.from_tangent(pose_wt).apply(point))


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------

def triangulate_linear(poses: SE3, rays: torch.Tensor, mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Midpoint/linear triangulation of tracks from N views each.

    Args:
      poses: SE3 with shape (..., N) (world->camera).
      rays: (..., N, 3) normalised camera-frame rays.
      mask: (..., N) bool validity.

    Returns (X_world (..., 3), ok (...,)): the point minimising the summed
    squared distances to the valid views' rays, ok where at least two
    views are valid."""
    rt = poses.r.transpose(-1, -2)
    d = _mv(rt, rays)
    c = -_mv(rt, poses.t)
    # For each view: (I - dd^T/|d|^2) (X - c) = 0
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                         min=_EPS)
    p = _eye(d.shape[:-1], d) - dn[..., :, None] * dn[..., None, :]
    p = p * mask[..., None, None].to(p.dtype)
    a = p.sum(-3)
    b = _mv(p, c).sum(-2)
    # Solve 3x3 (regularised for rank-deficient masks).
    a = a + 1e-9 * torch.eye(3, dtype=a.dtype, device=a.device)
    x = torch.linalg.solve(a, b[..., None])[..., 0]
    ok = mask.sum(-1) >= 2
    return x, ok


# ---------------------------------------------------------------------------
# Two-view geometry (essential matrix, RANSAC, pose recovery)
# ---------------------------------------------------------------------------

def essential_8pt(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """8-point essential matrix from >= 8 ray pairs (..., N, 3) each,
    with the rank-2 constraint enforced: (..., 3, 3)."""
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                     x1, y1, torch.ones_like(x1)], -1)
    # full_matrices: with exactly 8 rows the null vector is the 9th right
    # singular vector, which the thin SVD does not return.
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    e = vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3)
    u, s, vt2 = torch.linalg.svd(e)
    s_mean = (s[..., 0] + s[..., 1]) * 0.5
    s_fixed = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], -1)
    return (u * s_fixed[..., None, :]) @ vt2


def sampson_error(e: torch.Tensor, r1: torch.Tensor,
                  r2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error of ray pairs (N, 3) under E
    (..., 3, 3): (..., N)."""
    ex1 = r1 @ e.transpose(-1, -2)   # E @ x1 per row
    etx2 = r2 @ e                    # E^T @ x2 per row
    x2ex1 = torch.sum(r2 * ex1, -1)
    denom = (ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2
             + etx2[..., 1] ** 2)
    return x2ex1 ** 2 / torch.clamp(denom, min=_EPS)


def ransac_essential(rays1: torch.Tensor, rays2: torch.Tensor,
                     valid: torch.Tensor, generator: torch.Generator, *,
                     threshold: float = 1e-5, nb_iters: int = 256):
    """RANSAC essential-matrix estimation, all hypotheses in one batch.

    Args:
      rays1/rays2: (N, 3) normalised rays per correspondence (padded).
      valid: (N,) bool; invalid rows never count as inliers.
      generator: a CPU ``torch.Generator``; the (nb_iters, 8) uniform
        draws come from it on the CPU and move to the rays' device once,
        so a run on the card and one on the CPU draw the same samples.
      threshold: Sampson error inlier threshold (normalised coords^2).

    Returns (E_best, inlier_mask, nb_inliers).
    """
    n = rays1.shape[0]
    dev = rays1.device
    nvalid = torch.clamp(valid.sum(), min=1)
    u = torch.rand((nb_iters, 8), generator=generator).to(dev)
    # Sample 8 valid indices per hypothesis (with replacement).
    ranks = (u * nvalid).to(torch.int64)
    cs = torch.cumsum(valid.to(torch.int64), 0)
    idx = torch.searchsorted(cs, ranks + 1).clamp(0, n - 1)
    es = essential_8pt(rays1[idx], rays2[idx])           # (iters, 3, 3)
    err = sampson_error(es, rays1, rays2)                # (iters, N)
    scores = ((err < threshold) & valid).sum(-1)
    e_best = es[torch.argmax(scores)]
    inl = (sampson_error(e_best, rays1, rays2) < threshold) & valid
    return e_best, inl, inl.sum()


def decompose_essential(e: torch.Tensor, rays1: torch.Tensor,
                        rays2: torch.Tensor, mask: torch.Tensor) -> SE3:
    """Recover the relative pose (cam1 -> cam2) from E by the cheirality
    vote over the 4 candidate decompositions."""
    u, _, vt = torch.linalg.svd(e)
    # Enforce proper rotations.
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=e.dtype, device=e.device)
    r_a = u @ w @ vt
    r_b = u @ w.T @ vt
    t_u = u[:, 2]
    n = rays1.shape[0]
    eye = torch.eye(3, dtype=e.dtype, device=e.device)
    rays = torch.stack([rays1, rays2], 1)                 # (N, 2, 3)
    both = torch.ones((n, 2), dtype=torch.bool, device=e.device)

    def count_front(r, t):
        poses = SE3(torch.stack([eye, r]).expand(n, 2, 3, 3),
                    torch.stack([torch.zeros_like(t), t]).expand(n, 2, 3))
        x, _ = triangulate_linear(poses, rays, both)
        z1 = x[:, 2]
        z2 = SE3(r, t).apply(x)[:, 2]
        return ((z1 > 0) & (z2 > 0) & mask).sum()

    cands = [(r_a, t_u), (r_a, -t_u), (r_b, t_u), (r_b, -t_u)]
    best = torch.argmax(torch.stack([count_front(r, t) for r, t in cands]))
    return SE3(torch.stack([c[0] for c in cands])[best],
               torch.stack([c[1] for c in cands])[best])
