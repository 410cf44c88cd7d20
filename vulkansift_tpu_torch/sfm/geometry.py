"""SE(3)/SO(3) primitives, projection, triangulation, two-view geometry.

Port of ``vulkansift_tpu/sfm/geometry.py`` in float32. Every function
takes leading batch dimensions where the JAX package vmaps it, so that
RANSAC runs its hypotheses and the reconstruction its tracks as one
batch.

Conventions:
* Rotations: axis-angle vectors ``w`` (3,) with ``R = exp([w]x)``;
  world-to-camera: ``x_cam = R @ x_world + t``.
* Pixels: pinhole ``(fx, fy, cx, cy)``; no distortion (rectified inputs).

The 8-point solver's two small decompositions (the null vector of the
8x9 system, the rank-2 projection of E) are written out in float64, in a
fixed number of batched operations: inverse iteration on a Gram matrix
(``inv_ex``) and a closed form for the 3x3. ``torch.linalg.svd`` on a card
synchronises with the host, which a recorded program cannot hold. The
eager ``decompose_essential`` and the 3x3 solves go to ``torch.linalg``,
as the JAX package leaves them to XLA's library calls. On a card,
:func:`ransac_essential` replays a recorded program
(:class:`..compiled.LoopProgram`), one per ``(rows, nb_iters,
threshold)`` in an LRU of ``RANSAC_PROGRAMS``, the counterpart of the JAX
package's ``jax.jit``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from .. import compiled

_EPS = 1e-12

# Recorded RANSAC programs kept a device (``(rows, nb_iters, threshold)``
# keys; a reconstruction pads its pairs to powers of two).
RANSAC_PROGRAMS = 8
PROGRAMS = compiled.ProgramCache(RANSAC_PROGRAMS)

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

def _shift_invert(g: torch.Tensor, rel: float) -> torch.Tensor:
    """``(g + mu I)^-1`` for symmetric PSD ``g`` (..., n, n), ``mu`` =
    ``rel`` times its mean diagonal (and a floor that keeps a zero ``g``
    invertible). ``inv_ex``: ``inv`` checks its info on the host."""
    n = g.shape[-1]
    mu = rel * torch.diagonal(g, dim1=-2, dim2=-1).mean(-1) + 1e-100
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    return torch.linalg.inv_ex(g + mu[..., None, None] * eye).inverse


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _dominant(m: torch.Tensor, steps: int) -> torch.Tensor:
    """The unit eigenvector of the largest eigenvalue of symmetric ``m``
    (..., n, n) by power iteration, started from its largest column."""
    k = torch.argmax(torch.linalg.vector_norm(m, dim=-2), -1)
    x = _unit(torch.take_along_dim(m, k[..., None, None], -1)[..., 0])
    for _ in range(steps):
        x = _unit((m @ x[..., None])[..., 0])
    return x


def _null_vector(a: torch.Tensor) -> torch.Tensor:
    """Unit vector (..., 9) that ``a`` (..., m, 9), m >= 8, float64, maps
    closest to zero: the right singular vector of the smallest singular
    value, up to sign. Where ``a`` has a null space of more dimensions
    (repeated rows), one unit vector of it; never zero.

    Inverse iteration on the Gram matrix. With 8 rows (RANSAC's samples)
    the columns are first scaled to unit norm: rays over a narrow field
    give columns of very different sizes, whose Gram matrix would lose the
    null vector to rounding, and the null vector of the scaled system,
    scaled back, is the one of ``a``. With more rows the scaling would
    weigh the residuals otherwise, so the unscaled inverse is squared ten
    times (the smallest singular vector's share grows with the 1024th
    power of the gap) before its largest column is taken."""
    if a.shape[-2] <= 8:
        d = 1.0 / torch.clamp(torch.linalg.vector_norm(a, dim=-2),
                              min=1e-100)
        ad = a * d[..., None, :]
        y = _dominant(_shift_invert(ad.transpose(-1, -2) @ ad, 1e-13), 3)
        return _unit(y * d)
    m = _shift_invert(a.transpose(-1, -2) @ a, 1e-15)
    for _ in range(10):
        m = m @ m
        m = m / m.abs().amax((-2, -1), keepdim=True)
    return _dominant(m, 2)


def _rank2(e: torch.Tensor) -> torch.Tensor:
    """E (..., 3, 3), float64, with its two largest singular values
    replaced by their mean and the smallest by 0: ``u diag(m, m, 0) vt``
    from the SVD ``u diag(s) vt``, in closed form.

    With ``M = E' E`` (eigenvalues s0^2 >= s1^2 >= s2^2), its smallest
    eigenvalue comes from the trigonometric solution of the cubic, its
    eigenvector ``v2`` from the largest cross product of two rows of
    ``M - s2^2 I``, and on ``P = I - v2 v2'``
    ``u diag(m, m, 0) vt = E ((q + p) P - P M P) / (2 p)`` with
    ``q = s0^2 + s1^2`` and ``p = s0 s1``. A rank-1 E (p = 0) gives E / 2,
    never zero."""
    eye = torch.eye(3, dtype=e.dtype, device=e.device)
    m = e.transpose(-1, -2) @ e
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    b = m - (tr / 3)[..., None, None] * eye
    half = torch.sqrt((b * b).sum((-2, -1)) / 6)          # 0 if M = c I
    det = (b[..., 0, :] * torch.linalg.cross(b[..., 1, :], b[..., 2, :])
           ).sum(-1)
    r = torch.clamp(det / torch.clamp(2 * half ** 3, min=1e-300), -1.0, 1.0)
    low = tr / 3 + 2 * half * torch.cos(torch.acos(r) / 3 + 2 * torch.pi / 3)
    c = m - low[..., None, None] * eye
    cross = torch.linalg.cross(c, c.roll(-1, -2))          # rows i x i+1
    norm = torch.linalg.vector_norm(cross, dim=-1)
    k = torch.argmax(norm, -1)
    v = torch.take_along_dim(cross, k[..., None, None], -2)[..., 0, :]
    big = torch.take_along_dim(norm, k[..., None], -1)
    # All cross products zero: M = c I, any direction serves.
    v = torch.where(big > 0, v / torch.clamp(big, min=1e-300), eye[2])
    proj = eye - v[..., :, None] * v[..., None, :]
    q = tr - low
    p = torch.sqrt(torch.clamp(
        ((tr * tr - (m * m).sum((-2, -1))) / 2 - low * q), min=0.0))
    fixed = e @ ((q + p)[..., None, None] * proj - proj @ m @ proj) / (
        2 * torch.clamp(p, min=1e-300))[..., None, None]
    return torch.where((p > 0)[..., None, None], fixed, e * 0.5)


def essential_8pt(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """8-point essential matrix from >= 8 ray pairs (..., N, 3) each,
    with the rank-2 constraint enforced: (..., 3, 3). The null vector of
    the N x 9 system (:func:`_null_vector`) and the rank-2 projection
    (:func:`_rank2`) are computed in float64, in a fixed number of batched
    operations, and returned in the rays' type."""
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                     x1, y1, torch.ones_like(x1)], -1)
    e = _null_vector(a.to(torch.float64)).unflatten(-1, (3, 3))
    return _rank2(e).to(r1.dtype)


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


def _ransac(rays1: torch.Tensor, rays2: torch.Tensor, valid: torch.Tensor,
            u: torch.Tensor, threshold: float):
    """RANSAC from the (nb_iters, 8) uniform draws ``u``, on the rays'
    device, with no host synchronisation (a recorded program replays it)."""
    n = rays1.shape[0]
    nvalid = torch.clamp(valid.sum(), min=1)
    # Sample 8 valid indices per hypothesis (with replacement).
    ranks = (u * nvalid).to(torch.int64)
    cs = torch.cumsum(valid.to(torch.int64), 0)
    idx = torch.searchsorted(cs, ranks + 1).clamp(0, n - 1)
    es = essential_8pt(rays1[idx], rays2[idx])           # (iters, 3, 3)
    err = sampson_error(es, rays1, rays2)                # (iters, N)
    scores = ((err < threshold) & valid).sum(-1)
    e_best = torch.index_select(es, 0, torch.argmax(scores)[None])[0]
    inl = (sampson_error(e_best, rays1, rays2) < threshold) & valid
    return e_best, inl, inl.sum()


def _ransac_replayed(rays1: torch.Tensor, rays2: torch.Tensor,
                     valid: torch.Tensor, u: torch.Tensor, threshold: float):
    """RANSAC on a card: the recorded program of ``(N, nb_iters,
    threshold)`` (built at its first use), its draws copied in, replayed
    once."""
    dev, n = rays1.device, rays1.shape[0]
    inputs = (rays1, rays2, valid, u)

    def build(pool):
        results = (torch.zeros((3, 3), dtype=rays1.dtype, device=dev),
                   torch.zeros(n, dtype=torch.bool, device=dev),
                   torch.zeros((), dtype=torch.int64, device=dev))
        return compiled.LoopProgram(
            lambda state, static: _ransac(*static, threshold), results,
            inputs, pool=pool)

    with PROGRAMS.lock:
        prog = PROGRAMS.get((dev, n, u.shape[0], float(threshold)),
                            lambda: build(PROGRAMS.pool(dev)))
        return tuple(prog(1, inputs=inputs))


def ransac_essential(rays1: torch.Tensor, rays2: torch.Tensor,
                     valid: torch.Tensor, generator: torch.Generator, *,
                     threshold: float = 1e-5, nb_iters: int = 256):
    """RANSAC essential-matrix estimation, all hypotheses in one batch.

    Args:
      rays1/rays2: (N, 3) normalised rays per correspondence (padded).
      valid: (N,) bool; invalid rows never count as inliers.
      generator: a CPU ``torch.Generator``; the (nb_iters, 8) uniform
        draws come from it on the CPU and move to the rays' device, so a
        run on the card and one on the CPU draw the same samples.
      threshold: Sampson error inlier threshold (normalised coords^2).

    On a card it replays the recorded program of ``(N, nb_iters,
    threshold)``, built at its first call; the CPU runs the same function
    eagerly.

    Returns (E_best, inlier_mask, nb_inliers).
    """
    u = torch.rand((nb_iters, 8), generator=generator)
    if rays1.device.type == "cuda":
        return _ransac_replayed(rays1, rays2, valid, u, threshold)
    return _ransac(rays1, rays2, valid, u.to(rays1.device), threshold)


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
