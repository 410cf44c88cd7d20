"""Small-scale sequential SfM: match -> initialise -> triangulate
-> bundle adjust.

Port of ``vulkansift_tpu/sfm/reconstruction.py``. The device work
(matching, RANSAC, pose recovery, the pose graph, triangulation, BA) runs
on the device given to it; on a card the pairwise matching is the matcher
kernel (``csrc/match_2nn.cu`` through :func:`..ops.match.match_2nn_fused`).
The track bookkeeping (union-find over matches) stays on the host in
NumPy: it is pointer chasing with no parallel structure.

Randomness: one CPU ``torch.Generator`` seeded with ``seed`` feeds every
pair's RANSAC in turn, so the same seed draws the same hypotheses on the
card and on the CPU. The JAX package splits a ``jax.random`` key instead,
so the two packages draw different samples.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.match import lowe_ratio_mask, match_2nn_fused
from ..utils.device import DeviceLike, resolve_device
from .bundle_adjustment import BAProblem, bundle_adjust
from .geometry import (SE3, Camera, decompose_essential, ransac_essential,
                       triangulate_linear)


@dataclasses.dataclass
class Reconstruction:
    poses: np.ndarray        # (C, 6) world->cam tangents
    points: np.ndarray       # (P, 3)
    point_valid: np.ndarray  # (P,) bool
    initial_cost: float
    final_cost: float


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _se3(p: SE3) -> SE3:
    """A host pose as float32 CPU tensors."""
    return SE3(torch.as_tensor(p.r, dtype=torch.float32),
               torch.as_tensor(p.t, dtype=torch.float32))


def _pairwise_matches(feats: Sequence[np.ndarray], ratio: float,
                      max_pairs_gap: int, dev: torch.device):
    """Lowe-filtered 2-NN matches for frame pairs (i, j), j - i <= gap."""
    desc = [torch.from_numpy(np.ascontiguousarray(f["descriptor"])).to(dev)
            for f in feats]
    out = []
    for i in range(len(feats) - 1):
        for j in range(i + 1, min(i + 1 + max_pairs_gap, len(feats))):
            na, nb = len(feats[i]), len(feats[j])
            if na < 8 or nb < 8:
                continue
            m = match_2nn_fused(desc[i], na, desc[j], nb)
            keep = lowe_ratio_mask(m, ratio)[:na].cpu().numpy()
            ia = m.idx_a[:na].cpu().numpy()[keep]
            ib = m.idx_b1[:na].cpu().numpy()[keep]
            out.append((i, j, ia, ib))
    return out


def reconstruct_sequence(
        features: Sequence[np.ndarray], camera: Camera, *,
        ratio: float = 0.75,
        ransac_iters: int = 256,
        ransac_threshold: float = 2e-5,
        min_track_views: int = 2,
        ba_iters: int = 30,
        max_pairs_gap: int = 1,
        pose_graph_iters: int = 15,
        seed: int = 0,
        device: DeviceLike = "cuda") -> Reconstruction:
    """Reconstruct a camera trajectory and a sparse map from per-frame
    features (FEATURE_DTYPE arrays; x, y and the descriptors are used).

    Pipeline: pairwise essential-matrix RANSAC -> pose chaining ->
    pose-graph optimisation over all relative-pose edges (when
    ``max_pairs_gap`` > 1 adds loop closures) -> union-find tracks ->
    linear triangulation -> LM bundle adjustment (matrix-free Schur). Scale
    is fixed by unit baselines between consecutive views, and BA keeps it
    (``fix_scale``: the JAX package lets it drift). Runs on ``device``
    (default ``"cuda"``, raising without a card)."""
    dev = resolve_device(device)
    nb = len(features)
    if nb < 2:
        raise ValueError("need at least two frames")
    gen = torch.Generator().manual_seed(seed)
    matches = _pairwise_matches(features, ratio, max_pairs_gap, dev)

    # --- relative poses + inlier masks -----------------------------------
    rel: Dict[Tuple[int, int], SE3] = {}
    inliers: Dict[Tuple[int, int], np.ndarray] = {}
    for (i, j, ia, ib) in matches:
        if len(ia) < 8:   # too few for an 8-point hypothesis
            continue
        uv1 = np.stack([features[i]["x"][ia], features[i]["y"][ia]], 1)
        uv2 = np.stack([features[j]["x"][ib], features[j]["y"][ib]], 1)
        r1 = camera.unproject(torch.from_numpy(uv1).to(dev))
        r2 = camera.unproject(torch.from_numpy(uv2).to(dev))
        valid = torch.ones(len(ia), dtype=torch.bool, device=dev)
        e, inl, nin = ransac_essential(r1, r2, valid, gen,
                                       threshold=ransac_threshold,
                                       nb_iters=ransac_iters)
        if int(nin) < 8:
            continue
        # Cheirality vote over the inliers only: outliers can flip the
        # (R, t) branch.
        pose = decompose_essential(e, r1, r2, inl)
        rel[(i, j)] = SE3(pose.r.cpu().numpy(), pose.t.cpu().numpy())
        inliers[(i, j)] = inl.cpu().numpy()

    # --- chain consecutive poses (unit-baseline monocular gauge) ---------
    poses: List[SE3] = [SE3(np.eye(3), np.zeros(3))]
    for i in range(1, nb):
        if (i - 1, i) in rel:
            rp, prev = rel[(i - 1, i)], poses[i - 1]
            poses.append(SE3(rp.r @ prev.r, rp.r @ prev.t + rp.t))
        else:
            poses.append(poses[i - 1])

    # --- pose-graph optimisation over loop-closure edges -----------------
    # Nodes are the inverse poses S_i = T_i^{-1}, so that the graph's
    # Z_ij = S_i^{-1} S_j equals rel_ij^{-1} (rel_ij = T_j T_i^{-1}); the
    # unit-baseline measured translations are rescaled to the chained
    # estimate's edge baseline (monocular scale is unobservable per edge).
    if any(j - i > 1 for (i, j) in rel) and pose_graph_iters > 0:
        from .pose_graph import PoseGraph, optimize_pose_graph
        inv_tangents = np.stack([_se3(p).inverse().log().numpy()
                                 for p in poses])
        ei, ej, meas, wt = [], [], [], []
        for (i, j), rp in rel.items():
            er = poses[i].r @ poses[j].r.T           # est T_i T_j^{-1}
            et = poses[i].t - er @ poses[j].t
            scale = float(np.linalg.norm(et))
            mr = rp.r.T                              # rel_ij^{-1}
            mt = -rp.r.T @ rp.t
            mt = mt * (scale / max(float(np.linalg.norm(mt)), 1e-9))
            meas.append(_se3(SE3(mr, mt)).log().numpy())
            ei.append(i)
            ej.append(j)
            wt.append(float(inliers[(i, j)].sum()))
        graph = PoseGraph(
            poses=torch.from_numpy(inv_tangents).to(dev),
            edge_i=torch.tensor(ei, device=dev),
            edge_j=torch.tensor(ej, device=dev),
            meas=torch.from_numpy(np.stack(meas)).to(dev),
            weight=torch.tensor(wt, dtype=torch.float32, device=dev)
            / max(max(wt), 1.0))
        opt = optimize_pose_graph(graph, nb_iters=pose_graph_iters)
        s = SE3.from_tangent(opt.poses).inverse()
        poses = [SE3(r, t) for r, t in zip(s.r.cpu().numpy(),
                                            s.t.cpu().numpy())]

    # --- tracks via union-find over inlier matches ------------------------
    offsets = np.cumsum([0] + [len(f) for f in features])
    uf = _UnionFind(offsets[-1])
    for (i, j, ia, ib) in matches:
        inl = inliers.get((i, j))
        if inl is None:
            continue
        for a, b in zip(ia[inl], ib[inl]):
            uf.union(offsets[i] + a, offsets[j] + b)
    # Track ids in order of first appearance over (frame, feature).
    roots = np.array([uf.find(g) for g in range(offsets[-1])])
    _, first, inv = np.unique(roots, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    obs_pt = rank[inv].astype(np.int32)
    obs_cam = np.repeat(np.arange(nb), [len(f) for f in features]).astype(
        np.int32)
    obs_uv = np.concatenate([np.stack([f["x"], f["y"]], 1)
                             for f in features]).astype(np.float32)
    nb_tracks = len(first)

    # Keep tracks seen from >= min_track_views distinct cameras.
    views = np.zeros((nb_tracks, nb), bool)
    views[obs_pt, obs_cam] = True
    good = views.sum(1) >= min_track_views
    remap = -np.ones(nb_tracks, np.int64)
    remap[good] = np.arange(good.sum())
    keep = good[obs_pt]
    obs_cam, obs_uv = obs_cam[keep], obs_uv[keep]
    obs_pt = remap[obs_pt[keep]].astype(np.int32)
    nb_pts = int(good.sum())
    if nb_pts == 0:
        raise ValueError("no multi-view tracks; matching failed")

    # --- triangulate every track in one batch ----------------------------
    pose_r = torch.from_numpy(np.stack([p.r for p in poses]).astype(
        np.float32)).to(dev)
    pose_t = torch.from_numpy(np.stack([p.t for p in poses]).astype(
        np.float32)).to(dev)
    nviews = np.bincount(obs_pt, minlength=nb_pts)
    max_views = int(nviews.max())
    # Each track's observations in order, at columns 0 .. nviews - 1.
    order = np.argsort(obs_pt, kind="stable")
    col = np.arange(len(order)) - (np.cumsum(nviews) - nviews)[obs_pt[order]]
    tr_cam = np.zeros((nb_pts, max_views), np.int64)
    tr_uv = np.zeros((nb_pts, max_views, 2), np.float32)
    tr_msk = np.zeros((nb_pts, max_views), bool)
    tr_cam[obs_pt[order], col] = obs_cam[order]
    tr_uv[obs_pt[order], col] = obs_uv[order]
    tr_msk[obs_pt[order], col] = True
    cams = torch.from_numpy(tr_cam).to(dev)
    pts, ok = triangulate_linear(
        SE3(pose_r[cams], pose_t[cams]),
        camera.unproject(torch.from_numpy(tr_uv).to(dev)),
        torch.from_numpy(tr_msk).to(dev))

    # Drop observations of failed triangulations and any observation whose
    # initial reprojection is wild (bad track, point behind the camera):
    # BA cannot recover from a poisoned start.
    oc = torch.from_numpy(obs_cam.astype(np.int64)).to(dev)
    op = torch.from_numpy(obs_pt.astype(np.int64)).to(dev)
    uv_t = torch.from_numpy(obs_uv).to(dev)
    x_cam = SE3(pose_r[oc], pose_t[oc]).apply(pts[op])
    reproj_err = torch.linalg.norm(camera.project(x_cam) - uv_t, dim=1)
    obs_valid = ok[op] & (x_cam[:, 2] > 0.05) & (reproj_err < 30.0)

    # --- bundle adjust ----------------------------------------------------
    tangents = np.stack([_se3(p).log().numpy() for p in poses])
    problem = BAProblem(poses=torch.from_numpy(tangents).to(dev),
                        points=pts.to(torch.float32), cam_idx=oc, pt_idx=op,
                        uv=uv_t, valid=obs_valid, camera=camera)
    # CG converges in as many steps as there are free camera parameters
    # (exact arithmetic); fewer leave each step, and so the poses, to the
    # rounding of the sums.
    result = bundle_adjust(problem, nb_iters=ba_iters,
                           nb_cg_iters=max(20, 6 * (nb - 1) - 1),
                           fix_scale=True)
    return Reconstruction(
        poses=result.poses.cpu().numpy(),
        points=result.points.cpu().numpy(),
        point_valid=ok.cpu().numpy(),
        initial_cost=float(result.initial_cost),
        final_cost=float(result.final_cost))
