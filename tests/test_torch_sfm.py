"""The port's SfM back end (``vulkansift_tpu_torch.sfm``) against the JAX
package's on the CPU, on ``tests/test_sfm.py``'s synthetic scenes.

Tolerances (float32 throughout):

* SO(3)/SE(3) and rays: 1e-5 (rotations, tangents, unit-scale points);
  pixels: rtol 1e-6 (a few float32 ulps); triangulated points: 1e-4;
* the 8-point E (up to sign and scale) and the pose recovered from one E:
  1e-4; Sampson errors: rtol 1e-3;
* RANSAC by outcome on a clean scene with 20 % outliers: the same inlier
  set as the JAX package, every outlier rejected, and the pose within the
  JAX test's bars (translation direction cos > 0.999, rotation 1e-3);
* ``bundle_adjust``, ``optimize_pose_graph`` and the distributed BA: the
  JAX test's bars (``tests/test_sfm.py:144-157``): costs rtol 1e-2, poses
  1e-3; the distributed BA runs on four gloo ranks;
* ``reconstruct_sequence``: the JAX end-to-end test's bars (final cost <
  1 px^2, relative rotations < 1 degree, ATE < 0.05);
* a checkpoint written by either package loads in the other, exactly.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_sfm
import torch_parallel_workers
from vulkansift_tpu import sfm as jsfm
from vulkansift_tpu.types import FEATURE_DTYPE
from vulkansift_tpu_torch import sfm as tsfm
from torch_threads import one_torch_thread  # noqa: F401

TCAM = tsfm.Camera(500.0, 500.0, 320.0, 240.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, jax_value, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(jax_value),
                               atol=atol, rtol=rtol)


def test_so3_se3_and_projection_match_jax():
    rng = np.random.default_rng(0)
    w = rng.uniform(-1.5, 1.5, (50, 3)).astype(np.float32)
    w[:3] = [[0, 0, 0], [1e-5, 0, 0], [0, 2e-4, 1e-4]]   # small-angle branches
    _close(tsfm.hat(_t(w)), jsfm.hat(jnp.asarray(w)), 0)
    r = tsfm.exp_so3(_t(w))
    _close(r, jsfm.exp_so3(jnp.asarray(w)), 1e-5)
    _close(tsfm.log_so3(r), jsfm.log_so3(jnp.asarray(r.numpy())), 1e-5)
    wt = rng.uniform(-1, 1, (2, 6)).astype(np.float32)
    x = rng.uniform(-1, 1, (3,)).astype(np.float32)
    ta, tb = (tsfm.SE3.from_tangent(_t(v)) for v in wt)
    ja, jb = (jsfm.SE3.from_tangent(jnp.asarray(v)) for v in wt)
    for tp, jp in ((ta.compose(tb), ja.compose(jb)),
                   (ta.inverse(), ja.inverse())):
        _close(tp.r, jp.r, 1e-5)
        _close(tp.t, jp.t, 1e-5)
        _close(tp.apply(_t(x)), jp.apply(jnp.asarray(x)), 1e-5)
        _close(tp.log(), jp.log(), 1e-5)
    pts = (rng.uniform(-2, 2, (40, 3)) + [0, 0, 8]).astype(np.float32)
    uv = tsfm.Camera.project(TCAM, _t(pts))
    _close(uv, test_sfm.CAM.project(jnp.asarray(pts)), 0, rtol=1e-6)
    _close(TCAM.unproject(uv), test_sfm.CAM.unproject(jnp.asarray(uv.numpy())),
           1e-5)
    _close(tsfm.geometry.reproject(_t(wt[0]), _t(pts), TCAM),
           jsfm.geometry.reproject(jnp.asarray(wt[0]), jnp.asarray(pts),
                                   test_sfm.CAM), 0, rtol=1e-6)


def test_triangulate_linear_matches_jax():
    rng = np.random.default_rng(2)
    poses_t = np.array([[0, 0, 0, 0, 0, 0], [0, 0.1, 0, -1.0, 0, 0],
                        [0.05, -0.1, 0, 1.0, 0.2, 0]], np.float32)
    x_true = (rng.uniform(-1, 1, (16, 3)) + [0, 0, 5]).astype(np.float32)
    jp = jsfm.SE3.from_tangent(jnp.asarray(poses_t))
    rays = np.stack([np.asarray(jp.apply(jnp.broadcast_to(jnp.asarray(x),
                                                          (3, 3))))
                     for x in x_true]).astype(np.float32)
    rays = rays / rays[..., 2:3]
    mask = np.ones((16, 3), bool)
    mask[3, 1:] = False                                  # one view: not ok
    tp = tsfm.SE3.from_tangent(_t(poses_t))
    x, ok = tsfm.triangulate_linear(
        tsfm.SE3(tp.r.expand(16, 3, 3, 3), tp.t.expand(16, 3, 3)),
        _t(rays), _t(mask))
    jx, jok = jax.vmap(lambda r, m: jsfm.triangulate_linear(jp, r, m))(
        jnp.asarray(rays), jnp.asarray(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _close(x[ok], np.asarray(jx)[ok.numpy()], 1e-4)
    _close(x[ok], x_true[ok.numpy()], 1e-4)


def _two_view_scene(n_out: int):
    """The JAX RANSAC test's scene (tests/test_sfm.py:87-99)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (128, 3))
    pts[:, 2] += 6.0
    rel_true = jsfm.SE3.from_tangent(jnp.asarray(
        [0.03, 0.2, -0.02, 1.0, 0.1, 0.05], jnp.float32))
    r1 = (pts / pts[:, 2:3]).astype(np.float32)
    p2 = np.asarray(rel_true.apply(jnp.asarray(pts, jnp.float32)))
    r2 = (p2 / p2[:, 2:3]).astype(np.float32)
    r2[:n_out, :2] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return r1, r2, rel_true


def test_two_view_geometry_matches_jax():
    r1, r2, _ = _two_view_scene(0)
    e = tsfm.essential_8pt(_t(r1[:8]), _t(r2[:8]))
    je = np.asarray(jsfm.essential_8pt(jnp.asarray(r1[:8]),
                                       jnp.asarray(r2[:8])))

    def unit(m):
        m = np.asarray(m) / np.linalg.norm(m)
        return m * np.sign(m.flat[np.argmax(np.abs(m))])

    _close(unit(e), unit(je), 1e-4)
    _close(tsfm.sampson_error(_t(je), _t(r1), _t(r2)),
           jsfm.sampson_error(jnp.asarray(je), jnp.asarray(r1),
                              jnp.asarray(r2)), 1e-12, rtol=1e-3)
    mask = np.ones(128, bool)
    tp = tsfm.decompose_essential(_t(je), _t(r1), _t(r2), _t(mask))
    jp = jsfm.decompose_essential(jnp.asarray(je), jnp.asarray(r1),
                                  jnp.asarray(r2), jnp.asarray(mask))
    _close(tp.r, jp.r, 1e-4)
    _close(tp.t, jp.t, 1e-4)


def test_ransac_essential_outcome_matches_jax():
    n_out = 25
    r1, r2, rel_true = _two_view_scene(n_out)
    valid = np.ones(128, bool)
    gen = torch.Generator().manual_seed(0)
    e, inl, nin = tsfm.ransac_essential(_t(r1), _t(r2), _t(valid), gen,
                                        threshold=1e-6, nb_iters=128)
    _, jinl, _ = jsfm.ransac_essential(
        jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(valid),
        jax.random.PRNGKey(0), threshold=1e-6, nb_iters=128)
    assert int(nin) >= 95
    assert not inl[:n_out].any()
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    pose = tsfm.decompose_essential(e, _t(r1), _t(r2), inl)
    t_est, t_true = pose.t.numpy(), np.asarray(rel_true.t)
    assert abs(t_est @ t_true) / (np.linalg.norm(t_est)
                                  * np.linalg.norm(t_true)) > 0.999
    _close(pose.r, rel_true.r, 1e-3)


def _port_problem(problem):
    return tsfm.BAProblem(*(_t(x) for x in problem[:6]), camera=TCAM)


def test_bundle_adjust_matches_jax():
    rng = np.random.default_rng(4)
    problem, _, _ = test_sfm._perturbed_problem(rng)
    jr = jsfm.bundle_adjust(problem, nb_iters=15, nb_cg_iters=25)
    tr = tsfm.bundle_adjust(_port_problem(problem), nb_iters=15,
                            nb_cg_iters=25)
    assert float(tr.final_cost) < 0.02 * float(tr.initial_cost)
    assert float(tr.final_cost) < 1.0
    _close(float(tr.initial_cost), float(jr.initial_cost), 0, rtol=1e-5)
    _close(float(tr.final_cost), float(jr.final_cost), 0, rtol=1e-2)
    _close(tr.poses, jr.poses, 1e-3)
    _close(tr.points, jr.points, 1e-3)


def test_pose_graph_matches_jax():
    rng = np.random.default_rng(6)
    n = 8
    ang = 2 * np.pi * np.arange(n) / n
    truth = np.stack([[0, 0, a, np.cos(a), np.sin(a), 0] for a in ang]
                     ).astype(np.float32)
    ts_ = jsfm.SE3.from_tangent(jnp.asarray(truth))
    meas = np.stack([np.asarray(jsfm.SE3(ts_.r[i], ts_.t[i]).inverse()
                                .compose(jsfm.SE3(ts_.r[(i + 1) % n],
                                                  ts_.t[(i + 1) % n])).log())
                     for i in range(n)])
    init = truth + 0.08 * rng.standard_normal(truth.shape).astype(np.float32)
    init[0] = truth[0]
    ei = np.arange(n, dtype=np.int32)
    ej = (ei + 1) % n
    jg = jsfm.PoseGraph(jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej),
                        jnp.asarray(meas), jnp.ones(n))
    tg = tsfm.PoseGraph(_t(init), _t(ei), _t(ej), _t(meas), torch.ones(n))
    _close(float(tsfm.pose_graph_cost(tg)), float(jsfm.pose_graph_cost(jg)),
           0, rtol=1e-4)
    tout = tsfm.optimize_pose_graph(tg, nb_iters=15)
    jout = jsfm.optimize_pose_graph(jg, nb_iters=15)
    assert float(tsfm.pose_graph_cost(tout)) < 1e-6
    _close(tout.poses, jout.poses, 1e-3)


def test_distributed_ba_on_four_ranks_matches_single(tmp_path):
    rng = np.random.default_rng(5)
    problem, _, _ = test_sfm._perturbed_problem(rng)
    d = str(tmp_path)
    np.savez(os.path.join(d, "ba_problem.npz"),
             **{f: np.asarray(getattr(problem, f)) for f in
                ("poses", "points", "cam_idx", "pt_idx", "uv", "valid")},
             camera=np.array([500.0, 500.0, 320.0, 240.0]))
    torch_parallel_workers.spawn(4, d, ["distributed_ba"])
    single = tsfm.bundle_adjust(_port_problem(problem), nb_iters=10,
                                nb_cg_iters=20)
    res = [np.load(os.path.join(d, f"distributed_ba.{r}.npz"))
           for r in range(4)]
    for r in res[1:]:                 # replicated state, the same everywhere
        np.testing.assert_array_equal(r["poses"], res[0]["poses"])
    r0 = res[0]
    assert float(r0["final_cost"]) < 0.05 * float(r0["initial_cost"])
    _close(float(r0["final_cost"]), float(single.final_cost), 0, rtol=1e-2)
    _close(r0["poses"], single.poses, 1e-3)


def _sequence_features(rng, nb_cams, nb_pts, noise_px, jitter=2):
    """Per-frame features of a synthetic scene with track-consistent u8
    descriptors (tests/test_sfm.py:176-193)."""
    poses_t, pts, cam_idx, pt_idx, uv = test_sfm._synthetic_scene(
        rng, nb_cams=nb_cams, nb_pts=nb_pts, noise_px=noise_px)
    descs = rng.integers(0, 256, (nb_pts, 128), dtype=np.uint8)
    feats = []
    for c in range(nb_cams):
        sel = cam_idx == c
        f = np.zeros(int(sel.sum()), FEATURE_DTYPE)
        f["x"], f["y"] = uv[sel, 0], uv[sel, 1]
        j = rng.integers(-jitter, jitter + 1, (len(f), 128))
        f["descriptor"] = np.clip(descs[pt_idx[sel]].astype(int) + j, 0, 255)
        feats.append(f)
    return poses_t, feats


def test_reconstruct_sequence_end_to_end():
    poses_t, feats = _sequence_features(np.random.default_rng(7), 4, 150,
                                        0.3)
    rec = tsfm.reconstruct_sequence(feats, TCAM, ratio=0.8, ransac_iters=128,
                                    ba_iters=40, seed=0, device="cpu")
    assert rec.final_cost < 1.0
    assert rec.final_cost < 0.2 * max(rec.initial_cost, 1e-6) or \
        rec.initial_cost < 1.0
    rot = tsfm.SE3.from_tangent(_t(rec.poses)).r.numpy()
    rot_t = tsfm.SE3.from_tangent(_t(poses_t)).r.numpy()
    for i in range(3):
        r_est = rot[i + 1] @ rot[i].T
        r_true = rot_t[i + 1] @ rot_t[i].T
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(r_est.T @ r_true) - 1) / 2, -1, 1)))
        assert ang < 1.0, f"pair {i}: {ang} deg rotation error"
    assert tsfm.absolute_trajectory_error(rec.poses, poses_t) < 0.05
    assert rec.point_valid.any()


def test_metrics_match_jax():
    rng = np.random.default_rng(11)
    est = rng.uniform(-1, 1, (6, 6)).astype(np.float32)
    gt = rng.uniform(-1, 1, (6, 6)).astype(np.float32)
    _close(tsfm.camera_centers(est), jsfm.camera_centers(est), 1e-5)
    for a, b in zip(tsfm.umeyama_alignment(est[:, 3:], gt[:, 3:]),
                    jsfm.umeyama_alignment(est[:, 3:], gt[:, 3:])):
        _close(a, b, 1e-12)
    _close(tsfm.absolute_trajectory_error(est, gt),
           jsfm.absolute_trajectory_error(est, gt), 1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(8)
    arrays = dict(poses=rng.random((4, 6)).astype(np.float32),
                  points=rng.random((50, 3)).astype(np.float32),
                  point_valid=rng.random(50) > 0.5)
    save, load, rec_cls = (
        (tsfm.save_reconstruction, jsfm.load_reconstruction,
         tsfm.Reconstruction) if writer == "port" else
        (jsfm.save_reconstruction, tsfm.load_reconstruction,
         jsfm.Reconstruction))
    rec = rec_cls(initial_cost=10.0, final_cost=0.1, **arrays)
    save(str(tmp_path / "ckpt"), rec)
    back = load(str(tmp_path / "ckpt"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(back, k), v)
    assert (back.initial_cost, back.final_cost) == (10.0, 0.1)


def test_bundle_adjust_fix_scale_holds_the_gauge():
    """``fix_scale`` holds the first camera and the largest translation
    coordinate of the others exactly, and converges at least as far as the
    JAX package's gauge (first camera's update zeroed after the solve)."""
    problem, _, _ = test_sfm._perturbed_problem(np.random.default_rng(4))
    p = _port_problem(problem)
    held = tsfm.bundle_adjustment._gauge_free(p.poses) == 0
    assert int(held.sum()) == 7 and bool(held[0].all())
    fixed = tsfm.bundle_adjust(p, nb_iters=15, nb_cg_iters=29,
                               fix_scale=True)
    free = tsfm.bundle_adjust(p, nb_iters=15, nb_cg_iters=29)
    np.testing.assert_array_equal(fixed.poses[held], p.poses[held])
    assert float(fixed.final_cost) < 0.02 * float(fixed.initial_cost)
    assert float(fixed.final_cost) <= float(free.final_cost)
    with pytest.raises(ValueError):
        tsfm.bundle_adjust(p, fix_scale=True, fix_first_pose=False)


# The summation-order scene: 8 cameras, 0.3 px noise, cut from the card
# check's 4096 points to 1536, the smallest size tried at which the three
# claims below hold and the JAX package's gauge still fails the noise floor
# (tried: 512 and 1024 points moved the poses by 7e-3 and 8e-3 under one
# of the shuffled orders).
ORDER_SCENE_POINTS = 1536
ORDER_KW = dict(ratio=0.8, ransac_iters=256, ba_iters=30, seed=0,
                device="cpu")


def _order_scene():
    return _sequence_features(np.random.default_rng(7), 8,
                              ORDER_SCENE_POINTS, 0.3)


def _noise_floor_bar(rec, feats) -> float:
    """5 % above the noise floor, 2 sigma^2 (1 - unknowns / residuals)."""
    nb_res = 2 * sum(len(f) for f in feats)
    nb_unknowns = 3 * len(rec.points) + 6 * len(feats) - 7
    return 1.05 * 2 * 0.3 ** 2 * (1 - nb_unknowns / nb_res)


def test_reconstruct_sequence_does_not_depend_on_the_summation_order(
        monkeypatch):
    """On an 8-camera scene (``ORDER_SCENE_POINTS`` points): BA's segment
    sums taken in two other orders (as the card's atomics take them) move
    the poses by no more than the card gate's 1e-3, and BA reaches the
    noise floor, 2 sigma^2 (1 - unknowns / residuals), within 5 %."""
    poses_t, feats = _order_scene()
    ref = tsfm.reconstruct_sequence(feats, TCAM, **ORDER_KW)
    assert ref.final_cost < _noise_floor_bar(ref, feats)
    assert tsfm.absolute_trajectory_error(ref.poses, poses_t) < 0.05
    plain = tsfm.bundle_adjustment._segment_sum
    for seed in (1, 2):
        gen = torch.Generator().manual_seed(seed)

        def shuffled(x, idx, n, psum):
            p = torch.randperm(len(idx), generator=gen)
            return plain(x[p], idx[p], n, psum)

        monkeypatch.setattr(tsfm.bundle_adjustment, "_segment_sum",
                            shuffled)
        rec = tsfm.reconstruct_sequence(feats, TCAM, **ORDER_KW)
        _close(rec.poses, ref.poses, 1e-3)


def test_summation_order_scene_needs_the_held_gauge(monkeypatch):
    """The summation-order test's scene is large enough to tell the gauges
    apart: with ``bundle_adjust``'s default gauge (the JAX package's: scale
    free, 20 CG steps) the reconstruction stays above the noise-floor bar
    that the held gauge meets."""
    _, feats = _order_scene()
    rec_mod = tsfm.reconstruct_sequence.__module__
    ba = tsfm.bundle_adjust

    def old_call(problem, *, nb_iters, nb_cg_iters, fix_scale):
        return ba(problem, nb_iters=nb_iters)

    monkeypatch.setattr(f"{rec_mod}.bundle_adjust", old_call)
    rec = tsfm.reconstruct_sequence(feats, TCAM, **ORDER_KW)
    assert rec.final_cost > _noise_floor_bar(rec, feats)
