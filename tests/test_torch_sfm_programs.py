"""The SfM back end's recorded programs, checked on the CPU, where each
runs the function its program records, eagerly.

* the written-out 8-point solver (inverse iteration on a Gram matrix and
  a closed-form rank-2 projection, in float64) against
  ``torch.linalg.svd`` and the JAX ``essential_8pt``: E unit-normalised
  and compared up to sign within 1e-4, with 8 rows and with more; on
  samples with repeated rows (a rank-deficient system) the null vector is
  a unit vector of the null space, never zero (a zero E would make every
  row an inlier);
* RANSAC and BA padded as the JAX ``reconstruct_sequence`` pads them give
  the outcome of the unpadded inputs (RANSAC byte for byte; BA poses
  within 1e-5 and costs within rtol 1e-5, the mean's sum taken over more
  zeros), and the port pads to the JAX package's shapes on the same scene;
* ``lm_iteration`` chained ``nb_iters`` times is ``bundle_adjust`` byte
  for byte, and both meet ``tests/test_torch_sfm.py``'s bars against the
  JAX ``bundle_adjust`` (costs rtol 1e-2, poses and points 1e-3);
* ``compiled.ProgramCache`` keeps its programs in LRU order and closes
  those it drops; the programs' plumbing (graphs replaced by calls)
  equals the eager paths, from several threads at once too.

Graph replay against the eager paths is checked on the card by
``chip_smoke.py`` (its ``compiled_sfm`` line); ``LoopProgram``'s refusal
on the CPU and under ``force_plain`` is in ``tests/test_torch_programs.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import program_stubs
import test_sfm
from test_torch_sfm import TCAM, _port_problem, _sequence_features
from vulkansift_tpu import sfm as jsfm
from vulkansift_tpu.sfm import reconstruction as jrec
from vulkansift_tpu_torch import compiled, sfm as tsfm
from vulkansift_tpu_torch.sfm import bundle_adjustment as tba
from vulkansift_tpu_torch.sfm import geometry as tgeo
from vulkansift_tpu_torch.sfm import reconstruction as trec
from torch_threads import one_torch_thread  # noqa: F401


def _rays(rng, batch, n, spread):
    """``batch`` sets of ``n`` ray pairs, the second a small motion of the
    first, spread over ``spread`` of the normalised image plane."""
    r1 = (rng.uniform(-0.5, 0.5, (batch, n, 3)) * spread).astype(np.float32)
    r1[..., 2] = 1.0
    r2 = r1 + (0.02 * spread * rng.standard_normal((batch, n, 3))
               ).astype(np.float32)
    r2[..., 2] = 1.0
    return r1, r2


def _assert_close_up_to_sign(e, ref, atol):
    """E and the reference, each scaled to unit norm, agree within
    ``atol`` once E takes the sign that points it the reference's way."""
    e, ref = (np.asarray(x, np.float64) for x in (e, ref))
    e = e / np.linalg.norm(e, axis=(-2, -1), keepdims=True)
    ref = ref / np.linalg.norm(ref, axis=(-2, -1), keepdims=True)
    sign = np.sign((e * ref).sum((-2, -1)))
    np.testing.assert_allclose(e * sign[:, None, None], ref, atol=atol)


def _svd_essential(r1, r2):
    """The 8-point E through ``torch.linalg.svd`` in float64 (the port's
    solver before it was written out, which ran in float32)."""
    x1, y1, x2, y2 = r1[..., 0], r1[..., 1], r2[..., 0], r2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1).double()
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    u, s, vt2 = torch.linalg.svd(vt[..., -1, :].reshape(-1, 3, 3))
    m = (s[..., 0] + s[..., 1]) * 0.5
    fixed = torch.stack([m, m, torch.zeros_like(m)], -1)
    return (u * fixed[..., None, :]) @ vt2


@pytest.mark.parametrize("spread", [1.0, 0.5, 0.3, 0.05])
def test_essential_8pt_matches_svd_and_jax(spread):
    """Against the float64 SVD at every spread; against the JAX package's
    float32 SVD where the rays span half the image plane or more (a 640x480
    frame at f = 500 spans 1.28 x 0.96): on narrower rays float32 SVDs are
    off by more than the bar (the JAX one and torch's float32 one differ
    by 1e-4 at 0.3 and 2.6e-3 at 0.05 on these rays)."""
    r1, r2 = _rays(np.random.default_rng(1), 64, 8, spread)
    e = tsfm.essential_8pt(torch.from_numpy(r1), torch.from_numpy(r2))
    ref = _svd_essential(torch.from_numpy(r1), torch.from_numpy(r2))
    assert e.dtype == torch.float32 and e.shape == (64, 3, 3)
    _assert_close_up_to_sign(e, ref, 1e-4)
    if spread >= 0.5:
        jax_e = jax.vmap(jsfm.essential_8pt)(jnp.asarray(r1),
                                             jnp.asarray(r2))
        _assert_close_up_to_sign(e, jax_e, 1e-4)


def test_essential_8pt_on_repeated_samples():
    """RANSAC draws with replacement: repeated rows leave a null space of
    two or more dimensions. The solver returns a unit vector of it, and an
    E that is finite and far from zero."""
    rng = np.random.default_rng(2)
    r1, r2 = _rays(rng, 32, 8, 0.5)
    r1[:16, 1], r2[:16, 1] = r1[:16, 0], r2[:16, 0]      # one repeat
    r1[16:, 3:], r2[16:, 3:] = r1[16:, :1], r2[16:, :1]  # five repeats
    t1, t2 = torch.from_numpy(r1), torch.from_numpy(r2)
    x1, y1, x2, y2 = t1[..., 0], t1[..., 1], t2[..., 0], t2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1).double()
    v = tgeo._null_vector(a)
    np.testing.assert_allclose(torch.linalg.vector_norm(v, dim=-1), 1.0,
                               atol=1e-12)
    assert float((a @ v[..., None]).abs().max()) < 1e-12
    e = tsfm.essential_8pt(t1, t2)
    assert torch.isfinite(e).all()
    assert float(torch.linalg.matrix_norm(e).min()) > 0.4
    # Not every correspondence is an inlier of such an E.
    q1, q2 = _rays(rng, 1, 64, 0.5)
    err = tsfm.sampson_error(e, torch.from_numpy(q1[0]),
                             torch.from_numpy(q2[0]))
    assert bool((err > 0).any(-1).all())


def _svd_rank2(e):
    u, sv, vt = torch.linalg.svd(e)
    m = (sv[..., 0] + sv[..., 1]) * 0.5
    return (u * torch.stack([m, m, torch.zeros_like(m)], -1)[..., None, :]
            ) @ vt


@pytest.mark.parametrize("singular", [None, (1.0, 1.0, 0.0),
                                      (1.0, 1.0, 1e-9), (1.0, 0.5, 0.49)])
def test_rank2_projection_matches_svd(singular):
    """The closed-form projection against the SVD's on random E and on E
    of given singular values, an essential one (two equal, the cubic's
    repeated root) among them."""
    g = torch.Generator().manual_seed(5)
    e = torch.randn((256, 3, 3), generator=g, dtype=torch.float64)
    if singular is not None:
        u = torch.linalg.qr(e)[0]
        v = torch.linalg.qr(torch.randn((256, 3, 3), generator=g,
                                        dtype=torch.float64))[0]
        e = (u * torch.tensor(singular, dtype=torch.float64)) \
            @ v.transpose(-1, -2)
    np.testing.assert_allclose(tgeo._rank2(e), _svd_rank2(e), atol=1e-9)


def test_rank2_projection_of_rank_one_is_not_zero():
    """A rank-1 E keeps at least half its norm; only a zero E gives 0."""
    e = torch.tensor([[1.0, 2.0, 0.5]], dtype=torch.float64).T \
        @ torch.tensor([[0.3, -1.0, 2.0]], dtype=torch.float64)
    fixed = tgeo._rank2(e[None])[0]
    assert torch.isfinite(fixed).all()
    # The SVD's second pair is any one there; its mean keeps half of s0.
    assert float(torch.linalg.matrix_norm(fixed)) \
        >= 0.499 * float(torch.linalg.matrix_norm(e))
    assert float(torch.linalg.matrix_norm(
        tgeo._rank2(torch.zeros((1, 3, 3), dtype=torch.float64)))) == 0.0


@pytest.mark.parametrize("spread", [1.0, 0.3, 0.05])
def test_essential_8pt_from_more_rows_matches_svd(spread):
    """32 ray pairs: the least-squares null vector, against the float64
    SVD; against the JAX package's float32 SVD at the widest spread."""
    r1, r2 = _rays(np.random.default_rng(8), 32, 32, spread)
    e = tsfm.essential_8pt(torch.from_numpy(r1), torch.from_numpy(r2))
    ref = _svd_essential(torch.from_numpy(r1), torch.from_numpy(r2))
    _assert_close_up_to_sign(e, ref, 1e-4)
    if spread >= 0.5:
        jax_e = jax.vmap(jsfm.essential_8pt)(jnp.asarray(r1),
                                             jnp.asarray(r2))
        _assert_close_up_to_sign(e, jax_e, 1e-4)


def _two_view(n, n_out):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (n, 3))
    pts[:, 2] += 6.0
    rel = tsfm.SE3.from_tangent(torch.tensor(
        [0.03, 0.2, -0.02, 1.0, 0.1, 0.05]))
    r1 = (pts / pts[:, 2:3]).astype(np.float32)
    p2 = rel.apply(torch.from_numpy(pts.astype(np.float32))).numpy()
    r2 = (p2 / p2[:, 2:3]).astype(np.float32)
    r2[:n_out, :2] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return torch.from_numpy(r1), torch.from_numpy(r2)


def test_padded_ransac_has_the_unpadded_outcome():
    n = 100
    r1, r2 = _two_view(n, 20)
    npad = trec.ransac_rows(n)
    assert npad == 128
    pad = torch.zeros((npad - n, 3))
    runs = []
    for rays1, rays2, valid in (
            (r1, r2, torch.ones(n, dtype=torch.bool)),
            (torch.cat([r1, pad]), torch.cat([r2, pad]),
             torch.arange(npad) < n)):
        gen = torch.Generator().manual_seed(0)
        runs.append(tsfm.ransac_essential(rays1, rays2, valid, gen,
                                          threshold=1e-6, nb_iters=64))
    (e, inl, nin), (pe, pinl, pnin) = runs
    assert e.numpy().tobytes() == pe.numpy().tobytes()
    assert torch.equal(inl, pinl[:n]) and not pinl[n:].any()
    assert int(nin) == int(pnin) >= 75


def test_padded_ba_has_the_unpadded_outcome():
    problem, _, _ = test_sfm._perturbed_problem(np.random.default_rng(4))
    n = 900                                    # of 1024 observations
    p = _port_problem(problem)
    p = p._replace(cam_idx=p.cam_idx[:n], pt_idx=p.pt_idx[:n], uv=p.uv[:n],
                   valid=p.valid[:n])
    rows = trec.ba_rows(n)
    assert rows > n and rows & (rows - 1) == 0

    def padded(t):
        return torch.cat([t, t.new_zeros((rows - n,) + t.shape[1:])])

    pp = p._replace(cam_idx=padded(p.cam_idx), pt_idx=padded(p.pt_idx),
                    uv=padded(p.uv), valid=padded(p.valid))
    kw = dict(nb_iters=10, nb_cg_iters=29, fix_scale=True)
    a, b = tsfm.bundle_adjust(p, **kw), tsfm.bundle_adjust(pp, **kw)
    np.testing.assert_allclose(b.poses, a.poses, atol=1e-5)
    np.testing.assert_allclose(b.points, a.points, atol=1e-5)
    for f in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(b, f)),
                                   float(getattr(a, f)), rtol=1e-5)


def test_padded_shapes_match_jax(monkeypatch):
    """Both packages' ``reconstruct_sequence`` on the same scene, with each
    RANSAC and BA call's input rows and live count recorded: for the
    counts the JAX package met, the port pads to the rows it padded to
    (RANSAC ``max(64, next power of two)`` of the matches, BA the next
    power of two of the observations), and the port's own calls follow
    the same rule. (The live counts themselves follow each package's
    draws.)"""
    _, feats = _sequence_features(np.random.default_rng(7), 4, 150, 0.3)
    calls = {"jax": [], "port": []}

    def ransac_rows_of(args):
        valid = np.asarray(args[2])
        return valid.shape[0], int(valid.sum())   # valid: the first n rows

    def ba_rows_of(args):
        uv = np.asarray(args[0].uv)
        # Padding rows are zero rows (camera 0, point 0, uv 0).
        return uv.shape[0], int(np.flatnonzero(uv.any(-1))[-1]) + 1

    for mod, who in ((jrec, "jax"), (trec, "port")):
        for name, rows_of in (("ransac_essential", ransac_rows_of),
                              ("bundle_adjust", ba_rows_of)):
            def wrapped(*args, _real=getattr(mod, name), _name=name,
                        _who=who, _rows_of=rows_of, **kw):
                calls[_who].append((_name, *_rows_of(args)))
                return _real(*args, **kw)

            monkeypatch.setattr(mod, name, wrapped)
    kw = dict(ratio=0.8, ransac_iters=32, ba_iters=2, seed=0)
    jsfm.reconstruct_sequence(feats, test_sfm.CAM, **kw)
    tsfm.reconstruct_sequence(feats, TCAM, device="cpu", **kw)
    pad = {"ransac_essential": trec.ransac_rows,
           "bundle_adjust": trec.ba_rows}
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]] \
        == ["ransac_essential"] * 3 + ["bundle_adjust"]
    for name, rows, n in calls["jax"] + calls["port"]:
        assert rows == pad[name](n), (name, rows, n)


def test_lm_iterations_are_bundle_adjust():
    rng = np.random.default_rng(4)
    problem, _, _ = test_sfm._perturbed_problem(rng)
    p = _port_problem(problem)
    iters, cg = 15, 25
    res = tsfm.bundle_adjust(p, nb_iters=iters, nb_cg_iters=cg)
    state = tba.LMState(p.poses, p.points, torch.tensor(1e-3))
    for _ in range(iters):
        state = tba.lm_iteration(state, p, nb_cg_iters=cg, huber_delta=3.0,
                                 fix_first_pose=True)
    for got, want in ((state.poses, res.poses), (state.points, res.points)):
        assert got.numpy().tobytes() == want.numpy().tobytes()
    jr = jsfm.bundle_adjust(problem, nb_iters=iters, nb_cg_iters=cg)
    np.testing.assert_allclose(float(res.initial_cost),
                               float(jr.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(res.final_cost), float(jr.final_cost),
                               rtol=1e-2)
    np.testing.assert_allclose(state.poses, jr.poses, atol=1e-3)
    np.testing.assert_allclose(state.points, jr.points, atol=1e-3)


class _Stub:
    def __init__(self, name, closed):
        self.name, self._closed = name, closed

    def close(self):
        self._closed.append(self.name)


def test_program_cache_is_an_lru():
    closed, built = [], []
    cache = compiled.ProgramCache(2)

    def build(name):
        def make():
            built.append((name, list(closed)))
            return _Stub(name, closed)
        return make

    a = cache.get("a", build("a"))
    cache.get("b", build("b"))
    assert cache.get("a", build("a2")) is a          # a hit moves a last
    cache.get("c", build("c"))                       # drops b, then builds
    assert closed == ["b"] and built[-1] == ("c", ["b"])
    assert list(cache) == ["a", "c"] and cache["c"].name == "c"
    assert [p.name for p in cache.values()] == ["a", "c"]
    dev = torch.device("cpu")
    assert cache.pool(dev) is cache.pool(dev)        # one pool a device
    cache.get("f", lambda: (lambda x: x))            # no close(): kept as is
    cache.close()
    assert closed == ["b", "a", "c"] and not cache


class _CallGraph:
    """Stands in for a captured CUDA graph: a replay calls the function
    the program recorded."""

    def __init__(self, run):
        self.replay = run

    def reset(self):
        pass


@pytest.fixture
def graphs_as_calls(monkeypatch):
    """``compiled._Program`` with the CUDA graph replaced by a call of the
    recorded function, so that the SfM programs' own plumbing (static
    buffers, chained state, results copied out, the LRU) runs on the CPU.
    The graph itself is checked on the card."""
    def record(self, device, run, pool):
        self.device, self._pool = device, pool or compiled.GraphPool()
        self._pool.acquire = lambda: None
        self._graph, self.replays, self._launches = _CallGraph(run), 0, {}
        self._outputs = []

    monkeypatch.setattr(compiled._Program, "_record", record)
    program_stubs.card_stubs(monkeypatch)


def test_program_plumbing_equals_the_eager_paths(graphs_as_calls):
    """Each SfM program's step, run through ``LoopProgram`` and its
    ``ProgramCache`` (graph replaced by a call), equals the eager path
    byte for byte, at a second call with other values too."""
    from vulkansift_tpu_torch.sfm import pose_graph as tpg
    problem, _, _ = test_sfm._perturbed_problem(np.random.default_rng(4))
    p = _port_problem(problem)
    cache = compiled.ProgramCache(2)
    kw = dict(nb_iters=6, init_lambda=1e-3, fix_scale=True, nb_cg_iters=29,
              huber_delta=3.0, fix_first_pose=True)
    for poses in (p.poses, p.poses + 0.01):
        q = p._replace(poses=poses)
        got = tba._replayed(q, programs=cache, key="k", **kw)
        want = tsfm.bundle_adjust(q, nb_iters=6, nb_cg_iters=29,
                                  fix_scale=True)
        for f in got._fields:
            assert getattr(got, f).numpy().tobytes() == \
                getattr(want, f).numpy().tobytes(), f
    assert len(cache) == 1 and cache.values()[0].replays == 12

    n = 6
    rng = np.random.default_rng(6)
    ei = np.arange(n)
    graph = tsfm.PoseGraph(
        torch.from_numpy(rng.normal(0, 0.1, (n, 6)).astype(np.float32)),
        torch.from_numpy(ei), torch.from_numpy((ei + 1) % n),
        torch.from_numpy(rng.normal(0, 0.1, (n, 6)).astype(np.float32)),
        torch.ones(n))
    got = tpg._replayed(graph, 5, 1e-6)
    want = tsfm.optimize_pose_graph(graph, nb_iters=5)
    assert got.poses.numpy().tobytes() == want.poses.numpy().tobytes()
    tpg.PROGRAMS.close()

    r1, r2 = _two_view(100, 20)
    valid = torch.arange(100) < 90
    for seed in (0, 1):
        u = torch.rand((32, 8), generator=torch.Generator().manual_seed(seed))
        got = tgeo._ransac_replayed(r1, r2, valid, u, 1e-6)
        want = tgeo._ransac(r1, r2, valid, u, 1e-6)
        for a, b in zip(got, want):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    tgeo.PROGRAMS.close()


def test_programs_serve_threads(graphs_as_calls):
    """Four threads call one RANSAC program at once (its static buffers
    shared; the cache's lock keeps the calls apart): every result is its
    eager one, and ``sfm.close_programs`` empties the cache."""
    import threading
    r1, r2 = _two_view(100, 20)
    valid = torch.arange(100) < 90
    results = {}

    def work(t):
        try:
            for k in range(8):
                u = torch.rand((32, 8), generator=torch.Generator(
                    ).manual_seed(10 * t + k))
                got = tgeo._ransac_replayed(r1, r2, valid, u, 1e-6)
                want = tgeo._ransac(r1, r2, valid, u, 1e-6)
                results[t, k] = all(torch.equal(a, b)
                                    for a, b in zip(got, want))
        except Exception as e:  # noqa: BLE001
            results[t, "error"] = repr(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(results) == 32 and all(v is True for v in results.values())
    assert len(tgeo.PROGRAMS) == 1
    tsfm.close_programs()
    assert not tgeo.PROGRAMS
