"""The port's 2-NN matcher (``vulkansift_tpu_torch.ops.match``) against the
JAX package's, on the CPU: the plain ``match_2nn`` against JAX
``match_2nn`` and the golden serial scan on the cases of
tests/test_match.py, and ``match_2nn_fused`` (the kernel wrapper's plain
path on CPU tensors) against JAX ``match_2nn_fused`` with its Pallas kernel
in interpret mode. Every gate is bit-exact on the live rows: indices and
float32 distances.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vulkansift_tpu.golden import reference as gold
from vulkansift_tpu.ops import match as jmatch
from vulkansift_tpu.ops import pallas_match
from vulkansift_tpu_torch.ops import match
from torch_threads import one_torch_thread  # noqa: F401


def _rand_desc(rng, n):
    return rng.integers(0, 256, (n, 128), dtype=np.uint8)


def _case(name):
    """(a, count_a, b, count_b, tile) of one case of tests/test_match.py."""
    if name == "100x333":
        rng = np.random.default_rng(7)
        a, b = _rand_desc(rng, 100), _rand_desc(rng, 333)
        return a, 100, b, 333, 128
    if name == "identical_rows":
        rng = np.random.default_rng(8)
        a = _rand_desc(rng, 8)
        b = np.zeros((300, 128), np.uint8)
        b[:] = rng.integers(0, 256, (1, 128), dtype=np.uint8)
        return a, 8, b, 300, 64
    if name == "duplicated_rows":
        rng = np.random.default_rng(8)
        a = _rand_desc(rng, 8)
        rng.integers(0, 256, (1, 128), dtype=np.uint8)
        b = _rand_desc(rng, 200)
        b[70] = a[0]
        b[130] = a[0]
        return a, 8, b, 200, 64
    if name == "count_b_50_of_128":
        rng = np.random.default_rng(9)
        a, b = _rand_desc(rng, 16), _rand_desc(rng, 128)
        return a, 16, b, 50, 32
    assert name == "33x97"
    rng = np.random.default_rng(10)
    a, b = _rand_desc(rng, 33), _rand_desc(rng, 97)
    return a, 33, b, 97, 64


def _assert_same(m_port, m_jax, live):
    for name in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
        np.testing.assert_array_equal(getattr(m_port, name).numpy()[live],
                                      np.asarray(getattr(m_jax, name))[live],
                                      err_msg=name)


@pytest.mark.parametrize("case", ["100x333", "identical_rows",
                                  "duplicated_rows", "count_b_50_of_128",
                                  "33x97"])
def test_match_2nn_matches_jax_and_golden(case):
    a, ca, b, cb, tile = _case(case)
    m = match.match_2nn(torch.from_numpy(a), ca, torch.from_numpy(b), cb,
                        tile=tile)
    mj = jmatch.match_2nn(jnp.asarray(a), jnp.asarray(ca), jnp.asarray(b),
                          jnp.asarray(cb), tile=tile)
    _assert_same(m, mj, np.arange(len(a)) < ca)
    ref = gold.match_2nn_np(a, b[:cb])
    np.testing.assert_array_equal(m.idx_b1.numpy(), ref[:, 0])
    np.testing.assert_array_equal(m.idx_b2.numpy(), ref[:, 1])
    np.testing.assert_allclose(m.dist_a_b1.numpy(), ref[:, 2], rtol=1e-6)
    np.testing.assert_allclose(m.dist_a_b2.numpy(), ref[:, 3], rtol=1e-6)
    assert int(m.count) == ca
    if case == "identical_rows":
        assert (m.idx_b1.numpy() == 0).all() and (m.idx_b2.numpy() == 1).all()
    if case == "duplicated_rows":
        assert (int(m.idx_b1[0]), int(m.idx_b2[0])) == (70, 130)
        assert float(m.dist_a_b1[0]) == 0.0


@pytest.fixture
def jax_interpret(monkeypatch):
    """JAX's fused matcher with its Pallas kernel in interpret mode, as
    tests/test_match.py runs it on the CPU."""
    orig = pallas_match.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pallas_match.pl, "pallas_call", patched)


@pytest.mark.parametrize("case", ["1100x700_duplicates", "count_b_1"])
def test_match_2nn_fused_matches_jax_interpret(case, jax_interpret):
    if case == "1100x700_duplicates":
        rng = np.random.default_rng(11)
        a, b = _rand_desc(rng, 1100), _rand_desc(rng, 700)
        # Ties across tile boundaries.
        b[650] = b[10]
        b[600] = a[5]
        b[100] = a[5]
        ca, cb = 1030, 660
    else:
        rng = np.random.default_rng(12)
        a, b = _rand_desc(rng, 64), _rand_desc(rng, 64)
        ca, cb = 4, 1
    before = match.match_2nn_tiles.launches
    m = match.match_2nn_fused(torch.from_numpy(a), torch.tensor(ca),
                              torch.from_numpy(b),
                              torch.tensor(cb, dtype=torch.int32))
    assert match.match_2nn_tiles.launches == before  # CPU: plain version
    mj = jmatch.match_2nn_fused(jnp.asarray(a), jnp.asarray(ca),
                                jnp.asarray(b), jnp.asarray(cb))
    live = np.arange(len(a)) < ca
    _assert_same(m, mj, live)
    # Rows past count_a carry the "no neighbour" marker.
    assert np.isinf(m.dist_a_b1.numpy()[~live]).all()
    assert (m.idx_b1.numpy()[~live] == 0).all()
    if case == "count_b_1":
        assert np.isinf(m.dist_a_b2.numpy()[:ca]).all()
        assert (m.idx_b1.numpy()[:ca] == 0).all()
        assert (m.idx_b2.numpy()[:ca] == 0).all()
    else:
        assert int(m.idx_b1[5]) == 100 and float(m.dist_a_b1[5]) == 0.0
        assert int(m.idx_b2[5]) == 600


def test_raw_markers_and_count_b_zero():
    rng = np.random.default_rng(13)
    a = torch.from_numpy(_rand_desc(rng, 40))
    b = torch.from_numpy(_rand_desc(rng, 30))
    d1, i1, d2, i2 = match.match_2nn_tiles(a, 25, b, 0)
    assert (d1 == match.D2_INVALID).all() and (d2 == match.D2_INVALID).all()
    assert (i1 == 0).all() and (i2 == 0).all()
    d1, i1, d2, i2 = match.match_2nn_tiles(a, 25, b, 30)
    assert d1.dtype == torch.int32 and d1.shape == (40,)
    assert (d1[:25] < match.D2_INVALID).all()
    assert (d1[25:] == match.D2_INVALID).all() and (i2[25:] == 0).all()
    with pytest.raises(ValueError):
        match.match_2nn_tiles(a.float(), 25, b, 30)
    with pytest.raises(ValueError):
        match.match_2nn_tiles(a[:, :64], 25, b, 30)


def test_merge_top2_matches_jax_and_is_associative():
    rng = np.random.default_rng(14)

    def stream(n):
        # Sorted (d, i) pairs with many ties in d.
        d = np.sort(rng.integers(0, 4, (n, 2)), axis=1).astype(np.int32)
        i = rng.integers(0, 50, (n, 2)).astype(np.int32)
        swap = (d[:, 0] == d[:, 1]) & (i[:, 0] > i[:, 1])
        i[swap] = i[swap][:, ::-1]
        return d[:, 0], i[:, 0], d[:, 1], i[:, 1]

    x, y, z = stream(500), stream(500), stream(500)
    tx, ty, tz = ([torch.from_numpy(v) for v in s] for s in (x, y, z))
    got = match.merge_top2(tx, ty)
    want = jmatch._merge_top2([jnp.asarray(v) for v in x],
                              [jnp.asarray(v) for v in y])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    left = match.merge_top2(match.merge_top2(tx, ty), tz)
    right = match.merge_top2(tx, match.merge_top2(ty, tz))
    swapped = match.merge_top2(ty, tx)
    for u, v, w in zip(left, right, swapped):
        assert torch.equal(u, v)
    for u, w in zip(swapped, got):
        assert torch.equal(u, w)


def test_lowe_and_cross_check_match_jax():
    rng = np.random.default_rng(11)
    base = _rand_desc(rng, 60)
    noise = rng.integers(-4, 5, base.shape)
    b = np.clip(base.astype(int) + noise, 0, 255).astype(np.uint8)
    perm = rng.permutation(60)
    bp = np.ascontiguousarray(b[perm])
    m_ab = match.match_2nn(torch.from_numpy(base), 60, torch.from_numpy(bp), 60)
    m_ba = match.match_2nn(torch.from_numpy(bp), 60, torch.from_numpy(base), 60)
    j_ab = jmatch.match_2nn(jnp.asarray(base), jnp.asarray(60),
                            jnp.asarray(bp), jnp.asarray(60))
    j_ba = jmatch.match_2nn(jnp.asarray(bp), jnp.asarray(60),
                            jnp.asarray(base), jnp.asarray(60))
    np.testing.assert_array_equal(m_ab.idx_b1.numpy(), np.argsort(perm))
    ratio = match.lowe_ratio_mask(m_ab, 0.75).numpy()
    np.testing.assert_array_equal(
        ratio, np.asarray(jmatch.lowe_ratio_mask(j_ab, 0.75)))
    assert ratio.mean() > 0.95
    cc = match.cross_check_mask(m_ab, m_ba).numpy()
    np.testing.assert_array_equal(
        cc, np.asarray(jmatch.cross_check_mask(j_ab, j_ba)))
    assert cc.all()


def test_kernel_geometry_mirrors_the_cuda_defines():
    """ops/match.KERNEL_GEOMETRY is a copy of csrc/match_2nn.cu's tiling;
    the tie tests are placed from it, so it must not drift."""
    src = (Path(match.__file__).resolve().parent.parent / "csrc"
           / "match_2nn.cu").read_text()
    defines = dict((k, int(v)) for k, v in re.findall(
        r"^#define\s+(A_TILE|B_TILE|SLICES)\s+(\d+)", src, re.M))
    assert defines == {"A_TILE": match.KERNEL_GEOMETRY["a_tile_rows"],
                       "B_TILE": match.KERNEL_GEOMETRY["b_tile_rows"],
                       "SLICES": match.KERNEL_GEOMETRY["slices"]}


@pytest.mark.parametrize("count_b", [0, 1, 63, 64, 65, 1001, 16001, 16384])
def test_kernel_slices_cover_the_live_rows(count_b):
    g = match.KERNEL_GEOMETRY
    sl = match.kernel_slices(count_b)
    assert len(sl) == g["slices"]
    assert sl[0][0] == 0 and sl[-1][1] == count_b
    for (b0, e0), (b1, _) in zip(sl, sl[1:]):
        assert e0 == b1 and b0 <= e0
        # Every slice but the one holding count_b is whole B tiles.
        assert e0 == count_b or (e0 - b0) % g["b_tile_rows"] == 0


def _edge_case():
    """A at 300 rows with count_a = 290 (neither a multiple of the A tile),
    B at 1100 rows with count_b = 1001, and ties on the kernel's edges at
    that count: B rows duplicated across B-tile and slice edges, copies of
    one A row on both sides of a slice edge, and copies of A rows past
    count_b (they would win if they were read)."""
    g = match.KERNEL_GEOMETRY
    rng = np.random.default_rng(15)
    a, b = _rand_desc(rng, 300), _rand_desc(rng, 1100)
    ca, cb = 290, 1001
    assert ca % g["a_tile_rows"] and len(a) % g["a_tile_rows"]
    slice_edges = [s for s, e in match.kernel_slices(cb)[1:] if s < cb]
    tile = g["b_tile_rows"]
    for edge in [tile, 2 * tile] + slice_edges:
        b[edge] = b[edge - 1]
    e0, e1 = slice_edges[0], slice_edges[-1]
    b[e0 - 3] = a[5]
    b[e0 + 2] = a[5]
    b[e1 + 1] = a[6]
    b[e1 - 1] = a[6]
    b[cb:] = a[:len(b) - cb]
    return a, ca, b, cb, (e0, e1)


def test_top2_plain_on_kernel_edges_matches_jax_and_golden():
    a, ca, b, cb, (e0, e1) = _edge_case()
    m = match.match_2nn(torch.from_numpy(a), ca, torch.from_numpy(b), cb)
    mj = jmatch.match_2nn(jnp.asarray(a), jnp.asarray(ca), jnp.asarray(b),
                          jnp.asarray(cb))
    live = np.arange(len(a)) < ca
    _assert_same(m, mj, live)
    ref = gold.match_2nn_np(a[:ca], b[:cb])
    np.testing.assert_array_equal(m.idx_b1.numpy()[:ca], ref[:, 0])
    np.testing.assert_array_equal(m.idx_b2.numpy()[:ca], ref[:, 1])
    assert (int(m.idx_b1[5]), int(m.idx_b2[5])) == (e0 - 3, e0 + 2)
    assert (int(m.idx_b1[6]), int(m.idx_b2[6])) == (e1 - 1, e1 + 1)
    assert np.isinf(m.dist_a_b1.numpy()[~live]).all()


def test_match_2nn_fused_on_kernel_edges_matches_jax_interpret(jax_interpret):
    a, ca, b, cb, _ = _edge_case()
    m = match.match_2nn_fused(torch.from_numpy(a), torch.tensor(ca),
                              torch.from_numpy(b),
                              torch.tensor(cb, dtype=torch.int32))
    mj = jmatch.match_2nn_fused(jnp.asarray(a), jnp.asarray(ca),
                                jnp.asarray(b), jnp.asarray(cb))
    live = np.arange(len(a)) < ca
    _assert_same(m, mj, live)
    raw = match.top2_plain(torch.from_numpy(a), ca, torch.from_numpy(b), cb)
    assert (raw[0][~torch.from_numpy(live)] == match.D2_INVALID).all()
