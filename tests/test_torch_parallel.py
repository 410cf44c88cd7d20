"""The port's multi-device package (``vulkansift_tpu_torch.parallel``) in
four gloo processes on the CPU, against the JAX package's
``parallel`` on its 8-device virtual mesh.

One spawn of four ranks (``torch.multiprocessing``, a ``file://`` store,
workers in ``torch_parallel_workers``) runs every multi-process case; the
tests read what the ranks wrote.

* dp detect: each frame of the gathered batch against the JAX
  ``make_dp_detect_fn`` (XLA back half) with the JAX package's own bar for
  a dp detect (``tests/test_pipeline_parallel.py:80-91``): the same count
  and positions row for row within 1e-3 px; and bit for bit against the
  port's single-image detect;
* ring match on meshes of 4, 3 and 2 ranks: every row bit-identical to
  the port's single-device ``match_2nn_fused`` (rows past ``count_a``
  included), and the live rows' indices and distance bits identical to
  the JAX ``make_ring_match_fn``, at counts that do not divide by the mesh
  size and with ties across shards (``tests/test_pipeline_parallel.py``);
* the one-process n-shard fold (n = 4 and 3) bit-identical to
  ``match_2nn_fused``;
* ``measure_dp_scaling`` over 1, 2 and 4 ranks;
* ``spawn_ranks`` raises for a failed rank and kills ranks that outlive
  its timeout.
"""

import dataclasses
import json
import os
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_image
import torch_parallel_workers
import vulkansift_tpu as jvs
from vulkansift_tpu.config import SiftConfig
from vulkansift_tpu.parallel import make_dp_detect_fn as jax_dp_detect
from vulkansift_tpu.parallel import make_mesh as jax_mesh
from vulkansift_tpu.parallel import make_ring_match_fn as jax_ring
from vulkansift_tpu.parallel import shard_batch as jax_shard
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.ops.match import match_2nn_fused
from vulkansift_tpu_torch.parallel.mesh import spawn_ranks
from vulkansift_tpu_torch.parallel.ring_match import (finish, fold_shards,
                                                     pad_rows)
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
CFG = SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                 sift_buffer_count=1, input_image_max_size=128 * 96)
H, W = 96, 128


def _ring_cases():
    def u8(n, seed):
        return np.random.default_rng(seed).integers(0, 256, (n, 128),
                                                    dtype=np.uint8)

    ties_a = u8(8, 22)
    ties_b = np.repeat(ties_a[:1], 64, axis=0)   # every B row = A row 0
    # Copies of one A row on both sides of every shard edge, for 2, 3 and
    # 4 shards of 101 rows padded to 102 and 104.
    edge_a, edge_b = u8(40, 24), u8(101, 25)
    for e in (26, 34, 51, 52, 68, 78):
        edge_b[e - 1] = edge_b[e] = edge_a[5]
    return {
        "exact": (u8(256, 26), u8(512, 27), 250, 505),
        "ragged": (u8(250, 28), u8(505, 29), 247, 501),
        "ties": (ties_a, ties_b, 8, 64),
        "edge_ties": (edge_a, edge_b, 37, 99),
        "one_live_b": (u8(30, 30), u8(30, 31), 30, 1),
        "no_live_b": (u8(30, 32), u8(30, 33), 30, 0),
    }


RING_CASES = _ring_cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once; returns the directory they wrote."""
    d = str(tmp_path_factory.mktemp("ranks"))
    images = np.stack([make_blob_image(H, W, seed=s) for s in range(8)])
    np.save(os.path.join(d, "dp_images.npy"), images)
    with open(os.path.join(d, "dp_config.json"), "w") as f:
        json.dump({k: (v.value if hasattr(v, "value") else v)
                   for k, v in dataclasses.asdict(CFG).items()}, f)
    cases = {}
    for name, (a, b, ca, cb) in RING_CASES.items():
        cases.update({f"{name}:a": a, f"{name}:b": b,
                      f"{name}:counts": np.array([ca, cb])})
    np.savez(os.path.join(d, "ring_cases.npz"), **cases)
    torch_parallel_workers.spawn(WORLD, d, ["dp_detect", "ring_match",
                                            "scaling"])
    return d


def _rank_files(d, name):
    return [np.load(os.path.join(d, f"{name}.{r}.npz")) for r in range(WORLD)]


def test_dp_detect_matches_jax_mesh_and_single_detect(ranks):
    images = np.load(os.path.join(ranks, "dp_images.npy"))
    frames = {}
    for part in _rank_files(ranks, "dp_detect"):
        frames.update({k: part[k] for k in part.files})
    assert sorted(frames) == [f"frame{i}" for i in range(8)]
    mesh = jax_mesh(8)
    j_out = jax_dp_detect(CFG, W, H, mesh, backhalf="xla")(
        jax_shard(images, mesh))
    single = vt.make_detect_fn(vt.from_reference_dict(
        dataclasses.asdict(CFG)), W, H, device="cpu")
    for i in range(8):
        ta = frames[f"frame{i}"]
        # The rank's batched detect is the single-image path, bit for bit.
        ref = vt.features_to_numpy(single(images[i]).features)
        assert ta.tobytes() == ref.tobytes()
        n_j = int(j_out.features.count[i])
        ja = jvs.features_to_numpy(jvs.Features(**{
            f.name: np.asarray(getattr(j_out.features, f.name))[i]
            for f in dataclasses.fields(j_out.features)}))
        assert len(ta) == len(ja) == n_j > 10
        for f in ("x", "y"):
            np.testing.assert_allclose(ta[f], ja[f], atol=1e-3)


@pytest.mark.parametrize("n_dev", [4, 3, 2])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_match_bit_identical(ranks, case, n_dev):
    a, b, ca, cb = RING_CASES[case]
    parts = _rank_files(ranks, "ring_match")[:n_dev]

    def gathered(field):
        return np.concatenate([p[f"{n_dev}:{case}:{field}"] for p in parts])

    na_pad = a.shape[0] + (-a.shape[0]) % n_dev
    assert gathered("idx_a").tolist() == list(range(na_pad))
    assert all(int(p[f"{n_dev}:{case}:count"]) == ca for p in parts)
    single = match_2nn_fused(torch.from_numpy(a), ca, torch.from_numpy(b), cb)
    for field in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
        got = gathered(field)
        assert got[:a.shape[0]].tobytes() == \
            getattr(single, field).numpy().tobytes(), field
        assert not got[a.shape[0]:].any() if field.startswith("idx") \
            else np.isinf(got[a.shape[0]:]).all()
    m = jax_ring(jax_mesh(8))(jnp.asarray(a), ca, jnp.asarray(b), cb)
    for field in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
        assert gathered(field)[:ca].tobytes() == \
            np.asarray(getattr(m, field))[:ca].tobytes(), field


@pytest.mark.parametrize("n", [4, 3])
def test_n_shard_fold_bit_identical(n):
    """Every virtual rank's fold over the shards in ring visit order, in
    one process with no transport (as chip_smoke.py runs it on one card),
    against the single-device matcher."""
    rng = np.random.default_rng(40 + n)
    a = torch.from_numpy(rng.integers(0, 256, (203, 128), dtype=np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (301, 128), dtype=np.uint8))
    cb = 290
    b[100] = b[101] = a[7]          # ties across the 3- and 4-shard edges
    b[75] = b[76] = a[9]
    single = match_2nn_fused(a, a.shape[0], b, cb)
    bp = pad_rows(b, n)
    nb_l = bp.shape[0] // n
    shards = [(bp[s * nb_l:(s + 1) * nb_l], s * nb_l) for s in range(n)]
    ap = pad_rows(a, n)
    na_l = ap.shape[0] // n
    parts = []
    for r in range(n):
        visit = [shards[(r - i) % n] for i in range(n)]
        parts.append(finish(fold_shards(ap[r * na_l:(r + 1) * na_l], visit,
                                        cb), r * na_l, a.shape[0]))
    for field in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
        got = torch.cat([getattr(m, field) for m in parts])[:a.shape[0]]
        assert got.numpy().tobytes() == \
            getattr(single, field).numpy().tobytes(), field


def test_measure_dp_scaling_runs(ranks):
    with open(os.path.join(ranks, "scaling.json")) as f:
        res = json.load(f)
    assert [p["devices"] for p in res["points"]] == [1, 2, 4]
    assert all(p["fps"] > 0 and p["ms_per_frame"] > 0 for p in res["points"])
    assert res["points"][0]["efficiency"] == 1.0
    assert res["backend"] == "cpu" and res["world_size"] == WORLD
    assert res["cards"] is None


def test_spawn_ranks_raises_for_a_failed_rank():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(torch_parallel_workers.fail_rank, 2)


def test_spawn_ranks_kills_ranks_past_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_ranks(torch_parallel_workers.sleep_rank, 2, (600.0,),
                    timeout=2.0)
    assert time.monotonic() - t0 < 60
