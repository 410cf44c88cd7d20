"""The port's resolution bucketing and program cache against the JAX
package's on the CPU, and the pieces of ``compiled.py`` that run without
a card.

On a card ``SiftInstance`` records each detect key as a CUDA graph
(``compiled.DetectProgram``); a CPU instance keeps the eager functions
under the same keys, so these tests hold the keys, their LRU order, the
octave plans and the bucketed detect to the JAX instance's. Graph replay
against the eager path is checked on the card by ``chip_smoke.py``.

Feature bars are the port's (tests/test_torch_pipeline.py): at least 95 %
of the port's features at a position the reference also has, 85 % in
angle-matched pairs, and for pairs within 1e-3 rad at least 99.5 % of
descriptor bins within +-1 u8, none off by more than 8.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import make_blob_image
import vulkansift_tpu as jvs
from vulkansift_tpu.pipeline import octave_plan as jax_octave_plan
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.compiled import (DetectProgram, GraphPool,
                                           MatchProgram)
from vulkansift_tpu_torch.errors import DeviceError
from vulkansift_tpu_torch.ops import cuda_lib
from vulkansift_tpu_torch.pipeline import make_detect_fn, octave_plan
from test_torch_pipeline import _Feats, _match_pairs
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_instance.py::test_auto_bucketing_default's configuration and
# frame sizes: 160x128 and 150x120 get exact programs, 140x110 and 130x105
# the 192x128 bucket's. The frames are crops of a 160x128 blob image, which
# has features at every crop (the JAX test's 640x480 one has none there).
AUTO_KW = dict(use_input_upsampling=False, max_nb_sift_per_buffer=2048,
               sift_buffer_count=1, input_image_max_size=1 << 22)
AUTO_SIZES = ((128, 160), (120, 150), (110, 140), (105, 130))


@pytest.fixture(scope="module")
def blob():
    return make_blob_image(128, 160, seed=5, nb_blobs=14)


def _agree(ta: np.ndarray, ja: np.ndarray) -> None:
    """The port's feature bars between two FEATURE_DTYPE arrays."""
    n_t, n_j = len(ta), len(ja)
    assert n_t > 5
    ft, fj = _Feats(ta), _Feats(ja)
    pairs, pos_hit = _match_pairs(ft, n_t, fj, n_j)
    assert pos_hit >= 0.95 * n_t
    assert len(pairs) >= 0.85 * max(n_t, n_j)
    tight = [(i, j) for i, j in pairs
             if abs(float(ft.orientation[i]) - float(fj.orientation[j])) < 1e-3]
    d = np.concatenate([np.abs(ft.descriptor[i].astype(np.int32)
                               - fj.descriptor[j].astype(np.int32))
                        for i, j in tight])
    assert np.mean(d <= 1) >= 0.995
    assert d.max() <= 8


@pytest.mark.parametrize("upsampling", [False, True])
def test_octave_plan_matches_jax(upsampling):
    cfg = jvs.SiftConfig(use_input_upsampling=upsampling)
    tcfg = vt.from_reference_dict(dataclasses.asdict(cfg))
    dropped = 0
    for w in (32, 64, 100, 192, 512, 640, 1536):
        for h in (32, 96, 128, 480, 512, 1024):
            for bucket in (1, 16, 64, 128):
                plan = octave_plan(tcfg, w, h, bucket)
                assert plan == jax_octave_plan(cfg, w, h, bucket)
                dropped += len(plan) < len(octave_plan(tcfg, w, h))
    # 512x512 at bucket 64: the smallest frame of the bucket, 449x449, has
    # one octave fewer.
    assert len(octave_plan(tcfg, 512, 512, 64)) \
        == len(octave_plan(tcfg, 512, 512)) - 1
    assert dropped > 0


@pytest.fixture(scope="module")
def jax_auto(blob):
    """The JAX instance through the AUTO sequence: after each detect its
    cache keys, octave plan, per-octave counts and features. The instance
    stays open, so that its compiled bucket program serves
    test_bucketed_detect_matches_jax as well."""
    inst = jvs.SiftInstance(jvs.SiftConfig(**AUTO_KW))
    steps = []
    for h, w in AUTO_SIZES:
        inst.detect_features(blob[:h, :w], 0)
        nb = inst.get_scale_space_nb_octaves(0)
        steps.append(dict(
            keys=list(inst._detect_cache),
            plan=[tuple(inst.get_scale_space_octave_resolution(o, 0))
                  for o in range(nb)],
            per_octave=tuple(inst._buffers[0].per_octave_counts),
            features=inst.download_features(0)))
    yield inst, steps
    inst.close()


def test_bucketed_detect_matches_jax(jax_auto):
    """make_detect_fn(bucket=64) on a 110x140 frame edge-padded to the
    192x128 bucket, against the JAX package's bucketed XLA program (the
    JAX instance's, make_detect_fn(cfg, 192, 128, bucket=64) under
    jax.jit)."""
    img = make_blob_image(110, 140, seed=5, nb_blobs=14)
    padded = np.pad(img, ((0, 18), (0, 52)), mode="edge")
    j_inst = jax_auto[0]
    with jax.default_device(j_inst.device):  # as the instance called it
        j_out, _, _ = j_inst._detect_cache[(192, 128, True)](
            padded, jnp.float32(140.0), jnp.float32(110.0))
    tcfg = vt.SiftConfig(**AUTO_KW)
    fn = make_detect_fn(tcfg, 192, 128, device="cpu", bucket=64)
    t_out = fn(padded, 140, 110)
    assert int(t_out.lost) == int(j_out.lost)
    np.testing.assert_array_equal(t_out.per_octave_counts.numpy(),
                                  np.asarray(j_out.per_octave_counts))
    ta = vt.features_to_numpy(t_out.features)
    ja = jvs.features_to_numpy(j_out.features)
    _agree(ta, ja)
    assert (ta["x"] < 140).all() and (ta["y"] < 110).all()
    # The mask keeps exactly the unmasked features inside the valid size:
    # a valid size of 100x80 on the same frame drops the rest, and leaves
    # the kept ones and their order as they were.
    full = vt.features_to_numpy(fn(padded).features)
    inside = full[(full["x"] < 100) & (full["y"] < 80)]
    assert 0 < len(inside) < len(full)
    assert vt.features_to_numpy(fn(padded, 100, 80).features).tobytes() \
        == inside.tobytes()


def test_auto_bucketing_matches_jax_instance(blob, jax_auto):
    """The default configuration (AUTO bucketing) over four resolutions:
    the same cache keys, octave plans and features as the JAX instance's
    (the third and fourth frames run the 192x128 bucket's program)."""
    assert jvs.SiftConfig(**AUTO_KW).resolution_bucket == 0
    t = vt.SiftInstance(vt.SiftConfig(**AUTO_KW), device="cpu")
    for (h, w), ref in zip(AUTO_SIZES, jax_auto[1]):
        t.detect_features(blob[:h, :w], 0)
        assert list(t._detect_cache) == ref["keys"]
        nb = t.get_scale_space_nb_octaves(0)
        assert [t.get_scale_space_octave_resolution(o, 0)
                for o in range(nb)] == ref["plan"]
        assert t.get_per_octave_counts(0) == ref["per_octave"]
        ta = t.download_features(0)
        _agree(ta, ref["features"])
        assert (ta["x"] < w).all() and (ta["y"] < h).all()
    keys = list(t._detect_cache)
    assert [k[2] for k in keys] == [False, False, True]
    assert keys[2][:2] == (192, 128)
    assert t.get_scale_space_octave_resolution(0, 0) == (192, 128)
    assert t._buffers[0].input_width == 130
    t.close()
    assert not t._detect_cache


def test_lru_eviction_matches_jax_instance(blob):
    """detect_cache_size=2, resolution_bucket=1: after every detect the
    cache holds the same keys in the same order as the JAX instance's."""
    kw = dict(AUTO_KW, detect_cache_size=2, resolution_bucket=1)
    j = jvs.SiftInstance(jvs.SiftConfig(**kw))
    t = vt.SiftInstance(vt.SiftConfig(**kw), device="cpu")
    seen = []
    for h, w in ((32, 40), (36, 44), (32, 40), (33, 48)):
        img = blob[:h, :w]
        j.detect_features(img, 0)
        t.detect_features(img, 0)
        seen.append(list(t._detect_cache))
        assert seen[-1] == list(j._detect_cache)
    # 40x32 was used again after 44x36, so 44x36 went.
    assert seen == [[(40, 32, False)], [(40, 32, False), (44, 36, False)],
                    [(44, 36, False), (40, 32, False)],
                    [(40, 32, False), (48, 33, False)]]


def test_recording_defers_launch_counts():
    """Launches inside cuda_lib.recording() go to the recording (a graph's
    capture runs no kernel); outside they count, on every thread."""

    def wrapper():
        pass

    wrapper.launches = 0
    cuda_lib.count_launch(wrapper)
    with cuda_lib.recording() as rec:
        cuda_lib.count_launch(wrapper)
        cuda_lib.count_launch(wrapper)
        with cuda_lib.recording() as inner:
            cuda_lib.count_launch(wrapper)
        cuda_lib.count_launch(wrapper)
    cuda_lib.count_launch(wrapper)
    assert wrapper.launches == 2
    assert rec == {wrapper: 3} and inner == {wrapper: 1}


def test_graph_pool_new_handle_once_empty(monkeypatch):
    """An instance's programs record into one pool; once its last program
    has closed, the next one records into a new pool, never into one the
    allocator may be freeing."""
    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(handles)))
    pool = GraphPool()
    assert pool.acquire() == pool.acquire() == ("pool", 0)
    pool.release()
    assert pool.acquire() == ("pool", 0)
    pool.release()
    pool.release()
    assert pool.acquire() == ("pool", 1)


def test_program_needs_a_card():
    """A recorded program is a card's: on the CPU it raises, it does not
    run the eager function in its place."""
    cfg = vt.SiftConfig(use_input_upsampling=False,
                        max_nb_sift_per_buffer=64)
    with pytest.raises(DeviceError):
        DetectProgram(cfg, 64, 64, device="cpu")


def test_program_refuses_force_plain():
    """A recorded program runs its kernels: inside cuda_lib.force_plain()
    it is neither built nor called (a program built there would record the
    plain path and replay it outside the block), and it says why."""
    cfg = vt.SiftConfig(use_input_upsampling=False,
                        max_nb_sift_per_buffer=64)
    with cuda_lib.force_plain():
        with pytest.raises(DeviceError, match="force_plain"):
            DetectProgram(cfg, 64, 64, device="cpu")
        with pytest.raises(DeviceError, match="force_plain"):
            MatchProgram(64, 64, device="cpu")
