"""The paths the port records as CUDA graphs beyond the instance's
(``compiled.RingStepProgram``, ``compiled.StageProgram``, the data-parallel
detect's ``DetectProgram``, the SfM back end's ``LoopProgram``), checked
on the CPU, where each runs the same function its program records,
eagerly.

* the staged detector's bucket function equals the JAX package's, and the
  S2 and S3 keys the port's detector builds equal the profiles the JAX
  ``SiftDetector`` computes (from its ``_stage1`` counts and its
  ``_stage2`` pair counts) on ``tests/test_torch_detector.py``'s cases;
  its resolutions are held in an LRU of ``detect_cache_size``;
* the recorded ring step (offset and ``count_b`` as scalar tensors,
  written in place) equals ``ring_step`` with Python ints bit for bit, at
  every step of every rank's fold, over ``tests/test_torch_parallel.py``'s
  ring cases on 4 and 3 shards;
* at world size 1 (one gloo process) the data-parallel detect equals the
  single-image detect byte for byte and the ring equals
  ``match_2nn_fused``;
* the new programs need a card and refuse ``cuda_lib.force_plain()``.

Graph replay against the eager paths is checked on the card by
``chip_smoke.py`` (its ``compiled_dp``, ``compiled_ring`` and
``compiled_staged`` lines).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from conftest import make_blob_image
from test_torch_detector import CASES
from test_torch_parallel import RING_CASES
from vulkansift_tpu import detector as jax_detector
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch import detector as t_detector
from vulkansift_tpu_torch.compiled import (GraphPool, LoopProgram,
                                           RingStepProgram, StageProgram)
from vulkansift_tpu_torch.errors import DeviceError
from vulkansift_tpu_torch.ops import cuda_lib
from vulkansift_tpu_torch.ops.match import match_2nn_fused
from vulkansift_tpu_torch.parallel import ring_match as rm
from vulkansift_tpu_torch.pipeline import make_detect_fn
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("cap", [0, 1, 37, 63, 64, 65, 100, 128, 4096,
                                 16384])
def test_bucket_matches_jax(cap):
    for n in [0, 1, 2, 63, 64, 65, 127, 128, 129, 1000, 4097, 16384, 20000]:
        assert t_detector._bucket(n, cap) == jax_detector._bucket(n, cap), \
            (n, cap)


@pytest.fixture(scope="module")
def jax_profiles():
    """Per case: the JAX detector's S2 profile (buckets of its S1 counts)
    and S3 profile (buckets of its S2 pair counts)."""
    out = {}
    for case, (img, cfg) in CASES.items():
        h, w = img.shape
        det = jax_detector.SiftDetector(cfg)
        g, d, cands, counts = det._stage1(img, width=w, height=h)
        caps = cfg.octave_section_capacities(
            len(cfg.octave_resolutions(w, h)))
        profile = tuple(jax_detector._bucket(int(c), caps[o])
                        for o, c in enumerate(np.asarray(counts)))
        _, pairs = det._stage2(g, d, cands, width=w, height=h,
                               profile=profile)
        dprofile = tuple(
            jax_detector._bucket(int(p), min(profile[o] * det.ori_capacity,
                                             caps[o]))
            for o, p in enumerate(np.asarray(pairs)))
        out[case] = profile, dprofile
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_keys_match_jax_profiles(case, jax_profiles, caplog):
    img, cfg = CASES[case]
    h, w = img.shape
    det = vt.SiftDetector(vt.from_reference_dict(dataclasses.asdict(cfg)),
                          device="cpu")
    with caplog.at_level(logging.WARNING):
        first = vt.features_to_numpy(det.detect(img, w, h)[0])
        again = vt.features_to_numpy(det.detect(img, w, h)[0])
    profile, dprofile = jax_profiles[case]
    res = det._programs[(w, h)]
    assert list(det._programs) == [(w, h)]
    assert list(res.s2) == [profile]
    assert list(res.s3) == [(profile, dprofile)]
    # The stages' buffers are reused; the results are the caller's.
    assert first.tobytes() == again.tobytes()


def test_staged_detector_lru_of_resolutions():
    cfg = vt.SiftConfig(use_input_upsampling=False, max_nb_sift_per_buffer=512,
                        input_image_max_size=160 * 128, detect_cache_size=2)
    det = vt.SiftDetector(cfg, device="cpu")
    sizes = ((128, 96), (160, 128), (128, 96), (96, 64))
    for w, h in sizes:
        feats, _, _, per = det.detect(make_blob_image(h, w, seed=5), w, h)
        assert int(feats.count) == sum(per) > 0
    assert list(det._programs) == [(128, 96), (96, 64)]
    det.close()
    assert not det._programs


def _folds(a, b, cb, n):
    """Every rank's fold of ``n`` shards in ring visit order, both ways:
    ``ring_step`` with ints and ``ring_step_into`` with scalar tensors;
    the top-2 after each step."""
    ap, bp = rm.pad_rows(torch.from_numpy(a), n), rm.pad_rows(
        torch.from_numpy(b), n)
    na_l, nb_l = ap.shape[0] // n, bp.shape[0] // n
    off_t = torch.zeros((), dtype=torch.int32)
    cb_t = torch.tensor(cb, dtype=torch.int32)
    for r in range(n):
        a_l = ap[r * na_l:(r + 1) * na_l]
        ref = rm.empty_top2(na_l, "cpu")
        got = rm.empty_top2(na_l, "cpu")
        for s in ((r - i) % n for i in range(n)):
            shard = bp[s * nb_l:(s + 1) * nb_l]
            ref = rm.ring_step(ref, a_l, shard, s * nb_l, cb)
            off_t.fill_(s * nb_l)
            rm.ring_step_into(got, a_l, shard, off_t, cb_t)
            yield r, s, ref, got


@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_recorded_ring_step_equals_ring_step(case, n):
    a, b, _, cb = RING_CASES[case]
    for r, s, ref, got in _folds(a, b, cb, n):
        for x, y in zip(got, ref):
            assert x.dtype == y.dtype == torch.int32
            assert x.numpy().tobytes() == y.numpy().tobytes(), (r, s)


def test_world_size_one_paths(tmp_path):
    """dp detect and the ring in one gloo process: the dp batch is two
    single-image detects byte for byte, the ring (and fold_shards with a
    step made once and reused) is match_2nn_fused bit for bit."""
    import torch.distributed as dist
    from vulkansift_tpu_torch import parallel
    parallel.init_distributed(f"file://{tmp_path}/store", 1, 0, device="cpu")
    try:
        mesh = parallel.make_mesh(1)
        img, jcfg = CASES["no_upsampling_ubc"]
        cfg = vt.from_reference_dict(dataclasses.asdict(jcfg))
        h, w = img.shape
        frames = np.stack([img, img[::-1].copy()])
        dp = parallel.make_dp_detect_fn(cfg, w, h, mesh, device="cpu")
        out = dp(parallel.shard_batch(frames, mesh, device="cpu"))
        single = make_detect_fn(cfg, w, h, device="cpu")
        for i in range(2):
            ref = single(frames[i])
            got = vt.Features(**{f.name: getattr(out.features, f.name)[i]
                                 for f in dataclasses.fields(vt.Features)})
            assert vt.features_to_numpy(got).tobytes() == \
                vt.features_to_numpy(ref.features).tobytes()
            assert int(out.lost[i]) == int(ref.lost)
            assert torch.equal(out.per_octave_counts[i],
                               ref.per_octave_counts)
        dp.close()

        a, b, ca, cb = RING_CASES["edge_ties"]
        at, bt = torch.from_numpy(a), torch.from_numpy(b)
        single_m = match_2nn_fused(at, ca, bt, cb)
        ring = parallel.make_ring_match_fn(mesh, device="cpu")
        for count_b in (cb, torch.tensor(cb, dtype=torch.int32)):
            m = ring(at, ca, bt, count_b)
            for f in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
                assert getattr(m, f).numpy().tobytes() == \
                    getattr(single_m, f).numpy().tobytes(), f
        ring.close()
    finally:
        dist.destroy_process_group()

    step = rm.make_step(at.shape[0], 51, torch.device("cpu"))
    shards = [(rm.pad_rows(bt, 2)[51 * s:51 * (s + 1)], 51 * s)
              for s in (1, 0)]
    for _ in range(2):
        top2 = rm.fold_shards(at, shards, cb, step=step)
        m = rm.finish(top2, 0, ca)
        for f in ("idx_b1", "idx_b2", "dist_a_b1", "dist_a_b2"):
            assert getattr(m, f).numpy().tobytes() == \
                getattr(single_m, f).numpy().tobytes(), f


def _ring_program():
    return RingStepProgram(64, 64, device="cpu")


def _stage_program():
    return StageProgram(lambda: torch.zeros(4), device="cpu",
                        pool=GraphPool())


def _loop_program():
    return LoopProgram(lambda state, inputs: (state[0] + inputs[0],),
                       (torch.zeros(4),), (torch.ones(4),))


@pytest.mark.parametrize("make", [_ring_program, _stage_program,
                                  _loop_program],
                         ids=["ring_step", "stage", "loop"])
def test_new_programs_need_a_card(make):
    """A recorded program is a card's: on the CPU it raises, it does not
    run its function eagerly in its place; inside force_plain it raises
    and says why."""
    with pytest.raises(DeviceError):
        make()
    with cuda_lib.force_plain():
        with pytest.raises(DeviceError, match="force_plain"):
            make()
