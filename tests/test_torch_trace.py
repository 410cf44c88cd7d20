"""The port's spans and counters (``vulkansift_tpu_torch.utils.trace``) on
the CPU: spans nest under the root of their public call and share its id,
nothing is recorded while they are off, ``host_reads`` counts each
blocking read of a frame's and a match's download, the program cache
counts hits, misses and evictions, a recorded program's and the kernel
libraries' spans and seconds (the graph and the library stubbed), the
bytes a recorded program's call stages in and copies out, and
``stop_trace`` writes the spans into the profiler's Chrome trace.
Counters are process-wide, so every test reads deltas."""

import dataclasses
import json
import threading

import pytest
import torch

from conftest import make_blob_image
import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch import compiled
from vulkansift_tpu_torch.ops import blur, cuda_lib
from vulkansift_tpu_torch.utils import trace
from program_stubs import graphs_as_calls  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

IMG = make_blob_image(96, 128, seed=5)


def _instance(**kw):
    cfg = vt.SiftConfig(max_nb_sift_per_buffer=512, sift_buffer_count=2,
                        **kw)
    return vt.SiftInstance(cfg, device="cpu")


def _delta(before):
    after = trace.counters()
    return {k: after[k] - before[k] for k in after}


@pytest.fixture(autouse=True)
def spans_off_after():
    """Spans left on by a failing test are stopped after it."""
    yield
    if trace.recording():
        trace.stop()


@pytest.fixture
def spans():
    trace.start()


def test_spans_nest_under_their_root_and_share_its_call_id(spans):
    inst = _instance()
    inst.detect_features(IMG, 0)
    inst.get_features_number(0)
    inst.download_features(0)
    got = trace.stop()
    roots = [s for s in got if s.parent < 0]
    assert [s.name for s in roots] == ["detect_features",
                                       "get_features_number",
                                       "download_features"]
    assert [s.call for s in roots] == [s.id for s in roots]
    by_id = {s.id: s for s in got}
    for s in got:
        if s.parent < 0:
            continue
        parent = by_id[s.parent]
        assert s.call == parent.call
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    kids = {r.name: [s.name for s in got if s.parent == r.id] for r in roots}
    assert kids == {"detect_features": ["instance.prepare",
                                        "instance.store"],
                    "get_features_number": ["instance.count_sync"],
                    "download_features": ["types.to_host"]}
    assert len({s.thread for s in got}) == 1


def test_spans_off_record_nothing():
    assert not trace.recording()
    assert trace.span("a") is trace.span("b")       # one shared no-op
    inst = _instance()
    inst.detect_features(IMG, 0)
    inst.download_features(0)
    with pytest.raises(RuntimeError):
        trace.stop()
    trace.start()
    with pytest.raises(RuntimeError):
        trace.start()
    assert trace.stop() == []
    trace.start(capacity=2)
    inst.get_features_number(0)                     # root + nothing to sync
    inst.download_features(0)                       # root + to_host: full
    got = trace.stop()
    assert [s.name for s in got] == ["get_features_number",
                                     "download_features"]


def test_host_reads_count_each_blocking_read():
    """A frame's count and download read 2 + 10 tensors, a match's count
    and download 1 + 5; a second count reads nothing."""
    inst = _instance()
    inst.detect_features(IMG, 0)
    inst.detect_features(IMG[:, ::-1].copy(), 1)
    before = trace.counters()
    inst.get_features_number(0)
    inst.get_features_number(0)
    inst.download_features(0)
    assert _delta(before)["host_reads"] == 12
    before = trace.counters()
    inst.match_features(0, 1)
    inst.get_matches_number()
    inst.download_matches()
    assert _delta(before)["host_reads"] == 6
    before = trace.counters()
    vt.features_to_numpy(inst._buffers[0].features)  # reads the count too
    assert _delta(before)["host_reads"] == 11


def test_program_cache_counts_hits_misses_and_evictions():
    """Three resolutions through an LRU of two: three misses and one
    eviction (AUTO bucketing gives the third a bucketed key); the two
    kept then hit."""
    inst = _instance(detect_cache_size=2)
    imgs = [make_blob_image(h, w, seed=1) for h, w in
            ((64, 96), (96, 64), (80, 112))]
    before = trace.counters()
    for img in imgs:
        inst.detect_features(img, 0)
    d = _delta(before)
    assert (d["programs.miss"], d["programs.evicted"], d["programs.hit"]) \
        == (3, 1, 0)
    before = trace.counters()
    inst.detect_features(imgs[2], 0)
    inst.detect_features(imgs[1], 0)
    d = _delta(before)
    assert (d["programs.miss"], d["programs.evicted"], d["programs.hit"]) \
        == (0, 0, 2)


def test_stop_trace_writes_the_program_spans(tmp_path):
    inst = _instance()
    inst.start_trace(str(tmp_path))
    assert trace.recording()
    inst.detect_features(IMG, 0)
    inst.get_features_number(0)
    inst.download_features(0)
    path = inst.stop_trace()
    assert not trace.recording()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "vulkansift_tpu_torch"]
    assert [e["name"] for e in ours] == [
        "detect_features", "instance.prepare", "instance.store",
        "get_features_number", "instance.count_sync", "download_features",
        "types.to_host"]
    # On the profiler's time base: the operators run inside the spans.
    ops = [e for e in events if str(e.get("name", "")).startswith("aten::")
           and e.get("ph") == "X"]
    lo = min(e["ts"] for e in ours)
    hi = max(e["ts"] + e["dur"] for e in ours)
    assert ops and all(lo - 1e3 <= e["ts"] <= hi + 1e3 for e in ops)
    # Spans someone else turned on stay theirs.
    trace.start()
    inst.start_trace(str(tmp_path))
    inst.detect_features(IMG, 0)
    inst.stop_trace()
    assert [s.name for s in trace.stop()] == [
        "detect_features", "instance.prepare", "instance.store"]


def test_compiled_spans_of_a_program(graphs_as_calls, spans):
    """A program's build is one ``compiled.record`` span with its key and
    adds to ``programs.record_s``; a call is upload, replay and copy-out,
    and the copy equals the eager function's result."""
    cfg = vt.SiftConfig(max_nb_sift_per_buffer=512)
    before = trace.counters()
    prog = compiled.DetectProgram(cfg, 128, 96, device="cpu")
    want = vt.make_detect_fn(cfg, 128, 96, device="cpu")(
        torch.from_numpy(IMG))
    out = prog(IMG)
    got = trace.stop()
    assert [(s.name, s.parent) for s in got] == [
        ("compiled.record", -1), ("compiled.upload", -1),
        ("compiled.replay", -1), ("compiled.copy_out", -1)]
    assert got[0].detail == "DetectProgram (128, 96, 1)"
    d = _delta(before)
    assert d["programs.record_s"] > 0 and d["host_reads"] == 0
    assert prog.replays == 1
    assert torch.equal(out.features.x, want.features.x)
    assert int(out.features.count) == int(want.features.count)


def test_byte_counters_of_a_detect_and_a_match(graphs_as_calls):
    """With spans off, a detect program's call adds its frame, from host
    memory, to ``compiled.upload_bytes`` (a bucketed program's valid-size
    fills are no upload) and every byte of its result, the retained
    pyramid included, to ``compiled.copy_out_bytes``; a match program's
    call adds its two descriptor blocks and two counts (on the CPU, in
    host memory), and its matches. Each detect total equals the one the
    program worked out when it was recorded."""
    assert not trace.recording()
    cfg = vt.SiftConfig(max_nb_sift_per_buffer=512)
    det = compiled.DetectProgram(cfg, 128, 96, device="cpu",
                                 return_pyramid=True)
    before = trace.counters()
    out, gauss, dogs = det(IMG)
    d = _delta(before)
    result = [getattr(out.features, f.name)
              for f in dataclasses.fields(out.features)]
    result += [out.lost, out.per_octave_counts, *gauss, *dogs]
    copied = sum(t.nbytes for t in result)
    assert copied > 512 * (9 * 4 + 128) + sum(g.nbytes for g in gauss)
    assert d["compiled.upload_bytes"] == det.upload_bytes == 96 * 128
    assert d["compiled.copy_out_bytes"] == det.output_bytes == copied
    assert d["host_reads"] == 0

    match = compiled.MatchProgram(512, 256, device="cpu")
    before = trace.counters()
    m = match(out.features.descriptor, out.features.count,
              out.features.descriptor[:256], out.features.count)
    d = _delta(before)
    matches = sum(getattr(m, f.name).nbytes for f in dataclasses.fields(m))
    assert d["compiled.upload_bytes"] == (512 + 256) * 128 + 2 * 4
    assert d["compiled.copy_out_bytes"] == match.output_bytes == matches \
        == 512 * (3 * 4 + 2 * 4) + 4
    before = trace.counters()
    det(IMG)
    det(IMG)
    d = _delta(before)
    assert (d["compiled.upload_bytes"], d["compiled.copy_out_bytes"]) == \
        (2 * 96 * 128, 2 * copied)

    bucketed = compiled.DetectProgram(cfg, 128, 96, bucket=32, device="cpu")
    before = trace.counters()
    bucketed(IMG, 120, 90)
    d = _delta(before)
    assert d["compiled.upload_bytes"] == bucketed.upload_bytes == 96 * 128
    assert d["compiled.copy_out_bytes"] == bucketed.output_bytes


def test_kernel_library_spans_and_seconds(monkeypatch, tmp_path, spans):
    """``build`` is a ``kernels.build`` span, a library's first load a
    ``kernels.load`` span named after it with the build inside; both add
    their seconds to ``kernels.load_s``."""
    lib = tmp_path / "libvks_x.so"
    built = []
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(cuda_lib, "_lib_path", lambda name: lib)
    monkeypatch.setattr(cuda_lib, "_build", lambda verbose: (
        built.append(lib.write_bytes(b"")) or {}))
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", lambda path: ("lib", path))
    before = trace.counters()
    assert cuda_lib.library("x") == ("lib", str(lib))
    assert cuda_lib.library("x") == ("lib", str(lib))   # loaded once
    got = trace.stop()
    assert [(s.name, s.detail, s.parent) for s in got] == [
        ("kernels.load", "x", -1), ("kernels.build", None, got[0].id)]
    assert len(built) == 1
    assert 0 < _delta(before)["kernels.load_s"] < 60


def test_record_seconds_are_the_programs_less_its_threads_loads(
        monkeypatch):
    """``programs.record_s`` adds a program's warm-up and capture seconds
    less the kernel libraries' seconds of its own thread: a library that
    another thread loads meanwhile is not taken off."""
    other_loaded = threading.Event()

    def record_graph(self, device, run, pool):
        cuda_lib._loaded(1.5)       # a library loaded by the warm-up
        t = threading.Thread(target=lambda: (cuda_lib._loaded(10.0),
                                             other_loaded.set()))
        t.start()
        t.join(timeout=30)
        self.warmup_seconds, self.capture_seconds = 2.0, 0.5

    monkeypatch.setattr(compiled._Program, "_record_graph", record_graph)
    before = trace.counters()
    compiled._Program()._record("cpu", None, None)
    d = _delta(before)
    assert other_loaded.is_set()
    assert d["programs.record_s"] == pytest.approx(1.0)
    assert d["kernels.load_s"] == pytest.approx(11.5)


def test_counters_read_the_wrappers_launches():
    before = trace.counters()
    cuda_lib.count_launch(blur.blur_dog)
    d = _delta(before)
    assert d["launches.blur_dog"] == 1
    assert trace.counters()["launches.blur_dog"] == blur.blur_dog.launches
    assert set(d) >= {"launches.blur_dog", "launches.frontend",
                      "launches.orientation_hist", "launches.descriptor",
                      "launches.match_2nn_tiles"}
    assert set(d) >= {"programs.hit", "programs.miss", "programs.evicted",
                      "programs.record_s", "kernels.load_s", "host_reads",
                      "compiled.upload_bytes", "compiled.copy_out_bytes"}


def test_counters_and_spans_from_many_threads(spans):
    """Sixteen threads count and record at once: no update is lost, and
    each thread's spans nest under its own roots."""
    n, k = 16, 200
    before = trace.counters()
    start = threading.Barrier(n)

    def work():
        start.wait(timeout=30)
        for _ in range(k):
            with trace.span("root"):
                with trace.span("child"):
                    trace.count("host_reads")

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert _delta(before)["host_reads"] == n * k
    got = trace.stop()
    assert len(got) == 2 * n * k
    by_id = {s.id: s for s in got}
    for s in got:
        if s.name == "child":
            root = by_id[s.parent]
            assert root.name == "root" and root.thread == s.thread
            assert s.call == root.id


def test_chrome_events_are_microseconds_from_the_base():
    s = trace.Span(3, "x", "k", 5_000, 7_500, 1, 1, 42)
    (e,) = trace.chrome_events([s], base_ns=1_000)
    assert (e["ph"], e["name"], e["tid"], e["ts"], e["dur"]) == \
        ("X", "x", 42, 4.0, 2.5)
    assert e["args"] == {"id": 3, "parent": 1, "call": 1, "detail": "k"}
