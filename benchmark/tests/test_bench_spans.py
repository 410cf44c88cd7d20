"""The readers of the program's spans and counters (``yardstick/spans.py``):
the windows on a cell of their own, the counts a frame and a pair, a
checkout without spans, idle gaps put down to spans, the profiler's clock
offset from probe kernels; and, on the card, that a replay's span and its
kernels are on one clock once that offset is taken off."""

import time

import pytest

from yardstick import loop, spans

SEED = 2 ** 31 + 11


@pytest.mark.parametrize("cell,reads", [("hannover1536-video", 12),
                                        ("oxford640-pairs", 6)])
def test_windows_read_the_program(tiny, cell, reads):
    p = tiny(cell)
    run = loop.Run(device="cpu")
    w = spans.windows(run, dict(cfg_file=p["cfg_file"],
                                traffic=p["traffic"], seed=SEED))
    assert w is spans.windows(run)                  # measured once
    assert spans.counter_per_item(run, "host_reads") == reads
    assert w["counters"]["programs.miss"] == 0      # recorded in set-up
    assert spans.ms_per_item(run, "types.to_host") > 0
    assert spans.ms_per_item(run, "compiled.upload") is None  # card only
    assert 0 < w["detect_cover"] <= 1
    assert sum(v for _, v in w["idle_spans"]) > 0
    assert spans.setup_counter(run, "programs.record_s") == 0.0  # CPU
    calls = [c[0] for c in p["traffic"]["calls"]]
    for side in ("spans_off", "spans_on"):
        assert set(w["calls_ms"][side]) == set(calls)
        assert all(v > 0 for v in w["calls_ms"][side].values())
    assert spans.setup_counter(run, "kernels.load_s") is not None


def test_nothing_to_read_without_spans_or_a_cell(monkeypatch):
    run = loop.Run(device="cpu")
    assert spans.windows(run) is None               # no --workload here
    assert spans.ms_per_item(run, "compiled.upload") is None
    monkeypatch.setattr(spans, "program_trace", lambda: None)
    run = loop.Run(device="cpu")
    assert spans.counter_per_item(run, "host_reads") is None
    assert spans.setup_counter(run, "kernels.load_s") is None


def test_command_line_names_the_cell(monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "run.py", "--workload", "oxford640-pairs", f"--seed={SEED}",
        "--seconds", "5", "--trace", "1"])
    parts = spans.command_line_parts()
    assert parts["seed"] == SEED
    assert parts["traffic"]["unit"] == "pair"
    assert parts["cfg_file"]["frame"]["width"] == 640


def _span(i, name, start, end, parent=-1):
    from vulkansift_tpu_torch.utils.trace import Span
    return Span(i, name, None, start, end, parent,
                i if parent < 0 else parent, 1)


def test_idle_gaps_go_to_the_innermost_span():
    """Busy [10, 20] and [40, 50] in a window [0, 100]: the gap [0, 10]
    falls in a root alone, [20, 40] in its child, [50, 100] (midpoint 75)
    after the root, inside the benchmark's call span."""
    got = [_span(0, "detect_features", 2, 60),
           _span(1, "instance.prepare", 2, 4, 0),
           _span(2, "compiled.replay", 25, 35, 0),
           _span(3, "compiled.copy_out", 35, 45, 0)]
    host = [(1, 80, "detect_features")]
    dev = [(10, 20, "k"), (40, 50, "k")]
    idle, child, root = spans.idle_by_span(dev, got, host, 0, 100)
    assert idle == {"detect_features": 10e-9, "compiled.replay": 20e-9,
                    "detect_features outside spans": 50e-9}
    assert (child, root) == (20e-9, 10e-9)
    assert spans.cover(got, "detect_features") == pytest.approx(
        (2 + 10 + 10) / 58)


@pytest.mark.card
def test_replay_spans_and_kernels_share_one_clock(card):
    """Two profiler windows of one process, each with spans on: probe
    kernels, then detect, count and download eight frames. In each window
    the probes' lags agree (one offset a window: the profiler maps the
    card's clock onto the host's once a window), and, moved by that
    offset, the first kernel after each frame's predecessor is done
    starts after the frame's ``compiled.replay`` span starts and before
    the next one starts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import vulkansift_tpu_torch as vt
    from vulkansift_tpu_torch.utils import trace
    from yardstick import images, trace as trace_mod

    img = images.bench_image(480, 640, np.random.default_rng(3))
    inst = vt.SiftInstance(vt.SiftConfig(max_nb_sift_per_buffer=4096),
                           device=card)
    x = torch.zeros(1, device=card)
    for _ in range(2):
        inst.detect_features(img, 0)
        inst.get_features_number(0)
        inst.download_features(0)
    torch.cuda.synchronize()
    for window in range(2):
        trace.start()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                probes = spans.probe(x)
                t0 = time.time_ns()
                for _ in range(8):
                    inst.detect_features(img, 0)
                    inst.get_features_number(0)
                    inst.download_features(0)
                torch.cuda.synchronize()
        finally:
            got = trace.stop()
        dev = trace_mod._device_events(prof)
        off = spans.clock_offset(dev, probes)
        lags = sorted(s - t for s, t in zip(
            sorted(d[0] for d in dev)[:len(probes)], probes))
        assert lags[len(lags) // 2] - off < 50_000, (window, lags)
        kernels = sorted(s - off for s, _, n in dev
                         if "Memcpy" not in n and "Memset" not in n)
        replays = [s.start_ns for s in got if s.name == "compiled.replay"]
        done = [s.end_ns for s in got if s.name == "download_features"]
        assert len(replays) == len(done) == 8
        for i, start in enumerate(replays):
            after = done[i - 1] if i else t0
            first = next(k for k in kernels if k >= after)
            nxt = replays[i + 1] if i + 1 < len(replays) else float("inf")
            assert start <= first < nxt, (window, i, start, first, nxt, off)
    inst.close()


def test_clock_offset_is_the_least_probe_lag():
    """The first device intervals are the probes' kernels, 600 us behind
    the host's readings plus a launch latency of 8 to 30 us."""
    probes = [1_000_000 * k for k in range(1, 5)]
    dev = [(t - 600_000 + lat, t - 590_000, "probe")
           for t, lat in zip(probes, (30_000, 8_000, 9_000, 12_000))]
    dev.append((probes[-1] + 50, probes[-1] + 900, "a later kernel"))
    assert spans.clock_offset(dev, probes) == -592_000
