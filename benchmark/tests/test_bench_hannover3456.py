"""The ``hannover3456-video`` cell: its configuration is the 1536x1024
deployment's at the second published frame, the harness finds its files
and metrics by name (the 1536 cell's per-layer metrics, the three byte
and clone readers new with it included), its tiny run is correct on the
CPU, and its per-layer metrics read a traced tiny run: on the CPU through
the recorded program's plumbing with the CUDA graph replaced by a call of
the recorded function (the kernels' roofline on the work of the run's own
traced frames), and on a card as the benchmark runs it."""

import json
import sys
from pathlib import Path

import pytest

from yardstick import readers, spans, spec

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
from program_stubs import graphs_as_calls  # noqa: E402,F401

CELL = "hannover3456-video"
SEED = 2 ** 31 + 18
BENCH = spec.benchmark()
NEW = ("video.clone_ms", "video.upload_mb", "video.copy_out_gb")


def static_output_bytes(cfg_file: dict) -> int:
    """A detect's result by hand: the features at the buffer's capacity
    (nine 4-byte fields, a 128-byte descriptor a row, the count), ``lost``,
    a count an octave, and the retained float32 pyramid, S + 3 gaussian
    and S + 2 DoG layers an octave."""
    from reference import sift as ref_sift
    cfg = cfg_file["sift_config"]
    sizes = ref_sift.octave_sizes(cfg, cfg_file["frame"]["width"],
                                  cfg_file["frame"]["height"])
    layers = 2 * cfg["nb_scales_per_octave"] + 5
    return (cfg["max_nb_sift_per_buffer"] * (9 * 4 + 128) + 4 + 4
            + 4 * len(sizes) + sum(4 * layers * w * h for w, h in sizes))


def test_static_bytes_at_the_published_size():
    """A 3456x2304 detect copies out 1.874 GB, the pyramid 1.869 GB of it
    (the 1536x1024 one 0.374 GB)."""
    assert static_output_bytes(spec.config(
        BENCH, "hannover-3456x2304")) == 1_873_907_912
    assert static_output_bytes(spec.config(
        BENCH, "hannover-1536x1024")) == 374_450_212


def test_config_is_the_1536_deployment_at_3456():
    new = spec.config(BENCH, "hannover-3456x2304")
    old = spec.config(BENCH, "hannover-1536x1024")
    assert new["frame"] == {"width": 3456, "height": 2304}
    assert new["sift_config"] == old["sift_config"]
    assert new["reduced"] == [] and new["precision"] == old["precision"]
    same = set(old) - {"name", "source", "deployment", "frame", "assumed"}
    assert {k: new[k] for k in same} == {k: old[k] for k in same}
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == "hannover-3456x2304")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert "Performances.md" in entry["source"]


def test_cell_and_its_metrics_found_by_name():
    w = spec.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("hannover-3456x2304", "pan-video", 1)
    assert len(w["why"]) <= 200
    m = spec.metrics_of(BENCH, CELL)
    assert [x["name"] for x in m["end_to_end"]] == ["frames_per_s",
                                                    "setup_s"]
    # The same per-layer metrics as the 1536 cell, the new three too.
    names = [x["name"] for x in m["per_layer"]]
    assert names == [x["name"] for x in spec.metrics_of(
        BENCH, "hannover1536-video")["per_layer"]]
    assert set(NEW) < set(names)
    assert all(n.startswith(("video.", "setup.")) for n in names)
    for x in m["per_layer"]:
        assert callable(spec.reader(x["name"]).read)
        if x["name"] in NEW:
            assert x["workloads"] == ["hannover1536-video", CELL]
            assert (x["moves"], x["better"]) == ("frames_per_s", "lower")
    assert not set(NEW) & {x["name"] for x in spec.metrics_of(
        BENCH, "oxford640-pairs")["per_layer"]}


def test_tiny_run_is_correct(tiny):
    import run as bench_run
    out = bench_run.measure(**tiny(CELL), seed=SEED, seconds=3, trace=False,
                            device="cpu")
    res = out["result"]
    assert res["correct"] is True, out["why"]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(v["limit"] is not None for v in res["checks"].values())


@pytest.fixture
def programs_on_cpu(graphs_as_calls, monkeypatch):
    """The CPU instance records its detects as ``compiled.DetectProgram``s
    whose CUDA graph is a call of the recorded function, and the spans
    windows run in this process; returns the programs built. The process's
    counters are put back afterwards: other tests read the CPU's record
    seconds as 0."""
    import vulkansift_tpu_torch as vt
    from vulkansift_tpu_torch import compiled
    from vulkansift_tpu_torch.utils import trace

    built = []

    def build_detect(self, width, height, bucket):
        prog = compiled.DetectProgram(
            self.config, width, height, bucket=bucket, device=self.device,
            return_pyramid=self.config.retain_pyramid, pool=self._graph_pool)
        built.append(prog)
        return prog

    monkeypatch.setattr(trace, "_counts", dict(trace._counts))
    monkeypatch.setattr(vt.SiftInstance, "_build_detect", build_detect)
    monkeypatch.setattr(spans, "in_child", lambda parts: spans.measure(
        spans.program_trace(), **parts))
    return built


def per_layer_names(cell: str) -> set:
    return {x["name"] for x in spec.metrics_of(BENCH, cell)["per_layer"]}


def test_traced_tiny_run_reads_every_metric(tiny, programs_on_cpu,
                                            monkeypatch):
    import run as bench_run
    from yardstick import loop
    from yardstick import trace as trace_mod

    p = tiny(CELL)
    monkeypatch.setattr(spans, "command_line_parts", lambda: dict(
        cfg_file=p["cfg_file"], traffic=p["traffic"], seed=SEED))
    kept, work_items = {}, bench_run.work_items

    def keep(c, trace, cfg_file):
        kept["items"] = work_items(c, trace, cfg_file)
        return kept["items"]

    monkeypatch.setattr(bench_run, "work_items", keep)
    out = bench_run.measure(**p, seed=SEED, seconds=2, trace=True,
                            device="cpu")
    got = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    assert out["result"]["correct"] is True, out["why"]
    # No kernel runs on the CPU's trace: the roofline has nothing to read.
    assert set(got) == per_layer_names(CELL) - {"video.kernel_roofline"}
    assert all(isinstance(v, (int, float)) for v in got.values()), got
    frame = p["cfg_file"]["frame"]
    assert got["video.upload_mb"] == frame["width"] * frame["height"] / 1e6
    prog = programs_on_cpu[-1]
    assert got["video.copy_out_gb"] == prog.output_bytes / 1e9 \
        == static_output_bytes(p["cfg_file"]) / 1e9
    assert got["video.upload_ms"] > 0 and got["video.copy_out_ms"] > 0
    assert got["video.clone_ms"] == 0.0

    # The device readers on the traced frames' own work, with the detect
    # kernels, a clone and a fill given device time.
    run = loop.Run(device="cpu", window_s=1.0,
                   spans=loop.Spans(names=[], latencies_ns=[1] * 10))
    run.kernels, run.work_items = spec.kernels(), kept["items"]
    detect = [k.SYMBOL for k in run.kernels if k.GROUP == "detect"]
    device_s = {s: 1e-3 for s in detect}
    device_s.update({trace_mod.short_name(
        "Memcpy DtoD (Device -> Device)"): 2e-3, "Memset (Device)": 1e-3})
    n = len(kept["items"])
    run.trace = {"items": list(range(n)), "busy_s": 10e-3,
                 "device_s": device_s}
    share = spec.reader("video.kernel_roofline").read(run)
    assert share == readers.roofline_share(run, "detect") and 0 < share
    assert spec.reader("video.clone_ms").read(run) == pytest.approx(2.0 / n)
    assert spec.reader("video.glue_ms").read(run) == \
        pytest.approx((10 - len(detect)) / n)


def test_counter_metrics_silent_where_the_program_has_no_counter():
    """A checkout whose program lacks the byte counters (the parent of the
    change that adds them) reads None, not an error."""
    from yardstick import loop
    run = loop.Run(device="cpu")
    run.program_spans = {"items": 10, "counters": {"host_reads": 120},
                         "span_s": {}}
    for n in ("video.upload_mb", "video.copy_out_gb"):
        assert spec.reader(n).read(run) is None
    run.program_spans["counters"]["compiled.upload_bytes"] = 10 * 7962624
    assert spec.reader("video.upload_mb").read(run) == 7.962624


@pytest.mark.card
def test_traced_tiny_run_on_card(card, tiny, monkeypatch):
    import run as bench_run
    p = tiny(CELL)
    monkeypatch.setattr(spans, "command_line_parts", lambda: dict(
        cfg_file=p["cfg_file"], traffic=p["traffic"], seed=SEED))
    out = bench_run.measure(**p, seed=SEED, seconds=2, trace=True,
                            device=card)
    got = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    assert out["result"]["correct"] is True, out["why"]
    assert set(got) == per_layer_names(CELL), json.dumps(got)
    frame = p["cfg_file"]["frame"]
    assert got["video.upload_mb"] == frame["width"] * frame["height"] / 1e6
    assert got["video.copy_out_gb"] == \
        static_output_bytes(p["cfg_file"]) / 1e9
    assert 0 < got["video.kernel_roofline"] <= 105
    assert got["video.clone_ms"] > 0
