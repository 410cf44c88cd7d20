"""The harness finds every configuration, traffic mix, metric reader,
kernel and check by the names in ``BENCHMARK.json``, and the file keeps
the benchmark contract's shape."""

import re

import pytest

from yardstick import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = spec.config(BENCH, w["config"])
    t = spec.traffic(w["traffic"])
    assert {"frame", "sift_config", "source"} <= set(cfg)
    assert {"images", "buffers", "setup", "items", "calls", "check",
            "traced_items"} <= set(t)
    m = spec.metrics_of(BENCH, w["name"])
    names = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert m["per_layer"]


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]


def test_names_units_and_keys():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in BENCH[group]:
            assert NAME.match(x["name"]), x["name"]
            assert x["name"] not in seen
            seen.add(x["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert spec.load_json(spec.REPO / c["file"])["reduced"] == c["reduced"]


def test_kernels_and_checks_found_by_name():
    ks = spec.kernels()
    assert {k.SYMBOL for k in ks} == {
        "blur_dog_kernel", "frontend_kernel", "orientation_hist_kernel",
        "descriptor_kernel", "match_2nn_kernel"}
    assert {k.GROUP for k in ks} == {"detect", "match"}
    assert spec.check_limits("match")["match_wrong"] == 0
    assert set(spec.check_limits("detect")) >= {
        "det_unpaired", "det_pos_gap", "det_ori_gap", "det_desc_gap"}


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(KeyError):
        spec.config(BENCH, "no-such-config")
