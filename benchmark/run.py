"""Run one cell of the benchmark of ``vulkansift_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up makes the cell's frames from the seed, builds the instance and
runs two items (every program recorded, every kernel built or loaded from
the checkout's ``build/``); the window then runs the cell's closed loop
for ``--seconds``. ``--trace 1`` adds a traced window of a fixed number of
items and reports the per-layer metrics instead of the end-to-end ones.
After the window the sampled answers are judged against the plain
reference in ``reference/``; the last line of standard output is the
result as JSON, the last lines of standard error the numbers compared,
each beside its limit. No card, too few cards, or JAX loaded: a message,
exit code 2 and no result.
"""

from __future__ import annotations

import os
import time

T_MODULE = time.time()


def process_start() -> float:
    """The process's start on the wall clock (Linux), else this module's."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return min(time.time() - up + ticks / os.sysconf("SC_CLK_TCK"),
                   T_MODULE)
    except (OSError, ValueError, IndexError):
        return T_MODULE


import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
# The benchmark's own modules, then the checkout's root for the program.
sys.path[:0] = [str(HERE), str(HERE.parent)]

FORBIDDEN = ("jax", "jaxlib", "flax", "vulkansift_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load(cell_name: str) -> dict:
    """The cell's configuration, traffic mix and metrics, by the names in
    ``BENCHMARK.json``."""
    from yardstick import spec
    bench = spec.benchmark()
    cell = spec.cell(bench, cell_name)
    return dict(cfg_file=spec.config(bench, cell["config"]),
                traffic=spec.traffic(cell["traffic"]),
                wanted=spec.metrics_of(bench, cell_name))


def measure(cfg_file: dict, traffic: dict, wanted: dict,
            seed: int, seconds: float, trace: bool, device: str = "cuda",
            instance_factory=None, control: bool = False) -> dict:
    """One run: everything but the look for a card and the printing.
    Returns the result's fields and what was not correct (or None); with
    ``control``, also the match check's control numbers on the same
    sampled answers (:func:`control_numbers`)."""
    import torch
    from yardstick import check, loop, spec
    from yardstick import trace as trace_mod
    from reference import sift as ref_sift

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    run = loop.Run(device=device)
    c = loop.Cell(cfg_file, traffic, seed, device, instance_factory)
    run.setup_s = time.time() - process_start()
    c.window(seconds, run)
    if trace:
        run.trace = trace_mod.traced_window(c, traffic["traced_items"])
        run.kernels = spec.kernels()
        run.work_items = work_items(c, run.trace, cfg_file)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    got = c.collect()
    images = c.images
    c.close()
    del c
    if on_card:
        torch.cuda.empty_cache()

    ref_cfg = dict(cfg_file["sift_config"])
    numbers = loop.judge(got, images, device,
                         lambda img: ref_sift.detect(img, ref_cfg, device))
    limits, required = {}, []
    if traffic["check"]["detect_items"]:
        limits.update(spec.check_limits("detect"))
        required += list(check.DETECT_NUMBERS)
    if traffic["check"]["match_items"]:
        limits.update(spec.check_limits("match"))
        required.append("match_wrong")
    limits = {k: v for k, v in limits.items() if not k.startswith("_")}
    bad = check.verdict(numbers, limits, required)
    if run.failed:
        bad = bad or f"{run.failed} of {run.attempted} items raised"

    metrics = {}
    for m in wanted["per_layer" if trace else "end_to_end"]:
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    res = {"correct": bad is None, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": device_info(device, peak, run)}
    if trace:
        res["breakdown"] = trace_mod.breakdown(run.trace)
    res["checks"] = {k: {"value": numbers.get(k), "limit": limits.get(k)}
                     for k in required}
    out = {"result": res, "why": bad, "numbers": numbers}
    if control:
        out["control"] = control_numbers(got, images, device)
    return out


def control_config(cfg_file: dict) -> dict:
    """The configuration with the program's own lower-precision path
    switched on (``checks/detect.json``'s ``_control_config``): the
    control of the detect check."""
    from yardstick import spec
    out = copy.deepcopy(cfg_file)
    out["sift_config"].update(spec.check_limits("detect")["_control_config"])
    return out


def control_numbers(got: dict, images, device) -> dict:
    """The match check's control: the reference's 2-NN on the same sampled
    descriptors cut to 4 bits, judged like the program's matches."""
    from yardstick import check, loop
    ctl = {"detect": [], "match": []}
    for fa, fb, _ in got["match"]:
        ctl["match"].append((fa, fb, check.reference_matches(
            np.asarray(fa["descriptor"]), np.asarray(fb["descriptor"]),
            device, bits=4)))
    return loop.judge(ctl, images, device, None)


def work_items(c, trace: dict, cfg_file: dict):
    """The traced items' work: each detect's frame and features (from the
    item's own download, or the detect run again now), and the match's
    live counts."""
    from yardstick import roofline, traffic as tm
    ref_cfg = dict(cfg_file["sift_config"])
    w, h = cfg_file["frame"]["width"], cfg_file["frame"]["height"]
    cache = {}
    out = []
    for idx, kept in zip(trace["items"], trace["kept"]):
        item = c.items[idx]
        frames = []
        for img, buf in tm.detects(c.calls, item):
            feats = kept.get(("download_features", buf))
            if feats is None:
                if img not in cache:
                    c.inst.detect_features(c.images[img], buf)
                    cache[img] = c.inst.download_features(buf)
                feats = cache[img]
            frames.append(roofline.Frame(ref_cfg, w, h, feats))
        na = nb = None
        pair = tm.matched_buffers(c.calls, item)
        if pair is not None:
            counts = {}
            for img, buf in tm.detects(c.calls, item):
                counts[buf] = len(cache[img]) if img in cache else None
            for buf in pair:
                if counts.get(buf) is None:
                    counts[buf] = c.inst.get_features_number(buf)
            na, nb = counts[pair[0]], counts[pair[1]]
        out.append(roofline.Item(frames, na, nb))
    return out


def device_info(device: str, peak: int, run) -> dict:
    import torch
    info = {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}
    if torch.device(device).type == "cuda":
        info.update(platform="gpu", kind=torch.cuda.get_device_name(0))
    if run.trace:
        info.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from yardstick import spec
    chips = spec.cell(spec.benchmark(), args.workload)["chips"]
    parts = load(args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and does not "
             "fall back to the CPU")
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} cards, "
             f"{torch.cuda.device_count()} present")
    out = measure(**parts, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace))
    found = forbidden_modules()
    if found:
        fail(f"modules loaded that the benchmark may not load: {found}")
    res = out["result"]
    for k, v in res["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    if out["why"]:
        print(f"not correct: {out['why']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
