"""The program's own spans and counters (``vulkansift_tpu_torch.utils.trace``),
read into per-layer metrics of ``--trace 1``.

The metric readers run after the cell's windows, with the cell closed. The
first reader that needs spans runs three more windows, in a process of
their own (the profiler, once used, leaves a replayed graph's launch
slower in its process: 4.83 against 1.84 ms a 1536x1024
``detect_features`` call, H100) on a cell built from the same
configuration, traffic mix and seed (``run.py``'s ``--workload`` and
``--seed``), with the same set-up as the run's own (``loop.Cell``: the
traffic's ``warmup_seconds`` of the closed loop):

* a window of ``HOST_ITEMS`` times the traffic's ``traced_items`` items
  with spans off, each call timed from outside as the run's own window
  times it;
* the spans window, as long: the program's spans on, no profiler, each
  call timed from outside again, the counters read before and after it.
  The host figures come from it: the profiler stretches a replayed
  graph's launch.
* the spans + profiler window of ``traced_items`` items, as the run's
  traced window: each device-idle gap put down to the innermost program
  span that holds its midpoint, else to the benchmark's own call label
  (``idle_spans``), once the window's probe kernels have measured where
  the profiler put the card's clock (``clock_offset_us``).

All are kept on the run and printed to standard error as one ``program
spans:`` line, with the share of each ``detect_features`` call that its
child spans cover, and each call's mean ms in the run's own window, in the
spans-off window and in the spans window (``calls_ms``): where those
agree, the spans window's host figures stand for the run's window.

The set-up counters are read once, at the first reading and before that
cell is built. Every program a cell replays is recorded, and every kernel
library loaded, in its set-up (``loop.WARMUP_ITEMS`` runs every call of
the traffic), so the process's totals then are the set-up's.

A checkout whose program has no spans reads None: the metric is left out
of the line.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

from . import loop, spec
from . import trace as trace_mod

CHILD_TIMEOUT_S = 600
# The host windows run this many times the traffic's ``traced_items``: a
# window of 20 items is a third of a second of a shared host whose calls
# swing from one second to the next (1.50-5.74 ms a 1536x1024
# ``detect_features`` call in 20-item windows, H100).
HOST_ITEMS = 10
PROBES = 16   # kernels that measure the profiler's clock offset


def program_trace():
    """The program's span and counter module, or None where it has none."""
    try:
        from vulkansift_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def setup_counter(run, name: str) -> Optional[float]:
    """Counter ``name`` as the cell's set-up left it."""
    if not hasattr(run, "program_setup"):
        pt = program_trace()
        run.program_setup = None if pt is None else pt.counters()
    return None if run.program_setup is None else run.program_setup.get(name)


def ms_per_item(run, name: str) -> Optional[float]:
    """Host ms an item inside the spans named ``name`` (spans window)."""
    w = windows(run)
    if w is None or name not in w["span_s"]:
        return None
    return w["span_s"][name] * 1e3 / w["items"]


def counter_per_item(run, name: str) -> Optional[float]:
    """Counter ``name``'s increase an item over the spans window."""
    w = windows(run)
    return None if w is None else w["counters"][name] / w["items"]


def _arg(flag: str) -> Optional[str]:
    argv = sys.argv[1:]
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def command_line_parts() -> Optional[dict]:
    """The configuration, traffic mix and seed of the cell that ``run.py``
    was started for; None in a process started otherwise."""
    name, seed = _arg("--workload"), _arg("--seed")
    if name is None or seed is None:
        return None
    bench = spec.benchmark()
    cell = spec.cell(bench, name)
    return dict(cfg_file=spec.config(bench, cell["config"]),
                traffic=spec.traffic(cell["traffic"]), seed=int(seed))


def windows(run, parts: Optional[dict] = None) -> Optional[dict]:
    """The windows' figures, measured at the first call for a run (on
    ``parts``, else on the command line's cell) and kept on it."""
    if hasattr(run, "program_spans"):
        return run.program_spans
    run.program_spans = None
    pt = program_trace()
    if pt is None:
        return None
    setup_counter(run, "programs.record_s")
    parts = parts or command_line_parts()
    if parts is None:
        return None
    try:
        run.program_spans = in_child(dict(parts, device=run.device))
    except Exception:  # noqa: BLE001  (the other metrics are still read)
        traceback.print_exc()
        return None
    if run.spans is not None:
        run.program_spans["calls_ms"]["run"] = {
            n: run.spans.mean_ms(lambda m, n=n: m == n)
            for n in run.spans.names}
    print("program spans: " + json.dumps(run.program_spans),
          file=sys.stderr, flush=True)
    return run.program_spans


def in_child(parts: dict) -> dict:
    """:func:`measure` of ``parts`` (as JSON) in a new Python process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(spec.ROOT), str(spec.REPO)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    p = subprocess.run([sys.executable, "-m", "yardstick.spans"],
                       input=json.dumps(parts), capture_output=True,
                       text=True, env=env, cwd=str(spec.REPO),
                       timeout=CHILD_TIMEOUT_S)
    sys.stderr.write(p.stderr[-4000:])
    if p.returncode != 0:
        raise RuntimeError(f"spans windows exited with {p.returncode}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    pt = program_trace()
    parts = json.loads(sys.stdin.read())
    print(json.dumps(measure(pt, **parts)), flush=True)
    return 0


def measure(pt, cfg_file: dict, traffic: dict, seed: int,
            device: str) -> dict:
    """Set up a cell as the run does, run the spans-off window, the spans
    window and the spans + profiler window, close the cell."""
    cell = loop.Cell(cfg_file, traffic, seed, device)
    n = traffic["traced_items"]
    m = HOST_ITEMS * n
    try:
        off = calls_ms(cell, m)
        before = pt.counters()
        pt.start()
        try:
            on = calls_ms(cell, m)
        finally:
            spans = pt.stop()
        after = pt.counters()
        out = {"items": m,
               "counters": {k: after[k] - before[k] for k in after},
               "span_s": seconds_by_name(spans),
               "detect_cover": cover(spans, "detect_features"),
               "calls_ms": {"spans_off": off, "spans_on": on}}
        out.update(profiled(pt, cell, n))
    finally:
        cell.close()
    return out


def calls_ms(cell, n: int) -> Dict[str, float]:
    """Run ``n`` items; each call's mean host ms an item, timed from
    outside as ``loop.Cell.window`` times it."""
    names = [c[0] for c in cell.calls]
    tot = collections.defaultdict(int)
    cell.sync()
    for k in range(n):
        durs: List[int] = []
        cell.run_item(cell.items[k % len(cell.items)], durs)
        for name, d in zip(names, durs):
            tot[name] += d
    cell.sync()
    return {name: tot[name] / n / 1e6 for name in names}


def seconds_by_name(spans) -> Dict[str, float]:
    out: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        out[s.name] += (s.end_ns - s.start_ns) / 1e9
    return dict(out)


def cover(spans, root: str) -> Optional[float]:
    """The share of the time of the root spans named ``root`` that their
    child spans cover."""
    total = covered = 0
    kids: Dict[int, list] = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append((s.start_ns, s.end_ns))
    for s in spans:
        if s.parent < 0 and s.name == root:
            total += s.end_ns - s.start_ns
            covered += sum(
                min(e, s.end_ns) - max(b, s.start_ns)
                for b, e in trace_mod.union(kids[s.id]))
    return covered / total if total else None


def profiled(pt, cell, n: int) -> dict:
    """``n`` items under the profiler with spans on: device-idle seconds
    by span (``idle_spans``) and the share of the idle time inside the
    program's root spans that falls under a child span. On a card the
    window starts with :func:`probe` kernels, and the device intervals
    are moved onto the host's clock by :func:`clock_offset`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    host: list = []
    cell.sync()
    x = torch.zeros(1, device=cell.device) if cell.on_card else None
    acts = [ProfilerActivity.CUDA] if cell.on_card else \
        [ProfilerActivity.CPU]
    pt.start()
    try:
        with profile(activities=acts) as prof:
            probes = probe(x) if x is not None else []
            t0 = time.time_ns()
            for k in range(n):
                cell.run_item(cell.items[k % len(cell.items)], spans=host)
            cell.sync()
            t1 = time.time_ns()
    finally:
        spans = pt.stop()
    dev = trace_mod._device_events(prof)
    off = clock_offset(dev, probes) if probes else 0
    idle, in_child, in_root = idle_by_span(
        [(s - off, e - off, name) for s, e, name in dev], spans, host,
        t0, t1)
    top = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"idle_spans": [[k, v] for k, v in top],
            "idle_child_share": (in_child / (in_child + in_root)
                                 if in_child + in_root else None),
            "clock_offset_us": off / 1e3}


def probe(x, n: int = PROBES) -> List[int]:
    """Launch ``n`` one-element kernels on ``x``'s idle card, each right
    after a host reading of ``time.time_ns()``; returns the readings. Run
    first in a profiler window, so that its first device intervals are
    these kernels (:func:`clock_offset`)."""
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize(x.device)
        out.append(time.time_ns())
        x.add_(1)
    torch.cuda.synchronize(x.device)
    return out


def clock_offset(dev, probes: List[int]) -> int:
    """How far the profiler's device intervals ``dev`` lie ahead of the
    host's clock, in ns: the least lag from a :func:`probe` reading to the
    start of its kernel (a launch's own latency, about 10 us, included).
    The profiler maps the card's clock onto ``time.time_ns()`` once a
    window, and a window read 11 us where another of the same process read
    -668 us (H100)."""
    starts = sorted(s for s, _, _ in dev)[:len(probes)]
    return min(s - t for s, t in zip(starts, probes))


def idle_by_span(dev, spans, host, t0: int, t1: int):
    """Idle seconds by label over [t0, t1], and the idle seconds held by
    child spans and by root spans alone. A gap's label is the innermost
    program span holding its midpoint; outside every span, the
    benchmark's call label (``<call> outside spans``) or ``between
    calls``."""
    busy = trace_mod.union([(max(s, t0), min(e, t1)) for s, e, _ in dev
                            if e > t0 and s < t1])
    spans = sorted(spans, key=lambda s: (s.start_ns, s.id))
    starts = [s.start_ns for s in spans]
    host = sorted(host)
    hstarts = [h[0] for h in host]
    idle: Dict[str, float] = collections.defaultdict(float)
    in_child = in_root = 0.0
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid, secs = (gs + ge) // 2, (ge - gs) / 1e9
        held = _innermost(spans, starts, mid)
        if held is not None:
            idle[held.name] += secs
            if held.parent < 0:
                in_root += secs
            else:
                in_child += secs
            continue
        i = bisect.bisect_right(hstarts, mid) - 1
        label = f"{host[i][2]} outside spans" \
            if i >= 0 and mid < host[i][1] else "between calls"
        idle[label] += secs
    return idle, in_child, in_root


def _innermost(spans: List, starts: List[int], t: int):
    """The span with the latest start that holds ``t`` (spans of one
    thread, sorted by start): walking back stops at a root that ended
    before ``t``, since no earlier span can hold ``t`` then."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s = spans[i]
        if s.end_ns > t:
            return s
        if s.parent < 0:
            return None
        i -= 1
    return None


if __name__ == "__main__":
    sys.exit(main())
