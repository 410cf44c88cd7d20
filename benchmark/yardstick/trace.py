"""The traced window: ``torch.profiler`` on the card over a fixed number of
items, read into device busy time, each kernel's device time, the top
device operations and the idle gaps by what the host was doing.

Only CUDA activity is traced: recording every host operation as well
doubles the host's time a call (1.06 against 0.44 ms a match and
download, 24.8 against 21.4 ms a 1536x1024 frame, H100). Device intervals
are every CUDA activity of the trace (kernels, also those inside a
replayed CUDA graph, copies and fills); busy time is the length of their
union. An idle gap is a stretch between two device intervals; it is put
down to the instance call whose host span (the benchmark's own
``time.time_ns`` readings, the clock the profiler's timestamps are on)
holds its midpoint.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Tuple


def _ns(evt, what: str) -> int:
    f = getattr(evt, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(evt, f"{what}_us")() * 1000)


def _device_events(prof):
    """Device intervals [(start, end, name)] in ns."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()) and not e.is_user_annotation():
            start = _ns(e, "start")
            dev.append((start, start + _ns(e, "duration"), e.name()))
    return dev


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments and
    parameters."""
    name = name.removeprefix("void ")
    for stop in ("(", "<"):
        name = name.split(stop)[0]
    return name[:80]


def reduce(dev, host, t0_ns: int, t1_ns: int) -> dict:
    """Busy and window seconds, device seconds by short name, and idle
    seconds by host annotation, over the window [t0, t1]."""
    dev = [(max(s, t0_ns), min(e, t1_ns), n) for s, e, n in dev
           if e > t0_ns and s < t1_ns]
    busy = union([(s, e) for s, e, _ in dev])
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, n in dev:
        by_name[short_name(n)] += (e - s) / 1e9
    gaps: Dict[str, float] = collections.defaultdict(float)
    host = sorted(host)
    starts = [h[0] for h in host]
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        # The benchmark's annotations do not nest: the last one to start
        # before the midpoint is the only one that can hold it.
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = host[i][2] if i >= 0 and mid < host[i][1] \
            else "between calls"
        gaps[label] += (ge - gs) / 1e9
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (t1_ns - t0_ns) / 1e9,
            "device_s": dict(by_name), "idle_s": dict(gaps)}


def traced_window(cell, n_items: int) -> dict:
    """Run ``n_items`` items under the profiler and reduce the trace. Also
    returns the traced items and their downloads, for the readers that
    count the work those items needed."""
    from torch.profiler import ProfilerActivity, profile
    items, kept, host = [], [], []
    cell.sync()
    acts = [ProfilerActivity.CUDA] if cell.on_card else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        for k in range(n_items):
            idx = k % len(cell.items)
            keep: dict = {}
            cell.run_item(cell.items[idx], keep=keep, spans=host)
            items.append(idx)
            kept.append(keep)
        cell.sync()
        t1 = time.time_ns()
    out = reduce(_device_events(prof), host, t0, t1)
    out.update(items=items, kept=kept)
    return out


def breakdown(trace: dict) -> dict:
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(trace["device_s"]),
            "idle_gaps": top(trace["idle_s"])}
