"""Arithmetic shared by the metric readers in ``metrics/``."""

from __future__ import annotations

from typing import Optional

from . import roofline


def items_traced(run) -> int:
    return len(run.trace["items"]) if run.trace else 0


def device_ms(run) -> Optional[float]:
    n = items_traced(run)
    return run.trace["busy_s"] * 1e3 / n if n else None


def kernel_s(run, group: str) -> float:
    return sum(run.trace["device_s"].get(k.SYMBOL, 0.0)
               for k in run.kernels if k.GROUP == group)


def glue_ms(run, group: str) -> Optional[float]:
    """Device ms an item outside the group's kernels."""
    n = items_traced(run)
    if not n:
        return None
    return (run.trace["busy_s"] - kernel_s(run, group)) * 1e3 / n


def roofline_share(run, group: str) -> Optional[float]:
    """The group's bound over its device time, in %, counted only over the
    kernels the trace saw (a kernel taken off the path counts neither)."""
    if not run.trace:
        return None
    bound = spent = 0.0
    for k in run.kernels:
        if k.GROUP != group:
            continue
        t = run.trace["device_s"].get(k.SYMBOL, 0.0)
        if t <= 0.0:
            continue
        spent += t
        for item in run.work_items:
            bound += sum(roofline.bound_s(b, o, rate)
                         for b, o, rate in k.work(item, run.device))
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None


def idle_share(run) -> Optional[float]:
    """1 - device busy ms an item in the traced window over wall ms an item
    in the untraced window (%). The traced window's own wall time is not
    used: the profiler stretches a replayed graph's launch on the host."""
    busy = device_ms(run)
    done = len(run.spans.latencies_ns) if run.spans else 0
    if busy is None or not done or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / (run.window_s * 1e3 / done))
