"""One run of one cell: set-up, the closed loop's window, the traced
window and the correctness check.

The loop has one caller: each instance call waits for the one before it,
as VulkanSift's ``perf_runtime`` and a feature-extraction job call the
library. Every call is a host span (``perf_counter_ns`` before and after,
in the benchmark's own code); an item's latency runs from its first call
to the return of its last.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, traffic as traffic_mod

# Items run before the window, so that every program the window replays is
# recorded and every kernel built; the traffic's ``warmup_seconds`` of the
# closed loop follow, because a replayed program runs slower for the first
# seconds of a process (11.1-12.0 against 10.24-10.31 ms a 1536x1024
# detect replay for 5 to 20 s, H100).
WARMUP_ITEMS = 2


@dataclasses.dataclass
class Spans:
    """Host spans of the window: each item's call durations (ns, in the
    order of ``names``) and its latency."""

    names: List[str]
    durations: List[List[int]] = dataclasses.field(default_factory=list)
    latencies_ns: List[int] = dataclasses.field(default_factory=list)

    def mean_ms(self, pick: Callable[[str], bool]) -> Optional[float]:
        """Mean over items of the summed duration of the calls ``pick``
        selects, in ms."""
        cols = [i for i, n in enumerate(self.names) if pick(n)]
        if not cols or not self.durations:
            return None
        tot = sum(sum(d[i] for i in cols) for d in self.durations)
        return tot / len(self.durations) / 1e6


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read this."""

    setup_s: float = 0.0
    window_s: float = 0.0
    spans: Optional[Spans] = None
    attempted: int = 0
    failed: int = 0
    device: str = "cuda"
    trace: Optional[dict] = None
    kernels: list = dataclasses.field(default_factory=list)
    work_items: list = dataclasses.field(default_factory=list)

    def rate(self) -> Optional[float]:
        done = len(self.spans.latencies_ns)
        return done / self.window_s if self.window_s > 0 and done else None


def sift_config(cfg_file: dict, traffic: dict):
    import vulkansift_tpu_torch as vt
    fields = dict(cfg_file["sift_config"])
    fields["sift_buffer_count"] = traffic["buffers"]
    return vt.from_reference_dict(
        {k: (vt.DescriptorFormat[v] if k == "descriptor_format" else
             vt.PyramidPrecision[v] if k == "pyramid_precision" else v)
         for k, v in fields.items()})


class Cell:
    """The system under test driven by one traffic mix."""

    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device,
                 instance_factory=None):
        self.cfg_file, self.traffic = cfg_file, traffic
        self.device = device
        rng = np.random.default_rng(seed)
        self.images = traffic_mod.make_images(traffic, cfg_file["frame"], rng)
        self.items = traffic_mod.make_items(traffic, len(self.images))
        self.calls = traffic["calls"]
        # The sampled items whose answers the check judges, drawn from the
        # seed before the window.
        chk = traffic["check"]
        pick = np.random.default_rng([seed, 1])
        self.detect_sample = sorted(pick.choice(
            len(self.items), min(chk["detect_items"], len(self.items)),
            replace=False).tolist())
        self.match_sample = sorted(pick.choice(
            len(self.items), min(chk["match_items"], len(self.items)),
            replace=False).tolist())
        self.kept: Dict[int, Dict[str, object]] = {}
        if instance_factory is None:
            import vulkansift_tpu_torch as vt
            instance_factory = vt.SiftInstance
        self.inst = instance_factory(sift_config(cfg_file, traffic),
                                     device=device)
        self.setup_images: Dict[int, int] = {}
        if traffic["setup"] == "detect_all":
            for k in range(traffic["buffers"]):
                self.inst.detect_features(self.images[k], k)
                self.setup_images[k] = k
            for k in range(traffic["buffers"]):
                self.inst.get_features_number(k)
        for n in range(WARMUP_ITEMS):
            self.run_item(self.items[n % len(self.items)])
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < traffic["warmup_seconds"]:
            self.run_item(self.items[n % len(self.items)])
            n += 1
        self.sync()

    @property
    def on_card(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def run_item(self, item, durations: Optional[List[int]] = None,
                 keep: Optional[dict] = None,
                 spans: Optional[list] = None) -> int:
        """Run one item's calls. ``durations`` receives each call's host
        ns, ``keep`` its downloads, ``spans`` (start, end, name) on the
        wall clock."""
        t_first = None
        for call in self.calls:
            args = [traffic_mod.resolve(a, item, self.images)
                    for a in call[1:]]
            fn = getattr(self.inst, call[0])
            w0 = time.time_ns() if spans is not None else 0
            t0 = time.perf_counter_ns()
            out = fn(*args)
            t1 = time.perf_counter_ns()
            if spans is not None:
                spans.append((w0, w0 + t1 - t0, call[0]))
            t_first = t0 if t_first is None else t_first
            if durations is not None:
                durations.append(t1 - t0)
            if keep is not None and call[0].startswith("download_"):
                keep[(call[0], *args)] = out
        return t1 - t_first

    def window(self, seconds: float, run: Run) -> None:
        """Cycle the items until ``seconds`` have passed; the window ends
        with the last item that completes."""
        spans = Spans(names=[c[0] for c in self.calls])
        sampled = set(self.detect_sample) | set(self.match_sample)
        n = len(self.items)
        k = 0
        t0 = time.perf_counter()
        while True:
            idx = k % n
            durs: List[int] = []
            keep = {} if idx in sampled else None
            run.attempted += 1
            try:
                lat = self.run_item(self.items[idx], durs, keep)
            except Exception:  # noqa: BLE001  (counted; the run goes on)
                run.failed += 1
            else:
                spans.durations.append(durs)
                spans.latencies_ns.append(lat)
                if keep is not None:
                    self.kept[idx] = keep
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        run.window_s = time.perf_counter() - t0
        run.spans = spans

    # -- after the window ------------------------------------------------------
    def _features(self, idx: int) -> Dict[int, tuple]:
        """buffer -> (image index, the program's features) for a sampled
        item: the window's own download where the item made one, else the
        item's detects run again (or, for buffers the set-up filled, the
        set-up's) and downloaded now."""
        item = self.items[idx]
        kept = self.kept.get(idx, {})
        out = {}
        for img, buf in traffic_mod.detects(self.calls, item):
            got = kept.get(("download_features", buf))
            if got is None:
                self.inst.detect_features(self.images[img], buf)
                got = self.inst.download_features(buf)
            out[buf] = (img, got)
        pair = traffic_mod.matched_buffers(self.calls, item)
        for buf in pair or ():
            if buf not in out:
                out[buf] = (self.setup_images[buf],
                            self.inst.download_features(buf))
        return out

    def collect(self) -> dict:
        """The answers the check judges, taken from the program before it
        is closed: per sampled item, its features and its matches."""
        got = {"detect": [], "match": []}
        for idx in self.detect_sample:
            if idx in self.kept:
                for img, feats in self._features(idx).values():
                    got["detect"].append((img, feats))
        for idx in self.match_sample:
            pair = traffic_mod.matched_buffers(self.calls, self.items[idx])
            if pair is None or idx not in self.kept:
                continue
            feats = self._features(idx)
            matches = self.kept[idx].get(("download_matches",))
            got["match"].append((feats[pair[0]][1], feats[pair[1]][1],
                                 matches))
        return got

    def close(self) -> None:
        self.inst.close()
        self.inst = None


def judge(got: dict, images, device, detect_fn) -> Dict[str, float]:
    """The run's worst numbers over the sampled answers. ``detect_fn``
    makes the reference's features of an image (memoised here)."""
    worst: Dict[str, float] = {}
    refs: Dict[int, dict] = {}
    for img, feats in got["detect"]:
        if img not in refs:
            refs[img] = detect_fn(images[img])
        check.fold(worst, check.compare_features(feats, refs[img], device))
    for fa, fb, matches in got["match"]:
        ref = check.reference_matches(np.asarray(fa["descriptor"]),
                                      np.asarray(fb["descriptor"]), device)
        prog = matches if matches is not None else np.zeros(0, ref.dtype)
        check.fold(worst, check.compare_matches(prog, ref))
    return worst


