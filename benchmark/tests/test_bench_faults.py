"""A whole run with the timed path broken underneath sees ``correct`` come
out false, once for each fault the cells can have: a detect that leaves
its buffer as it was, half of the answer's rows left out, and an answer
altered where it is produced. It skips the look for a card and runs on the
CPU at a small size (one chip: no exchange between chips to leave out)."""

import numpy as np
import pytest

SECONDS = {"hannover1536-video": 3, "oxford640-pairs": 8,
           "hannover1536-exhaustive": 2}


class Faulty:
    """The port's instance with one fault planted."""

    def __init__(self, fault, config, device):
        import vulkansift_tpu_torch as vt
        self.inst = vt.SiftInstance(config, device=device)
        self.fault = fault
        self.detects = 0

    def __getattr__(self, name):
        return getattr(self.inst, name)

    def detect_features(self, image, buf):
        self.detects += 1
        if self.fault == "unchanged" and self.detects > 1:
            return
        self.inst.detect_features(image, buf)

    def download_features(self, buf):
        f = self.inst.download_features(buf)
        if self.fault == "half_features":
            return f[:len(f) // 2]
        if self.fault == "altered_features" and len(f):
            f = f.copy()
            f["descriptor"][0, 0] = (int(f["descriptor"][0, 0]) + 128) % 256
        return f

    def download_matches(self):
        m = self.inst.download_matches()
        if self.fault == "half_matches":
            return m[:len(m) // 2]
        if self.fault == "altered_matches" and len(m):
            m = m.copy()
            m["idx_b1"][0] = m["idx_b2"][0] if m["idx_b2"][0] != \
                m["idx_b1"][0] else m["idx_b1"][0] + 1
        return m


CASES = [
    ("hannover1536-video", "unchanged"),
    ("hannover1536-video", "half_features"),
    ("hannover1536-video", "altered_features"),
    ("oxford640-pairs", "unchanged"),
    ("oxford640-pairs", "half_matches"),
    ("oxford640-pairs", "altered_matches"),
    ("hannover1536-exhaustive", "unchanged"),
    ("hannover1536-exhaustive", "half_matches"),
    ("hannover1536-exhaustive", "altered_matches"),
]


def _measure(tiny, cell, fault):
    import run as bench_run
    return bench_run.measure(
        **tiny(cell), seed=2 ** 31 + 11, seconds=SECONDS[cell], trace=False,
        device="cpu",
        instance_factory=lambda cfg, device: Faulty(fault, cfg, device))


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_sound_run_is_correct(tiny, cell):
    out = _measure(tiny, cell, None)
    assert out["result"]["correct"], out["why"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny, cell, fault):
    out = _measure(tiny, cell, fault)
    assert out["result"]["correct"] is False
    assert out["why"]
