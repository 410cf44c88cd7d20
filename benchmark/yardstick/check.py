"""The comparison that decides ``correct``.

Detect: the program's downloaded features of a frame against the plain
reference's features of the same frame. Features pair up within one
octave and scale index when their octave positions lie within
``PAIR_PX`` and their orientations within ``PAIR_RAD`` (closest pairs
first, one to one); the numbers are

* ``det_unpaired``: features of either side without a partner, as a share
  of the reference's count;
* ``det_pos_gap``: the widest gap of a pair's octave position (px);
* ``det_ori_gap``: the widest gap of a pair's orientation (rad);
* ``det_desc_gap``: the widest gap of a pair's descriptor bytes.

Match: the program's downloaded matches against the reference's 2-NN of
the same two feature sets (the program's own, as downloaded; the detect
check judges those): ``match_wrong``, the rows whose indices or distances
differ, plus any difference in the row count. It is exact.

Each frame's or pair's numbers are folded into the run's worst.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from reference import match as ref_match

PAIR_PX = 0.25
PAIR_RAD = 0.05
DETECT_NUMBERS = ("det_unpaired", "det_pos_gap", "det_ori_gap",
                  "det_desc_gap")


def _fields(feats) -> Dict[str, np.ndarray]:
    if isinstance(feats, dict):
        return feats
    return {k: feats[k] for k in feats.dtype.names}


def compare_features(prog, ref, device="cpu") -> Dict[str, float]:
    """The detect numbers of one frame (see the module's docstring)."""
    p, r = _fields(prog), _fields(ref)
    n_p, n_r = len(p["x"]), len(r["x"])
    paired = 0
    pos = ori = desc = 0.0
    for o in np.union1d(np.unique(p["octave_idx"]), np.unique(r["octave_idx"])):
        ip = np.nonzero(p["octave_idx"] == o)[0]
        ir = np.nonzero(r["octave_idx"] == o)[0]
        if len(ip) == 0 or len(ir) == 0:
            continue

        def t(a, idx, dt=torch.float64):
            return torch.as_tensor(np.asarray(a)[idx], device=device).to(dt)
        dx = (t(p["scale_x"], ip)[:, None] - t(r["scale_x"], ir)[None]).abs()
        dy = (t(p["scale_y"], ip)[:, None] - t(r["scale_y"], ir)[None]).abs()
        da = (t(p["orientation"], ip)[:, None]
              - t(r["orientation"], ir)[None]).abs() % (2 * math.pi)
        da = torch.minimum(da, 2 * math.pi - da)
        same = (t(p["scale_idx"], ip, torch.int64)[:, None]
                == t(r["scale_idx"], ir, torch.int64)[None])
        cost = torch.maximum(torch.maximum(dx, dy) / PAIR_PX, da / PAIR_RAD)
        cost = torch.where(same, cost, math.inf)
        # Greedy assignment by cost: duplicates (one point reached from two
        # candidates) pair up one to one.
        ci, cj = torch.nonzero(cost <= 1.0, as_tuple=True)
        order = torch.argsort(cost[ci, cj], stable=True).cpu().numpy()
        ci, cj = ci.cpu().numpy()[order], cj.cpu().numpy()[order]
        used_p, used_r, pa, pb = set(), set(), [], []
        for i, j in zip(ci.tolist(), cj.tolist()):
            if i not in used_p and j not in used_r:
                used_p.add(i)
                used_r.add(j)
                pa.append(i)
                pb.append(j)
        if not pa:
            continue
        a = torch.as_tensor(pa, device=device)
        b = torch.as_tensor(pb, device=device)
        paired += int(a.numel())
        pos = max(pos, float(torch.maximum(dx[a, b], dy[a, b]).max()))
        ori = max(ori, float(da[a, b].max()))
        dp = t(p["descriptor"], ip[a.cpu().numpy()], torch.int32)
        dr = t(r["descriptor"], ir[b.cpu().numpy()], torch.int32)
        desc = max(desc, float((dp - dr).abs().max()))
    unpaired = (n_p - paired) + (n_r - paired)
    return {"det_unpaired": unpaired / max(n_r, 1), "det_pos_gap": pos,
            "det_ori_gap": ori, "det_desc_gap": desc}


def reference_matches(desc_a: np.ndarray, desc_b: np.ndarray, device="cpu",
                      bits: int = 8) -> np.ndarray:
    """The reference's 2-NN as a structured array of the download's
    fields."""
    i1, i2, d1, d2 = ref_match.match_2nn(desc_a, desc_b, device, bits)
    out = np.zeros(len(i1), [("idx_a", np.uint32), ("idx_b1", np.uint32),
                             ("idx_b2", np.uint32), ("dist_a_b1", np.float32),
                             ("dist_a_b2", np.float32)])
    out["idx_a"] = np.arange(len(i1))
    out["idx_b1"], out["idx_b2"] = i1, i2
    out["dist_a_b1"], out["dist_a_b2"] = d1, d2
    return out


def compare_matches(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """``match_wrong`` of one pair: rows that differ in any field (bitwise
    for the distances), plus the difference of the row counts."""
    n = min(len(prog), len(ref))
    wrong = np.zeros(n, bool)
    for f in ("idx_a", "idx_b1", "idx_b2"):
        wrong |= prog[f][:n].astype(np.int64) != ref[f][:n].astype(np.int64)
    for f in ("dist_a_b1", "dist_a_b2"):
        wrong |= (prog[f][:n].view(np.uint32) != ref[f][:n].view(np.uint32))
    return {"match_wrong": float(wrong.sum() + abs(len(prog) - len(ref)))}


def fold(worst: Dict[str, float], new: Dict[str, float]) -> None:
    for k, v in new.items():
        worst[k] = max(worst.get(k, 0.0), v)


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            required) -> Optional[str]:
    """None when every required number was read and is within its limit,
    else what failed."""
    for k in required:
        if k not in numbers:
            return f"{k} was not read"
    for k, v in numbers.items():
        if k in limits and not v <= limits[k]:
            return f"{k} = {v!r} over its limit {limits[k]!r}"
    return None
