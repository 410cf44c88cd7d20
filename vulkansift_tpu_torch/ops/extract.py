"""DoG extrema detection and subpixel refinement.

Port of ``vulkansift_tpu/ops/extract.py`` (the reference's ExtractKeypoints
shader, reformulated dense-first):

1. :func:`dense_frontend` -- the plain version of kernel 2
   (:mod:`.frontend`): for every interior DoG cell, the strict 26-neighbour
   extremum test with the ``|v| > 0.8*threshold`` pre-filter and the packed
   Newton walk code, plus per-(layer, row) candidate counts.
2. :func:`rank_select` -- raster-order compaction to a static capacity with
   a cumsum and a scatter (no atomics, no ``torch.nonzero``, no host sync).
3. :func:`refine_candidates` -- each candidate walks the dense code field
   for 5 steps, then one 27-point Newton solve and the acceptance tests at
   its final cell (ExtractKeypoints.comp:133-206).

Code layout (the port's, used by the kernel and this plain version alike):
``code[s-1, y-1, x-1]`` for the interior cell (s, y, x) of an
``(S+2, H, W)`` DoG stack, shape ``(S, H-2, W-2)``, u8: walk code 0..107
plus the candidate bit 128. Row counts are ``counts[s-1, y-1]``, i32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import NB_REFINEMENT_STEPS

# Walk-code layout (u8): ms+1 (base 3) | mx+1 (base 3) | my+1 (base 3)
# | converged (27) | singular (54) -> [0, 107]; candidate bit 128.
_CODE_CONV = 27
_CODE_SING = 54
CODE_CAND = 128


class Candidates(NamedTuple):
    """Compacted extremum candidates for one octave (static capacity)."""

    s: torch.Tensor      # i32[K] DoG centre layer (1..nb_scales)
    y: torch.Tensor      # i32[K]
    x: torch.Tensor      # i32[K]
    count: torch.Tensor  # i32[] live candidates (clamped to K)
    code0: Optional[torch.Tensor] = None  # i32[K] walk code at (s, y, x)


class RefinedKeypoints(NamedTuple):
    """Refinement output; ``valid`` marks survivors of all final tests."""

    valid: torch.Tensor      # bool[K]
    scale_x: torch.Tensor    # f32[K] subpixel x in octave coords
    scale_y: torch.Tensor    # f32[K]
    subpix_s: torch.Tensor   # f32[K] subpixel scale
    scale_idx: torch.Tensor  # i32[K] round(subpix_s)
    sigma: torch.Tensor      # f32[K] absolute blur level (includes 2^octave)
    intensity: torch.Tensor  # f32[K] refined DoG value
    x: torch.Tensor          # f32[K] input-image x (= scale_x * 2^octave)
    y: torch.Tensor          # f32[K]


def scatter_ranks(rank: torch.Tensor, capacity: int,
                  dump: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[rank[i]] = i`` for ranks below ``capacity``; the other
    elements go to dump slots past the end (``dump``, default 0, spreads
    them over up to 256 slots) and are dropped. Slots no rank reaches are
    0."""
    n = rank.numel()
    src = torch.arange(n, dtype=torch.int32, device=rank.device)
    spill = capacity + (dump if dump is not None else 0)
    idx = torch.where(rank < capacity, rank, spill).to(torch.int64)
    out = torch.zeros(capacity + 256, dtype=torch.int32, device=rank.device)
    out.scatter_(0, idx.reshape(-1), src)
    return out[:capacity]


def rank_select(mask_flat: torch.Tensor,
                capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``capacity`` true elements, in order, and the
    true count clamped to ``capacity`` (a device scalar). Slots beyond the
    count are 0."""
    dev = mask_flat.device
    if mask_flat.numel() == 0:
        return (torch.zeros(capacity, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    cs = torch.cumsum(mask_flat.to(torch.int32), 0, dtype=torch.int32)
    count = torch.clamp(cs[-1], max=capacity)
    rank = torch.where(mask_flat, cs - 1, capacity)
    return scatter_ranks(rank, capacity), count


# ---------------------------------------------------------------------------
# Dense Newton step and walk-code classification
# ---------------------------------------------------------------------------

def _newton_step(n000, n001, n002, n010, n011, n012, n020, n021, n022,
                 n100, n101, n102, n110, n111, n112, n120, n121, n122,
                 n200, n201, n202, n210, n211, n212, n220, n221, n222):
    """One 3x3x3 Newton solve. Arguments n{s}{y}{x} are the neighbourhood
    values, offsets 0/1/2 meaning -1/0/+1. Returns (off_s, off_x, off_y,
    g_s, g_x, g_y, singular) (ExtractKeypoints.comp:124-165)."""
    g_s = 0.5 * (n211 - n011)
    g_x = 0.5 * (n112 - n110)
    g_y = 0.5 * (n121 - n101)
    ctr = n111
    h11 = n211 + n011 - 2.0 * ctr
    h22 = n112 + n110 - 2.0 * ctr
    h33 = n121 + n101 - 2.0 * ctr
    h12 = 0.25 * (n212 - n210 - n012 + n010)
    h13 = 0.25 * (n221 - n201 - n021 + n001)
    h23 = 0.25 * (n122 - n120 - n102 + n100)

    det = (h11 * (h22 * h33 - h23 * h23)
           - h12 * (h12 * h33 - h13 * h23)
           + h13 * (h12 * h23 - h13 * h22))
    singular = det == 0.0
    rdet = 1.0 / torch.where(singular, 1.0, det)
    inv11 = (h22 * h33 - h23 * h23) * rdet
    inv12 = -(h12 * h33 - h13 * h23) * rdet
    inv13 = (h12 * h23 - h13 * h22) * rdet
    inv22 = (h11 * h33 - h13 * h13) * rdet
    inv23 = -(h11 * h23 - h13 * h12) * rdet
    inv33 = (h11 * h22 - h12 * h12) * rdet

    off_s = -inv11 * g_s - inv12 * g_x - inv13 * g_y
    off_x = -inv12 * g_s - inv22 * g_x - inv23 * g_y
    off_y = -inv13 * g_s - inv23 * g_x - inv33 * g_y
    return off_s, off_x, off_y, g_s, g_x, g_y, singular


def _walk_classify(n000, n001, n002, n010, n011, n012, n020, n021, n022,
                   n100, n101, n102, n110, n111, n112, n120, n121, n122,
                   n200, n201, n202, n210, n211, n212, n220, n221, n222):
    """Division-free walk classification: each Newton offset classified
    into {<= -0.6, interior, >= 0.6} by comparing the Cramer numerators with
    ``0.6*|det|``. Returns (cs, cx, cy, conv, singular), c* in {0, 1, 2}.
    ``csrc/frontend.cu`` evaluates the same expressions in the same
    order."""
    g_s = 0.5 * (n211 - n011)
    g_x = 0.5 * (n112 - n110)
    g_y = 0.5 * (n121 - n101)
    ctr = n111
    h11 = n211 + n011 - 2.0 * ctr
    h22 = n112 + n110 - 2.0 * ctr
    h33 = n121 + n101 - 2.0 * ctr
    h12 = 0.25 * (n212 - n210 - n012 + n010)
    h13 = 0.25 * (n221 - n201 - n021 + n001)
    h23 = 0.25 * (n122 - n120 - n102 + n100)

    m11 = h22 * h33 - h23 * h23
    m12 = h12 * h33 - h13 * h23
    m13 = h12 * h23 - h13 * h22
    det = h11 * m11 - h12 * m12 + h13 * m13
    singular = det == 0.0
    num_s = -g_s * m11 + g_x * m12 - g_y * m13
    num_x = (g_s * m12 - g_x * (h11 * h33 - h13 * h13)
             + g_y * (h11 * h23 - h13 * h12))
    num_y = (-g_s * m13 + g_x * (h11 * h23 - h12 * h13)
             - g_y * (h11 * h22 - h12 * h12))
    thr = 0.6 * torch.abs(det)
    neg = det < 0.0

    def cls(num):
        n = torch.where(neg, -num, num)
        return torch.where(n >= thr, 2, torch.where(n <= -thr, 0, 1))

    cs, cx, cy = cls(num_s), cls(num_x), cls(num_y)
    conv = (cs == 1) & (cx == 1) & (cy == 1)
    return cs, cx, cy, conv, singular


def _neighbourhood(d: torch.Tensor) -> list:
    """The 27 shifted interior views of an (S+2, H, W) stack, in
    n{s}{y}{x} order."""
    ns, h, w = d.shape
    return [d[a:a + ns - 2, b:b + h - 2, c:c + w - 2]
            for a in (0, 1, 2) for b in (0, 1, 2) for c in (0, 1, 2)]


def dense_frontend(dog: torch.Tensor, dog_threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 2 for one octave.

    Returns (code u8 (S, H-2, W-2) -- walk code plus candidate bit 128 --,
    row counts i32 (S, H-2)). The candidate test is the strict
    26-neighbour extremum with ``|v| > 0.8*threshold``; the threshold is
    compared in float32 (``float32(threshold*0.8)``)."""
    d = dog.to(torch.float32)
    nb = _neighbourhood(d)
    ctr = nb[13]
    others = torch.stack(nb[:13] + nb[14:])
    nb_max = others.amax(0)
    nb_min = others.amin(0)
    del others
    cand = (torch.abs(ctr) > dog_threshold * 0.8) & (
        (ctr > nb_max) | (ctr < nb_min))
    cs, cx, cy, conv, singular = _walk_classify(*nb)
    code = (cs + 3 * cx + 9 * cy + _CODE_CONV * conv.to(torch.int64)
            + _CODE_SING * singular.to(torch.int64)
            + CODE_CAND * cand.to(torch.int64))
    counts = cand.sum(dim=2, dtype=torch.int32)
    return code.to(torch.uint8), counts


def compact_candidates(code: torch.Tensor, counts: torch.Tensor,
                       capacity: int) -> Candidates:
    """Raster-order compaction of the frontend's candidate bits into
    :class:`Candidates`: an exclusive cumsum of the row counts gives each
    row's first rank, a cumsum along the row the rank within it, and one
    scatter places every candidate (no atomics, no host sync)."""
    s_l, h2, w2 = code.shape
    dev = code.device
    if code.numel() == 0:
        z = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return Candidates(z + 1, z + 1, z + 1,
                          torch.zeros((), dtype=torch.int32, device=dev), z)
    rows = counts.reshape(-1)
    row_cs = torch.cumsum(rows, 0, dtype=torch.int32)
    cand = (code >= CODE_CAND).reshape(s_l * h2, w2)
    within = torch.cumsum(cand.to(torch.int32), 1, dtype=torch.int32)
    rank = torch.where(cand, (row_cs - rows)[:, None] + within - 1, capacity)
    spread = (torch.arange(w2, dtype=torch.int32, device=dev) % 256)[None, :]
    idx = scatter_ranks(rank, capacity, spread.expand(s_l * h2, w2))
    count = torch.clamp(row_cs[-1], max=capacity)
    live = torch.arange(capacity, device=dev) < count
    plane = h2 * w2
    s = idx // plane + 1
    rem = idx % plane
    y = rem // w2 + 1
    x = rem % w2 + 1
    c0 = code.reshape(-1)[idx.to(torch.int64)].to(torch.int32) % CODE_CAND
    one = torch.ones_like(s)
    return Candidates(
        s=torch.where(live, s, one), y=torch.where(live, y, one),
        x=torch.where(live, x, one), count=count.to(torch.int32),
        code0=torch.where(live, c0, 0).to(torch.int32))


def refine_candidates(dog: torch.Tensor, cand: Candidates, *, nb_scales: int,
                      width: int, height: int, dog_threshold: float,
                      edge_threshold: float, seed_sigma: float,
                      octave_idx: int, code: torch.Tensor) -> RefinedKeypoints:
    """Subpixel refinement of compacted candidates.

    ``code`` is the frontend's (S, H-2, W-2) code field. Slots at index >=
    ``cand.count`` walk dummy data and are masked invalid. ``octave_idx``
    already includes the -1 shift of the upsampled octave."""
    d = dog.to(torch.float32)
    ns, h, w = d.shape
    dev = d.device
    code_flat = code.reshape(-1)
    h2, w2 = code.shape[1], code.shape[2]

    def code_at(rs, ry, rx):
        i = ((rs - 1) * h2 + (ry - 1)) * w2 + (rx - 1)
        i = i.clamp(0, code_flat.numel() - 1).to(torch.int64)
        return code_flat[i].to(torch.int32) % CODE_CAND

    k = cand.s.shape[0]
    rs, ry, rx = cand.s, cand.y, cand.x
    valid = torch.ones(k, dtype=torch.bool, device=dev)
    done = torch.zeros(k, dtype=torch.bool, device=dev)
    for step_i in range(NB_REFINEMENT_STEPS):
        c = cand.code0 if (step_i == 0 and cand.code0 is not None) \
            else code_at(rs, ry, rx)
        sing = (c // _CODE_SING) % 2 == 1
        conv = (c // _CODE_CONV) % 2 == 1
        active = valid & ~done
        valid = torch.where(active & sing, False, valid)
        act2 = active & ~sing
        done = torch.where(act2 & conv, True, done)
        may_move = act2 & ~conv & (step_i < NB_REFINEMENT_STEPS - 1)
        mm = may_move.to(torch.int32)
        rx = torch.clamp(rx + ((c // 3) % 3 - 1) * mm, 1, width - 2)
        ry = torch.clamp(ry + ((c // 9) % 3 - 1) * mm, 1, height - 2)
        rs = torch.clamp(rs + (c % 3 - 1) * mm, 1, nb_scales)

    # Final Newton solve + acceptance tests at the stop cell.
    d_flat = d.reshape(-1)
    nb = []
    for a in (0, 1, 2):
        for b in (0, 1, 2):
            row = ((rs + a - 1) * h + (ry + b - 1)) * w
            for c_ in (0, 1, 2):
                i = (row + rx + c_ - 1).clamp(0, d_flat.numel() - 1)
                nb.append(d_flat[i.to(torch.int64)])
    off_s, off_x, off_y, g_s, g_x, g_y, singular = _newton_step(*nb)
    valid = valid & ~singular

    subpix_x = rx.to(torch.float32) + off_x
    subpix_y = ry.to(torch.float32) + off_y
    subpix_s = rs.to(torch.float32) + off_s
    ctr = nb[13]
    new_val = ctr + 0.5 * (g_x * off_x + g_y * off_y + g_s * off_s)

    # Python-float thresholds compare in float32, as in the JAX package;
    # a scalar tensor made here would cost a host-to-device copy.
    ok = valid
    ok = ok & (torch.abs(new_val) > dog_threshold)
    ok = ok & ((torch.abs(off_x) < 1.5) & (torch.abs(off_y) < 1.5)
               & (torch.abs(off_s) < 1.5))
    ok = ok & (subpix_x >= 0) & (subpix_x < width)
    ok = ok & (subpix_y >= 0) & (subpix_y < height)
    ok = ok & (subpix_s >= 0) & (subpix_s <= nb_scales + 1)

    # 2x2 spatial Hessian edge test (ExtractKeypoints.comp:197-206).
    h11 = nb[14] + nb[12] - 2.0 * ctr
    h22 = nb[16] + nb[10] - 2.0 * ctr
    h12 = 0.25 * (nb[17] - nb[11] - nb[15] + nb[9])
    det2 = h11 * h22 - h12 * h12
    edgeness = torch.where(
        det2 == 0.0, torch.inf,
        (h11 + h22) ** 2 / torch.where(det2 == 0.0, 1.0, det2))
    e = edge_threshold
    ok = ok & (edgeness < (e + 1.0) ** 2 / e) & (edgeness >= 0)
    ok = ok & (torch.arange(k, device=dev) < cand.count)

    scale_factor = 2.0 ** octave_idx
    sigma = seed_sigma * torch.exp2(subpix_s / nb_scales) * scale_factor
    return RefinedKeypoints(
        valid=ok, scale_x=subpix_x, scale_y=subpix_y, subpix_s=subpix_s,
        scale_idx=torch.round(subpix_s).to(torch.int32), sigma=sigma,
        intensity=new_val, x=subpix_x * scale_factor,
        y=subpix_y * scale_factor)
