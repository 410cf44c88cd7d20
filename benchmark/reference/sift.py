"""Plain PyTorch SIFT: the benchmark's reference for the detect path.

Written for the benchmark from the published semantics of VulkanSift's
shaders (GaussianBlur, DifferenceOfGaussian, ExtractKeypoints,
ComputeOrientation, ComputeDescriptors) and the sampling the measured
program documents (sigma-scaled sampling: keypoints refined to an octave's
top scales read the next octave's layer ``scale_idx - S`` at ``(u - 1) / 2``
with half the sigma). It imports nothing of the measured program and takes
nothing it made: it works the whole detect out again from the u8 frame.

Everything is vectorised over pixels, candidates and keypoints, so that it
runs on the card at the timed sizes in well under a second a frame. The
arithmetic is float32, the precision the configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DESC_SIZE = 128
NB_HIST, NB_ORI, NB_ORI_BINS = 4, 8, 36
LAMBDA_ORI, LAMBDA_DESC = 1.5, 3.0
L2_CLAMP = 0.2
ORI_PEAK_RATIO = 0.8
MAX_TAPS = 20
REFINE_STEPS = 5
TWO_PI = 2.0 * math.pi

FEATURE_FIELDS = ("x", "y", "scale_x", "scale_y", "scale_idx", "octave_idx",
                  "sigma", "orientation", "intensity", "descriptor")


# -- sizes --------------------------------------------------------------------

def octave_sizes(cfg: dict, width: int, height: int) -> List[Tuple[int, int]]:
    """(width, height) of each octave: log2(min side) - 4 octaves, one more
    with the 2x upsampled seed, capped by ``nb_octaves`` when it is set."""
    up = bool(cfg["use_input_upsampling"])
    n = max(int(math.log2(float(min(width, height)))) - 4 + int(up), 1)
    if cfg["nb_octaves"] > 0:
        n = min(n, cfg["nb_octaves"])
    s0 = 2 if up else 1
    return [(s0 * width // 2 ** o, s0 * height // 2 ** o) for o in range(n)]


def section_capacities(total: int, nb_oct: int) -> List[int]:
    """Each octave's candidate capacity: geometric halves rescaled to sum to
    the buffer capacity."""
    corr = total / (total - 0.5 ** nb_oct * total)
    return [int(math.floor(0.5 ** (i + 1) * total * corr))
            for i in range(nb_oct)]


def blur_taps(cfg: dict) -> List[List[float]]:
    """Half kernels of the S + 3 incremental blurs of an octave: the seed's
    from the input blur (doubled when upsampling) to the seed sigma, then
    scale i-1 to scale i; ceil(4 sigma) + 1 taps (at most 20), normalised so
    that the whole symmetric kernel sums to one."""
    s = cfg["nb_scales_per_octave"]
    seed = cfg["seed_scale_sigma"]
    out = []
    for i in range(s + 3):
        if i == 0:
            blur0 = cfg["input_image_blur_level"] * (
                2.0 if cfg["use_input_upsampling"] else 1.0)
            sig = math.sqrt(max(seed ** 2 - blur0 ** 2, 0.0))
        else:
            prev = 2.0 ** ((i - 1) / s) * seed
            sig = math.sqrt((prev * 2.0 ** (1.0 / s)) ** 2 - prev ** 2)
        if sig <= 0.0:
            out.append([1.0])
            continue
        k = min(int(math.ceil(sig * 4.0) + 1.0), MAX_TAPS)
        t = np.exp(-0.5 * np.arange(k, dtype=np.float64) ** 2 / sig ** 2)
        t /= t[0] + 2.0 * t[1:].sum()
        out.append([float(v) for v in t.astype(np.float32)])
    return out


# -- scale space --------------------------------------------------------------

def _conv1d(x: torch.Tensor, taps: List[float], dim: int) -> torch.Tensor:
    """``y[i] = t0 x[i] + sum_j tj (x[i-j] + x[i+j])`` with mirrored
    (period-2n) borders, accumulated in that order."""
    k = len(taps) - 1
    if k == 0:
        return x * taps[0]
    n = x.shape[dim]
    i = torch.arange(-k, n + k, device=x.device) % (2 * n)
    xp = x.index_select(dim, torch.where(i < n, i, 2 * n - 1 - i))
    acc = xp.narrow(dim, k, n) * taps[0]
    for j in range(1, k + 1):
        acc = acc + (xp.narrow(dim, k - j, n) + xp.narrow(dim, k + j, n)) \
            * taps[j]
    return acc


def blur(x: torch.Tensor, taps: List[float]) -> torch.Tensor:
    """Separable blur: the horizontal pass, then the vertical."""
    return _conv1d(_conv1d(x, taps, 1), taps, 0)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x with half-pixel centres and clamped edges (a linear
    blit): even outputs 0.25 prev + 0.75 cur, odd 0.75 cur + 0.25 next;
    rows, then columns."""
    def up(v: torch.Tensor, dim: int) -> torch.Tensor:
        n = v.shape[dim]
        idx = torch.arange(-1, n + 1, device=v.device).clamp(0, n - 1)
        p = v.index_select(dim, idx)
        prev, cur, nxt = (p.narrow(dim, o, n) for o in (0, 1, 2))
        shape = list(v.shape)
        shape[dim] = 2 * n
        return torch.stack([0.25 * prev + 0.75 * cur,
                            0.75 * cur + 0.25 * nxt], dim + 1).reshape(shape)
    return up(up(x, 0), 1)


def build_pyramid(img: torch.Tensor, cfg: dict, sizes):
    """Per octave, the (S+3, H, W) gaussian and (S+2, H, W) DoG stacks, in
    float32. Octave o > 0 starts from the odd texels of octave o - 1's
    gaussian layer S."""
    s = cfg["nb_scales_per_octave"]
    taps = blur_taps(cfg)

    gauss, dogs = [], []
    top = None
    for o, (w, h) in enumerate(sizes):
        if o == 0:
            seed = upsample2x(img) if cfg["use_input_upsampling"] else img
            base = blur(seed, taps[0])
        else:
            base = top[1::2, 1::2][:h, :w]
        g, d = [base], []
        prev = base
        for i in range(1, s + 3):
            y = blur(prev, taps[i])
            g.append(y)
            d.append(y - prev)
            prev = y
            if i == s:
                top = y
        gauss.append(torch.stack(g))
        dogs.append(torch.stack(d))
    return gauss, dogs


# -- keypoints ----------------------------------------------------------------

def _candidates(dog: torch.Tensor, thr: float, cap: int) -> torch.Tensor:
    """(K, 3) (s, y, x) of the strict 26-neighbour extrema with |v| above
    0.8 thr, in raster order, at most ``cap``."""
    ns, h, w = dog.shape
    c = dog[1:-1, 1:-1, 1:-1]
    hi = torch.full_like(c, -math.inf)
    lo = torch.full_like(c, math.inf)
    for a in range(3):
        for b in range(3):
            for e in range(3):
                if a == b == e == 1:
                    continue
                v = dog[a:a + ns - 2, b:b + h - 2, e:e + w - 2]
                torch.maximum(hi, v, out=hi)
                torch.minimum(lo, v, out=lo)
    mask = (c.abs() > thr * 0.8) & ((c > hi) | (c < lo))
    return (torch.nonzero(mask) + 1)[:cap]


def _cube(dog: torch.Tensor, s, y, x) -> torch.Tensor:
    """(K, 3, 3, 3) neighbourhoods [ds, dy, dx] around each cell."""
    _, h, w = dog.shape
    d = torch.arange(-1, 2, device=dog.device)
    idx = (((s[:, None, None, None] + d[:, None, None]) * h
            + y[:, None, None, None] + d[None, :, None]) * w
           + x[:, None, None, None] + d[None, None, :])
    return dog.reshape(-1)[idx]


def _newton(n: torch.Tensor):
    """Gradient, offset (ds, dx, dy) = -H^-1 g by the adjugate, and whether
    H is singular, for (K, 3, 3, 3) neighbourhoods."""
    c = n[:, 1, 1, 1]
    gs = 0.5 * (n[:, 2, 1, 1] - n[:, 0, 1, 1])
    gx = 0.5 * (n[:, 1, 1, 2] - n[:, 1, 1, 0])
    gy = 0.5 * (n[:, 1, 2, 1] - n[:, 1, 0, 1])
    h11 = n[:, 2, 1, 1] + n[:, 0, 1, 1] - 2.0 * c
    h22 = n[:, 1, 1, 2] + n[:, 1, 1, 0] - 2.0 * c
    h33 = n[:, 1, 2, 1] + n[:, 1, 0, 1] - 2.0 * c
    h12 = 0.25 * (n[:, 2, 1, 2] - n[:, 2, 1, 0] - n[:, 0, 1, 2] + n[:, 0, 1, 0])
    h13 = 0.25 * (n[:, 2, 2, 1] - n[:, 2, 0, 1] - n[:, 0, 2, 1] + n[:, 0, 0, 1])
    h23 = 0.25 * (n[:, 1, 2, 2] - n[:, 1, 2, 0] - n[:, 1, 0, 2] + n[:, 1, 0, 0])
    a11 = h22 * h33 - h23 * h23
    a12 = -(h12 * h33 - h13 * h23)
    a13 = h12 * h23 - h13 * h22
    a22 = h11 * h33 - h13 * h13
    a23 = -(h11 * h23 - h13 * h12)
    a33 = h11 * h22 - h12 * h12
    det = h11 * a11 + h12 * a12 + h13 * a13
    sing = det == 0.0
    r = 1.0 / torch.where(sing, 1.0, det)
    os_ = -(a11 * gs + a12 * gx + a13 * gy) * r
    ox = -(a12 * gs + a22 * gx + a23 * gy) * r
    oy = -(a13 * gs + a23 * gx + a33 * gy) * r
    return (gs, gx, gy), (os_, ox, oy), sing


def refine(dog: torch.Tensor, cand: torch.Tensor, cfg: dict, octave: int,
           size: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """Walk each candidate to the cell where its Newton offset is under 0.6
    in every axis (at most four moves, clamped to the interior), then keep
    it if the final solve is regular, the refined |DoG| beats the threshold,
    every offset is under 1.5, the subpixel point lies in the octave and the
    2x2 spatial Hessian passes the edge test."""
    s_n = cfg["nb_scales_per_octave"]
    thr = cfg["intensity_threshold"] / s_n
    w, h = size
    s, y, x = cand[:, 0], cand[:, 1], cand[:, 2]
    alive = torch.ones_like(s, dtype=torch.bool)
    done = torch.zeros_like(alive)
    for it in range(REFINE_STEPS):
        _, (os_, ox, oy), sing = _newton(_cube(dog, s, y, x))
        walking = alive & ~done
        alive = alive & ~(walking & sing)
        walking = walking & ~sing
        conv = (os_.abs() < 0.6) & (ox.abs() < 0.6) & (oy.abs() < 0.6)
        done = done | (walking & conv)
        if it == REFINE_STEPS - 1:
            break
        mv = (walking & ~conv).long()

        def step(o):
            return ((o >= 0.6).long() - (o <= -0.6).long()) * mv
        x = (x + step(ox)).clamp(1, w - 2)
        y = (y + step(oy)).clamp(1, h - 2)
        s = (s + step(os_)).clamp(1, s_n)
    n = _cube(dog, s, y, x)
    (gs, gx, gy), (os_, ox, oy), sing = _newton(n)
    c = n[:, 1, 1, 1]
    val = c + 0.5 * (gx * ox + gy * oy + gs * os_)
    sx = x.float() + ox
    sy = y.float() + oy
    ss = s.float() + os_
    h11 = n[:, 1, 1, 2] + n[:, 1, 1, 0] - 2.0 * c
    h22 = n[:, 1, 2, 1] + n[:, 1, 0, 1] - 2.0 * c
    h12 = 0.25 * (n[:, 1, 2, 2] - n[:, 1, 0, 2] - n[:, 1, 2, 0] + n[:, 1, 0, 0])
    det2 = h11 * h22 - h12 * h12
    edge = (h11 + h22) ** 2 / torch.where(det2 == 0.0, 1.0, det2)
    e = cfg["edge_threshold"]
    ok = (alive & ~sing & (val.abs() > thr)
          & (ox.abs() < 1.5) & (oy.abs() < 1.5) & (os_.abs() < 1.5)
          & (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
          & (ss >= 0) & (ss <= s_n + 1)
          & (det2 != 0.0) & (edge >= 0) & (edge < (e + 1.0) ** 2 / e))
    f = 2.0 ** octave
    out = dict(scale_x=sx, scale_y=sy, subpix_s=ss,
               scale_idx=torch.round(ss).long(),
               sigma=cfg["seed_scale_sigma"] * torch.exp2(ss / s_n) * f,
               intensity=val, x=sx * f, y=sy * f)
    return {k: v[ok] for k, v in out.items()}


# -- orientation and descriptor -----------------------------------------------

def _window(flat, base, cx, cy, w, h, radius: int):
    """Central-difference gradients over the (2r+1)^2 window around each
    centre, the offsets and the in-image mask (stencil inside the layer)."""
    d = torch.arange(-radius, radius + 1, device=flat.device)
    px = cx[:, None, None] + d[None, None, :]
    py = cy[:, None, None] + d[None, :, None]
    w_, h_ = w[:, None, None], h[:, None, None]
    inside = (px >= 1) & (px < w_ - 1) & (py >= 1) & (py < h_ - 1)
    at = torch.where(inside, base[:, None, None] + py * w_ + px, 0)
    step_x = inside.long()
    step_y = torch.where(inside, w_, 0)
    gx = 0.5 * (flat[at + step_x] - flat[at - step_x])
    gy = 0.5 * (flat[at + step_y] - flat[at - step_y])
    df = d.float()
    return gx, gy, df[None, None, :], df[None, :, None], inside


def orientations(flat, rec, capacity: int, chunk: int = 2048):
    """(K, capacity) angles and validity: the gaussian-weighted (1.5 sigma)
    gradient histogram over 36 bins in the box of radius floor(4.5 sigma),
    six circular [1 1 1]/3 smoothings, then the strict local maxima at or
    above 0.8 of the highest, parabola-interpolated, strongest first."""
    r_max = int(math.floor(3.0 * LAMBDA_ORI * float(rec["sig"].max()))) \
        if rec["sig"].numel() else 0
    hists = []
    for i in range(0, rec["sig"].numel(), chunk):
        r = {k: v[i:i + chunk] for k, v in rec.items()}
        gx, gy, dx, dy, inside = _window(flat, r["base"], r["cx"], r["cy"],
                                         r["w"], r["h"], r_max)
        lam = LAMBDA_ORI * r["sig"]
        box = torch.floor(3.0 * lam)[:, None, None]
        fx = (r["sx"] - r["cx"].float())[:, None, None]
        fy = (r["sy"] - r["cy"].float())[:, None, None]
        sq = (dx - fx) ** 2 + (dy - fy) ** 2
        wt = torch.exp(sq * (-1.0 / (2.0 * lam * lam))[:, None, None])
        mag = wt * torch.sqrt(gx * gx + gy * gy)
        keep = inside & (dx.abs() <= box) & (dy.abs() <= box)
        mag = torch.where(keep, mag, 0.0).reshape(mag.shape[0], -1)
        th = torch.atan2(gy, gx)
        th = torch.where(th < 0, th + TWO_PI, th)
        b = torch.floor(th * (NB_ORI_BINS / TWO_PI)).long()
        b = b.clamp(0, NB_ORI_BINS - 1).reshape(mag.shape[0], -1)
        hist = torch.zeros(mag.shape[0], NB_ORI_BINS, device=flat.device)
        hists.append(hist.scatter_add_(1, b, mag))
    hist = torch.cat(hists) if hists else torch.zeros(
        0, NB_ORI_BINS, device=flat.device)
    for _ in range(6):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    prev, nxt = torch.roll(hist, 1, 1), torch.roll(hist, -1, 1)
    peak = ((hist >= ORI_PEAK_RATIO * hist.amax(1, keepdim=True))
            & (hist > prev) & (hist > nxt))
    den = prev - 2.0 * hist + nxt
    interp = torch.where(den == 0.0, 0.0,
                         0.5 * (prev - nxt) / torch.where(den == 0.0, 1.0, den))
    bins = torch.arange(NB_ORI_BINS, device=flat.device).float()
    ang = (bins + interp + 0.5) * (TWO_PI / NB_ORI_BINS)
    vals = torch.where(peak, hist, -math.inf)
    top, idx = torch.topk(vals, min(capacity, NB_ORI_BINS), dim=1)
    return torch.gather(ang, 1, idx), torch.isfinite(top)


def descriptors(flat, rec, angle, vlfeat: bool, chunk: int = 256):
    """(P, 128) u8 descriptors: the window of radius
    floor(sqrt(2) 3 sigma 5/2 + 1/2) rotated by the orientation, weighted by
    a gaussian of half the 4x4 grid, each sample spread trilinearly over
    4x4 cells and 8 orientation bins; then L2 normalise, clamp at 0.2,
    renormalise, scale by 512, floor and saturate."""
    if angle.numel() == 0:
        return torch.zeros(0, DESC_SIZE, dtype=torch.uint8,
                           device=flat.device)
    lam_all = LAMBDA_DESC * rec["sig"]
    r_max = int(math.floor(math.sqrt(2.0) * float(lam_all.max())
                           * (NB_HIST + 1) * 0.5 + 0.5))
    cells = torch.arange(NB_HIST, device=flat.device).float()
    obins = torch.arange(NB_ORI, device=flat.device).float()
    out = []
    for i in range(0, angle.numel(), chunk):
        r = {k: v[i:i + chunk] for k, v in rec.items()}
        ori = angle[i:i + chunk]
        k = ori.numel()
        gx, gy, dx, dy, inside = _window(flat, r["base"], r["cx"], r["cy"],
                                         r["w"], r["h"], r_max)
        lam = LAMBDA_DESC * r["sig"]
        rad = torch.floor(math.sqrt(2.0) * lam * (NB_HIST + 1) * 0.5 + 0.5)
        keep = inside & (dx.abs() <= rad[:, None, None]) \
            & (dy.abs() <= rad[:, None, None])
        sdx = dx - (r["sx"] - r["cx"].float())[:, None, None]
        sdy = dy - (r["sy"] - r["cy"].float())[:, None, None]
        kc = (torch.cos(ori) / lam)[:, None, None]
        ks = (torch.sin(ori) / lam)[:, None, None]
        ox = kc * sdx + ks * sdy
        oy = kc * sdy - ks * sdx
        g = torch.exp((-1.0 / (2.0 * (NB_HIST / 2) ** 2)) * (ox * ox + oy * oy))
        mag = torch.where(keep, g * torch.sqrt(gx * gx + gy * gy), 0.0)
        th = torch.atan2(gy, gx)
        th = torch.where(th < 0, th + TWO_PI, th)
        rel = torch.remainder(th - ori[:, None, None], TWO_PI)
        fbin = (rel if vlfeat else torch.remainder(-rel, TWO_PI)) \
            * (NB_ORI / TWO_PI)
        wy = (1.0 - (cells - (oy + NB_HIST / 2 - 0.5)[..., None]).abs()).clamp(min=0)
        wx = (1.0 - (cells - (ox + NB_HIST / 2 - 0.5)[..., None]).abs()).clamp(min=0)
        od = (obins - fbin[..., None]).abs()
        wo = (1.0 - torch.minimum(od, NB_ORI - od)).clamp(min=0)
        p = mag.shape[1] * mag.shape[2]
        wxo = (wx[..., :, None] * wo[..., None, :]).reshape(k, p, NB_HIST * NB_ORI)
        wxo = wxo * mag.reshape(k, p, 1)
        raw = torch.bmm(wy.reshape(k, p, NB_HIST).transpose(1, 2), wxo)
        out.append(raw.reshape(k, DESC_SIZE))
    raw = torch.cat(out)
    norm = torch.sqrt((raw * raw).sum(1, keepdim=True))
    clip = torch.minimum(raw, L2_CLAMP * norm)
    norm2 = torch.sqrt((clip * clip).sum(1, keepdim=True))
    vals = torch.floor(clip * (512.0 / torch.where(norm2 == 0, 1.0, norm2)))
    return vals.clamp(0, 255).to(torch.uint8)


# -- the whole detect -----------------------------------------------------------

@torch.no_grad()
def detect(image: np.ndarray, cfg: dict, device="cpu"
           ) -> Dict[str, np.ndarray]:
    """The features of a (H, W) u8 frame as arrays named after the
    structured download's fields: octaves in order, each octave's keypoints
    in raster (s, y, x) order of their candidates, a keypoint's orientations
    strongest first, clamped to ``max_nb_sift_per_buffer``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h0, w0 = image.shape
    img = torch.as_tensor(np.ascontiguousarray(image), device=device)
    img = img.to(torch.float32) / 255.0
    sizes = octave_sizes(cfg, w0, h0)
    s_n = cfg["nb_scales_per_octave"]
    caps = section_capacities(cfg["max_nb_sift_per_buffer"], len(sizes))
    gauss, dogs = build_pyramid(img, cfg, sizes)
    up = 1 if cfg["use_input_upsampling"] else 0
    thr = cfg["intensity_threshold"] / s_n

    offsets, tot = [], 0
    for g in gauss:
        offsets.append(tot)
        tot += g.numel()
    flat = torch.cat([g.reshape(-1) for g in gauss])

    kps = []
    for o, (dog, size) in enumerate(zip(dogs, sizes)):
        kp = refine(dog, _candidates(dog, thr, caps[o]), cfg, o - up, size)
        n_o = len(sizes)
        remap = (kp["scale_idx"] >= s_n) & (o + 1 < n_o)
        nxt = min(o + 1, n_o - 1)
        sig = cfg["seed_scale_sigma"] * torch.exp2(kp["subpix_s"] / s_n)
        layer = torch.where(remap, kp["scale_idx"] - s_n,
                            kp["scale_idx"]).clamp(0, s_n + 2)
        w = torch.where(remap, sizes[nxt][0], size[0])
        h = torch.where(remap, sizes[nxt][1], size[1])
        off = torch.where(remap, offsets[nxt], offsets[o])
        sx = torch.where(remap, (kp["scale_x"] - 1.0) * 0.5, kp["scale_x"])
        sy = torch.where(remap, (kp["scale_y"] - 1.0) * 0.5, kp["scale_y"])
        sig = torch.where(remap, sig * 0.5, sig).clamp(min=1e-6)
        cx = torch.minimum(torch.round(sx).clamp(min=0), w.float()).long()
        cy = torch.minimum(torch.round(sy).clamp(min=0), h.float()).long()
        kp.update(octave_idx=torch.full_like(kp["scale_idx"], o - up),
                  rec_sx=sx, rec_sy=sy, rec_sig=sig, rec_cx=cx, rec_cy=cy,
                  rec_w=w, rec_h=h, rec_base=off + layer * h * w)
        kps.append(kp)
    kp = {k: torch.cat([d[k] for d in kps]) for k in kps[0]}
    rec = {k: kp["rec_" + k] for k in ("sx", "sy", "sig", "cx", "cy", "w",
                                       "h", "base")}
    cap_ori = cfg["max_nb_orientation_per_keypoint"]
    ang, ok = orientations(flat, rec, cap_ori if cap_ori > 0 else 8)
    owner = torch.arange(ang.shape[0], device=flat.device)[:, None] \
        .expand_as(ang)[ok]
    angle = ang[ok]
    owner, angle = owner[:cfg["max_nb_sift_per_buffer"]], \
        angle[:cfg["max_nb_sift_per_buffer"]]
    desc = descriptors(flat, {k: v[owner] for k, v in rec.items()}, angle,
                       cfg["descriptor_format"] == "VLFEAT")
    out = {k: kp[k][owner] for k in ("x", "y", "scale_x", "scale_y",
                                     "scale_idx", "octave_idx", "sigma",
                                     "intensity")}
    out.update(orientation=angle, descriptor=desc)
    return {k: v.cpu().numpy() for k, v in out.items()}
