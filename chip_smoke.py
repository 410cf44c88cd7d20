#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vulkansift_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (name, power limit) and the torch, CUDA and nvcc
   versions.
2. Builds the four kernels from ``vulkansift_tpu_torch/csrc`` into the
   git-ignored ``build/`` (nvcc, sm_90a) and prints the build seconds.
3. Detects a 1536x1024 textured frame under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
   inside a detect), then once more to get the main path's real inputs,
   holds each kernel against its plain PyTorch version on the card at those
   shapes, and times both (CUDA events).
4. Drives the main path: ``SiftInstance.detect_features`` at 1536x1024
   (upsampling, capacity 32768) into buffers 0 and 1, with every launch
   counter set to 0 just before and read just after, and checks the
   result against the same pipeline run with every wrapper forced to its
   plain version.
5. Prints the kernel table as one JSON line, the card line, and as the
   last line ``{"ok": true, "device": {...}}``, after a short
   torch.profiler breakdown of three frames (device busy time, idle share,
   the kernels that take the most device time).

Any failure raises, so the script exits non-zero and prints no result
line; it also exits non-zero when no CUDA card is available.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.ops import backhalf, blur, cuda_lib, frontend
from vulkansift_tpu_torch.ops import descriptor as desc_mod
from vulkansift_tpu_torch.ops import extract, gaussian, orientation
from vulkansift_tpu_torch.ops.scale_space import upsample2x_linear
from vulkansift_tpu_torch.pipeline import make_detect_fn

W, H = 1536, 1024
CAPACITY = 32768
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
REPS = 20                     # kernel timing repetitions
PLAIN_REPS = 5                # plain-version and library timing repetitions
WARMUP_FRAMES = 3
TIMED_FRAMES = 10
REPLACES = {
    "blur_dog": "vulkansift_tpu/ops/pallas_blur.py:331",
    "frontend": "vulkansift_tpu/ops/pallas_frontend.py:327",
    "orientation_hist": "vulkansift_tpu/ops/pallas_backhalf.py:403",
    "descriptor": "vulkansift_tpu/ops/pallas_backhalf.py:677",
}
WRAPPERS = {
    "blur_dog": blur.blur_dog,
    "frontend": frontend.frontend,
    "orientation_hist": backhalf.orientation_hist,
    "descriptor": backhalf.descriptor,
}


def bench_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Deterministic multi-scale textured image (the repository bench's
    recipe: Hannover-like keypoint density)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for cell in (8, 16, 32, 64):
        small = rng.random((h // cell + 1, w // cell + 1))
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        yi, xi = ys.astype(int), xs.astype(int)
        fy, fx = (ys - yi)[:, None], (xs - xi)[None, :]
        img += ((1 - fy) * (1 - fx) * small[yi][:, xi]
                + (1 - fy) * fx * small[yi][:, xi + 1]
                + fy * (1 - fx) * small[yi + 1][:, xi]
                + fy * fx * small[yi + 1][:, xi + 1])
    img -= img.min()
    return (255 * img / img.max()).astype(np.uint8)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- per-kernel checks --------------------------------------------------------

def check_blur(cap: dict) -> dict:
    """Every blur step of octave 0 (3072x2048) on the frame's own layers."""
    cfg = cap["config"]
    g0 = cap["gaussians"][0]
    seed = cap["seed"]
    taps = [gaussian.half_kernel(s) for s in gaussian.kernel_sigmas(cfg)]
    worst = 0.0
    rows = []
    for i, t in enumerate(taps):
        x = seed if i == 0 else g0[i - 1].contiguous()
        with_dog = i > 0
        y_k, d_k = blur.blur_dog(x, t, with_dog)
        y_p, d_p = blur.blur_dog_plain(x, t, with_dog)
        err = (y_k - y_p).abs().max().item()
        if with_dog:
            err = max(err, (d_k - d_p).abs().max().item())
        check(err <= 1e-6, f"blur taps={len(t)} err {err}")
        worst = max(worst, err)
        k = len(t) - 1
        ms = median_ms(lambda: blur.blur_dog(x, t, with_dog), REPS)
        plain_ms = median_ms(lambda: blur.blur_dog_plain(x, t, with_dog),
                             PLAIN_REPS)
        # Yardstick: one conv2d of the pre-padded layer with the full 2-D
        # kernel (f32, TF32 off); the port never calls it.
        full = np.concatenate([t[:0:-1], t]).astype(np.float32)
        k2 = torch.from_numpy(np.outer(full, full)).to(x.device)[None, None]
        xp = x[blur._symmetric_index(x.shape[0], k, x.device)][
            :, blur._symmetric_index(x.shape[1], k, x.device)][None, None]
        xp = xp.contiguous()
        prev_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib_ms = median_ms(
                lambda: torch.nn.functional.conv2d(xp, k2), PLAIN_REPS)
        finally:
            torch.backends.cudnn.allow_tf32 = prev_tf32
        npx = x.numel()
        b_ms, b_by = bound(4 * npx * (3 if with_dog else 2),
                           npx * (2 * (1 + 3 * k) + (1 if with_dog else 0)))
        rows.append(dict(taps=len(t), shape=list(x.shape), max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms))
        print(f"blur_dog taps={len(t)} {tuple(x.shape)} err={err:.3g} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by}) conv2d_ms={lib_ms:.4f}", flush=True)
    big = max(rows, key=lambda r: r["taps"])
    return dict(big, max_abs_err=worst,
                note="largest-tap layer of octave 0 (3072x2048)")


def check_frontend(cap: dict) -> dict:
    """Bit-exact on octaves 0 (3072x2048, timed) and 1 (1536x1024, where
    this frame's candidates start)."""
    thr = cap["dog_threshold"]
    err = 0
    for o in (1, 0):
        dog = cap["dogs"][o]
        code_k, cnt_k = frontend.frontend(dog, thr)
        code_p, cnt_p = extract.dense_frontend(dog, thr)
        err = max(err, (code_k.int() - code_p.int()).abs().max().item(),
                  (cnt_k - cnt_p).abs().max().item())
        check(err == 0, f"frontend octave {o} not bit-exact: max diff {err}")
        print(f"frontend octave {o} {tuple(dog.shape)} "
              f"candidates={int(cnt_k.sum())} bit-exact", flush=True)
    ms = median_ms(lambda: frontend.frontend(dog, thr), REPS)
    plain_ms = median_ms(lambda: extract.dense_frontend(dog, thr), PLAIN_REPS)
    ns, h, w = dog.shape
    cells = (ns - 2) * (h - 2) * (w - 2)
    # 147 f32 operations per centre cell, counted from frontend.cu.
    b_ms, b_by = bound(4 * dog.numel() + cells + 4 * (ns - 2) * (h - 2),
                       147 * cells)
    print(f"frontend {tuple(dog.shape)} err={err} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
    return dict(shape=list(dog.shape), max_abs_err=float(err), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _window_work(flat, recs, count: int, radius_fn, max_radius: int,
                 ops_per_px: int, out_floats: int):
    """Bytes and operations the live records need, as the kernels read
    them. Bytes: every distinct pyramid pixel read (the four gradient taps
    of each window cell inside the layer's border), so a window shared by
    the orientations of one keypoint, or pixels shared by overlapping
    windows, count once; each record read once; each output row written
    once. Operations: per record, per window cell inside the border."""
    rec = recs.rec[:count]
    base = recs.base[:count]
    rad = radius_fn(rec[:, 2]).clamp(max=max_radius)
    d = torch.arange(-max_radius, max_radius + 1, device=flat.device)
    dy, dx = (g.reshape(1, -1) for g in torch.meshgrid(d, d, indexing="ij"))
    read = torch.zeros(flat.numel(), dtype=torch.bool, device=flat.device)
    cells = 0
    for i in range(0, count, 256):
        r = rad[i:i + 256, None]
        cx, cy = rec[i:i + 256, 3:4].long(), rec[i:i + 256, 4:5].long()
        w, h = rec[i:i + 256, 5:6].long(), rec[i:i + 256, 6:7].long()
        px, py = cx + dx, cy + dy
        ok = ((dx.abs() <= r) & (dy.abs() <= r) & (px >= 1) & (px < w - 1)
              & (py >= 1) & (py < h - 1))
        idx = (base[i:i + 256, None] + py * w + px)[ok]
        row = w.expand_as(ok)[ok]
        cells += idx.numel()
        for tap in (idx - 1, idx + 1, idx - row, idx + row):
            read[tap] = True
    nbytes = (4 * int(read.sum()) + count * (8 * 4 + 8)
              + 4 * out_floats * count)
    return nbytes, ops_per_px * cells, cells


def check_orientation_hist(cap: dict) -> dict:
    flat, recs, cnt = cap["flat"], cap["hist_records"], cap["hist_count"]
    r = cap["ori_radius"]
    h_k = backhalf.orientation_hist(flat, recs, cnt, ori_radius=r)
    h_p = orientation.raw_histograms(flat, recs, cnt, ori_radius=r)
    err = (h_k - h_p).abs().max().item()
    check(err <= 1e-4, f"orientation_hist err {err}")
    ms = median_ms(lambda: backhalf.orientation_hist(
        flat, recs, cnt, ori_radius=r), REPS)
    plain_ms = median_ms(lambda: orientation.raw_histograms(
        flat, recs, cnt, ori_radius=r), PLAIN_REPS)
    n = int(cnt)
    # ~30 f32 operations per window pixel (transcendentals counted as one),
    # counted from orientation_hist.cu.
    nbytes, ops, px = _window_work(
        flat, recs, n, lambda s: torch.floor(3.0 * (1.5 * s)), r, 30, 36)
    b_ms, b_by = bound(nbytes, ops)
    print(f"orientation_hist keypoints={n} cells={px} bytes={nbytes} "
          f"err={err:.3g} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by})", flush=True)
    return dict(keypoints=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_descriptor(cap: dict) -> dict:
    flat, recs, cnt = cap["flat"], cap["desc_records"], cap["desc_count"]
    r, vl = cap["desc_radius"], cap["use_vlfeat"]
    d_k = backhalf.descriptor(flat, recs, cnt, desc_radius=r, use_vlfeat=vl)
    d_p = desc_mod.raw_descriptors(flat, recs, cnt, desc_radius=r,
                                   use_vlfeat=vl)
    err = (d_k - d_p).abs().max().item()
    q_k = desc_mod.normalize_descriptor(d_k).int()
    q_p = desc_mod.normalize_descriptor(d_p).int()
    n = int(cnt)
    qd = (q_k[:n] - q_p[:n]).abs()
    within = (qd <= 1).float().mean().item() if n else 1.0
    qmax = qd.max().item() if n else 0
    check(within >= 0.995 and qmax <= 8,
          f"descriptor u8 within1={within} max={qmax}")
    ms = median_ms(lambda: backhalf.descriptor(
        flat, recs, cnt, desc_radius=r, use_vlfeat=vl), REPS)
    plain_ms = median_ms(lambda: desc_mod.raw_descriptors(
        flat, recs, cnt, desc_radius=r, use_vlfeat=vl), PLAIN_REPS)
    # ~75 f32 operations per window pixel (8 weighted bin updates,
    # transcendentals counted as one), counted from descriptor.cu.
    nbytes, ops, px = _window_work(
        flat, recs, n,
        lambda s: torch.floor(((math.sqrt(2.0) * (3.0 * s)) * 5.0) * 0.5
                              + 0.5), r, 75, 128)
    b_ms, b_by = bound(nbytes, ops)
    print(f"descriptor pairs={n} cells={px} bytes={nbytes} "
          f"raw_err={err:.3g} "
          f"u8_within1={within:.6f} u8_max={qmax} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
          flush=True)
    return dict(pairs=n, max_abs_err=err, u8_within1=within, u8_max=qmax,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# -- the slice ------------------------------------------------------------------

def compare_with_plain(feats: np.ndarray, plain: np.ndarray) -> dict:
    """Kernel run vs the all-plain run of the same pipeline on the card."""
    n_k, n_p = len(feats), len(plain)
    check(abs(n_k - n_p) <= 0.005 * max(n_p, 1),
          f"count {n_k} vs plain {n_p}")
    pos = {}
    for j, f in enumerate(plain):
        pos.setdefault((round(float(f["x"]), 3), round(float(f["y"]), 3)),
                       []).append(j)
    hits, diffs = 0, []
    for f in feats:
        key = (round(float(f["x"]), 3), round(float(f["y"]), 3))
        cands = pos.get(key, [])
        if cands:
            hits += 1
        for j in cands:
            da = abs((float(f["orientation"]) - float(plain[j]["orientation"])
                      + math.pi) % (2 * math.pi) - math.pi)
            if da < 1e-3:
                diffs.append(np.abs(f["descriptor"].astype(np.int32)
                                    - plain[j]["descriptor"].astype(np.int32)))
                break
    pos_frac = hits / max(n_k, 1)
    check(pos_frac >= 0.99, f"positions matched {pos_frac}")
    d = np.concatenate(diffs) if diffs else np.zeros(1, np.int32)
    within = float(np.mean(d <= 1))
    check(within >= 0.995, f"descriptors within 1: {within}")
    return dict(count=n_k, plain_count=n_p, position_match=pos_frac,
                desc_pairs=len(diffs), desc_within1=within,
                desc_max=int(d.max()))


def run_slice(img: np.ndarray) -> dict:
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    inst = vt.SiftInstance(cfg, device="cuda")
    for w in WRAPPERS.values():
        w.launches = 0
    frames = 0
    for i in range(WARMUP_FRAMES):
        inst.detect_features(img, i % 2)
        frames += 1
    torch.cuda.synchronize()
    t_detect = []
    for i in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        inst.detect_features(img, i % 2)
        torch.cuda.synchronize()
        t_detect.append((time.perf_counter() - t0) * 1e3)
        frames += 1
    t_download = []
    for i in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        inst.detect_features(img, i % 2)
        feats = inst.download_features(i % 2)
        t_download.append((time.perf_counter() - t0) * 1e3)
        frames += 1
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    print("kernels " + " ".join(f"{k}={v}" for k, v in launches.items()),
          flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    b = (TIMED_FRAMES - 1) % 2
    count = inst.get_features_number(b)
    lost = inst.get_lost_features_number(b)
    per_oct = inst.get_per_octave_counts(b)
    check(count > 0 and len(feats) == count, "no features detected")
    for name in ("x", "y", "sigma", "orientation", "intensity"):
        check(bool(np.isfinite(feats[name]).all()), f"non-finite {name}")
    check(bool((feats["x"] >= 0).all() and (feats["x"] < W).all()
               and (feats["y"] >= 0).all() and (feats["y"] < H).all()),
          "positions outside the image")

    with cuda_lib.force_plain():
        out_p = make_detect_fn(cfg, W, H, device="cuda")(img)
        plain = vt.features_to_numpy(out_p.features)
    cmp = compare_with_plain(feats, plain)
    res = dict(frames=frames, launches=launches,
               launches_per_frame={k: v / frames
                                   for k, v in launches.items()},
               count=count, lost=lost, per_octave_counts=list(per_oct),
               frame_ms_median=statistics.median(t_detect),
               frame_ms_with_download_median=statistics.median(t_download),
               frame_ms=t_detect, frame_ms_with_download=t_download,
               plain_comparison=cmp)
    print("slice " + json.dumps(res), flush=True)
    return res


def profile_frames(img: np.ndarray, frames: int = 3) -> dict:
    """Where a frame's time goes: torch.profiler over ``frames`` detects.
    Device busy time is the sum of kernel (and copy) self times on the
    card; the idle share is the rest of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    inst = vt.SiftInstance(cfg, device="cuda")
    inst.detect_features(img, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            inst.detect_features(img, i % 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, us / 1e3 / frames, evt.count / frames))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = {k: sum(r[1] for r in rows if r[0].startswith(k + "_kernel"))
            for k in WRAPPERS}
    res = dict(frames=frames, wall_ms_per_frame=wall_ms / frames,
               device_busy_ms_per_frame=busy if rows else None,
               device_idle_share=(1.0 - busy * frames / wall_ms)
               if rows else None,
               device_ops_per_frame=sum(r[2] for r in rows),
               kernel_ms_per_frame=ours,
               top=[dict(name=r[0][:60], ms=r[1], calls=r[2])
                    for r in rows[:12]])
    print("profile " + json.dumps(res), flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} nvcc "
          f"{nvcc.strip().splitlines()[-1]}", flush=True)

    t0 = time.perf_counter()
    info = cuda_lib.build(verbose=True)
    print(f"build_seconds {time.perf_counter() - t0:.2f}", flush=True)
    for name, v in info.items():
        for line in v["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    img = bench_image(H, W, seed=0)
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    detect = make_detect_fn(cfg, W, H, return_pyramid=True, device="cuda")
    detect(img)
    torch.cuda.synchronize()
    # No host synchronisation between the stages of one detect: PyTorch
    # raises on any synchronising call inside this block.
    torch.cuda.set_sync_debug_mode("error")
    try:
        detect(img)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sync check: one detect ran with no host synchronisation",
          flush=True)
    cap = {}
    out, gaussians, dogs = detect(img, capture=cap)
    torch.cuda.synchronize()
    print(f"capture run: count={int(out.features.count)} "
          f"lost={int(out.lost)}", flush=True)
    x = torch.from_numpy(img).cuda().to(torch.float32) * (1.0 / 255.0)
    cap.update(config=cfg, gaussians=gaussians, dogs=dogs,
               dog_threshold=cfg.dog_threshold,
               seed=upsample2x_linear(x).contiguous())

    rows = {
        "blur_dog": check_blur(cap),
        "frontend": check_frontend(cap),
        "orientation_hist": check_orientation_hist(cap),
        "descriptor": check_descriptor(cap),
    }
    del cap
    torch.cuda.empty_cache()
    res = run_slice(img)
    profile_frames(img)

    kernels = []
    for name, r in rows.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"vulkansift_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=res["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
