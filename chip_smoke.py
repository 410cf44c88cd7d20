#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vulkansift_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card (name, power limit) and the torch, CUDA and nvcc
   versions.
2. Builds the five kernels from ``vulkansift_tpu_torch/csrc`` into the
   git-ignored ``build/`` (nvcc, sm_90a, one process per source) and prints
   the build seconds.
3. Detects a 1536x1024 textured frame and matches two buffers under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
   inside a detect or a ``match_features``), then detects once more to get
   the main path's real inputs and holds each kernel against its plain
   PyTorch version on the card: the blur bit for bit on all 36 layers of
   the frame and on ragged and tiny layers (n < k) with every tap count,
   the frontend bit for bit on all 7 octaves and on ragged, tiny,
   unaligned and 17-layer stacks, the orientation histogram within 1e-4
   on the frame's records, at 1/16 and 1/256 of the contrast (the bar
   scaled to match), at counts 0 and 1 and on synthetic edge records
   (windows clipped at a layer's corners, a window larger than the
   smallest octave's layer, radius 0 and 28), the descriptor in UBC and
   VLFeat order and on the pyramid at 1/16 and 1/256 of its contrast (u8
   bar); every back-half gate also holds rows past the count at zero and
   two launches equal byte for byte; the 2-NN matcher bit for bit at
   16384x16384, with ties on its tile and slice edges (placed from
   ``ops/match.KERNEL_GEOMETRY``), with a ragged A and with count_b 0
   and 1. Each kernel is timed on the device (CUDA events around calls
   queued behind a device-side sleep) and summed over its launches of a
   frame at their own shapes; the histogram also at count 0, beside a
   zero fill of its output and an estimate of its instruction-issue floor
   (a static count of the SASS loop's instructions a cell, by
   ``cuobjdump``). Then one
   ``detect_features`` at
   ``nb_scales_per_octave=15`` on a 640x480 frame against the all-plain
   pipeline.
4. Drives the detect path: ``SiftInstance.detect_features`` at 1536x1024
   (upsampling, capacity 32768) into buffers 0 and 1, with every launch
   counter set to 0 just before and read just after, and checks the result
   against the same pipeline run with every wrapper forced to its plain
   version.
5. Drives the match path the same way: detect frame A into buffer 0 and
   frame B (A moved 7 px right and 5 px down) into buffer 1,
   ``match_features(0, 1)``, ``get_matches_number``, ``download_matches``
   and ``match_features(1, 0)`` for the cross-check; at least 90 % of the
   Lowe-0.75 cross-checked matches must land within 1.5 px of the known
   translation, and the downloaded bytes must equal those of the same
   matching with the plain version.
6. A short torch.profiler breakdown of three frames (device busy time,
   idle share, the kernels that take the most device time).
7. Drives the later paths, each with the launch counters set to 0 just
   before and read just after:
   - ``SiftDetector`` (the staged detector) at the headline frame: wall
     ms and launches a detect, then its gates against ``make_detect_fn``
     (lost 0 on both, the same count, sorted (x, y, sigma, orientation)
     within 1e-5, descriptors equal after a lexsort), at 640x480 if its
     per-octave capacities clamp at 1536x1024;
   - ``start_trace`` / ``stop_trace`` around two detects and a match: the
     Chrome trace must name the five kernels;
   - in a process group of world size 1 (NCCL, ``file://`` store): dp
     detect of two frames bit-equal to two single detects, the ring
     matcher at 16384x16384 and the one-card 4- and 3-shard folds at
     count_b 16001 (ties on the kernel's and the shards' edges) bit-equal
     to ``match_2nn_fused``, and one ``measure_dp_scaling`` point;
   - SfM on a synthetic scene (8 cameras, 4096 points, 0.3 px noise):
     ``reconstruct_sequence`` on the card (final cost < 1 px^2, ATE <
     0.05, relative rotations < 1 degree) and against its CPU run (poses
     within 1e-3), ``make_distributed_ba`` against ``bundle_adjust``, and
     the times of the reconstruction, RANSAC a pair, the 8-point SVDs and
     one BA iteration.
8. Drives the port's perf harness, examples and native IO, each with the
   launch counters set to 0 just before and read just after (none of it
   needs cv2, matplotlib or sklearn):
   - ``perf.harness.run_runtime_benchmark`` with
     ``VulkanSiftTpuTorchDetector`` at 640x480, 1536x1024 and 3456x2304
     (3 warm-ups, 10 timed upload + detect + download runs; the 1536x1024
     count must equal the slice's);
   - ``perf.harness.compute_metrics`` on the frame and its 7x5 px
     translate (precision >= 0.9, one matcher launch, Lowe matches equal
     to the CPU's);
   - each example's compute function on a 640x480 frame: ``sift_detect``
     (count equal to ``detect_features``'), ``sift_match`` (>= 90 % of the
     cross-checked matches on the translation), ``sift_error_handling``
     (four ``InvalidInputError``, the instance still detects),
     ``sift_profile`` (its trace names the four detect kernels) and
     ``sift_show_pyramid`` (the octave plan);
   - ``utils.native_io`` built with g++ into ``build/``: a PGM of the
     frame decodes to its bytes natively and in Python, a feature file
     round-trips the frame's features.
9. Prints the per-frame kernel sums, the launches by path and the kernel
   table (launches summed over every path) as JSON lines, the total
   seconds, the card line, and as the last line ``{"ok": true, "device":
   {...}}``.

``--parent DIR`` also builds the blur, frontend, orientation-histogram,
descriptor and matcher sources of the checkout at DIR (for example the
parent commit, unpacked with ``git archive`` into the git-ignored
``build/``), checks that they agree with these and times them in turns
with these.

``--cards N`` runs instead the multi-device paths across N cards, one
NCCL process each (``torch.multiprocessing``, a ``file://`` store under
``build/``): on every rank the ring at 16384x16384 and at count_b 16001
(ties on the kernel's and the shards' edges), dp detect of two frames a
rank and the distributed BA of the SfM scene, each against the
single-device result on that rank's card, their times, and
``measure_dp_scaling`` at 1, 2, 4, ... cards.

Any failure raises, so the script exits non-zero and prints no result
line; it also exits non-zero when no CUDA card is available.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import vulkansift_tpu_torch as vt
from vulkansift_tpu_torch.config import NB_ORI_HIST_BINS
from vulkansift_tpu_torch.ops import backhalf, blur, cuda_lib, frontend
from vulkansift_tpu_torch.ops import descriptor as desc_mod
from vulkansift_tpu_torch.ops import extract, gaussian
from vulkansift_tpu_torch.ops import match as match_mod
from vulkansift_tpu_torch.ops import orientation, patches
from vulkansift_tpu_torch.ops.scale_space import upsample2x_linear
from vulkansift_tpu_torch.parallel.scaling import card_info
from vulkansift_tpu_torch.pipeline import make_detect_fn

W, H = 1536, 1024
CAPACITY = 32768
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8/u8 tensor cores (data sheet)
# SIMT dp4a issue rate assumed for the ceiling of a matcher that takes its
# products on the SIMT pipe (the yardstick the tensor-core design must beat):
# 64 results per clock per SM (the CUDA guide's 32-bit integer multiply-add rate for
# compute capability 9.0), 132 SMs.
DP4A_PER_CLOCK_PER_SM = 64
SMS = 132
MATCH_N = 16384               # the JAX bench's sift_match_2nn_16k_ms shape
SHIFT = (7, 5)                # frame B = frame A moved right, down (px)
REPS = 20                     # kernel timing repetitions
SLEEP_CYCLES = 20_000_000     # ~10 ms, longer than queueing REPS calls takes
PLAIN_REPS = 5                # plain-version and library timing repetitions
WARMUP_FRAMES = 3
TIMED_FRAMES = 10
REPLACES = {
    "blur_dog": "vulkansift_tpu/ops/pallas_blur.py:331",
    "frontend": "vulkansift_tpu/ops/pallas_frontend.py:327",
    "orientation_hist": "vulkansift_tpu/ops/pallas_backhalf.py:403",
    "descriptor": "vulkansift_tpu/ops/pallas_backhalf.py:677",
    "match_2nn": "vulkansift_tpu/ops/pallas_match.py:222",
}
WRAPPERS = {
    "blur_dog": blur.blur_dog,
    "frontend": frontend.frontend,
    "orientation_hist": backhalf.orientation_hist,
    "descriptor": backhalf.descriptor,
    "match_2nn": match_mod.match_2nn_tiles,
}
DETECT_KERNELS = ("blur_dog", "frontend", "orientation_hist", "descriptor")


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


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up,
    each from an idle stream: the time includes the host's dispatch of the
    call (used for the plain versions and the yardsticks)."""
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


def device_ms(fn, reps: int = REPS) -> float:
    """Device time per call of a kernel wrapper: after one warm-up, ``reps``
    calls queued behind a device-side sleep, so that the two events bracket
    the kernels back to back and not the host's dispatch of each call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def ab_ms(new, old, reps: int = REPS):
    """Device ms of two versions of one kernel in turns (old, new, new,
    old), each the mean of its two turns: (new, old)."""
    o1, n1, n2, o2 = (device_ms(f, reps) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


class Parent:
    """The blur, frontend, orientation-histogram, descriptor and matcher
    kernels of another checkout (``--parent DIR``, for example ``git
    archive`` of the parent commit unpacked into the git-ignored
    ``build/``), built with the port's nvcc flags and launched through
    their C entry points, so that the two designs are timed in one call on
    one card."""

    def __init__(self, root: str):
        self.fns = {}
        csrc = Path(root) / "vulkansift_tpu_torch" / "csrc"
        procs = []
        for name, sym, argtypes in (
                ("blur_dog", "vks_blur_dog", blur._ARGTYPES),
                ("frontend", "vks_frontend", frontend._ARGTYPES),
                ("orientation_hist", "vks_orientation_hist",
                 backhalf._HIST_ARGTYPES),
                ("descriptor", "vks_descriptor", backhalf._DESC_ARGTYPES),
                ("match_2nn", "vks_match_2nn", match_mod._ARGTYPES)):
            src = csrc / f"{name}.cu"
            out = cuda_lib.BUILD_DIR / f"parent_{name}.so"
            cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs.append((subprocess.Popen(
                [cuda_lib.nvcc_path(), *cuda_lib.nvcc_flags(name), "-o",
                 str(out), str(src)]), name, sym, argtypes, out))
        for proc, name, sym, argtypes, out in procs:
            check(proc.wait() == 0, f"{root}: {name}.cu did not build")
            fn = getattr(ctypes.CDLL(str(out)), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.fns[name] = fn

    def blur(self, x, taps, with_dog: bool):
        y = torch.empty_like(x)
        dog = torch.empty_like(x) if with_dog else None
        t = np.ascontiguousarray(taps, np.float32)
        cuda_lib.launch(
            self.fns["blur_dog"], x, "parent blur_dog", x.data_ptr(),
            y.data_ptr(), 0 if dog is None else dog.data_ptr(),
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(t),
            x.shape[0], x.shape[1])
        return y, dog

    def frontend(self, dog, thr: float):
        ns, h, w = dog.shape
        code = torch.empty((ns - 2, h - 2, w - 2), dtype=torch.uint8,
                           device=dog.device)
        counts = torch.zeros((ns - 2, h - 2), dtype=torch.int32,
                             device=dog.device)
        cuda_lib.launch(self.fns["frontend"], dog, "parent frontend",
                        dog.data_ptr(), code.data_ptr(), counts.data_ptr(),
                        ns, h, w, float(np.float32(thr * 0.8)))
        return code, counts

    def orientation_hist(self, flat, recs, count, radius: int):
        # A zero-filled output, as the older wrapper gave its kernel, which
        # leaves the rows past the count alone (the current one writes
        # them).
        return backhalf._launch_orientation_hist(
            self.fns["orientation_hist"], flat, recs, count, radius,
            "parent orientation_hist",
            hist=torch.zeros((recs.rec.shape[0], NB_ORI_HIST_BINS),
                             device=flat.device))

    def descriptor(self, flat, recs, count, radius: int, vlfeat: bool):
        return backhalf._launch_descriptor(self.fns["descriptor"], flat, recs,
                                           count, radius, vlfeat,
                                           "parent descriptor")

    def match(self, a, ca, b, cb):
        out = tuple(torch.empty(a.shape[0], dtype=torch.int32,
                                device=a.device) for _ in range(4))
        cuda_lib.launch(
            self.fns["match_2nn"], a, "parent match_2nn", a.data_ptr(),
            ca.data_ptr(), b.data_ptr(), cb.data_ptr(),
            *(o.data_ptr() for o in out), a.shape[0], b.shape[0])
        return out


def max_sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- per-kernel checks --------------------------------------------------------

def blur_launches(cap: dict):
    """The 36 blur launches of one detect, with the frame's own inputs:
    (octave, layer, input, taps, with_dog). Octave 0 blurs its seed (no
    DoG) and then five layers; every other octave's first layer is a
    downsample, so it blurs five."""
    cfg = cap["config"]
    taps = [gaussian.half_kernel(s) for s in gaussian.kernel_sigmas(cfg)]
    out = [(0, 0, cap["seed"], taps[0], False)]
    for o, g in enumerate(cap["gaussians"]):
        for i in range(1, len(taps)):
            out.append((o, i, g[i - 1], taps[i], True))
    return out


def blur_bound(x: torch.Tensor, ntaps: int, with_dog: bool):
    npx, k = x.numel(), ntaps - 1
    return bound(4 * npx * (3 if with_dog else 2),
                 npx * (2 * (1 + 3 * k) + (1 if with_dog else 0)))


def blur_exact(x, t, with_dog: bool, what: str) -> float:
    """Kernel vs plain version on one layer: y and dog, bit for bit."""
    y_k, d_k = blur.blur_dog(x, t, with_dog)
    y_p, d_p = blur.blur_dog_plain(x, t, with_dog)
    err = (y_k - y_p).abs().max().item()
    if with_dog:
        err = max(err, (d_k - d_p).abs().max().item())
    check(err == 0.0, f"blur {what} taps={len(t)} err {err}")
    return err


def taps_of_length(n: int) -> np.ndarray:
    """The port's half-kernel with ``n`` taps (sigma = (n - 1) / 4)."""
    return gaussian.half_kernel((n - 1) / 4.0)


def check_blur(cap: dict, parent) -> dict:
    """Every blur launch of the frame (36 layers over 7 octaves), bit for
    bit, timed at its own shape and summed per frame; then ragged and tiny
    layers (1280x960, 75x41, 5x7 and 7x5, where n < k) with every tap count
    1..20, with and without the DoG, which reach the border path that the
    frame's shapes do not. The table row is the 14-tap 3072x2048 layer."""
    rows = []
    for o, i, x, t, with_dog in blur_launches(cap):
        err = blur_exact(x, t, with_dog, f"octave {o} layer {i}")
        ms = device_ms(lambda: blur.blur_dog(x, t, with_dog))
        b_ms, b_by = blur_bound(x, len(t), with_dog)
        rows.append(dict(octave=o, layer=i, taps=len(t), shape=list(x.shape),
                         dog=with_dog, max_abs_err=err, ms=ms, bound_ms=b_ms,
                         bound_by=b_by, x=x, t=t))
    frame_ms = sum(r["ms"] for r in rows)
    frame_bound = sum(r["bound_ms"] for r in rows)
    for r in rows:
        print(f"blur_dog octave {r['octave']} layer {r['layer']} "
              f"taps={r['taps']} {tuple(r['shape'])} dog={r['dog']} "
              f"bit-exact ms={r['ms']:.4f} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})", flush=True)
    print(f"blur_dog per frame: {len(rows)} launches bit-exact, "
          f"sum ms={frame_ms:.4f} sum bound_ms={frame_bound:.4f}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    n_small = 0
    for h, w in ((960, 1280), (41, 75), (7, 5), (5, 7)):
        x = torch.rand((h, w), generator=gen, device="cuda")
        for n in range(1, 21):
            for with_dog in (False, True):
                blur_exact(x, taps_of_length(n), with_dog, f"{w}x{h}")
                n_small += 1
    print(f"blur_dog ragged and n<k layers: {n_small} cases bit-exact "
          f"(1280x960, 75x41, 5x7, 7x5; taps 1..20; with and without DoG)",
          flush=True)

    big = max((r for r in rows if r["octave"] == 0), key=lambda r: r["taps"])
    x, t = big["x"], big["t"]
    k = len(t) - 1
    plain_ms = median_ms(lambda: blur.blur_dog_plain(x, t, True), PLAIN_REPS)
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
        lib_ms = device_ms(lambda: torch.nn.functional.conv2d(xp, k2),
                           PLAIN_REPS)
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    res = dict(taps=big["taps"], shape=big["shape"], max_abs_err=0.0,
               ms=big["ms"], plain_ms=plain_ms, bound_ms=big["bound_ms"],
               bound_by=big["bound_by"], library_ms=lib_ms,
               frame_launches=len(rows), frame_ms=frame_ms,
               frame_bound_ms=frame_bound,
               note="14-tap layer of octave 0 (3072x2048) with the DoG")
    if parent is not None:
        y_o, d_o = parent.blur(x, t, True)
        y_n, d_n = blur.blur_dog(x, t, True)
        check(torch.equal(y_o, y_n) and torch.equal(d_o, d_n),
              "parent blur_dog differs from this one")
        res["ms"], res["parent_ms"] = ab_ms(
            lambda: blur.blur_dog(x, t, True),
            lambda: parent.blur(x, t, True))
        res["parent_frame_ms"] = sum(
            device_ms(lambda: parent.blur(r["x"], r["t"], r["dog"]))
            for r in rows)
    print(f"blur_dog taps={res['taps']} {tuple(res['shape'])} ms="
          f"{res['ms']:.4f} plain_ms={plain_ms:.4f} bound_ms="
          f"{res['bound_ms']:.4f} ({res['bound_by']}) conv2d_ms={lib_ms:.4f}"
          + (f" parent_ms={res['parent_ms']:.4f} parent_frame_ms="
             f"{res['parent_frame_ms']:.4f}" if parent is not None else ""),
          flush=True)
    return res


def frontend_bound(dog: torch.Tensor):
    ns, h, w = dog.shape
    cells = (ns - 2) * (h - 2) * (w - 2)
    # 147 f32 operations per centre cell, counted from frontend.cu.
    return bound(4 * dog.numel() + cells + 4 * (ns - 2) * (h - 2),
                 147 * cells)


def frontend_exact(dog: torch.Tensor, thr: float, what: str) -> int:
    """Kernel vs plain version on one stack: codes and row counts, bit for
    bit. Returns the number of candidates."""
    code_k, cnt_k = frontend.frontend(dog, thr)
    code_p, cnt_p = extract.dense_frontend(dog, thr)
    check(torch.equal(code_k, code_p) and torch.equal(cnt_k, cnt_p),
          f"frontend {what} not bit-exact: codes differ at "
          f"{int((code_k != code_p).sum())} cells, counts at "
          f"{int((cnt_k != cnt_p).sum())} rows")
    return int(cnt_k.sum())


# Ragged, tiny and deep DoG stacks (layers, H, W) for the frontend gate:
# W-2 not a multiple of the 64-cell tile nor of 4, the smallest stack,
# the frame's octave-6 shape, 17 layers (nb_scales_per_octave 15), and one
# 17-layer stack as wide as octave 0.
FRONTEND_CASES = ((5, 41, 75), (3, 3, 3), (4, 19, 70), (5, 32, 48),
                  (6, 67, 131), (17, 130, 203), (17, 256, 3072))


def check_frontend(cap: dict, parent) -> dict:
    """Bit-exact on every octave's DoG stack (the 7 launches of a frame),
    each timed at its own shape and summed per frame; on the ragged, tiny
    and 17-layer stacks of FRONTEND_CASES (random normal DoG values, x 0.05,
    so that candidates are dense) and on one stack whose pointer is not
    16-byte aligned. The table row is octave 0 (5x2048x3072)."""
    thr = cap["dog_threshold"]
    frame_ms = frame_bound = 0.0
    for o, dog in enumerate(cap["dogs"]):
        n = frontend_exact(dog, thr, f"octave {o}")
        ms = device_ms(lambda: frontend.frontend(dog, thr))
        b_ms, b_by = frontend_bound(dog)
        frame_ms += ms
        frame_bound += b_ms
        print(f"frontend octave {o} {tuple(dog.shape)} "
              f"candidates={n} bit-exact ms={ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if o == 0:
            row = dict(shape=list(dog.shape), max_abs_err=0.0, ms=ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape in FRONTEND_CASES:
        dog = torch.randn(shape, generator=gen, device="cuda") * 0.05
        n = frontend_exact(dog, thr, f"{shape}")
        print(f"frontend {shape} candidates={n} bit-exact", flush=True)
    shape = FRONTEND_CASES[-1]
    store = torch.empty(math.prod(shape) + 1, device="cuda")
    dog = store[1:].view(shape)
    dog.copy_(torch.randn(shape, generator=gen, device="cuda") * 0.05)
    check(dog.data_ptr() % 16 != 0, "unaligned case is aligned")
    n = frontend_exact(dog, thr, f"{shape} unaligned")
    print(f"frontend {shape} at a pointer 4 bytes past 16-byte alignment "
          f"candidates={n} bit-exact", flush=True)
    del store, dog

    dog = cap["dogs"][0]
    row["plain_ms"] = median_ms(lambda: extract.dense_frontend(dog, thr),
                                PLAIN_REPS)
    row.update(frame_launches=len(cap["dogs"]), frame_ms=frame_ms,
               frame_bound_ms=frame_bound)
    if parent is not None:
        for o, d in enumerate(cap["dogs"]):
            check(all(torch.equal(a, b) for a, b in zip(
                parent.frontend(d, thr), frontend.frontend(d, thr))),
                  f"parent frontend differs from this one at octave {o}")
        row["ms"], row["parent_ms"] = ab_ms(
            lambda: frontend.frontend(dog, thr),
            lambda: parent.frontend(dog, thr))
        row["parent_frame_ms"] = sum(
            device_ms(lambda: parent.frontend(d, thr)) for d in cap["dogs"])
    print(f"frontend {tuple(dog.shape)} ms={row['ms']:.4f} "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}); per frame: {len(cap['dogs'])} launches, "
          f"sum ms={frame_ms:.4f} sum bound_ms={frame_bound:.4f}"
          + (f" parent_ms={row['parent_ms']:.4f} parent_frame_ms="
             f"{row['parent_frame_ms']:.4f}" if parent is not None else ""),
          flush=True)
    return row


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


def sass_loop(lib: str, kernel: str, marker: str = "MUFU.EX2"):
    """(instructions, markers) of the innermost loop of ``kernel`` in the
    library ``lib`` whose body holds ``marker``: the SASS (``cuobjdump
    -sass``) from a backward branch's target to the branch. With one
    ``expf`` a cell, the MUFU.EX2 count is the cells an (unrolled) body
    handles. A static count: instructions on branches that a cell does not
    take count too, so the issue floor built on it is an estimate, not a
    count of issued instructions. None when cuobjdump is missing or no
    such loop exists."""
    tool = Path(cuda_lib.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    code, fn = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and fn is not None and kernel in fn:
            code.append((int(m.group(1), 16), m.group(2)))
    best = None
    for addr, ins in code:
        m = re.search(r"\bBRA(?:\.\S+)?\s.*0x([0-9a-f]+)$", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        body = [i for a, i in code
                if int(m.group(1), 16) <= a <= addr and i != "NOP"]
        k = sum(marker in i for i in body)
        if k and (best is None or len(body) < best[0]):
            best = (len(body), k)
    return best


def hist_gate(flat, recs, cnt, r: int, what: str, bar: float = 1e-4):
    """Kernel vs plain version on one set of records: every bin within
    ``bar``, rows past the count zero, two launches equal byte for byte.
    Both launches write into outputs filled with NaN here, so the rows past
    the count are zero because the kernel wrote them; the wrapper's own
    output must hold the same bytes. Returns the max abs error."""
    fn = cuda_lib.entry("orientation_hist", "vks_orientation_hist",
                        backhalf._HIST_ARGTYPES)
    h_k, h_2 = (backhalf._launch_orientation_hist(
        fn, flat, recs, cnt, r, "orientation_hist",
        hist=torch.full((recs.rec.shape[0], NB_ORI_HIST_BINS), math.nan,
                        device=flat.device)) for _ in range(2))
    h_w = backhalf.orientation_hist(flat, recs, cnt, ori_radius=r)
    for other, who in ((h_2, "two launches"), (h_w, "the wrapper")):
        check(torch.equal(h_k.view(torch.int32), other.view(torch.int32)),
              f"orientation_hist {what}: {who} differ")
    h_p = orientation.raw_histograms(flat, recs, cnt, ori_radius=r)
    err = (h_k - h_p).abs().max().item()
    n = max(int(cnt), 0)
    check(err <= bar, f"orientation_hist {what}: err {err} > {bar}")
    check(not h_k[n:].any(), f"orientation_hist {what}: a row past the "
          "count is not zero")
    print(f"orientation_hist {what} keypoints={n} err={err:.3g} (bar "
          f"{bar:.3g}); two launches and the wrapper equal; rows past the "
          "count zero", flush=True)
    return err


def hist_edge_records(r_max: int):
    """Synthetic histogram records on two random layers, 64x96 and the
    frame's smallest octave's 32x48: windows of radius 12 clipped at each
    corner of the 64x96 layer (centres on its corner pixels and at (w, h),
    which ``keypoint_records`` allows), a window of radius ``r_max`` over
    the whole 32x48 layer, radius 0, radius ``r_max`` inside the 64x96
    layer, and a sigma whose radius exceeds ``r_max`` (clamped to it).
    Returns (flat, records)."""
    (h0, w0), (h1, w1) = (64, 96), (32, 48)
    gen = torch.Generator(device="cuda").manual_seed(13)
    flat = torch.rand(h0 * w0 + h1 * w1, generator=gen, device="cuda")

    def sig(rad: float) -> float:  # floor(3 * 1.5 * sig) == rad
        return (rad + 0.5) / 4.5
    rows = [(0, cx + 0.3, cy - 0.2, sig(12), cx, cy, w0, h0)
            for cx, cy in ((0, 0), (w0 - 1, 0), (0, h0 - 1),
                           (w0 - 1, h0 - 1), (w0, h0))]
    rows += [(h0 * w0, 24.1, 15.6, sig(r_max), 24, 16, w1, h1),
             (0, 40.2, 30.1, 0.2, 40, 30, w0, h0),
             (0, 48.4, 32.3, sig(r_max), 48, 32, w0, h0),
             (0, 30.0, 20.0, sig(r_max + 12), 30, 20, w0, h0)]
    base = torch.tensor([r[0] for r in rows], dtype=torch.int64,
                        device="cuda")
    rec = torch.tensor([list(r[1:]) + [0.0] for r in rows],
                       dtype=torch.float32, device="cuda")
    return flat, patches.SampleRecords(base, rec)


def check_orientation_hist(cap: dict, parent) -> dict:
    """The frame's records against the plain version (``hist_gate``: bins
    within 1e-4, rows past the count zero, two launches equal); the same
    on the pyramid at 1/16 and 1/256 of its contrast with the bar scaled to
    match, at counts 0 and 1, and on ``hist_edge_records`` at the largest
    radius of nb_scales_per_octave=1. Timed at the frame's count and at
    count 0, beside a zero fill of its output, its bound and an estimate
    of its instruction-issue floor (``sass_loop``)."""
    flat, recs, cnt = cap["flat"], cap["hist_records"], cap["hist_count"]
    r = cap["ori_radius"]
    err = hist_gate(flat, recs, cnt, r, "frame")
    for k in (16, 256):
        hist_gate(flat * (1.0 / k), recs, cnt, r, f"contrast 1/{k}",
                  1e-4 / k)
    for c in (0, 1):
        hist_gate(flat, recs, _cuda_count(c), r, f"count {c}")
    r1 = patches.max_orientation_radius(vt.SiftConfig(nb_scales_per_octave=1))
    e_flat, e_recs = hist_edge_records(r1)
    hist_gate(e_flat, e_recs, _cuda_count(e_recs.rec.shape[0]), r1,
              f"edge records (corners, a window over a 32x48 layer, radius 0,"
              f" radius {r1} and one clamped to it)")
    del e_flat, e_recs

    ms = device_ms(lambda: backhalf.orientation_hist(
        flat, recs, cnt, ori_radius=r))
    # A zero fill of the output (what the older wrapper launched before its
    # kernel), and the kernel at count 0 (its launch and the zeros it
    # writes to every row).
    fill_ms = device_ms(lambda: torch.zeros(
        (recs.rec.shape[0], NB_ORI_HIST_BINS), device=flat.device))
    zero = _cuda_count(0)
    count0_ms = device_ms(lambda: backhalf.orientation_hist(
        flat, recs, zero, ori_radius=r))
    plain_ms = median_ms(lambda: orientation.raw_histograms(
        flat, recs, cnt, ori_radius=r), PLAIN_REPS)
    n = int(cnt)
    # 30 f32 operations per window cell (transcendentals counted as one): a
    # property of the function (the plain version's arithmetic), whatever
    # implements it.
    nbytes, ops, px = _window_work(
        flat, recs, n, lambda s: torch.floor(3.0 * (1.5 * s)), r, 30, 36)
    b_ms, b_by = bound(nbytes, ops)
    res = dict(keypoints=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None, fill_ms=fill_ms,
               count0_ms=count0_ms, frame_launches=1, frame_ms=ms,
               frame_bound_ms=b_ms)
    clock_mhz = max_sm_clock_mhz()
    libs = {"": str(cuda_lib._lib_path("orientation_hist"))}
    if parent is not None:
        libs["parent "] = str(cuda_lib.BUILD_DIR
                              / "parent_orientation_hist.so")
    for who, lib in libs.items():
        loop = sass_loop(lib, "orientation_hist_kernel")
        if loop is None:
            print(f"orientation_hist {who}static issue floor: not measured "
                  "(no cuobjdump or no loop found)", flush=True)
            continue
        per_cell = loop[0] / loop[1]
        floor_ms = px * per_cell / (SMS * 128 * clock_mhz * 1e6) * 1e3
        res[f"{who.strip() or 'new'}_issue_floor_ms"] = floor_ms
        print(f"orientation_hist {who}static issue floor: {px} cells x "
              f"{per_cell:.1f} lane instructions a cell (a static count of "
              f"the SASS loop's {loop[0]} instructions over its {loop[1]} "
              f"cells) / ({SMS} SMs x 128 lanes x {clock_mhz:.0f} MHz) = "
              f"{floor_ms:.4f} ms", flush=True)
    if parent is not None:
        old = parent.orientation_hist(flat, recs, cnt, r)
        new = backhalf.orientation_hist(flat, recs, cnt, ori_radius=r)
        d = (old - new).abs().max().item()
        check(d <= 1e-4, f"parent orientation_hist differs from this one by "
              f"{d}")
        res["ms"], res["parent_ms"] = ab_ms(
            lambda: backhalf.orientation_hist(flat, recs, cnt, ori_radius=r),
            lambda: parent.orientation_hist(flat, recs, cnt, r))
        res["frame_ms"] = res["ms"]
    print(f"orientation_hist keypoints={n} cells={px} bytes={nbytes} "
          f"err={err:.3g} ms={res['ms']:.4f} (at count 0 {count0_ms:.4f}; "
          f"a zero fill of the output {fill_ms:.4f}) plain_ms="
          f"{plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})"
          + (f" parent_ms={res['parent_ms']:.4f}" if parent is not None
             else ""), flush=True)
    return res


def descriptor_gate(flat, recs, cnt, r: int, vl: bool, what: str = ""):
    """Kernel vs plain version on the frame's pair records in one bin
    order: at least 99.5 % of u8 bins within +-1 and none off by more than
    8 (the JAX package's bar), rows past the count zero, and two launches
    equal byte for byte. Returns (raw max abs error, share within 1, max
    u8 difference)."""
    fmt = ("VLFeat" if vl else "UBC") + what
    d_k = backhalf.descriptor(flat, recs, cnt, desc_radius=r, use_vlfeat=vl)
    d_2 = backhalf.descriptor(flat, recs, cnt, desc_radius=r, use_vlfeat=vl)
    check(torch.equal(d_k.view(torch.int32), d_2.view(torch.int32)),
          f"descriptor {fmt}: two launches differ")
    d_p = desc_mod.raw_descriptors(flat, recs, cnt, desc_radius=r,
                                   use_vlfeat=vl)
    err = (d_k - d_p).abs().max().item()
    q_k = desc_mod.normalize_descriptor(d_k).int()
    q_p = desc_mod.normalize_descriptor(d_p).int()
    n = int(cnt)
    check(not d_k[n:].any(), f"descriptor {fmt}: a row past the count is "
          "not zero")
    qd = (q_k[:n] - q_p[:n]).abs()
    within = (qd <= 1).float().mean().item() if n else 1.0
    qmax = qd.max().item() if n else 0
    check(within >= 0.995 and qmax <= 8,
          f"descriptor {fmt} u8 within1={within} max={qmax}")
    print(f"descriptor {fmt} pairs={n} raw_err={err:.3g} "
          f"u8_within1={within:.6f} u8_max={qmax}; two launches equal; rows "
          f"past the count zero", flush=True)
    return err, within, qmax


def check_descriptor(cap: dict, parent) -> dict:
    flat, recs, cnt = cap["flat"], cap["desc_records"], cap["desc_count"]
    r, vl = cap["desc_radius"], cap["use_vlfeat"]
    descriptor_gate(flat, recs, cnt, r, not vl)
    err, within, qmax = descriptor_gate(flat, recs, cnt, r, vl)
    # Low contrast: the pyramid scaled by 1/16 (a frame in 0..16 u8) and by
    # 1/256; the kernel's fixed-point step follows each pair's gradients.
    for k in (16, 256):
        descriptor_gate(flat * (1.0 / k), recs, cnt, r, vl,
                        f" contrast 1/{k}")
    n = int(cnt)
    ms = device_ms(lambda: backhalf.descriptor(
        flat, recs, cnt, desc_radius=r, use_vlfeat=vl))
    plain_ms = median_ms(lambda: desc_mod.raw_descriptors(
        flat, recs, cnt, desc_radius=r, use_vlfeat=vl), PLAIN_REPS)
    # ~75 f32 operations per window pixel (8 weighted bin updates,
    # transcendentals counted as one), counted from descriptor.cu.
    nbytes, ops, px = _window_work(
        flat, recs, n,
        lambda s: torch.floor(((math.sqrt(2.0) * (3.0 * s)) * 5.0) * 0.5
                              + 0.5), r, 75, 128)
    b_ms, b_by = bound(nbytes, ops)
    res = dict(pairs=n, max_abs_err=err, u8_within1=within, u8_max=qmax,
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, frame_launches=1, frame_ms=ms,
               frame_bound_ms=b_ms)
    if parent is not None:
        old = parent.descriptor(flat, recs, cnt, r, vl)
        new = backhalf.descriptor(flat, recs, cnt, desc_radius=r,
                                  use_vlfeat=vl)
        qd = (desc_mod.normalize_descriptor(old).int()
              - desc_mod.normalize_descriptor(new).int()).abs()[:n]
        check(n == 0 or ((qd <= 1).float().mean().item() >= 0.995
                         and qd.max().item() <= 8),
              "parent descriptor disagrees with this one")
        res["ms"], res["parent_ms"] = ab_ms(
            lambda: backhalf.descriptor(flat, recs, cnt, desc_radius=r,
                                        use_vlfeat=vl),
            lambda: parent.descriptor(flat, recs, cnt, r, vl))
        res["frame_ms"] = res["ms"]
    print(f"descriptor pairs={n} cells={px} bytes={nbytes} "
          f"raw_err={err:.3g} "
          f"u8_within1={within:.6f} u8_max={qmax} ms={res['ms']:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by})"
          + (f" parent_ms={res['parent_ms']:.4f}" if parent is not None
             else ""), flush=True)
    return res


def _cuda_count(n: int) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device="cuda")


def _rand_desc(seed: int, n: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, (n, 128), dtype=np.uint8)).cuda()


def _match_bit_exact(a, ca, b, cb, what: str) -> int:
    """Kernel vs plain version: every output of every row, bit for bit."""
    k = match_mod.match_2nn_tiles(a, ca, b, cb)
    p = match_mod.top2_plain(a, ca, b, cb)
    err = max(int((x.long() - y.long()).abs().max()) for x, y in zip(k, p))
    check(err == 0, f"match_2nn {what}: max diff {err} against plain")
    print(f"match_2nn {what} bit-exact", flush=True)
    return err


def match_bounds(na: int, nb: int, capacity: int):
    """The matcher's bound for ``na`` x ``nb`` live rows at an output
    capacity of ``capacity`` rows: (ms, what bounds it) from the bytes
    (each live descriptor read once, four int32 outputs per row, two
    counts) and the u8 products at the tensor cores' int8 rate; and the
    SIMT design's ceiling, 32 dp4a per pair at the SIMT dp4a
    rate."""
    b_ms, b_by = bound(128 * (na + nb) + 4 * 4 * capacity + 2 * 4,
                       2 * 128 * na * nb, INT8_OPS_PER_S)
    clock_mhz = max_sm_clock_mhz()
    dp4a_ms = (na * nb * 32 / (SMS * DP4A_PER_CLOCK_PER_SM * clock_mhz * 1e6)
               * 1e3)
    return b_ms, b_by, dp4a_ms


def edge_duplicates(a: torch.Tensor, b: torch.Tensor, count_b: int):
    """B with ties on the kernel's edges at ``count_b`` (from
    ``ops/match.KERNEL_GEOMETRY``): a B row copied across the first two
    B-tile edges and across every slice edge, one A row's copies on both
    sides of the first and the last slice edge, and copies of A rows in
    every B row past ``count_b``, which would win if they were read."""
    g = match_mod.KERNEL_GEOMETRY
    tile = g["b_tile_rows"]
    edges = [s for s, _ in match_mod.kernel_slices(count_b)[1:]
             if 0 < s < count_b]
    b = b.clone()
    for e in [tile, 2 * tile] + edges:
        b[e] = b[e - 1]
    b[edges[0] - 3] = a[3]
    b[edges[0] + 2] = a[3]
    b[edges[-1] - 1] = a[4]
    b[edges[-1] + 1] = a[4]
    b[count_b:] = a[:b.shape[0] - count_b]
    return b, edges


def check_match(parent) -> dict:
    """The JAX bench's 16384x16384 shape (descriptors from seeds 0 and 1,
    full counts), then, bit for bit: counts (16384, 16001) with ties on the
    kernel's B-tile and slice edges at that count; A of 16347 rows (not a
    multiple of the A tile) with count_a 16284; and count_b 0 and 1."""
    g = match_mod.KERNEL_GEOMETRY
    n = MATCH_N
    a, b = _rand_desc(0, n), _rand_desc(1, n)
    cnt = _cuda_count(n)
    err = _match_bit_exact(a, cnt, b, cnt, f"{n}x{n}")
    b2, edges = edge_duplicates(a, b, 16001)
    err = max(err, _match_bit_exact(
        a, cnt, b2, _cuda_count(16001),
        f"counts (16384, 16001), ties across B-tile edges "
        f"{g['b_tile_rows']}, {2 * g['b_tile_rows']} and slice edges "
        f"{edges}"))
    del b2
    na = n - 37
    check(na % g["a_tile_rows"] and (n - 100) % g["a_tile_rows"],
          "ragged A case is a multiple of the A tile")
    a_r = a[:na].contiguous()
    err = max(err, _match_bit_exact(a_r, _cuda_count(n - 100), b, cnt,
                                    f"A {na} rows, count_a {n - 100}"))
    for cb in (0, 1):
        err = max(err, _match_bit_exact(a_r, _cuda_count(n - 100), b,
                                        _cuda_count(cb), f"count_b {cb}"))
    ms = device_ms(lambda: match_mod.match_2nn_tiles(a, cnt, b, cnt))
    plain_ms = median_ms(lambda: match_mod.top2_plain(a, cnt, b, cnt),
                         PLAIN_REPS)
    # Yardsticks only, not library_ms: no single PyTorch call computes a
    # 2-NN with earliest-index ties. The f32 product of the same shapes
    # (TF32 off) and the int8 product (descriptors - 128, int32 out) are
    # the distances' dot products alone; the port calls neither.
    af, bf = a.float(), b.float()
    mm_ms = device_ms(lambda: torch.mm(af, bf.T), PLAIN_REPS)
    del af, bf
    ai = (a.to(torch.int16) - 128).to(torch.int8)
    bi = (b.to(torch.int16) - 128).to(torch.int8)
    int_mm_ms = device_ms(lambda: torch._int_mm(ai, bi.T), PLAIN_REPS)
    del ai, bi
    b_ms, b_by, dp4a_ms = match_bounds(n, n, n)
    res = dict(shape=[n, n], max_abs_err=float(err), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, mm_f32_ms=mm_ms, int_mm_ms=int_mm_ms,
               dp4a_ceiling_ms=dp4a_ms, geometry=g)
    if parent is not None:
        old = parent.match(a, cnt, b, cnt)
        new = match_mod.match_2nn_tiles(a, cnt, b, cnt)
        check(all(torch.equal(x, y) for x, y in zip(old, new)),
              "parent match_2nn differs from this one")
        res["ms"], res["parent_ms"] = ab_ms(
            lambda: match_mod.match_2nn_tiles(a, cnt, b, cnt),
            lambda: parent.match(a, cnt, b, cnt))
    print(f"match_2nn {n}x{n} err={err} ms={res['ms']:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"library_ms=null"
          + (f" parent_ms={res['parent_ms']:.4f}" if parent is not None
             else ""), flush=True)
    print(f"match_2nn yardsticks: torch.mm f32 {n}x128x{n} (TF32 off) "
          f"{mm_ms:.4f} ms; torch._int_mm int8 {n}x128x{n} {int_mm_ms:.4f} "
          f"ms; SIMT dp4a ceiling {dp4a_ms:.4f} ms "
          f"({n * n * 32} dp4a at {DP4A_PER_CLOCK_PER_SM}/clock/SM x {SMS} "
          f"SMs at the max SM clock)", flush=True)
    return res


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
    launches = {k: WRAPPERS[k].launches for k in DETECT_KERNELS}
    print("kernels " + " ".join(f"{k}={v}" for k, v in launches.items()),
          flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the detect path")

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


def check_many_scales() -> dict:
    """``detect_features`` at ``nb_scales_per_octave=15`` (17 DoG layers an
    octave) on a 640x480 frame against the same pipeline with every wrapper
    forced to its plain version, with the whole-detect limits."""
    w, h = 640, 480
    img = bench_image(h, w, seed=3)
    cfg = vt.SiftConfig(nb_scales_per_octave=15, use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    inst = vt.SiftInstance(cfg, device="cuda")
    before = {k: WRAPPERS[k].launches for k in DETECT_KERNELS}
    inst.detect_features(img, 0)
    feats = inst.download_features(0)
    for k in DETECT_KERNELS:
        check(WRAPPERS[k].launches > before[k],
              f"kernel {k} was not launched at 15 scales per octave")
    check(len(feats) > 0 and inst.get_lost_features_number(0) == 0,
          "15 scales per octave: no features, or features lost")
    with cuda_lib.force_plain():
        out_p = make_detect_fn(cfg, w, h, device="cuda")(img)
        plain = vt.features_to_numpy(out_p.features)
    cmp = compare_with_plain(feats, plain)
    print("15 scales per octave, 640x480: " + json.dumps(cmp), flush=True)
    return cmp


def shifted(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """``img`` moved ``dx`` px right and ``dy`` px down, edge-padded and
    cropped to its size: a feature at (x, y) moves to (x + dx, y + dy)."""
    h, w = img.shape
    return np.ascontiguousarray(
        np.pad(img, ((dy, 0), (dx, 0)), mode="edge")[:h, :w])


def run_match(img: np.ndarray, parent) -> dict:
    """The match path at the headline configuration, as
    ``examples/sift_match.py`` drives it."""
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    inst = vt.SiftInstance(cfg, device="cuda")
    img_b = shifted(img, *SHIFT)
    for w in WRAPPERS.values():
        w.launches = 0
    inst.detect_features(img, 0)
    inst.detect_features(img_b, 1)
    inst.match_features(0, 1)
    n_match = inst.get_matches_number()
    m_ab = inst.download_matches()
    inst.match_features(1, 0)
    m_ba = inst.download_matches()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    print("match path kernels "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the match path")

    n_a, n_b = inst.get_features_number(0), inst.get_features_number(1)
    check(n_a > 0 and n_b > 0, "no features detected")
    check(n_match == n_a and len(m_ab) == n_a and len(m_ba) == n_b,
          f"match counts {n_match}/{len(m_ab)}/{len(m_ba)} vs features "
          f"{n_a}/{n_b}")
    for name in ("idx_b1", "idx_b2"):
        check(bool((m_ab[name] < n_b).all()), f"{name} past buffer 1's count")
    check(bool(np.isfinite(m_ab["dist_a_b1"]).all()), "non-finite d1")
    fa, fb = inst.download_features(0), inst.download_features(1)
    lowe = m_ab["dist_a_b1"] < 0.75 * m_ab["dist_a_b2"]
    cross = m_ba["idx_b1"][m_ab["idx_b1"]] == m_ab["idx_a"]
    keep = lowe & cross
    j = m_ab["idx_b1"]
    err = np.hypot(fb["x"][j] - fa["x"] - SHIFT[0],
                   fb["y"][j] - fa["y"] - SHIFT[1])
    n_keep = int(keep.sum())
    share = float((err[keep] <= 1.5).mean()) if n_keep else 0.0
    print(f"translation check: {n_keep} Lowe-0.75 cross-checked matches "
          f"of {n_a}, {share:.6f} within 1.5 px of {SHIFT}", flush=True)
    check(share >= 0.9, f"translation share {share} < 0.9")

    with cuda_lib.force_plain():
        inst.match_features(0, 1)
        plain = inst.download_matches()
    check(plain.tobytes() == m_ab.tobytes(),
          "download_matches bytes differ from the plain matcher's")

    # The kernel alone on the frame's buffers: live counts (n_a, n_b) read
    # on the device, launched at the capacity.
    fa_t, fb_t = inst._buffers[0].features, inst._buffers[1].features
    def kernel():
        return match_mod.match_2nn_tiles(fa_t.descriptor, fa_t.count,
                                         fb_t.descriptor, fb_t.count)

    parent_ms = None
    if parent is None:
        kernel_ms = device_ms(kernel)
    else:
        kernel_ms, parent_ms = ab_ms(kernel, lambda: parent.match(
            fa_t.descriptor, fa_t.count, fb_t.descriptor, fb_t.count))
    k_bound_ms, k_bound_by, k_dp4a_ms = match_bounds(n_a, n_b, CAPACITY)

    def timed(download: bool) -> list:
        out = []
        for i in range(TIMED_FRAMES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inst.match_features(0, 1)
            inst.get_matches_number()
            if download:
                inst.download_matches()
            torch.cuda.synchronize()
            if i:  # the first is a warm-up
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    t_match, t_dl = timed(False), timed(True)
    res = dict(launches=launches, features=[n_a, n_b], matches=n_match,
               kept=n_keep, translation_share=share,
               kernel_ms_at_counts=kernel_ms,
               parent_kernel_ms_at_counts=parent_ms,
               kernel_bound_ms_at_counts=k_bound_ms,
               kernel_bound_by_at_counts=k_bound_by,
               dp4a_ceiling_ms_at_counts=k_dp4a_ms,
               match_ms_median=statistics.median(t_match),
               match_ms_with_download_median=statistics.median(t_dl),
               match_ms=t_match, match_ms_with_download=t_dl)
    print("match " + json.dumps(res), flush=True)
    return res


def device_rows(prof, per: int) -> list:
    """(name, device ms, calls) of every device operation in a
    torch.profiler run, per one of ``per`` repetitions, largest first."""
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, us / 1e3 / per, evt.count / per))
    rows.sort(key=lambda r: -r[1])
    return rows


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
    rows = device_rows(prof, frames)
    busy = sum(r[1] for r in rows)
    # Kernel names as the profiler gives them: "blur_dog_kernel<13>(...)"
    # with a "void " in front for a template, "frontend_kernel(...)".
    ours = {k: sum(r[1] for r in rows
                   if r[0].removeprefix("void ").startswith(k + "_kernel"))
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


# -- the staged detector, traces, multi-device paths and SfM ------------------

def zero_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {k: w.launches for k, w in WRAPPERS.items()}


def _sorted_rows(arr: np.ndarray) -> np.ndarray:
    return np.asarray(sorted(zip(*[arr[f].tolist() for f in
                                   ("x", "y", "sigma", "orientation")])))


def _lexsorted_desc(arr: np.ndarray) -> np.ndarray:
    return arr["descriptor"][np.lexsort((arr["orientation"], arr["y"],
                                         arr["x"]))]


def staged_gate(cfg, img: np.ndarray, what: str) -> dict:
    """``SiftDetector`` against ``make_detect_fn`` on the card, with the
    gates of tests/test_pipeline_parallel.py:31-52: lost 0 on both, the
    same count, sorted (x, y, sigma, orientation) within 1e-5 and the
    descriptors equal after a lexsort."""
    h, w = img.shape
    det = vt.SiftDetector(cfg, device="cuda")
    staged = vt.features_to_numpy(det.detect(img, w, h)[0])
    out = make_detect_fn(cfg, w, h, device="cuda")(img)
    main = vt.features_to_numpy(out.features)
    check(det.lost == 0 and int(out.lost) == 0,
          f"staged {what}: lost {det.lost} (staged), {int(out.lost)} (main)")
    check(len(staged) == len(main) > 0,
          f"staged {what}: count {len(staged)} vs main {len(main)}")
    row_err = float(np.abs(_sorted_rows(staged) - _sorted_rows(main)).max())
    check(row_err <= 1e-5, f"staged {what}: sorted rows differ by {row_err}")
    check(np.array_equal(_lexsorted_desc(staged), _lexsorted_desc(main)),
          f"staged {what}: descriptors differ after a lexsort")
    return dict(frame=what, count=len(staged), max_row_err=row_err)


def run_staged(img: np.ndarray) -> dict:
    """The staged detector at the headline configuration: wall ms and
    kernel launches per detect, then its gate against the main path there,
    or at 640x480 when its per-octave capacities clamp at 1536x1024."""
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    det = vt.SiftDetector(cfg, device="cuda")
    det.detect(img, W, H)
    runs = 3
    zero_launches()
    wall = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, per = det.detect(img, W, H)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    for k in DETECT_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by SiftDetector")
    res = dict(launches=launches,
               launches_per_detect={k: v / runs for k, v in launches.items()},
               wall_ms=wall, wall_ms_median=statistics.median(wall),
               per_octave=per, lost_1536x1024=det.lost)
    if det.lost == 0:
        res["gate"] = staged_gate(cfg, img, f"{W}x{H}")
    else:
        res["finding"] = (f"per-octave section capacities clamp at {W}x{H}: "
                          f"{det.lost} features lost, kept {per}")
        res["gate"] = staged_gate(cfg, bench_image(480, 640, seed=3),
                                  "640x480")
    print("staged " + json.dumps(res), flush=True)
    return res


TRACE_SYMBOLS = {k: f"{k}_kernel" for k in WRAPPERS}
FOLD_COUNT_B = 16001          # check_match's ragged B count


def run_trace(img: np.ndarray) -> dict:
    """``start_trace`` / ``stop_trace`` around the detects of a frame and
    its translate and one ``match_features``; the Chrome trace must name
    the five kernels."""
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    inst = vt.SiftInstance(cfg, device="cuda")
    img_b = shifted(img, *SHIFT)
    inst.detect_features(img, 0)
    inst.detect_features(img_b, 1)
    inst.match_features(0, 1)
    inst.get_matches_number()
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as d:
        zero_launches()
        inst.start_trace(d)
        inst.detect_features(img, 0)
        inst.detect_features(img_b, 1)
        inst.match_features(0, 1)
        inst.get_matches_number()
        path = inst.stop_trace()
        launches = read_launches()
        text = Path(path).read_text()
    missing = [s for s in TRACE_SYMBOLS.values() if s not in text]
    check(not missing, f"trace lacks the kernels {missing}")
    res = dict(launches=launches, trace_bytes=len(text),
               symbols=sorted(TRACE_SYMBOLS.values()))
    print("trace " + json.dumps(res), flush=True)
    return res


def _equal_matches(m, ref, rows: int) -> bool:
    return all(torch.equal(getattr(m, f)[:rows].view(torch.int32),
                           getattr(ref, f)[:rows].view(torch.int32))
               for f in ("idx_a", "idx_b1", "idx_b2", "dist_a_b1",
                         "dist_a_b2"))


def shard_edge_ties(a: torch.Tensor, b: torch.Tensor, count_b: int,
                    n: int) -> torch.Tensor:
    """``b`` with the ties of :func:`edge_duplicates` and, across every edge
    of ``n`` shards, a copy of one A row on both sides."""
    b, _ = edge_duplicates(a, b, count_b)
    nb_l = -(-b.shape[0] // n)
    for s in range(1, n):
        if s * nb_l < count_b:
            b[s * nb_l - 1] = b[s * nb_l] = a[10 + s]
    return b


def rank_ms(fn, reps: int = PLAIN_REPS) -> float:
    """Median wall ms of ``fn`` on every rank of the process group, each
    repetition started together after a barrier and ended by a sync."""
    import torch.distributed as dist
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def multi_device_checks(mesh, dev: torch.device) -> dict:
    """This rank's share of the multi-device paths over ``mesh`` (every one
    of its n ranks calls it), each against the single-device result on this
    rank's card: dp detect of 2 frames a rank at 1536x1024 against single
    detects, bit for bit; the ring at 16384x16384 and at count_b 16001 with
    ties on the kernel's and the shards' edges against ``match_2nn_fused``
    on this rank's rows, bit for bit, with n matcher launches a rank;
    ``make_distributed_ba`` against ``bundle_adjust`` (the JAX test's
    bars); then the dp scaling points at 1, 2, 4, 8 ranks up to n."""
    from vulkansift_tpu_torch import parallel, sfm
    n, rank = mesh.size(), mesh.get_local_rank()
    res = dict(rank=rank, device=str(dev))
    cfg = vt.SiftConfig(use_input_upsampling=True,
                        max_nb_sift_per_buffer=CAPACITY)
    img = bench_image(H, W, seed=0)
    frames = np.stack([shifted(img, i, i) for i in range(2 * n)])
    dp = parallel.make_dp_detect_fn(cfg, W, H, mesh, device=dev)
    zero_launches()
    out = dp(parallel.shard_batch(frames, mesh, device=dev))
    res["dp_launches"] = read_launches()
    single = make_detect_fn(cfg, W, H, device=dev)
    for i in range(2):
        ref = single(frames[2 * rank + i])
        got = vt.Features(**{f.name: getattr(out.features, f.name)[i]
                             for f in dataclasses.fields(vt.Features)})
        check(vt.features_to_numpy(got).tobytes()
              == vt.features_to_numpy(ref.features).tobytes()
              and int(out.lost[i]) == int(ref.lost)
              and torch.equal(out.per_octave_counts[i],
                              ref.per_octave_counts),
              f"dp detect: rank {rank} frame {i} differs from a single "
              f"detect")
    res["dp_counts"] = [int(c) for c in out.features.count]
    print(f"rank {rank}/{n}: dp detect of 2 frames at {W}x{H} bit-equal to "
          f"single detects, counts {res['dp_counts']}", flush=True)

    m_n = MATCH_N
    a, b = _rand_desc(0, m_n), _rand_desc(1, m_n)     # on this rank's card
    ring = parallel.make_ring_match_fn(mesh, device=dev)
    na_l = -(-m_n // n)
    rows = slice(rank * na_l, min((rank + 1) * na_l, m_n))
    for what, bb, cb in (("full", b, m_n),
                         ("ragged", shard_edge_ties(a, b, FOLD_COUNT_B, n),
                          FOLD_COUNT_B)):
        zero_launches()
        m = ring(a, m_n, bb, cb)
        launches = read_launches()
        check(launches["match_2nn"] == n,
              f"ring {what}: {launches['match_2nn']} launches, expected {n}")
        ref = match_mod.match_2nn_fused(a, m_n, bb, cb)
        check(all(torch.equal(getattr(m, f)[:rows.stop - rows.start]
                              .view(torch.int32),
                              getattr(ref, f)[rows].view(torch.int32))
                  for f in ("idx_a", "idx_b1", "idx_b2", "dist_a_b1",
                            "dist_a_b2")),
              f"ring {what}: rank {rank}'s rows differ from match_2nn_fused")
        res[f"ring_{what}_launches"] = launches
    res["ring_ms"] = rank_ms(lambda: ring(a, m_n, b, m_n))
    res["single_match_ms"] = rank_ms(
        lambda: match_mod.match_2nn_fused(a, m_n, b, m_n))
    print(f"rank {rank}/{n}: ring {m_n}x{m_n} (full and count_b "
          f"{FOLD_COUNT_B}) bit-equal to match_2nn_fused; "
          f"{res['ring_ms']:.4f} ms vs {res['single_match_ms']:.4f} ms",
          flush=True)

    poses, pts, cam_idx, pt_idx, uv = sfm_scene(np.random.default_rng(7))
    problem = sfm_ba_problem(np.random.default_rng(8), poses, pts, cam_idx,
                             pt_idx, uv, dev, multiple=n)
    dist_ba = sfm.make_distributed_ba(mesh, nb_iters=10, nb_cg_iters=20,
                                      device=dev)
    r_d = dist_ba(problem)
    r_s = sfm.bundle_adjust(problem, nb_iters=10, nb_cg_iters=20)
    err = float((r_d.poses - r_s.poses).abs().max())
    check(float(r_d.final_cost) < 0.05 * float(r_d.initial_cost),
          "distributed BA did not converge")
    check(err <= 1e-3 and abs(float(r_d.final_cost) - float(r_s.final_cost))
          <= 1e-2 * float(r_s.final_cost),
          f"distributed BA on {n} ranks vs bundle_adjust: poses {err}, costs "
          f"{float(r_d.final_cost)} / {float(r_s.final_cost)}")
    res.update(ba_pose_err=err, ba_final_cost=float(r_d.final_cost),
               single_ba_final_cost=float(r_s.final_cost),
               ba_observations=len(uv),
               distributed_ba_ms=rank_ms(lambda: dist_ba(problem), 3),
               single_ba_ms=rank_ms(lambda: sfm.bundle_adjust(
                   problem, nb_iters=10, nb_cg_iters=20), 3))
    print(f"rank {rank}/{n}: distributed BA agrees with bundle_adjust "
          f"(poses {err:.3g})", flush=True)

    zero_launches()
    res["scaling"] = parallel.measure_dp_scaling(
        cfg, W, H, per_device_batch=2,
        device_counts=[k for k in (1, 2, 4, 8) if k <= n], iters=3,
        device=dev)
    res["scaling_launches"] = read_launches()
    return res


def run_multi_device(mesh) -> dict:
    """World size 1 (one card): :func:`multi_device_checks`, then the
    one-card n-shard folds (n = 4 and 3, count_b 16001, ties on the
    kernel's and the shards' edges) against ``match_2nn_fused``, bit for
    bit. A run across cards is ``--cards N``."""
    from vulkansift_tpu_torch.parallel import ring_match as rm
    res = multi_device_checks(mesh, torch.device("cuda",
                                                 torch.cuda.current_device()))
    n, cb = MATCH_N, FOLD_COUNT_B
    a, b = _rand_desc(0, n), _rand_desc(1, n)
    res["fold_launches"] = {}
    for shards in (4, 3):
        b2 = shard_edge_ties(a, b, cb, shards)
        ref = match_mod.match_2nn_fused(a, n, b2, cb)
        ap, bp = rm.pad_rows(a, shards), rm.pad_rows(b2, shards)
        na_l, nb_l = ap.shape[0] // shards, bp.shape[0] // shards
        zero_launches()
        parts = []
        for r in range(shards):
            visit = [(bp[s * nb_l:(s + 1) * nb_l], s * nb_l)
                     for s in ((r - i) % shards for i in range(shards))]
            parts.append(rm.finish(rm.fold_shards(
                ap[r * na_l:(r + 1) * na_l], visit, cb), r * na_l, n))
        launches = read_launches()
        check(launches["match_2nn"] == shards * shards,
              f"{shards}-shard fold: {shards} launches a rank expected")
        res["fold_launches"][shards] = launches
        got = vt.Matches2NN(**{f: torch.cat([getattr(p, f) for p in parts])
                               for f in ("idx_a", "idx_b1", "idx_b2",
                                         "dist_a_b1", "dist_a_b2")},
                            count=ref.count)
        check(_equal_matches(got, ref, n),
              f"{shards}-shard fold differs from match_2nn_fused")
        print(f"{shards}-shard fold at count_b {cb} bit-equal to "
              f"match_2nn_fused", flush=True)
    print(f"scaling point: 1 device, {W}x{H}, 2 frames a device: "
          f"{res['scaling']['points'][0]['fps']:.3f} fps; across cards: "
          f"unmeasured here (chip_smoke.py --cards N)", flush=True)
    print("multi_device " + json.dumps(res), flush=True)
    return res


# The SfM scene: 8 cameras on an arc around 4096 points, ~0.3 px noise
# (tests/test_sfm.py's _synthetic_scene at this size), about a 640x480
# detect's feature count a frame.
SFM_CAMS, SFM_POINTS, SFM_NOISE = 8, 4096, 0.3
SFM_CAMERA = (500.0, 500.0, 320.0, 240.0)


def sfm_scene(rng: np.random.Generator):
    """(poses (C, 6), points, cam_idx, pt_idx, uv) of the visible
    observations of ``SFM_POINTS`` points, as tests/test_sfm.py's
    ``_synthetic_scene`` draws them."""
    from vulkansift_tpu_torch.sfm import SE3, Camera
    cam = Camera(*SFM_CAMERA)
    pts = rng.uniform(-2, 2, (SFM_POINTS, 3))
    pts[:, 2] += 8.0
    poses = np.asarray([[0.0, 0.08 * (i - SFM_CAMS / 2), 0.0,
                         0.6 * i - 0.3 * SFM_CAMS, 0.05 * i, 0.0]
                        for i in range(SFM_CAMS)], np.float32)
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(SFM_CAMS):
        se3 = SE3.from_tangent(torch.from_numpy(poses[c]))
        uv = cam.project(se3.apply(torch.from_numpy(
            pts.astype(np.float32)))).numpy()
        idx = np.nonzero((uv[:, 0] > 10) & (uv[:, 0] < 630)
                         & (uv[:, 1] > 10) & (uv[:, 1] < 470))[0]
        cam_idx.append(np.full(len(idx), c))
        pt_idx.append(idx)
        uvs.append(uv[idx] + SFM_NOISE * rng.standard_normal((len(idx), 2)))
    return (poses, pts.astype(np.float32),
            np.concatenate(cam_idx).astype(np.int32),
            np.concatenate(pt_idx).astype(np.int32),
            np.concatenate(uvs).astype(np.float32))


def sfm_features(rng, cam_idx, pt_idx, uv) -> list:
    """Per-frame features with track-consistent u8 descriptors (+-2
    jitter), as the JAX end-to-end test makes them."""
    descs = rng.integers(0, 256, (SFM_POINTS, 128), dtype=np.uint8)
    feats = []
    for c in range(SFM_CAMS):
        sel = cam_idx == c
        f = np.zeros(int(sel.sum()), vt.FEATURE_DTYPE)
        f["x"], f["y"] = uv[sel, 0], uv[sel, 1]
        jit = rng.integers(-2, 3, (len(f), 128))
        f["descriptor"] = np.clip(descs[pt_idx[sel]].astype(int) + jit, 0,
                                  255)
        feats.append(f)
    return feats


def rotation_errors_deg(est: np.ndarray, truth: np.ndarray) -> list:
    """Angles between estimated and true relative rotations of consecutive
    cameras."""
    from vulkansift_tpu_torch.sfm import SE3
    r_e = SE3.from_tangent(torch.from_numpy(est)).r.numpy()
    r_t = SE3.from_tangent(torch.from_numpy(truth)).r.numpy()
    out = []
    for i in range(len(est) - 1):
        d = (r_e[i + 1] @ r_e[i].T).T @ (r_t[i + 1] @ r_t[i].T)
        out.append(float(np.degrees(np.arccos(np.clip(
            (np.trace(d) - 1) / 2, -1, 1)))))
    return out


def sfm_ba_problem(rng, poses, pts, cam_idx, pt_idx, uv, dev,
                   multiple: int = 1):
    """tests/test_sfm.py's ``_perturbed_problem`` on this scene: poses
    perturbed by 0.02 (the first kept), points by 0.1; the observations
    padded with invalid ones to a multiple of ``multiple``."""
    from vulkansift_tpu_torch.sfm import BAProblem, Camera
    p0 = poses + 0.02 * rng.standard_normal(poses.shape).astype(np.float32)
    p0[0] = poses[0]
    x0 = pts + 0.1 * rng.standard_normal(pts.shape).astype(np.float32)
    pad = (-len(uv)) % multiple

    def t(x):
        x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return BAProblem(poses=torch.from_numpy(p0).to(dev),
                     points=torch.from_numpy(x0).to(dev), cam_idx=t(cam_idx),
                     pt_idx=t(pt_idx), uv=t(uv),
                     valid=t(np.ones(len(uv), bool)),
                     camera=Camera(*SFM_CAMERA))


def run_sfm() -> dict:
    """``reconstruct_sequence`` on the card (final cost < 1 px^2, ATE <
    0.05, relative rotations < 1 degree) and, each of its three card runs,
    against its CPU run with the same seed (poses within 1e-3); times of
    the reconstruction, of RANSAC a pair, of the 8-point SVDs and of one BA
    iteration."""
    from vulkansift_tpu_torch import sfm
    rng = np.random.default_rng(7)
    poses, pts, cam_idx, pt_idx, uv = sfm_scene(rng)
    feats = sfm_features(rng, cam_idx, pt_idx, uv)
    cam = sfm.Camera(*SFM_CAMERA)
    kw = dict(ratio=0.8, ransac_iters=256, ba_iters=30, seed=0)
    card_poses = [sfm.reconstruct_sequence(feats, cam, device="cuda",
                                           **kw).poses]  # warm-up
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = sfm.reconstruct_sequence(feats, cam, device="cuda", **kw)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    check(launches["match_2nn"] == SFM_CAMS - 1,
          f"SfM: {launches['match_2nn']} matcher launches, expected "
          f"{SFM_CAMS - 1}")
    ate = sfm.absolute_trajectory_error(rec.poses, poses)
    rot = rotation_errors_deg(rec.poses, poses)
    check(rec.final_cost < 1.0, f"SfM final cost {rec.final_cost}")
    check(ate < 0.05, f"SfM ATE {ate}")
    check(max(rot) < 1.0, f"SfM relative rotation errors {rot} deg")
    # Where the reconstruction's time goes on the card.
    from torch.profiler import ProfilerActivity, profile
    card_poses.append(rec.poses)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card_poses.append(sfm.reconstruct_sequence(feats, cam, device="cuda",
                                                   **kw).poses)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, 1)
    busy = sum(r[1] for r in rows)
    breakdown = dict(wall_ms=prof_ms, device_busy_ms=busy,
                     device_idle_share=1.0 - busy / prof_ms,
                     device_ops=sum(r[2] for r in rows),
                     top=[dict(name=r[0][:60], ms=r[1], calls=r[2])
                          for r in rows[:10]])
    print("sfm_profile " + json.dumps(breakdown), flush=True)
    t0 = time.perf_counter()
    rec_cpu = sfm.reconstruct_sequence(feats, cam, device="cpu", **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    pose_errs = [float(np.abs(p - rec_cpu.poses).max()) for p in card_poses]
    pose_err = max(pose_errs)
    check(pose_err <= 1e-3, f"SfM card vs CPU poses differ by {pose_errs}")

    # RANSAC of one pair (cameras 0 and 1, their common points) and the
    # batched 8-point SVDs alone.
    common = np.intersect1d(pt_idx[cam_idx == 0], pt_idx[cam_idx == 1])

    def rays(c):
        sel = cam_idx == c
        order = np.searchsorted(pt_idx[sel], common)
        return cam.unproject(torch.from_numpy(uv[sel][order]).cuda())

    r1, r2 = rays(0), rays(1)
    valid = torch.ones(len(common), dtype=torch.bool, device="cuda")
    gen = torch.Generator().manual_seed(0)
    ransac_ms = median_ms(lambda: sfm.ransac_essential(
        r1, r2, valid, gen, threshold=2e-5, nb_iters=256)[2].item(),
        PLAIN_REPS)
    idx = torch.randint(0, len(common), (256, 8), generator=gen).cuda()
    svd_ms = median_ms(lambda: sfm.essential_8pt(r1[idx], r2[idx]),
                       PLAIN_REPS)

    problem = sfm_ba_problem(np.random.default_rng(8), poses, pts, cam_idx,
                             pt_idx, uv, "cuda")

    def ba(iters):
        return float(sfm.bundle_adjust(problem, nb_iters=iters,
                                       nb_cg_iters=20).final_cost)

    ba_iter_ms = (median_ms(lambda: ba(11), 3) - median_ms(lambda: ba(1), 3)) \
        / 10
    res = dict(launches=launches, frames=SFM_CAMS,
               features=[len(f) for f in feats], observations=len(uv),
               final_cost=rec.final_cost, initial_cost=rec.initial_cost,
               ate=ate, rotation_err_deg=rot, card_vs_cpu_pose_err=pose_err,
               card_vs_cpu_pose_errs=pose_errs,
               reconstruction_ms=wall_ms, cpu_reconstruction_ms=cpu_ms,
               ransac_pair_ms=ransac_ms, ransac_pair_points=len(common),
               svd_8pt_256_ms=svd_ms, ba_iteration_ms=ba_iter_ms,
               ba_observations=len(uv), profile=breakdown)
    print("sfm " + json.dumps(res), flush=True)
    return res


def run_later_paths(img: np.ndarray) -> dict:
    """The staged detector, the trace, the multi-device paths (one process
    group of world size 1, NCCL over a file:// store), then SfM."""
    import torch.distributed as dist
    from vulkansift_tpu_torch import parallel
    res = dict(staged=run_staged(img), trace=run_trace(img))
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as d:
        parallel.init_distributed(f"file://{d}/store", 1, 0, device="cuda")
        try:
            mesh = parallel.make_mesh(1)
            res["multi_device"] = run_multi_device(mesh)
        finally:
            dist.destroy_process_group()
    res["sfm"] = run_sfm()
    return res


# -- the perf harness, native IO and the examples ---------------------------

RUNTIME_SIZES = ((640, 480), (1536, 1024), (3456, 2304))   # the JAX bench's
RUNTIME_WARMUP, RUNTIME_ITERS = 3, 10
DETECT_SYMBOLS = tuple(TRACE_SYMBOLS[k] for k in DETECT_KERNELS)


def run_runtime(card: str, slice_count: int) -> dict:
    """``perf.harness.run_runtime_benchmark`` (upload + detect + download)
    with ``VulkanSiftTpuTorchDetector`` at the JAX bench's three frame
    sizes, result files under ``build/perf``; the 1536x1024 frame must give
    the slice phase's count."""
    from vulkansift_tpu_torch.perf import harness
    out_dir = cuda_lib.BUILD_DIR / "perf"
    out_dir.mkdir(parents=True, exist_ok=True)
    det = harness.VulkanSiftTpuTorchDetector(device="cuda")
    det.init()
    sizes, launches = {}, {}
    for w, h in RUNTIME_SIZES:
        img = bench_image(h, w, seed=0)
        zero_launches()
        mean_ms, nb = harness.run_runtime_benchmark(
            img, det, warmup=RUNTIME_WARMUP, iters=RUNTIME_ITERS,
            out_dir=str(out_dir))
        launches[f"runtime_{w}x{h}"] = read_launches()
        for k in DETECT_KERNELS:
            check(launches[f"runtime_{w}x{h}"][k] > 0,
                  f"kernel {k} was not launched by the runtime protocol")
        check(nb > 0, f"runtime {w}x{h}: no features")
        sizes[f"{w}x{h}"] = dict(mean_ms=mean_ms, features=nb)
        print(f"runtime {w}x{h}: {mean_ms:.4f} ms mean of {RUNTIME_ITERS} "
              f"(after {RUNTIME_WARMUP} warm-ups), {nb} features; {card}",
              flush=True)
    written = (out_dir / "runtime_results_vulkansift_tpu_torch.txt"
               ).read_text().strip()
    check(written.endswith(f";{nb}"), f"runtime result file reads {written}")
    det.terminate()
    check(sizes[f"{W}x{H}"]["features"] == slice_count,
          f"runtime {W}x{H}: {sizes[f'{W}x{H}']['features']} features vs "
          f"{slice_count} in the slice phase")
    return dict(sizes=sizes, launches=launches)


def run_metrics(img: np.ndarray) -> dict:
    """``perf.harness.compute_metrics`` on the frame and its 7x5 px
    translate with H the translation: precision >= 0.9, one matcher
    launch, and its Lowe matches equal to the plain matcher's on the CPU."""
    from vulkansift_tpu_torch.perf import harness
    det = harness.VulkanSiftTpuTorchDetector(device="cuda")
    det.init()
    img_b = shifted(img, *SHIFT)
    r1, r2 = det.detect(img), det.detect(img_b)
    det.terminate()
    hmat = np.array([[1.0, 0.0, SHIFT[0]], [0.0, 1.0, SHIFT[1]],
                     [0.0, 0.0, 1.0]])
    zero_launches()
    rep, pmr, prec, score = harness.compute_metrics(img, img_b, hmat, r1, r2,
                                                    device="cuda")
    launches = read_launches()
    check(launches == {k: int(k == "match_2nn") for k in WRAPPERS},
          f"compute_metrics launched {launches}")
    check(prec >= 0.9, f"compute_metrics precision {prec} < 0.9")
    m_card = harness.lowe_matches(r1.descriptors, r2.descriptors,
                                  device="cuda")
    m_cpu = harness.lowe_matches(r1.descriptors, r2.descriptors,
                                 device="cpu")
    check(np.array_equal(m_card, m_cpu),
          "lowe_matches on the card differ from the CPU's")
    res = dict(launches=launches, features=[len(r1.xy), len(r2.xy)],
               lowe_matches=len(m_card), repeatability=rep,
               putative_match_ratio=pmr, precision=prec, matching_score=score)
    print("metrics " + json.dumps(res), flush=True)
    return res


def run_native_io(img: np.ndarray, feats: np.ndarray) -> dict:
    """``utils.native_io`` built from ``native/vksift_io.cpp`` into
    ``build/``: a PGM of the frame decodes to its bytes through the native
    and the Python paths, and a feature file round-trips the frame's
    features."""
    from vulkansift_tpu_torch.utils import native_io
    t0 = time.perf_counter()
    native_io.build()
    build_s = time.perf_counter() - t0
    check(native_io.available(), "native IO library not available")
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as d:
        pgm = Path(d, "frame.pgm")
        pgm.write_bytes(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0])
                        + img.tobytes())
        native = native_io.read_image_gray(str(pgm))
        python = native_io._read_pnm_python(str(pgm))
        check(native.tobytes() == python.tobytes() == img.tobytes(),
              "native and Python PGM decodes differ from the frame")
        vft = str(Path(d, "frame.vft"))
        native_io.save_features(vft, feats)
        back = native_io.load_features(vft)
        check(back.tobytes() == feats.tobytes(),
              "feature file does not round-trip the frame's features")
    res = dict(build_seconds=build_s, library=native_io.lib_path().name,
               pgm_bytes=img.size, features=len(feats))
    print("native_io " + json.dumps(res), flush=True)
    return res


def run_examples(img: np.ndarray) -> dict:
    """Each example's compute function once on the card, on ``img`` (and
    its 7x5 px translate for ``sift_match``), launches counted per
    example."""
    from vulkansift_tpu_torch.examples import (sift_detect,
                                               sift_error_handling,
                                               sift_match, sift_profile,
                                               sift_show_pyramid)
    h, w = img.shape
    res, launches = {}, {}

    zero_launches()
    feats = sift_detect.detect(img, "cuda")
    launches["example_sift_detect"] = read_launches()
    inst = vt.SiftInstance(vt.SiftConfig(max_nb_sift_per_buffer=16384,
                                         input_image_max_size=4096 * 4096),
                           device="cuda")
    inst.detect_features(img, 0)
    n_inst = inst.get_features_number(0)
    del inst
    check(len(feats) == n_inst > 0,
          f"sift_detect: {len(feats)} features vs detect_features {n_inst}")
    res["sift_detect"] = dict(features=len(feats))

    zero_launches()
    m = sift_match.match(img, shifted(img, *SHIFT), "cuda")
    launches["example_sift_match"] = read_launches()
    f1, f2, ia, ib = m["f1"], m["f2"], m["ia"], m["ib"]
    err = np.hypot(f2["x"][ib] - f1["x"][ia] - SHIFT[0],
                   f2["y"][ib] - f1["y"][ia] - SHIFT[1])
    share = float((err <= 1.5).mean()) if len(ia) else 0.0
    check(len(ia) > 0 and share >= 0.9,
          f"sift_match: {len(ia)} matches, {share} within 1.5 px of {SHIFT}")
    res["sift_match"] = dict(features=[len(f1), len(f2)], matches=len(ia),
                             translation_share=share)

    zero_launches()
    e = sift_error_handling.run(img, "cuda")
    launches["example_sift_error_handling"] = read_launches()
    check(len(e["caught"]) == 4 and None not in e["caught"]
          and e["callbacks"] == ["INVALID_INPUT_ERROR"] * 4
          and e["features"] > 0, f"sift_error_handling: {e}")
    res["sift_error_handling"] = dict(callbacks=len(e["callbacks"]),
                                      features=e["features"])

    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as d:
        zero_launches()
        p = sift_profile.profile(img, "cuda", iters=2, trace_dir=d)
        launches["example_sift_profile"] = read_launches()
        text = Path(p["trace"]).read_text()
    missing = [k for k in DETECT_SYMBOLS if k not in text]
    check(not missing, f"sift_profile's trace lacks the kernels {missing}")
    check(all(r[2] == len(feats) for r in p["iters"]),
          f"sift_profile counts {p['iters']} vs {len(feats)}")
    res["sift_profile"] = dict(iters=p["iters"], symbols=list(DETECT_SYMBOLS))

    zero_launches()
    pyr = sift_show_pyramid.pyramid(img, "cuda")
    launches["example_sift_show_pyramid"] = read_launches()
    plan = vt.octave_plan(vt.SiftConfig(), w, h)
    check(pyr["octaves"] == list(plan),
          f"sift_show_pyramid: octaves {pyr['octaves']} vs {plan}")
    check(all(g.shape == (oh, ow) and bool(np.isfinite(g).all())
              for (ow, oh), gs, ds in zip(plan, pyr["gaussians"], pyr["dogs"])
              for g in gs + ds), "sift_show_pyramid: level shapes")
    res["sift_show_pyramid"] = dict(octaves=len(pyr["octaves"]))
    for name, v in launches.items():
        for k in DETECT_KERNELS:
            check(v[k] > 0, f"{name} did not launch {k}")
    check(launches["example_sift_match"]["match_2nn"] == 2,
          "sift_match did not launch match_2nn twice")
    print("examples " + json.dumps(res), flush=True)
    return dict(results=res, launches=launches, features=feats)


def run_perf_paths(img: np.ndarray, card: str, slice_count: int) -> dict:
    """The runtime protocol, the matching metrics, the examples and native
    IO (none of them needs cv2, matplotlib or sklearn)."""
    res = dict(runtime=run_runtime(card, slice_count),
               metrics=run_metrics(img))
    ex = run_examples(bench_image(480, 640, seed=5))
    res["examples"] = ex
    res["native_io"] = run_native_io(img, ex["features"])
    return res


# -- across cards (--cards N) --------------------------------------------------

def cards_rank(rank: int, n: int, work: str) -> None:
    """Entry of one spawned rank: join the NCCL group, run
    :func:`multi_device_checks` over all ``n`` ranks, and rank 0 writes
    every rank's result to ``work``/cards.json."""
    import torch.distributed as dist
    from vulkansift_tpu_torch import parallel
    parallel.init_distributed(f"file://{work}/store", n, rank, device="cuda")
    try:
        res = multi_device_checks(parallel.make_mesh(n), torch.device(
            "cuda", torch.cuda.current_device()))
        every = [None] * n
        dist.all_gather_object(every, res)
        if rank == 0:
            Path(work, "cards.json").write_text(json.dumps(every))
    finally:
        dist.destroy_process_group()


def run_cards(n: int) -> list:
    """The multi-device paths across ``n`` cards, one spawned process
    each; every rank's failure fails the run."""
    from vulkansift_tpu_torch.parallel.mesh import spawn_ranks
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as work:
        spawn_ranks(cards_rank, n, (n, work))
        every = json.loads(Path(work, "cards.json").read_text())
    for r in every:
        print("cards_rank " + json.dumps(r), flush=True)
    pts = every[0]["scaling"]["points"]
    print("cards_summary " + json.dumps(dict(
        ranks=n, ring_ms=[r["ring_ms"] for r in every],
        single_match_ms=[r["single_match_ms"] for r in every],
        distributed_ba_ms=[r["distributed_ba_ms"] for r in every],
        single_ba_ms=[r["single_ba_ms"] for r in every],
        scaling=pts, cards=every[0]["scaling"]["cards"])), flush=True)
    return every


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the blur, frontend, orientation-"
                         "histogram, descriptor and matcher kernels of the "
                         "checkout at DIR, in turns with these")
    ap.add_argument("--cards", type=int, metavar="N",
                    help="instead: check the multi-device paths across N "
                         "cards (one NCCL process each) against single-"
                         "device results and time them")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_info()[0]
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} nvcc "
          f"{nvcc.strip().splitlines()[-1]}", flush=True)
    if args.cards:
        check(torch.cuda.device_count() >= args.cards,
              f"--cards {args.cards}: {torch.cuda.device_count()} cards")
        cuda_lib.build()
        run_cards(args.cards)
        print(f"total_seconds {time.perf_counter() - t_start:.1f}",
              flush=True)
        for line in card_info():
            print(line, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
    sync_inst = vt.SiftInstance(cfg, device="cuda")
    sync_inst.detect_features(img, 0)
    sync_inst.detect_features(img, 1)
    sync_inst.match_features(0, 1)
    torch.cuda.synchronize()
    # No host synchronisation between the stages of one detect, nor in a
    # match_features: PyTorch raises on any synchronising call inside this
    # block.
    torch.cuda.set_sync_debug_mode("error")
    try:
        detect(img)
        sync_inst.match_features(0, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(sync_inst.get_matches_number()
          == sync_inst.get_features_number(0), "sync-check match count")
    del sync_inst
    print("sync check: one detect and one match_features ran with no host "
          "synchronisation", flush=True)
    cap = {}
    out, gaussians, dogs = detect(img, capture=cap)
    torch.cuda.synchronize()
    print(f"capture run: count={int(out.features.count)} "
          f"lost={int(out.lost)}", flush=True)
    x = torch.from_numpy(img).cuda().to(torch.float32) * (1.0 / 255.0)
    cap.update(config=cfg, gaussians=gaussians, dogs=dogs,
               dog_threshold=cfg.dog_threshold,
               seed=upsample2x_linear(x).contiguous())

    parent = Parent(args.parent) if args.parent else None
    rows = {
        "blur_dog": check_blur(cap, parent),
        "frontend": check_frontend(cap, parent),
        "orientation_hist": check_orientation_hist(cap, parent),
        "descriptor": check_descriptor(cap, parent),
    }
    del cap
    torch.cuda.empty_cache()
    rows["match_2nn"] = check_match(parent)
    torch.cuda.empty_cache()
    check_many_scales()
    torch.cuda.empty_cache()
    res = run_slice(img)
    res_match = run_match(img, parent)
    profile_frames(img)
    later = run_later_paths(img)
    perf = run_perf_paths(img, card, res["count"])

    # Launches of every path's driven run, each counted from 0.
    md = later["multi_device"]
    paths = {"detect": res["launches"], "match": res_match["launches"],
             "staged": later["staged"]["launches"],
             "trace": later["trace"]["launches"],
             "dp_detect": md["dp_launches"],
             "ring": md["ring_full_launches"],
             "ring_ragged": md["ring_ragged_launches"],
             **{f"fold_{n}": v for n, v in md["fold_launches"].items()},
             "scaling": md["scaling_launches"],
             "sfm": later["sfm"]["launches"],
             **perf["runtime"]["launches"],
             "metrics": perf["metrics"]["launches"],
             **perf["examples"]["launches"]}
    print("launches_by_path " + json.dumps(paths), flush=True)
    kernels = []
    for name, r in rows.items():
        kernels.append(dict(
            name=name, route="cuda",
            source=f"vulkansift_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name],
            launches=sum(p.get(name, 0) for p in paths.values()),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    frame = {name: dict(launches=r["frame_launches"], ms=r["frame_ms"],
                        bound_ms=r["frame_bound_ms"])
             for name, r in rows.items() if name != "match_2nn"}
    frame["match_2nn"] = dict(
        launches=res_match["launches"]["match_2nn"],
        ms=res_match["launches"]["match_2nn"]
        * res_match["kernel_ms_at_counts"],
        bound_ms=res_match["launches"]["match_2nn"]
        * res_match["kernel_bound_ms_at_counts"])
    print("per_frame " + json.dumps(frame), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total_seconds {time.perf_counter() - t_start:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
