"""Data-parallel scaling of batched detect over 1, 2, 4, ... ranks.

Port of ``vulkansift_tpu/parallel/scaling.py``. For each mesh size n it
times ``iters`` data-parallel detects of ``per_device_batch * n`` frames
on ranks ``0 .. n - 1`` of the running process group (the others wait)
and reports frames/s and two efficiency views:

* ``efficiency`` = fps(n) / (n * fps(1)), the wall-clock scaling;
* ``work_efficiency`` = fps(n) / fps(1).

A step's time is the slowest member rank's, from a barrier to its last
frame's feature count on the host. The result names the device type, the
world size and, on CUDA, each card's name and power limit as
``nvidia-smi`` gives them.

CLI, one process per card::

    torchrun --nproc_per_node=4 -m vulkansift_tpu_torch.parallel.scaling
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import SiftConfig
from ..utils.device import DeviceLike, resolve_device
from .dp import make_dp_detect_fn, shard_batch
from .mesh import init_distributed, make_mesh


def card_info() -> List[str]:
    """``name, power.limit`` of every card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def measure_dp_scaling(config: SiftConfig, width: int, height: int, *,
                       per_device_batch: int = 2,
                       device_counts: Optional[List[int]] = None,
                       iters: int = 5, seed: int = 0,
                       device: DeviceLike = "cuda") -> Dict:
    """Throughput of data-parallel batched detect at several mesh sizes
    (every rank of the process group calls it).

    Returns ``{"points": [{"devices", "fps", "ms_per_frame",
    "efficiency", "work_efficiency"}], ...}``; the frames are random
    images drawn from ``seed``, the same on every rank."""
    if not dist.is_initialized():
        raise RuntimeError("measure_dp_scaling needs a process group; call "
                           "init_distributed first")
    dev = resolve_device(device, config.device_index)
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    rng = np.random.default_rng(seed)
    points = []
    fps1 = None
    for n in device_counts:
        mesh = make_mesh(n)
        batch = per_device_batch * n
        images = rng.integers(0, 256, (batch, height, width), np.uint8)
        secs = 0.0
        if mesh.get_coordinate() is not None:
            fn = make_dp_detect_fn(config, width, height, mesh, device=dev)
            try:
                local = shard_batch(images, mesh, device=dev)
                # Warm-up: the kernels' build and, on a card, the program's.
                fn(local).features.count.cpu()
                dist.barrier(group=mesh.get_group())
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(local).features.count.cpu()
                secs = time.perf_counter() - t0
            finally:
                fn.close()
        slowest = torch.tensor([secs], dtype=torch.float64, device=dev)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        dt = float(slowest.item()) / (iters * batch)
        fps = 1.0 / dt
        if fps1 is None:
            fps1 = fps
        points.append(dict(devices=n, fps=fps, ms_per_frame=dt * 1e3,
                           efficiency=fps / (n * fps1),
                           work_efficiency=fps / fps1))
    return dict(points=points, resolution=f"{width}x{height}",
                per_device_batch=per_device_batch, iters=iters,
                backend=dev.type, world_size=world,
                cards=card_info() if dev.type == "cuda" else None,
                host_cores=os.cpu_count())


def main(argv=None):  # pragma: no cover - CLI
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--max-features", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card per rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    init_distributed("env://", device=args.device)
    cfg = SiftConfig(use_input_upsampling=False,
                     max_nb_sift_per_buffer=args.max_features,
                     sift_buffer_count=1,
                     input_image_max_size=args.width * args.height)
    try:
        result = measure_dp_scaling(cfg, args.width, args.height,
                                    per_device_batch=args.batch,
                                    iters=args.iters, device=args.device)
        if dist.get_rank() == 0:
            print(json.dumps(result, indent=2))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":  # pragma: no cover
    main()
