"""Worker processes for the port's multi-process tests: each is started by
``torch.multiprocessing.spawn`` as one gloo rank on the CPU, reads its
inputs from a directory and writes its results there. The module imports
torch and the port only, so that a spawned child loads no JAX."""

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist


def spawn(world: int, work_dir: str, tasks) -> None:
    """Run ``tasks`` on ``world`` gloo ranks; raises if a rank fails, and
    kills them all when they have not finished in ``spawn_ranks``'s time
    (a stuck collective must not hold the test run)."""
    from vulkansift_tpu_torch.parallel.mesh import spawn_ranks
    spawn_ranks(run, world, (world, work_dir, list(tasks)))


def run(rank: int, world: int, work_dir: str, tasks) -> None:
    torch.set_num_threads(1)
    from vulkansift_tpu_torch.parallel import init_distributed
    init_distributed("file://" + os.path.join(work_dir, "store"), world,
                     rank, device="cpu")
    try:
        for task in tasks:
            globals()["_" + task](rank, work_dir)
    finally:
        dist.destroy_process_group()


def _out(work_dir: str, name: str, rank: int) -> str:
    return os.path.join(work_dir, f"{name}.{rank}.npz")


def _dp_detect(rank: int, work_dir: str) -> None:
    import vulkansift_tpu_torch as vt
    from vulkansift_tpu_torch.parallel import (make_dp_detect_fn, make_mesh,
                                               shard_batch)
    with open(os.path.join(work_dir, "dp_config.json")) as f:
        cfg = vt.from_reference_dict(json.load(f))
    images = np.load(os.path.join(work_dir, "dp_images.npy"))
    _, h, w = images.shape
    mesh = make_mesh()
    out = make_dp_detect_fn(cfg, w, h, mesh, device="cpu")(
        shard_batch(images, mesh, device="cpu"))
    per = len(images) // mesh.size()
    feats = {}
    for i in range(per):
        f = vt.Features(**{k.name: getattr(out.features, k.name)[i]
                           for k in dataclasses.fields(vt.Features)})
        feats[f"frame{rank * per + i}"] = vt.features_to_numpy(f)
    np.savez(_out(work_dir, "dp_detect", rank), **feats)


def _ring_match(rank: int, work_dir: str) -> None:
    from vulkansift_tpu_torch.parallel import make_mesh, make_ring_match_fn
    cases = np.load(os.path.join(work_dir, "ring_cases.npz"))
    res = {}
    for n_dev in (4, 3, 2):
        mesh = make_mesh(n_dev)
        if mesh.get_coordinate() is None:
            continue
        ring = make_ring_match_fn(mesh, device="cpu")
        for name in sorted({k.split(":")[0] for k in cases}):
            a = torch.from_numpy(cases[f"{name}:a"])
            b = torch.from_numpy(cases[f"{name}:b"])
            ca, cb = (int(c) for c in cases[f"{name}:counts"])
            m = ring(a, ca, b, torch.tensor(cb, dtype=torch.int32))
            for field in ("idx_a", "idx_b1", "idx_b2", "dist_a_b1",
                          "dist_a_b2", "count"):
                res[f"{n_dev}:{name}:{field}"] = getattr(m, field).numpy()
    np.savez(_out(work_dir, "ring_match", rank), **res)


def _scaling(rank: int, work_dir: str) -> None:
    import vulkansift_tpu_torch as vt
    from vulkansift_tpu_torch.parallel import measure_dp_scaling
    cfg = vt.SiftConfig(use_input_upsampling=False,
                        max_nb_sift_per_buffer=256, sift_buffer_count=1,
                        input_image_max_size=64 * 48)
    res = measure_dp_scaling(cfg, 64, 48, per_device_batch=1, iters=1,
                             device="cpu")
    if rank == 0:
        with open(os.path.join(work_dir, "scaling.json"), "w") as f:
            json.dump(res, f)


def _distributed_ba(rank: int, work_dir: str) -> None:
    from vulkansift_tpu_torch.parallel import make_mesh
    from vulkansift_tpu_torch.sfm import BAProblem, Camera, make_distributed_ba
    arr = np.load(os.path.join(work_dir, "ba_problem.npz"))
    problem = BAProblem(
        poses=torch.from_numpy(arr["poses"]),
        points=torch.from_numpy(arr["points"]),
        cam_idx=torch.from_numpy(arr["cam_idx"]),
        pt_idx=torch.from_numpy(arr["pt_idx"]),
        uv=torch.from_numpy(arr["uv"]), valid=torch.from_numpy(arr["valid"]),
        camera=Camera(*(float(v) for v in arr["camera"])))
    r = make_distributed_ba(make_mesh(), nb_iters=10, nb_cg_iters=20,
                            device="cpu")(problem)
    np.savez(_out(work_dir, "distributed_ba", rank),
             poses=r.poses.numpy(), points=r.points.numpy(),
             initial_cost=r.initial_cost.numpy(),
             final_cost=r.final_cost.numpy())


def sleep_rank(rank: int, seconds: float) -> None:
    import time
    time.sleep(seconds)


def fail_rank(rank: int) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 fails")
