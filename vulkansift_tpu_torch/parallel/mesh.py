"""Process group and device mesh setup.

Port of ``vulkansift_tpu/parallel/mesh.py``. Where the JAX package names
the devices of one runtime into a ``jax.sharding.Mesh``, the port runs one
process per device under ``torch.distributed`` and names the ranks into a
1-D :class:`~torch.distributed.device_mesh.DeviceMesh` along
:data:`DATA_AXIS`: data parallelism over images (:mod:`.dp`) and the
sharded 2-NN ring (:mod:`.ring_match`) both ride that axis.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: DeviceLike = "cuda") -> None:
    """Join the process group (parity: ``init_distributed``).

    ``coordinator_address`` is a ``torch.distributed`` init method
    (``tcp://host:port``, ``file:///path``, or ``env://`` under
    ``torchrun``); ``num_processes`` and ``process_id`` are the world size
    and this process's rank (read from the environment with ``env://``).
    The backend follows ``device``: NCCL for ``"cuda"``, which also makes
    card ``LOCAL_RANK`` (else the rank) modulo the card count current, and
    gloo for ``"cpu"``. A no-op when the group already exists or without a
    coordinator (one process). Raises :class:`~..errors.DeviceError` for
    ``"cuda"`` without a card.
    """
    dev = resolve_device(device)
    if dist.is_initialized() or coordinator_address is None:
        return
    # -1: taken from the environment (env://), torch's own default.
    world = -1 if num_processes is None else num_processes
    if dev.type == "cpu":
        dist.init_process_group("gloo", init_method=coordinator_address,
                                world_size=world,
                                rank=-1 if process_id is None else process_id)
        return
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", "0"))
    card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                        % torch.cuda.device_count())
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", init_method=coordinator_address,
                            world_size=world, rank=rank, device_id=card)


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS) -> DeviceMesh:
    """1-D mesh over ranks ``0 .. n_devices - 1`` of the process group
    (default: all of them), on the group's device type. Every rank of the
    group must call it; a rank outside the mesh gets one whose
    ``get_coordinate()`` is None. (``init_device_mesh`` spans the whole
    world, so a mesh over fewer ranks is built with ``DeviceMesh``.)"""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group; call "
                           "init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=(axis_name,))


def mesh_device(mesh: DeviceMesh, device: DeviceLike) -> torch.device:
    """This rank's device for ``mesh``: ``device`` resolved (CUDA takes the
    current card), which must be of the mesh's device type."""
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} does not match the mesh's "
                         f"{mesh.device_type}")
    return dev


def mesh_rank(mesh: DeviceMesh, axis_name: str = DATA_AXIS) -> int:
    """This rank's position along ``axis_name``; raises outside the
    mesh."""
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    return mesh.get_local_rank(axis_name)


def spawn_ranks(fn: Callable, nprocs: int, args: tuple = (),
                timeout: float = 300.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes on this host
    (``torch.multiprocessing.spawn``). Raises if a process fails, and
    kills them all when they have not finished within ``timeout`` seconds,
    so that a stuck collective cannot hold the caller."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{nprocs} processes did not finish in "
                               f"{timeout} s")
