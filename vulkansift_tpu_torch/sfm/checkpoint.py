"""SfM state checkpointing.

Port of ``vulkansift_tpu/sfm/checkpoint.py`` with the same on-disk
format (1): a directory holding ``sfm_arrays.npz`` (poses, points,
point_valid) and ``sfm_meta.json`` (costs, sizes, format), so that a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .reconstruction import Reconstruction

_META = "sfm_meta.json"
_ARRAYS = "sfm_arrays.npz"


def save_reconstruction(path: str, rec: Reconstruction) -> None:
    """Checkpoint a reconstruction into directory ``path``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, _ARRAYS),
             poses=rec.poses, points=rec.points,
             point_valid=rec.point_valid)
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"initial_cost": rec.initial_cost,
                   "final_cost": rec.final_cost,
                   "nb_cameras": int(rec.poses.shape[0]),
                   "nb_points": int(rec.points.shape[0]),
                   "format": 1}, f)


def load_reconstruction(path: str) -> Reconstruction:
    """Restore a reconstruction checkpointed by :func:`save_reconstruction`
    (of either package)."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    if meta.get("format") != 1:
        raise ValueError(f"unsupported checkpoint format in {path}")
    with np.load(os.path.join(path, _ARRAYS)) as arrays:
        return Reconstruction(
            poses=arrays["poses"], points=arrays["points"],
            point_valid=arrays["point_valid"],
            initial_cost=float(meta["initial_cost"]),
            final_cost=float(meta["final_cost"]))
