"""The one traffic generator: frames and the closed loop's items, from a
traffic file's parameters and the seed.

A traffic file gives:

* ``images``: ``{"kind": "pan", "count", "step"}`` (crops of one seeded
  canvas at the configuration's frame size) or ``{"kind": "oxford_sets",
  "sets", "rot_deg", "scale_step", "shift"}`` (img1 and its five warps a
  set);
* ``buffers``: the instance's ``sift_buffer_count``;
* ``setup``: ``"detect_all"`` detects image k into buffer k before the
  window, or ``"none"``;
* ``items``: ``"images"`` (one item an image), ``"set_pairs"`` (img1 with
  imgN, N = 2..6, a set) or ``"buffer_pairs"`` (every i < j of the
  buffers); the window cycles them in this order;
* ``calls``: the instance calls of one item, ``[method, arg, ...]``, where
  an argument is a buffer number or the name of one of the item's
  bindings (``image``, ``a``, ``b``: images; ``i``, ``j``: buffers);
* ``warmup_seconds``: how long set-up runs the closed loop before the
  window (the replayed programs run slower for the first seconds of a
  process);
* ``unit``, ``check`` (how many items the correctness check samples) and
  ``traced_items`` (the length of the traced window).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import images as img_mod

IMAGE_ARGS = ("image", "a", "b")


def make_images(traffic: dict, frame: dict, rng) -> List[np.ndarray]:
    spec = traffic["images"]
    w, h = frame["width"], frame["height"]
    if spec["kind"] == "pan":
        return img_mod.pan(w, h, spec["count"], spec["step"], rng)
    if spec["kind"] == "oxford_sets":
        sets = img_mod.oxford_sets(w, h, spec["sets"], spec["rot_deg"],
                                   spec["scale_step"], spec["shift"], rng)
        return [im for s in sets for im in s]
    raise ValueError(f"unknown image kind {spec['kind']!r}")


def make_items(traffic: dict, n_images: int) -> List[Dict[str, int]]:
    kind = traffic["items"]
    if kind == "images":
        return [{"image": k} for k in range(n_images)]
    if kind == "set_pairs":
        per = 6
        return [{"a": s * per, "b": s * per + n - 1}
                for s in range(n_images // per) for n in range(2, per + 1)]
    if kind == "buffer_pairs":
        nb = traffic["buffers"]
        return [{"i": i, "j": j} for i in range(nb) for j in range(i + 1, nb)]
    raise ValueError(f"unknown item kind {kind!r}")


def resolve(arg, item: Dict[str, int], images: List[np.ndarray]):
    """A call argument: an image for an image binding, a buffer number
    otherwise."""
    if isinstance(arg, int):
        return arg
    return images[item[arg]] if arg in IMAGE_ARGS else item[arg]


def detects(calls: list, item: Dict[str, int]):
    """(image index, buffer) of each ``detect_features`` call of an item."""
    return [(item[c[1]], c[2] if isinstance(c[2], int) else item[c[2]])
            for c in calls if c[0] == "detect_features"]


def matched_buffers(calls: list, item: Dict[str, int]):
    """(buffer A, buffer B) of the item's ``match_features`` call, or
    None."""
    for c in calls:
        if c[0] == "match_features":
            return tuple(a if isinstance(a, int) else item[a] for a in c[1:3])
    return None
