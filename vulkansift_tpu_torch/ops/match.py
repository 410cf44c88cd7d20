"""Brute-force 2-nearest-neighbour matching of u8 descriptors (kernel 5).

Port of ``vulkansift_tpu/ops/match.py``. The function is the reference's
Get2NearestNeighbors shader (Get2NearestNeighbors.comp:43-102): for every
live A row, the smallest and second-smallest squared distance
``d2 = sum((a - b)^2)`` over the live B rows, ties to the earlier B row
(strict ``<`` updates, :85-95), reported as ``sqrt(d2)``.

* :func:`match_2nn_tiles` -- the wrapper of ``csrc/match_2nn.cu``
  (replaces ``vulkansift_tpu/ops/pallas_match.py::match_2nn_tiles`` and its
  row-major twin ``_match_2nn_tiles_rowmajor``). It returns the raw int32
  ``(d2_1, i1, d2_2, i2)``; ``d2 == D2_INVALID`` with index 0 means "no
  neighbour": the second slot when ``count_b < 2``, both when
  ``count_b == 0``, and every row at or past ``count_a``. A CPU tensor runs
  the plain version :func:`top2_plain`.
* :func:`match_2nn_fused` decodes the raw result into :class:`Matches2NN`
  (the instance's matcher); :func:`match_2nn` is the plain version end to
  end.

Everything is integer: u8 products summed over 128 lanes are at most
8,323,200 < 2^23, so the distances are exact, and the decode is the
correctly rounded float32 ``sqrt(d2)``, the JAX package's, bit for bit.
The live counts are device tensors and never reach the host.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ..config import DESC_SIZE
from ..types import Matches2NN
from . import cuda_lib

D2_INVALID = (1 << 23) - 1   # raw "no neighbour" distance (with index 0)
_INF = float("inf")

# The kernel's tiling, mirrored from the #defines A_TILE, B_TILE and SLICES
# of csrc/match_2nn.cu (change both together; tests/test_torch_match.py
# checks that they agree). A block owns a_tile_rows A rows; the live B rows
# are cut into `slices` contiguous slices, one per block of a cluster, each
# streamed in b_tile_rows-row stages. The tie tests sit on these edges.
KERNEL_GEOMETRY = {"a_tile_rows": 128, "b_tile_rows": 64, "slices": 8}

# vks_match_2nn(desc_a, count_a, desc_b, count_b, d1, i1, d2, i2, na, nb,
#               stream)
_ARGTYPES = ((ctypes.c_void_p,) * 8
             + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))

Count = Union[int, torch.Tensor]
Top2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _lex_lt(da, ia, db, ib):
    """(distance, index) lexicographic less-than."""
    return (da < db) | ((da == db) & (ia < ib))


def merge_top2(r: Top2, t: Top2) -> Top2:
    """Merge two per-row top-2 streams ``(d1, i1, d2, i2)`` in (distance,
    index) lexicographic order (parity: ``match.py:118``). Within each
    stream ``(d1, i1) <= (d2, i2)``. The merge is associative and
    commutative, so it serves B split into slices in any order (the
    multi-device ring as well): best = the smaller of the two bests;
    second = the smaller of the other best and the winner's own second."""
    rd1, ri1, rd2, ri2 = r
    td1, ti1, td2, ti2 = t
    take_t1 = _lex_lt(td1, ti1, rd1, ri1)
    nd1 = torch.where(take_t1, td1, rd1)
    ni1 = torch.where(take_t1, ti1, ri1)
    loser_d = torch.where(take_t1, rd1, td1)
    loser_i = torch.where(take_t1, ri1, ti1)
    win2_d = torch.where(take_t1, td2, rd2)
    win2_i = torch.where(take_t1, ti2, ri2)
    take_loser = _lex_lt(loser_d, loser_i, win2_d, win2_i)
    nd2 = torch.where(take_loser, loser_d, win2_d)
    ni2 = torch.where(take_loser, loser_i, win2_i)
    return nd1, ni1, nd2, ni2


def kernel_slices(count_b: int) -> Tuple[Tuple[int, int], ...]:
    """The [begin, end) B rows that each slice of the kernel scans at a
    live count ``count_b``: a slice is ceil(count_b / slices) rows rounded
    up to whole B tiles, as the kernel computes it."""
    g = KERNEL_GEOMETRY
    per = -(-count_b // g["slices"])
    chunk = -(-per // g["b_tile_rows"]) * g["b_tile_rows"]
    return tuple((min(s * chunk, count_b), min(s * chunk + chunk, count_b))
                 for s in range(g["slices"]))


def _check_descriptors(desc: torch.Tensor, name: str) -> None:
    if desc.dtype != torch.uint8 or desc.dim() != 2 \
            or desc.shape[1] != DESC_SIZE:
        raise ValueError(f"{name}: expected uint8 (N, {DESC_SIZE}), got "
                         f"{desc.dtype} {tuple(desc.shape)}")


def top2_plain(desc_a: torch.Tensor, count_a: Count, desc_b: torch.Tensor,
               count_b: Count, *, tile: int = 2048) -> Top2:
    """Plain version of the kernel: raw int32 ``(d2_1, i1, d2_2, i2)`` of
    every A row, tiled over B so that no (NA, NB) matrix is materialised.

    The dot products run in float64, where every product (<= 255^2) and
    every partial sum (< 2^23) is an integer far below 2^53, so they are
    exact whatever TF32 is set to; ``d2`` is then int64. Each tile's top-2
    comes from the unique int64 keys ``(d2 << 32) | column``: one ``min``
    gives the smallest distance with the earliest column, and columns at or
    past ``count_b`` get the key of the "no neighbour" marker, which no live
    column reaches. Tiles merge with :func:`merge_top2`."""
    _check_descriptors(desc_a, "desc_a")
    _check_descriptors(desc_b, "desc_b")
    na, nb = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    i32, i64 = torch.int32, torch.int64
    if dev.type == "cpu":
        # On the CPU the counts cost nothing to read: A rows past count_a
        # are dead and B tiles wholly past count_b cannot win, so neither
        # is computed (the result is the same).
        live = min(na, max(int(count_a), 0))
        if live < na:
            out = top2_plain(desc_a[:live], live, desc_b, count_b, tile=tile)
            pad = na - live
            return tuple(torch.cat([o, torch.full((pad,), fill, dtype=i32)])
                         for o, fill in zip(out, (D2_INVALID, 0,
                                                  D2_INVALID, 0)))
        nb = min(nb, max(int(count_b), 0))
    invalid_key = D2_INVALID << 32
    a = desc_a.to(torch.float64)
    a_sq = a.square().sum(1).to(i64)
    best = (torch.full((na,), D2_INVALID, dtype=i64, device=dev),
            torch.zeros(na, dtype=i64, device=dev),
            torch.full((na,), D2_INVALID, dtype=i64, device=dev),
            torch.zeros(na, dtype=i64, device=dev))
    for c0 in range(0, nb, tile):
        b = desc_b[c0:c0 + tile].to(torch.float64)
        d2 = (a_sq[:, None] + b.square().sum(1).to(i64)[None, :]
              - 2 * (a @ b.T).to(i64))
        col = torch.arange(c0, c0 + b.shape[0], device=dev)
        key = torch.where(col[None, :] < count_b, (d2 << 32) | col[None, :],
                          invalid_key)
        k1 = key.min(1).values
        k2 = torch.where(key == k1[:, None], invalid_key, key).min(1).values
        best = merge_top2(best, (k1 >> 32, k1 & 0xFFFFFFFF,
                                 k2 >> 32, k2 & 0xFFFFFFFF))
    dead = torch.arange(na, device=dev) >= count_a
    d1, i1, d2_, i2 = best
    return (torch.where(dead, D2_INVALID, d1).to(i32),
            torch.where(dead, 0, i1).to(i32),
            torch.where(dead, D2_INVALID, d2_).to(i32),
            torch.where(dead, 0, i2).to(i32))


def _device_count(count: Count, dev: torch.device) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        cuda_lib.require(count, "count", torch.int32)
        if count.numel() != 1 or count.device != dev:
            raise ValueError("counts: expected one int32 on the "
                             "descriptors' device")
        return count
    # A fill on the device, not a copy from the host.
    return torch.full((), int(count), dtype=torch.int32, device=dev)


@cuda_lib.counted
def match_2nn_tiles(desc_a: torch.Tensor, count_a: Count,
                    desc_b: torch.Tensor, count_b: Count) -> Top2:
    """Raw 2-NN ``(d2_1, i1, d2_2, i2)``, int32 of shape (NA,), of every A
    row against the first ``count_b`` B rows (parity:
    ``pallas_match.match_2nn_tiles``). A CUDA tensor launches
    ``csrc/match_2nn.cu``; a CPU tensor runs :func:`top2_plain`."""
    if not cuda_lib.use_kernel(desc_a):
        return top2_plain(desc_a, count_a, desc_b, count_b)
    _check_descriptors(desc_a, "desc_a")
    _check_descriptors(desc_b, "desc_b")
    dev = desc_a.device
    for t, name in ((desc_a, "desc_a"), (desc_b, "desc_b")):
        cuda_lib.require(t, name, torch.uint8, 2)
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned tensor on "
                             f"{dev}")
    cnt_a, cnt_b = _device_count(count_a, dev), _device_count(count_b, dev)
    na, nb = desc_a.shape[0], desc_b.shape[0]
    out = tuple(torch.empty(na, dtype=torch.int32, device=dev)
                for _ in range(4))
    fn = cuda_lib.entry("match_2nn", "vks_match_2nn", _ARGTYPES)
    cuda_lib.launch(fn, desc_a, "match_2nn", desc_a.data_ptr(),
                    cnt_a.data_ptr(), desc_b.data_ptr(), cnt_b.data_ptr(),
                    *(o.data_ptr() for o in out), na, nb)
    cuda_lib.count_launch(match_2nn_tiles)
    return out


def _decode(raw: Top2, count_a: Count) -> Matches2NN:
    d1, i1, d2_, i2 = raw

    def dist(d):
        # The correctly rounded float32 square root, as XLA computes it:
        # sqrt in float64, then one rounding to float32 (harmless double
        # rounding for sqrt from 53 to 24 bits). PyTorch's vectorised CPU
        # float32 sqrt is off by one ulp for some integers (267, 999, ...).
        return torch.where(d >= D2_INVALID, _INF,
                           torch.sqrt(d.double()).float())

    dev = d1.device
    count = (count_a.to(torch.int32, copy=True)
             if isinstance(count_a, torch.Tensor)
             else torch.full((), int(count_a), dtype=torch.int32, device=dev))
    return Matches2NN(
        idx_a=torch.arange(d1.shape[0], dtype=torch.int32, device=dev),
        idx_b1=i1, idx_b2=i2, dist_a_b1=dist(d1), dist_a_b2=dist(d2_),
        count=count)


def match_2nn_fused(desc_a: torch.Tensor, count_a: Count,
                    desc_b: torch.Tensor, count_b: Count) -> Matches2NN:
    """2-NN of every live A row among the live B rows through the kernel
    (parity: ``match.py:298``): distances ``sqrt(d2)`` in float32, +inf for
    "no neighbour". ``count`` is a copy of ``count_a`` taken at dispatch,
    so a later detect into A cannot change it."""
    return _decode(match_2nn_tiles(desc_a, count_a, desc_b, count_b),
                   count_a)


def match_2nn(desc_a: torch.Tensor, count_a: Count, desc_b: torch.Tensor,
              count_b: Count, *, tile: int = 2048) -> Matches2NN:
    """The plain version end to end (parity: ``match.py:149``), any
    device; rows at or past ``count_a`` carry the "no neighbour" marker."""
    return _decode(top2_plain(desc_a, count_a, desc_b, count_b, tile=tile),
                   count_a)


def lowe_ratio_mask(m: Matches2NN, ratio: float = 0.75) -> torch.Tensor:
    """Lowe ratio-test mask (parity: ``match.py:323``): live rows with
    ``d1 < ratio * d2``."""
    valid = torch.arange(m.capacity, device=m.idx_a.device) < m.count
    return valid & (m.dist_a_b1 < ratio * m.dist_a_b2)


def cross_check_mask(m_ab: Matches2NN, m_ba: Matches2NN) -> torch.Tensor:
    """Mutual-nearest-neighbour mask (parity: ``match.py:330``): the A->B
    best maps back to the same A row under B->A."""
    back = m_ba.idx_b1[m_ab.idx_b1.long()]
    valid = torch.arange(m_ab.capacity, device=m_ab.idx_a.device) < m_ab.count
    return valid & (back == m_ab.idx_a)
