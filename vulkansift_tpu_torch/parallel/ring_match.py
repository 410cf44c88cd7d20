"""Sharded brute-force 2-NN matching over a device mesh (a send/recv
ring).

Port of ``vulkansift_tpu/parallel/ring_match.py``. The A rows are split
over the ranks and stay where they are; the B rows are split likewise and
the shards travel around the ring of ranks (``batch_isend_irecv`` to the
next rank, from the previous one), so that after n steps every rank has
seen every B shard and the NA x NB distance matrix exists nowhere. Each
step runs the matcher kernel (``csrc/match_2nn.cu``, through
:func:`..ops.match.match_2nn_tiles`) on the local A rows and the visiting
shard at that shard's live count, and folds its raw int32 ``(d2, index)``
streams into a running top-2 with :func:`..ops.match.merge_top2`; the
next shard's transfer overlaps the step. The merge is (distance, index)
lexicographic, associative and commutative, so the result is bit for bit
the single-device :func:`..ops.match.match_2nn_fused`, whatever order the
shards arrive in.

The JAX package compiles the whole fold as one program. On a card each
step here replays one recorded :class:`..compiled.RingStepProgram` (the
counterpart of that program's step: :func:`ring_step_into`, with the
shard's offset and live count read from device scalars); the transfers
stay outside the graph. On the CPU the same step runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..compiled import GraphPool, RingStepProgram
from ..ops.match import (D2_INVALID, Count, Top2, _decode, match_2nn_tiles,
                         merge_top2)
from ..types import Matches2NN
from ..utils.device import DeviceLike, resolve_device
from .mesh import DATA_AXIS, mesh_device, mesh_rank


def pad_rows(desc: torch.Tensor, n: int) -> torch.Tensor:
    """``desc`` with zero rows appended up to a multiple of ``n``."""
    pad = (-desc.shape[0]) % n
    if not pad:
        return desc
    return torch.cat([desc, desc.new_zeros((pad,) + desc.shape[1:])])


def empty_top2(na: int, device) -> Top2:
    """The running top-2 before any shard: "no neighbour" everywhere."""
    def z(v):
        return torch.full((na,), v, dtype=torch.int32, device=device)
    return z(D2_INVALID), z(0), z(D2_INVALID), z(0)


def ring_step(top2: Top2, desc_a: torch.Tensor, b_shard: torch.Tensor,
              offset: Count, count_b: Count) -> Top2:
    """Fold the B shard holding global rows ``[offset, offset + len)``
    into the running top-2 of every row of ``desc_a``. The kernel scans
    the shard's live rows, ``clamp(count_b - offset, 0, len)``; the offset
    goes onto live entries only, so a "no neighbour" marker (index 0)
    stays one and loses every merge against a live entry. ``offset`` and
    ``count_b`` are ints or int32 scalar tensors on the device."""
    nb_l = b_shard.shape[0]
    if isinstance(count_b, torch.Tensor) or isinstance(offset, torch.Tensor):
        live = torch.clamp(count_b - offset, 0, nb_l)
    else:
        live = max(0, min(int(count_b) - offset, nb_l))
    d1, i1, d2, i2 = match_2nn_tiles(desc_a, desc_a.shape[0], b_shard, live)
    i1 = torch.where(d1 < D2_INVALID, i1 + offset, i1)
    i2 = torch.where(d2 < D2_INVALID, i2 + offset, i2)
    return merge_top2(top2, (d1, i1, d2, i2))


def ring_step_into(top2: Top2, desc_a: torch.Tensor, b_shard: torch.Tensor,
                   offset: torch.Tensor, count_b: torch.Tensor) -> None:
    """:func:`ring_step` with the offset and ``count_b`` as int32 scalar
    tensors, writing the new top-2 into ``top2`` in place: the step a
    :class:`..compiled.RingStepProgram` records, one graph for every step
    of a fold."""
    for dst, new in zip(top2, ring_step(top2, desc_a, b_shard, offset,
                                        count_b)):
        dst.copy_(new)


class EagerStep:
    """The CPU's counterpart of a :class:`..compiled.RingStepProgram`, with
    its ``start`` / ``step`` / ``result``: :func:`ring_step_into` run
    eagerly, the offset and ``count_b`` in scalar tensors as the program
    reads them."""

    def __init__(self, device: torch.device):
        self.device = device
        self._offset = torch.zeros((), dtype=torch.int32, device=device)

    def start(self, desc_a: torch.Tensor, count_b: Count) -> None:
        self._desc_a = desc_a
        self._count_b = _count_tensor(count_b, self.device)
        self._top2 = empty_top2(desc_a.shape[0], self.device)

    def step(self, shard: torch.Tensor, offset: int) -> None:
        self._offset.fill_(int(offset))
        ring_step_into(self._top2, self._desc_a, shard, self._offset,
                       self._count_b)

    def result(self) -> Top2:
        return self._top2

    def close(self) -> None:
        pass


Step = Union[RingStepProgram, EagerStep]


def make_step(na_l: int, nb_l: int, device: torch.device,
              pool: Optional[GraphPool] = None) -> Step:
    """The fold step for ``na_l`` A rows and shards of ``nb_l`` rows: a
    recorded program on a card, :class:`EagerStep` on the CPU."""
    if device.type == "cuda":
        return RingStepProgram(na_l, nb_l, device=device, pool=pool)
    return EagerStep(device)


def fold_shards(desc_a: torch.Tensor,
                shards: Iterable[Tuple[torch.Tensor, int]],
                count_b: Count, *, step: Optional[Step] = None) -> Top2:
    """One fold step (:func:`ring_step_into`) a ``(b_shard, offset)`` pair,
    in the order given, from :func:`empty_top2`: one rank's ring with no
    transport. ``step`` (from :func:`make_step`, for these shapes) runs
    the steps; by default one is made for the call and closed after it."""
    shards = list(shards)
    if not shards:
        return empty_top2(desc_a.shape[0], desc_a.device)
    own = step is None
    if own:
        step = make_step(desc_a.shape[0], shards[0][0].shape[0],
                         desc_a.device)
    try:
        step.start(desc_a, count_b)
        for b_shard, offset in shards:
            step.step(b_shard, offset)
        return step.result()
    finally:
        if own:
            step.close()


def finish(top2: Top2, row0: int, count_a: Count) -> Matches2NN:
    """Decode a rank's folded top-2 of global A rows ``row0 ..`` into
    :class:`Matches2NN`, rows at or past ``count_a`` carrying the "no
    neighbour" marker, as the single-device matcher leaves them."""
    d1, i1, d2, i2 = top2
    row = torch.arange(row0, row0 + d1.shape[0], dtype=torch.int32,
                       device=d1.device)
    dead = row >= count_a
    m = _decode((torch.where(dead, D2_INVALID, d1), torch.where(dead, 0, i1),
                 torch.where(dead, D2_INVALID, d2), torch.where(dead, 0, i2)),
                count_a)
    return dataclasses.replace(m, idx_a=row)


def _count_on(count: Count, dev: torch.device) -> Count:
    """A count as given: an int, or a tensor moved to ``dev``."""
    return count.to(dev, torch.int32) if isinstance(count, torch.Tensor) \
        else int(count)


def _count_tensor(count: Count, dev: torch.device) -> torch.Tensor:
    """A count as an int32 scalar tensor on ``dev``."""
    if isinstance(count, torch.Tensor):
        return count.to(dev, torch.int32).reshape(())
    return torch.full((), int(count), dtype=torch.int32, device=dev)


class RingMatch:
    """This rank's sharded matcher (see :func:`make_ring_match_fn`)."""

    def __init__(self, mesh: DeviceMesh, axis_name: str,
                 device: torch.device):
        self.device = device
        self._n = mesh.size()
        self._me = mesh_rank(mesh, axis_name)
        self._group = mesh.get_group(axis_name)
        self._nxt = dist.get_global_rank(self._group, (self._me + 1) % self._n)
        self._prv = dist.get_global_rank(self._group, (self._me - 1) % self._n)
        self._pool = GraphPool()
        # (na_l, nb_l) -> the fold's step of those shard sizes.
        self.steps: Dict[Tuple[int, int], Step] = {}

    def __call__(self, desc_a: torch.Tensor, count_a: Count,
                 desc_b: torch.Tensor, count_b: Count) -> Matches2NN:
        n, me, dev, group = self._n, self._me, self.device, self._group
        a, b = pad_rows(desc_a, n), pad_rows(desc_b, n)
        na_l, nb_l = a.shape[0] // n, b.shape[0] // n
        a_l = a[me * na_l:(me + 1) * na_l].to(dev).contiguous()
        cur = b[me * nb_l:(me + 1) * nb_l].to(dev).contiguous()
        step = self.steps.get((na_l, nb_l))
        if step is None:
            step = self.steps[(na_l, nb_l)] = make_step(na_l, nb_l, dev,
                                                        self._pool)
        step.start(a_l, _count_on(count_b, dev))
        for i in range(n):
            # At step i this rank holds global B shard (me - i) mod n.
            reqs = []
            if i + 1 < n:
                nbuf = torch.empty_like(cur)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, cur, self._nxt, group),
                    dist.P2POp(dist.irecv, nbuf, self._prv, group)])
            step.step(cur, ((me - i) % n) * nb_l)
            for r in reqs:
                r.wait()
            if reqs:
                cur = nbuf
        return finish(step.result(), me * na_l, _count_on(count_a, dev))

    def close(self) -> None:
        """Free the recorded steps (later calls record them anew)."""
        for step in self.steps.values():
            step.close()
        self.steps.clear()


def make_ring_match_fn(mesh: DeviceMesh, axis_name: str = DATA_AXIS, *,
                       device: DeviceLike = "cuda") -> RingMatch:
    """The sharded 2-NN matcher of this rank over ``mesh``.

    Returns ``fn(desc_a u8[NA, 128], count_a, desc_b u8[NB, 128],
    count_b) -> Matches2NN`` for any NA and NB: every rank passes the same
    arrays (from any device), which are padded with zero rows to mesh
    multiples, and gets back its own rows ``[r * NA_l, (r + 1) * NA_l)`` of
    the padded A, with global ``idx_a``. Rows at or past ``count_a`` carry
    the "no neighbour" marker. ``device`` (default ``"cuda"``, raising
    without a card) must be of the mesh's type. Every rank of the mesh
    must call ``fn`` together.

    On a card every step replays a :class:`..compiled.RingStepProgram`,
    one for each pair of shard sizes, recorded at its first call into one
    graph pool; the transfers stay outside the graph, and the received
    shard is copied into the program's static shard after its transfer
    ends. ``fn.close()`` frees the programs."""
    return RingMatch(mesh, axis_name, mesh_device(mesh, resolve_device(device)))
