"""Recorded programs: the instance's counterpart of ``jax.jit``.

The JAX instance runs each detect resolution, and the matcher, as one
compiled XLA program (``vulkansift_tpu/instance.py``). On a card the port
records one call of the same function as a CUDA graph and replays it:

* :class:`DetectProgram` -- :func:`.pipeline.make_detect_fn` of one
  resolution, exact or a bucket's, with a static (H, W) u8 input and, when
  bucketed, the valid width and height as device scalars;
* :class:`MatchProgram` -- :func:`.ops.match.match_2nn_fused` for two
  descriptor capacities, with static descriptor blocks and counts;
* :class:`RingStepProgram` -- one step of the ring matcher's fold
  (:func:`.parallel.ring_match.ring_step_into`) for one pair of shard
  sizes, the shard's row offset and live count as device scalars, so that
  one graph serves every step of every fold;
* :class:`StageProgram` -- one stage of the staged
  :class:`~.detector.SiftDetector`, which reads its input in place (the
  stage's static image, or an earlier stage's static outputs) and whose
  outputs stay in the graph's buffers for the next stage;
* :class:`LoopProgram` -- one step of an iteration (an LM iteration of
  bundle adjustment, a Gauss-Newton step of the pose graph, RANSAC's
  batch of hypotheses) whose last operations write the new state into its
  static state buffers, so that ``k`` replays chain on the device: the
  counterpart of a ``lax.scan`` or ``fori_loop`` body under ``jax.jit``.

Programs are kept under their keys in a :class:`ProgramCache`, an LRU
like a jit cache: an instance's detect programs, a staged detector's
stages by resolution, and each SfM module's programs.

Building a program runs its function once on a side stream (the warm-up:
the kernels' nvcc build and one-time attributes, the allocator's and
PyTorch's first use), then records one call with ``torch.cuda.graph(...,
capture_error_mode="thread_local")``; other threads may go on launching
meanwhile. A call copies its inputs into the static buffers, replays the
graph and clones the outputs, all in stream order on the device's current
stream and with no host synchronisation, so that a result survives later
replays. Like a compiled program, the graph is fixed to its shapes.

The graph's memory comes from a :class:`GraphPool`. A program built alone
has a pool of its own; an instance's programs share one, so that they hold
one working set between them (the largest program's) and each only its
static inputs and outputs. That is safe because the programs of a pool
replay one at a time: each call waits for the pool's last call to have
copied its outputs, and nothing reads a graph's outputs after that.

Launch counts stay honest: the warm-up's launches count as they run, the
capture's are recorded (:func:`.ops.cuda_lib.recording`) and added at
every replay. A failure to build or replay raises; a program never runs
its function eagerly in place of the graph, and raises inside
:func:`.ops.cuda_lib.force_plain` rather than run its kernels there. A
program needs a card: on the CPU its callers run the same function
eagerly under the same keys (:class:`EagerStage` for a stage).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, Hashable, Iterator, List, Optional,
                    Sequence)

import numpy as np
import torch

from .config import DESC_SIZE, SiftConfig
from .errors import DeviceError
from .ops import cuda_lib
from .ops.match import match_2nn_fused
from .pipeline import DetectOutput, make_detect_fn
from .types import Features, Matches2NN
from .utils import trace
from .utils.device import DeviceLike, resolve_device

_FEATURE_FIELDS = tuple(f.name for f in dataclasses.fields(Features))
_MATCH_FIELDS = tuple(f.name for f in dataclasses.fields(Matches2NN))

# Every program of a device warms up and records on one side stream: the
# libraries PyTorch calls keep state per stream (cuBLAS a 32 MiB workspace,
# which the histogram smoothing's product takes), and a stream for each
# program would keep one more for good. The lock keeps two builds from
# capturing on it at once.
_build_lock = threading.Lock()
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _check_kernels() -> None:
    if cuda_lib.plain_forced():
        raise DeviceError("a recorded program runs its kernels: it is not "
                          "built or called inside cuda_lib.force_plain()")


class GraphPool:
    """The memory pool that one or more programs record into, and the event
    of its last call. A new handle is taken when no program holds the pool,
    so that a pool whose graphs are all gone is never recorded into again
    (the allocator frees it at its next ``empty_cache``)."""

    def __init__(self):
        self._handle = None
        self._programs = 0
        self.done: Optional[torch.cuda.Event] = None

    def acquire(self):
        if self._programs == 0:
            self._handle = torch.cuda.graph_pool_handle()
        self._programs += 1
        return self._handle

    def release(self) -> None:
        self._programs -= 1

    def record_done(self, stream: torch.cuda.Stream) -> None:
        """Mark the end of a call on ``stream``: its outputs are copied."""
        self.done = torch.cuda.Event()
        self.done.record(stream)


class _Program:
    """A function of static input buffers recorded as a CUDA graph.

    ``output_bytes``, worked out once from the static shapes at record
    time, is what a call copies out of the graph's outputs; each call adds
    it to the counter ``compiled.copy_out_bytes``. A detect or match call
    adds to ``compiled.upload_bytes`` the static inputs it copies from host
    memory: an input already on the card is a device copy, not an
    upload."""

    _outputs: Optional[List[torch.Tensor]] = None

    def _record(self, device: torch.device,
                run: Callable[[], List[torch.Tensor]],
                pool: Optional[GraphPool], key: Hashable = None) -> None:
        # Counted as programs.record_s: warm-up plus capture, less the
        # kernel libraries' seconds inside them (kernels.load_s counts
        # those).
        loads = cuda_lib.thread_load_seconds()
        with trace.span("compiled.record", type(self).__name__ + (
                "" if key is None else f" {key}")):
            self._record_graph(device, run, pool)
        self.output_bytes = sum(t.nbytes for t in self._outputs or ())
        trace.count("programs.record_s",
                    self.warmup_seconds + self.capture_seconds
                    - (cuda_lib.thread_load_seconds() - loads))

    def _record_graph(self, device: torch.device,
                      run: Callable[[], List[torch.Tensor]],
                      pool: Optional[GraphPool]) -> None:
        _check_kernels()
        if device.type != "cuda":
            raise DeviceError(f"a recorded program needs a CUDA device, "
                              f"not {device}")
        self.device = device
        self._pool = pool if pool is not None else GraphPool()
        with _build_lock, torch.cuda.device(device):
            side = _side_streams.get(device)
            if side is None:
                side = _side_streams[device] = torch.cuda.Stream(device)
            main = torch.cuda.current_stream(device)
            side.wait_stream(main)
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                run()
            main.wait_stream(side)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(device)
            graph = torch.cuda.CUDAGraph()
            handle = self._pool.acquire()
            try:
                with cuda_lib.recording() as launches:
                    with torch.cuda.graph(graph, pool=handle, stream=side,
                                          capture_error_mode="thread_local"):
                        outs = run()
            except BaseException:
                self._pool.release()
                raise
            t2 = time.perf_counter()
            # What the capture added to the pool (with a shared pool, less
            # than the program's working set where it fits in free memory).
            self.pool_bytes = torch.cuda.memory_reserved(device) - before
        self.warmup_seconds = t1 - t0
        # torch.cuda.graph instantiates the graph as the capture ends.
        self.capture_seconds = t2 - t1
        self._graph: Optional[torch.cuda.CUDAGraph] = graph
        self.replays = 0
        self._launches = launches
        self._outputs = outs

    @property
    def launches(self) -> Dict[str, int]:
        """Kernel launches of one replay, by wrapper name."""
        return {w.__name__: n for w, n in self._launches.items()}

    def _begin(self) -> torch.cuda.Stream:
        if self._graph is None:
            raise DeviceError("the program is closed")
        _check_kernels()
        stream = torch.cuda.current_stream(self.device)
        if self._pool.done is not None:
            # The static buffers, and the pool's memory, are shared by
            # every call: a call on another stream waits for the last
            # one's copies.
            stream.wait_event(self._pool.done)
        return stream

    def _launch(self) -> None:
        with trace.span("compiled.replay"):
            self._graph.replay()
            self.replays += 1
            for wrapper, n in self._launches.items():
                wrapper.launches += n

    def _replay(self, stream: torch.cuda.Stream,
                into: Optional[Sequence[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
        """Replay, then copy the outputs into new tensors, or into
        ``into`` (tensors of the outputs' shapes) when given."""
        self._launch()
        with trace.span("compiled.copy_out"):
            if into is None:
                outs = [t.clone() for t in self._outputs]
            else:
                outs = list(into)
                for dst, src in zip(outs, self._outputs):
                    dst.copy_(src, non_blocking=True)
            self._pool.record_done(stream)
            trace.count("compiled.copy_out_bytes", self.output_bytes)
        return outs

    def close(self) -> None:
        """Wait for the pool's last call, then free the graph and return its
        memory to the pool (the static inputs go with the program); the pool
        itself is freed when its last program closes."""
        if self._graph is None:
            return
        if self._pool.done is not None:
            self._pool.done.synchronize()
        self._outputs = None
        self._graph.reset()
        self._graph = None
        self._pool.release()


class DetectProgram(_Program):
    """:func:`.pipeline.make_detect_fn` of one resolution recorded as a
    CUDA graph. ``program(image[, valid_w, valid_h])`` returns what the
    eager function returns (a :class:`.pipeline.DetectOutput`, with the
    gaussian and DoG stacks under ``return_pyramid``), in new tensors.
    ``bucket > 1`` takes the bucket's edge-padded (H, W) frame and the
    valid size, which the graph reads from two device scalars. ``out``, a
    :class:`.pipeline.DetectOutput` of the result's shapes (views into a
    batch, say), receives the result in place of new tensors."""

    def __init__(self, config: SiftConfig, width: int, height: int, *,
                 bucket: int = 1, device: DeviceLike = "cuda",
                 return_pyramid: bool = False,
                 pool: Optional[GraphPool] = None):
        dev = resolve_device(device, config.device_index)
        self.width, self.height = width, height
        self.bucketed = bucket > 1
        self._return_pyramid = return_pyramid
        fn = make_detect_fn(config, width, height,
                            return_pyramid=return_pyramid, device=dev,
                            bucket=bucket)
        self._image = torch.zeros((height, width), dtype=torch.uint8,
                                  device=dev)
        self._valid = tuple(torch.zeros((), dtype=torch.float32, device=dev)
                            for _ in range(2 if self.bucketed else 0))
        self._nb_oct = 0

        def run() -> List[torch.Tensor]:
            out = fn(self._image, *self._valid)
            pyr: tuple = ((), ())
            if return_pyramid:
                out, *pyr = out
            self._nb_oct = len(out.per_octave_counts)
            return ([getattr(out.features, f) for f in _FEATURE_FIELDS]
                    + [out.lost, out.per_octave_counts, *pyr[0], *pyr[1]])

        self._record(dev, run, pool, key=(width, height, bucket))
        self.upload_bytes = self._image.nbytes

    def __call__(self, image, valid_w=None, valid_h=None, *,
                 out: Optional[DetectOutput] = None):
        if self.bucketed and (valid_w is None or valid_h is None):
            raise ValueError("a bucketed program needs valid_w and valid_h")
        if out is not None and self._return_pyramid:
            raise ValueError("out= takes no pyramid")
        with torch.cuda.device(self.device):
            with trace.span("compiled.upload"):
                img = image if isinstance(image, torch.Tensor) \
                    else torch.from_numpy(np.ascontiguousarray(image))
                if (img.shape != (self.height, self.width)
                        or img.dtype != torch.uint8):
                    raise ValueError(f"expected a ({self.height}, "
                                     f"{self.width}) uint8 image")
                stream = self._begin()
                if img.device.type == "cpu":
                    # Pinned staging, outside the graph: the upload does
                    # not wait for earlier frames.
                    img = img.pin_memory()
                    trace.count("compiled.upload_bytes", self.upload_bytes)
                self._image.copy_(img, non_blocking=True)
                if self.bucketed:
                    self._valid[0].fill_(float(valid_w))
                    self._valid[1].fill_(float(valid_h))
            outs = self._replay(stream, None if out is None else (
                [getattr(out.features, f) for f in _FEATURE_FIELDS]
                + [out.lost, out.per_octave_counts]))
        if out is not None:
            return out
        nf = len(_FEATURE_FIELDS)
        out = DetectOutput(Features(**dict(zip(_FEATURE_FIELDS, outs[:nf]))),
                           outs[nf], outs[nf + 1])
        if not self._return_pyramid:
            return out
        pyr = outs[nf + 2:]
        return out, tuple(pyr[:self._nb_oct]), tuple(pyr[self._nb_oct:])


class MatchProgram(_Program):
    """:func:`.ops.match.match_2nn_fused` for descriptor blocks of
    ``capacity_a`` and ``capacity_b`` rows recorded as a CUDA graph.
    ``program(desc_a, count_a, desc_b, count_b)`` returns a new
    :class:`.types.Matches2NN`; the counts are int32 scalars on the device
    and never reach the host."""

    def __init__(self, capacity_a: int, capacity_b: int, *,
                 device: DeviceLike = "cuda",
                 pool: Optional[GraphPool] = None):
        dev = resolve_device(device)
        self._desc = tuple(torch.zeros((n, DESC_SIZE), dtype=torch.uint8,
                                       device=dev)
                           for n in (capacity_a, capacity_b))
        self._count = tuple(torch.zeros((), dtype=torch.int32, device=dev)
                            for _ in range(2))

        def run() -> List[torch.Tensor]:
            m = match_2nn_fused(self._desc[0], self._count[0],
                                self._desc[1], self._count[1])
            return [getattr(m, f) for f in _MATCH_FIELDS]

        self._record(dev, run, pool, key=(capacity_a, capacity_b))

    def __call__(self, desc_a: torch.Tensor, count_a: torch.Tensor,
                 desc_b: torch.Tensor, count_b: torch.Tensor) -> Matches2NN:
        for d, s in zip((desc_a, desc_b), self._desc):
            if d.shape != s.shape or d.dtype != torch.uint8:
                raise ValueError(f"expected uint8 descriptors of shape "
                                 f"{tuple(s.shape)}, got {d.dtype} "
                                 f"{tuple(d.shape)}")
        with torch.cuda.device(self.device):
            with trace.span("compiled.upload"):
                stream = self._begin()
                staged = 0
                for src, dst in zip((desc_a, desc_b, count_a, count_b),
                                    (*self._desc, *self._count)):
                    dst.copy_(src, non_blocking=True)
                    if src.device.type == "cpu":
                        staged += dst.nbytes
                trace.count("compiled.upload_bytes", staged)
            outs = self._replay(stream)
        return Matches2NN(**dict(zip(_MATCH_FIELDS, outs)))


class RingStepProgram(_Program):
    """One step of the ring matcher's fold for ``na_l`` A rows and shards of
    ``nb_l`` B rows (:func:`.parallel.ring_match.ring_step_into`) recorded
    as a CUDA graph. The step folds the shard in its static buffer into
    the running top-2 in place, with the shard's row offset and ``count_b``
    read from device scalars, so that one graph serves every step of every
    fold. A fold is :meth:`start` (the A rows and ``count_b``; the top-2
    cleared), one :meth:`step` a shard, then :meth:`result`."""

    def __init__(self, na_l: int, nb_l: int, *, device: DeviceLike = "cuda",
                 pool: Optional[GraphPool] = None):
        from .parallel.ring_match import empty_top2, ring_step_into
        dev = resolve_device(device)
        self._desc_a = torch.zeros((na_l, DESC_SIZE), dtype=torch.uint8,
                                   device=dev)
        self._shard = torch.zeros((nb_l, DESC_SIZE), dtype=torch.uint8,
                                  device=dev)
        self._offset, self._count_b = (
            torch.zeros((), dtype=torch.int32, device=dev) for _ in range(2))
        self._empty = empty_top2(na_l, dev)
        self._top2 = tuple(t.clone() for t in self._empty)
        self._stream: Optional[torch.cuda.Stream] = None

        def run() -> List[torch.Tensor]:
            ring_step_into(self._top2, self._desc_a, self._shard,
                           self._offset, self._count_b)
            return []

        self._record(dev, run, pool, key=(na_l, nb_l))

    def start(self, desc_a: torch.Tensor, count_b) -> None:
        """Begin a fold of the A rows ``desc_a`` against B rows live up to
        ``count_b`` (an int, or an int32 scalar tensor)."""
        if desc_a.shape != self._desc_a.shape or desc_a.dtype != torch.uint8:
            raise ValueError(f"expected uint8 A rows of shape "
                             f"{tuple(self._desc_a.shape)}")
        with torch.cuda.device(self.device):
            self._stream = self._begin()
            self._desc_a.copy_(desc_a, non_blocking=True)
            if isinstance(count_b, torch.Tensor):
                self._count_b.copy_(count_b.reshape(()), non_blocking=True)
            else:
                self._count_b.fill_(int(count_b))
            for dst, src in zip(self._top2, self._empty):
                dst.copy_(src)

    def step(self, shard: torch.Tensor, offset: int) -> None:
        """Fold the shard holding global B rows from ``offset`` on."""
        if self._stream is None:
            raise DeviceError("step() before start()")
        if shard.shape != self._shard.shape or shard.dtype != torch.uint8:
            raise ValueError(f"expected a uint8 shard of shape "
                             f"{tuple(self._shard.shape)}")
        with torch.cuda.device(self.device):
            self._shard.copy_(shard, non_blocking=True)
            self._offset.fill_(int(offset))
            self._launch()

    def result(self):
        """The fold's top-2 ``(d1, i1, d2, i2)``, in new tensors."""
        if self._stream is None:
            raise DeviceError("result() before start()")
        with torch.cuda.device(self.device):
            top2 = tuple(t.clone() for t in self._top2)
            self._pool.record_done(self._stream)
        self._stream = None
        return top2


def _tensors_of(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors in a structure of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors_of(v)


class StageProgram(_Program):
    """``fn()`` recorded as a CUDA graph, where ``fn`` reads the tensors it
    needs in place: the static ``inputs`` given here, or static outputs of
    a program recorded before it in the same pool (a stage of the staged
    detector). ``program(*values)`` copies ``values`` into ``inputs``,
    replays and returns ``fn``'s result, a structure of tuples, lists and
    dicts whose tensors are the graph's own buffers: the next stage reads
    them, and whatever outlives the next call of the pool is copied out by
    the caller, who then calls the pool's :meth:`GraphPool.record_done`.

    Programs of one pool replay in the order they were recorded, or a later
    one's buffers may hold an earlier one's scratch: a stage is recorded
    after the stages whose outputs it reads, and those outputs are alive
    while it records, so its scratch never lies in them."""

    def __init__(self, fn: Callable[[], Any], *,
                 inputs: Sequence[torch.Tensor] = (),
                 device: DeviceLike = "cuda",
                 pool: Optional[GraphPool] = None):
        dev = resolve_device(device)
        self._inputs = tuple(inputs)
        self.outputs: Any = None

        def run() -> List[torch.Tensor]:
            self.outputs = fn()
            return list(_tensors_of(self.outputs))

        self._record(dev, run, pool)

    def __call__(self, *values: torch.Tensor) -> Any:
        with torch.cuda.device(self.device):
            self._begin()
            for dst, src in zip(self._inputs, values):
                dst.copy_(src, non_blocking=True)
            self._launch()
        return self.outputs

    def close(self) -> None:
        super().close()
        self.outputs = None


class LoopProgram(_Program):
    """``step(state, inputs) -> new state`` recorded as a CUDA graph whose
    last operations copy the new state into the static ``state`` buffers,
    so that replays chain on the device with no host work between them.
    ``step`` reads the static ``inputs`` in place and must not synchronise
    with the host (the capture fails if it does, and the failure raises).

    The static buffers start as copies of the ``state`` and ``inputs``
    given here, on ``state[0]``'s device; the warm-up runs one step on
    them. ``program(k, state, inputs)`` copies the values given (either
    may be left out, or cut short) into the static buffers, replays ``k``
    times and returns the final state in new tensors. A step may ignore
    the state it is given and write a result there: replayed once, that is
    a plain recorded function of its inputs (RANSAC's). Calls must not
    overlap (see :class:`ProgramCache`'s ``lock``)."""

    def __init__(self, step: Callable[[tuple, tuple], Sequence[torch.Tensor]],
                 state: Sequence[torch.Tensor],
                 inputs: Sequence[torch.Tensor] = (), *,
                 pool: Optional[GraphPool] = None):
        dev = state[0].device
        self.state = tuple(torch.empty_like(t, device=dev).copy_(t)
                           for t in state)
        self.inputs = tuple(torch.empty_like(t, device=dev).copy_(t)
                            for t in inputs)

        def run() -> List[torch.Tensor]:
            new = step(self.state, self.inputs)
            for dst, src in zip(self.state, new):
                dst.copy_(src)
            return []

        self._record(dev, run, pool)

    def __call__(self, k: int, state: Sequence[torch.Tensor] = (),
                 inputs: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
        with torch.cuda.device(self.device):
            stream = self._begin()
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src, non_blocking=True)
            for dst, src in zip(self.state, state):
                dst.copy_(src, non_blocking=True)
            for _ in range(k):
                self._launch()
            outs = [t.clone() for t in self.state]
            self._pool.record_done(stream)
        return outs

    def close(self) -> None:
        super().close()
        self.state = self.inputs = ()


class ProgramCache:
    """Programs under their keys, at most ``size`` of them (at least one),
    the least recently used closed first: the counterpart of a ``jax.jit``
    cache. ``get(key, build)`` returns the entry of ``key``, made by
    ``build()`` at its first use once the least recently used entries
    beyond ``size - 1`` are closed (so that their memory serves the new
    program). An entry is closed where it has ``close()``: on the CPU a
    cache holds eager functions under the same keys. ``pool(device)`` is
    the cache's :class:`GraphPool` for a device, for programs that share
    one. Reads as a mapping of keys to entries, least recently used first.

    A program's static buffers serve every call, so two calls must not
    overlap: a caller that may share the cache with other threads holds
    ``lock`` from ``get`` to the end of its call (``get`` and ``close``
    take it themselves)."""

    def __init__(self, size: int):
        self.size = size
        self.lock = threading.RLock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._pools: Dict[torch.device, GraphPool] = {}

    def pool(self, device: torch.device) -> GraphPool:
        with self.lock:
            return self._pools.setdefault(device, GraphPool())

    def get(self, key: Hashable, build: Callable[[], Any]) -> Any:
        with self.lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                trace.count("programs.hit")
                return self._entries[key]
            trace.count("programs.miss")
            while len(self._entries) >= max(self.size, 1):
                _close(self._entries.popitem(last=False)[1])
                trace.count("programs.evicted")
            entry = self._entries[key] = build()
            return entry

    def __getitem__(self, key: Hashable) -> Any:
        return self._entries[key]

    def __iter__(self) -> Iterator[Hashable]:
        return iter(list(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def items(self) -> List[tuple]:
        return list(self._entries.items())

    def values(self) -> List[Any]:
        return list(self._entries.values())

    def close(self) -> None:
        """Close every entry (the pools' memory is freed at the
        allocator's next ``empty_cache``)."""
        with self.lock:
            while self._entries:
                _close(self._entries.popitem(last=False)[1])


def _close(entry: Any) -> None:
    close = getattr(entry, "close", None)
    if close is not None:
        close()


class EagerStage:
    """The CPU's counterpart of a :class:`StageProgram`: the same ``fn`` on
    the same static inputs, run eagerly at each call (a program needs a
    card)."""

    def __init__(self, fn: Callable[[], Any], *,
                 inputs: Sequence[torch.Tensor] = ()):
        self._fn = fn
        self._inputs = tuple(inputs)
        self.outputs: Any = None

    def __call__(self, *values: torch.Tensor) -> Any:
        for dst, src in zip(self._inputs, values):
            dst.copy_(src)
        self.outputs = self._fn()
        return self.outputs

    def close(self) -> None:
        self.outputs = None
