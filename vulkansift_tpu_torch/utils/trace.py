"""Spans and counters at the boundaries of the port's layers.

Spans time what a public call does inside the program. Each records its
name, an optional detail (a program's key, a library's name), its start
and end on ``time.time_ns()`` (the clock ``torch.profiler`` stamps its
host and device events with, so that a span and a device interval compare
directly), the span that encloses it on the same thread and the id of the
public call it belongs to: the id of its root span, so every span of one
``SiftInstance.detect_features`` call shares that call's id. Spans are off
by default; a span site then costs one test of a flag, with no allocation
and no clock read. :func:`start` turns them on into a preallocated buffer,
:func:`stop` turns them off and returns what was recorded: whoever starts
them drains them. ``SiftInstance.start_trace`` starts them and
``stop_trace`` writes them into the profiler's Chrome trace
(:func:`chrome_events`).

Counters are process-wide sums, always on, read together by
:func:`counters`:

* ``programs.hit``, ``programs.miss``, ``programs.evicted``: lookups of
  recorded programs (``compiled.ProgramCache`` and an instance's match
  programs) and the programs an LRU closed to make room;
* ``programs.record_s``: seconds spent recording programs (each
  program's ``warmup_seconds`` plus ``capture_seconds``), less the kernel
  libraries' seconds its thread spent inside;
* ``kernels.load_s``: seconds spent building (``nvcc``) and loading the
  kernel libraries;
* ``host_reads``: blocking reads of device data by the host, one a
  tensor copied (counted on every device, so a CPU run counts what a card
  run reads);
* ``compiled.upload_bytes``, ``compiled.copy_out_bytes``: bytes a
  recorded program's call copies from host memory into its static inputs
  (a detect's frame; a match's descriptor blocks and counts where they
  are on the host, which on a card they are not) and copies out of its
  static outputs (a detect's retained pyramid included), at the
  ``compiled.upload`` and ``compiled.copy_out`` spans;
* ``launches.<wrapper>``: each kernel wrapper's own ``launches`` count,
  read from the wrapper (:func:`gauge`; ``ops.cuda_lib.counted``
  registers every wrapper).

Span names, by layer: a root per public ``SiftInstance`` call, named after
it; ``instance.prepare`` (validation, bucketing, padding, the program
lookup), ``instance.store`` (a detect's results into its buffer, the last
ones released) and ``instance.count_sync`` (the host's wait for a count);
``compiled.upload``, ``compiled.replay``, ``compiled.copy_out`` and
``compiled.record`` (recorded programs, on a card only);
``types.to_host`` (the field copies of a download); ``kernels.build`` and
``kernels.load`` (the kernel libraries).
"""

from __future__ import annotations

import array
import functools
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, TypeVar

CAPACITY = 1 << 16  # spans a buffer holds unless start() is told otherwise

F = TypeVar("F", bound=Callable)


class Span(NamedTuple):
    id: int
    name: str
    detail: Optional[str]
    start_ns: int
    end_ns: int
    parent: int   # id of the enclosing span, -1 for a root
    call: int     # id of the root span: the public call
    thread: int   # native id of the thread that ran it


class _Buffer:
    """Columns of ``capacity`` spans, allocated when recording starts, in
    arrays that the garbage collector does not traverse; names are
    indexes into a table."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.take = itertools.count().__next__   # atomic under the GIL
        zeros = bytes(8 * capacity)
        self.name, self.start, self.end, self.parent, self.call, \
            self.thread = (array.array("q", zeros) for _ in range(6))
        self.names: List[str] = []
        self.index: Dict[str, int] = {}
        self.details: Dict[int, str] = {}
        self.lock = threading.Lock()

    def name_index(self, name: str) -> int:
        i = self.index.get(name)
        if i is None:
            with self.lock:
                i = self.index.setdefault(name, len(self.names))
                if i == len(self.names):
                    self.names.append(name)
        return i

    def spans(self) -> List[Span]:
        """The spans closed so far, in the order they opened."""
        n = min(self.take(), self.capacity)
        return [Span(i, self.names[self.name[i]], self.details.get(i),
                     self.start[i], self.end[i], self.parent[i],
                     self.call[i], self.thread[i])
                for i in range(n) if self.end[i]]


_buffer: Optional[_Buffer] = None   # recording while not None
_local = threading.local()          # .open: its open spans; .thread: its id


class _Off:
    """What a span site gets while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Open:
    """One span being recorded into ``buf``."""

    __slots__ = ("buf", "name", "detail", "i")

    def __init__(self, buf: _Buffer, name: str, detail: Optional[str]):
        self.buf, self.name, self.detail = buf, name, detail

    def __enter__(self) -> "_Open":
        buf = self.buf
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
            _local.thread = threading.get_native_id()
        top = stack[-1] if stack else None
        stack.append(self)
        self.i = i = buf.take()
        if i >= buf.capacity:
            self.i = -1
            return self
        parent = top.i if top is not None and top.buf is buf else -1
        buf.name[i] = buf.name_index(self.name)
        if self.detail is not None:
            buf.details[i] = self.detail
        buf.parent[i] = parent
        buf.call[i] = buf.call[parent] if parent >= 0 else i
        buf.thread[i] = _local.thread
        buf.start[i] = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _local.open.pop()
        if self.i >= 0:
            self.buf.end[self.i] = end
        return False


def span(name: str, detail: Optional[str] = None):
    """A context manager that records ``name`` around its block while
    spans are on, and does nothing while they are off."""
    buf = _buffer
    if buf is None:
        return _OFF
    return _Open(buf, name, detail)


def traced(fn: F) -> F:
    """Record each call of ``fn`` as a span named after it (the root span
    of a public call)."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        buf = _buffer
        if buf is None:
            return fn(*args, **kwargs)
        with _Open(buf, name, None):
            return fn(*args, **kwargs)
    return call  # type: ignore[return-value]


def recording() -> bool:
    """True while spans are on."""
    return _buffer is not None


def start(capacity: int = CAPACITY) -> None:
    """Turn spans on into a new buffer of ``capacity`` spans (spans past
    it are not recorded). Raises if they are on already."""
    global _buffer
    if _buffer is not None:
        raise RuntimeError("spans are already being recorded")
    _buffer = _Buffer(capacity)


def stop() -> List[Span]:
    """Turn spans off and return those recorded since :func:`start`
    (spans still open are left out)."""
    global _buffer
    buf, _buffer = _buffer, None
    if buf is None:
        raise RuntimeError("spans are not being recorded")
    return buf.spans()


def chrome_events(spans: List[Span], base_ns: int = 0) -> List[dict]:
    """Chrome trace events (``"ph": "X"``, microseconds from ``base_ns``,
    the trace's ``baseTimeNanoseconds``) of ``spans``, in this process and
    on the threads that ran them."""
    pid = os.getpid()
    out = []
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "call": s.call}
        if s.detail is not None:
            args["detail"] = s.detail
        out.append({"ph": "X", "cat": "vulkansift_tpu_torch", "name": s.name,
                    "pid": pid, "tid": s.thread,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


_lock = threading.Lock()
_counts: Dict[str, float] = {
    "programs.hit": 0, "programs.miss": 0, "programs.evicted": 0,
    "programs.record_s": 0.0, "kernels.load_s": 0.0, "host_reads": 0,
    "compiled.upload_bytes": 0, "compiled.copy_out_bytes": 0}
_gauges: Dict[str, Callable[[], float]] = {}


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :func:`counters`'s)."""
    with _lock:
        _counts[name] += n


def gauge(name: str, read: Callable[[], float]) -> None:
    """Report ``read()`` as ``name`` in every :func:`counters` snapshot (a
    count kept elsewhere, such as a kernel wrapper's ``launches``)."""
    _gauges[name] = read


def counters() -> Dict[str, float]:
    """A snapshot of every counter and gauge."""
    with _lock:
        out = dict(_counts)
    out.update((name, read()) for name, read in list(_gauges.items()))
    return out
