"""A recorded program's plumbing on the CPU: ``compiled._Program`` with its
CUDA graph replaced by a call of the recorded function.

A test module takes the fixture by importing it::

    from program_stubs import graphs_as_calls  # noqa: F401

:func:`card_stubs` alone stubs the card's stream, done event, device
context and pinned memory, for a test that records its programs its own
way."""

import time

import pytest
import torch

from vulkansift_tpu_torch import compiled
from vulkansift_tpu_torch.ops import cuda_lib


class CallGraph:
    """A captured graph stood in for by the recorded function: a replay
    writes its results into the outputs of the recording."""

    def __init__(self, run, outs):
        self.run, self.outs = run, outs

    def replay(self):
        for dst, src in zip(self.outs, self.run()):
            dst.copy_(src)

    def reset(self):
        pass


class NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def record_graph(self, device, run, pool):
    """``_Program._record_graph`` with the warm-up run as the recording
    and no capture."""
    self.device, self._pool = device, pool or compiled.GraphPool()
    t0 = time.perf_counter()
    with cuda_lib.recording() as launches:
        outs = run()
    self.warmup_seconds, self.capture_seconds = \
        time.perf_counter() - t0, 0.0
    self._graph = CallGraph(run, outs)
    self.replays, self._launches, self._outputs = 0, launches, outs


def card_stubs(monkeypatch) -> None:
    monkeypatch.setattr(compiled._Program, "_begin", lambda self: None)
    monkeypatch.setattr(compiled.GraphPool, "record_done",
                        lambda self, stream: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: NoDevice())
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)


@pytest.fixture
def graphs_as_calls(monkeypatch):
    """``compiled._Program`` with its CUDA graph replaced by a call of the
    recorded function (and the card's stream, event and pinned memory
    stubbed), so that a program's plumbing runs on the CPU."""
    monkeypatch.setattr(compiled._Program, "_record_graph", record_graph)
    card_stubs(monkeypatch)
