"""The port's device guard and error contract, on the CPU.

* Every kernel wrapper makes its C launch under ``torch.cuda.device`` of
  its tensor's device, with that device's stream: the entry point,
  ``torch.cuda.device`` and ``torch.cuda.current_stream`` are stubbed, and
  ``use_kernel`` is forced on, so a CPU tensor takes the launch path.
* The descriptor's output carries the kernel's work counter after its
  rows, as ``csrc/descriptor.cu`` expects; the orientation histogram's is
  the K x 36 rows alone, which ``csrc/orientation_hist.cu`` writes in
  full.
* ``SiftInstance.detect_features`` and ``match_features`` turn any failure
  other than invalid input into ``DeviceError`` plus
  ``on_error(Result.DEVICE_ERROR)``, as the JAX instance does for the same
  injected failure; ``InvalidInputError`` passes through unchanged.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from conftest import make_blob_image
import vulkansift_tpu as jvs
import vulkansift_tpu.instance as jinstance
import vulkansift_tpu_torch as vt
import vulkansift_tpu_torch.instance as tinstance
from vulkansift_tpu_torch.ops import backhalf, blur, cuda_lib, frontend, match
from vulkansift_tpu_torch.ops.patches import SampleRecords


class _Guards:
    """Stubs of ``torch.cuda.device`` and ``current_stream`` that record
    the devices asked for, and an entry point that records the guard in
    force when it is called."""

    def __init__(self):
        self.active = []
        self.streams = []
        self.calls = []

    def device(self, dev):
        @contextlib.contextmanager
        def guard():
            self.active.append(torch.device(dev))
            try:
                yield
            finally:
                self.active.pop()
        return guard()

    def current_stream(self, dev=None):
        self.streams.append(torch.device(dev))

        class _S:
            cuda_stream = 0
        return _S()

    def entry(self, source, symbol, argtypes):
        def fn(*args):
            self.calls.append((symbol, list(self.active), len(args),
                               len(argtypes)))
            return 0
        return fn


def _records(k, w=12, h=10):
    rec = torch.zeros((k, 8), dtype=torch.float32)
    rec[:, 2] = 1.6                       # sigma
    rec[:, 3], rec[:, 4] = 5.0, 4.0       # centre
    rec[:, 5], rec[:, 6] = float(w), float(h)
    return SampleRecords(torch.zeros(k, dtype=torch.int64), rec)


def _launch_blur():
    return blur.blur_dog, lambda: blur.blur_dog(
        torch.zeros((6, 7)), [0.5, 0.25])


def _launch_frontend():
    return frontend.frontend, lambda: frontend.frontend(
        torch.zeros((5, 6, 7)), 0.01)


def _launch_orientation():
    return backhalf.orientation_hist, lambda: backhalf.orientation_hist(
        torch.zeros(120), _records(3), torch.tensor(2, dtype=torch.int32),
        ori_radius=4)


def _launch_descriptor():
    return backhalf.descriptor, lambda: backhalf.descriptor(
        torch.zeros(120), _records(3), torch.tensor(2, dtype=torch.int32),
        desc_radius=4, use_vlfeat=False)


def _launch_match():
    d = torch.zeros((4, 128), dtype=torch.uint8)
    return match.match_2nn_tiles, lambda: match.match_2nn_tiles(d, 4, d, 3)


@pytest.mark.parametrize("case", [_launch_blur, _launch_frontend,
                                  _launch_orientation, _launch_descriptor,
                                  _launch_match],
                         ids=["blur_dog", "frontend", "orientation_hist",
                              "descriptor", "match_2nn"])
def test_wrapper_launches_under_the_tensors_device(case, monkeypatch):
    g = _Guards()
    monkeypatch.setattr(cuda_lib, "use_kernel", lambda t: True)
    monkeypatch.setattr(cuda_lib, "entry", g.entry)
    monkeypatch.setattr(torch.cuda, "device", g.device)
    monkeypatch.setattr(torch.cuda, "current_stream", g.current_stream)
    wrapper, call = case()
    before = wrapper.launches
    call()
    assert len(g.calls) == 1
    symbol, active, nargs, nargtypes = g.calls[0]
    # Called inside exactly one guard, of the input's device (cpu here),
    # with the stream of that device as its last argument.
    assert active == [torch.device("cpu")], symbol
    assert g.streams == [torch.device("cpu")]
    assert nargs == nargtypes
    assert g.active == []
    assert wrapper.launches == before + 1


def test_descriptor_output_holds_the_work_counter(monkeypatch):
    """The descriptor's C entry point finds its int32 work counter, zero,
    in the element after the K x 128 rows of its output
    (``csrc/descriptor.cu``); the rows start zeroed."""
    g = _Guards()
    monkeypatch.setattr(torch.cuda, "device", g.device)
    monkeypatch.setattr(torch.cuda, "current_stream", g.current_stream)
    seen = []

    def fn(*args):
        seen.append(args)
        return 0
    desc = backhalf._launch_descriptor(
        fn, torch.zeros(120), _records(3), torch.tensor(2, dtype=torch.int32),
        4, False, "descriptor")
    (args,) = seen
    assert len(args) == len(backhalf._DESC_ARGTYPES)
    assert desc.shape == (3, 128) and args[4] == desc.data_ptr()
    assert args[5:8] == (3, 4, 0)
    whole = torch.empty(0).set_(desc.untyped_storage(), 0, (3 * 128 + 1,))
    assert not whole.any() and whole.view(torch.int32)[-1].item() == 0


@pytest.mark.parametrize("capacity", [3, 0])
def test_orientation_output_is_what_the_kernel_writes(capacity, monkeypatch):
    """The histogram's C entry point gets a K x 36 float output of its own
    and writes every row (``csrc/orientation_hist.cu`` zeroes the rows past
    the count, so there is no fill and no work counter): the stub writes a
    pattern through the pointer, and the helper returns exactly it, row
    major."""
    g = _Guards()
    monkeypatch.setattr(torch.cuda, "device", g.device)
    monkeypatch.setattr(torch.cuda, "current_stream", g.current_stream)
    seen = []
    pattern = np.arange(capacity * 36, dtype=np.float32) + 0.5

    def fn(*args):
        seen.append(args)
        out = (ctypes.c_float * (args[5] * 36)).from_address(args[4])
        ctypes.memmove(out, pattern.ctypes.data, pattern.nbytes)
        return 0
    flat, recs = torch.zeros(120), _records(capacity)
    count = torch.tensor(2, dtype=torch.int32)
    hist = backhalf._launch_orientation_hist(fn, flat, recs, count, 4,
                                             "orientation_hist")
    (args,) = seen
    assert len(args) == len(backhalf._HIST_ARGTYPES)
    assert args[:4] == (flat.data_ptr(), recs.base.data_ptr(),
                        recs.rec.data_ptr(), count.data_ptr())
    assert args[5:7] == (capacity, 4) and args[7] == 0  # the stream
    assert hist.shape == (capacity, 36) and hist.dtype == torch.float32
    assert hist.is_contiguous() and hist.storage_offset() == 0
    assert args[4] == hist.untyped_storage().data_ptr()
    assert hist.untyped_storage().nbytes() == pattern.nbytes
    np.testing.assert_array_equal(hist.numpy().ravel(), pattern)


def test_orientation_launch_into_a_given_output(monkeypatch):
    """A caller may hand the helper its own K x 36 output (a zero-filled one
    for kernels that leave the rows past the count alone, a NaN-filled one
    to see that the kernel writes them): the entry point gets that very
    buffer, and an output of another shape, type or layout is refused
    before any launch."""
    g = _Guards()
    monkeypatch.setattr(torch.cuda, "device", g.device)
    monkeypatch.setattr(torch.cuda, "current_stream", g.current_stream)
    seen = []

    def fn(*args):
        seen.append(args)
        return 0
    flat, recs = torch.zeros(120), _records(3)
    count = torch.tensor(2, dtype=torch.int32)
    mine = torch.full((3, 36), float("nan"))
    out = backhalf._launch_orientation_hist(fn, flat, recs, count, 4,
                                            "orientation_hist", hist=mine)
    assert out is mine and seen[0][4] == mine.data_ptr()
    for bad in (torch.zeros((4, 36)),
                torch.zeros((3, 36), dtype=torch.float64),
                torch.zeros((36, 3)).t()):
        with pytest.raises(ValueError, match="hist"):
            backhalf._launch_orientation_hist(fn, flat, recs, count, 4,
                                              "orientation_hist", hist=bad)
    assert len(seen) == 1


def test_launch_raises_on_a_kernel_error(monkeypatch):
    g = _Guards()
    monkeypatch.setattr(torch.cuda, "device", g.device)
    monkeypatch.setattr(torch.cuda, "current_stream", g.current_stream)
    with pytest.raises(vt.DeviceError, match="cudaError 1"):
        cuda_lib.launch(lambda *a: 1, torch.zeros(1), "k", 7)
    assert g.active == []


# -- error contract ----------------------------------------------------------

def _cfg_kw():
    return dict(use_input_upsampling=False, max_nb_sift_per_buffer=256,
                input_image_max_size=64 * 64)


def _raising(exc):
    def make(*args, **kwargs):
        def fn(*a, **k):
            raise exc
        return fn
    return make


@pytest.mark.parametrize("exc", [ValueError("bad kernel argument"),
                                 TypeError("bad type"),
                                 RuntimeError("launch failed")],
                         ids=["ValueError", "TypeError", "RuntimeError"])
def test_detect_failure_is_device_error_like_jax(exc, monkeypatch):
    img = make_blob_image(64, 64, seed=1, nb_blobs=6)
    seen = {"jax": [], "torch": []}
    monkeypatch.setattr(jinstance, "make_detect_fn", _raising(exc))
    monkeypatch.setattr(tinstance, "make_detect_fn", _raising(exc))
    j = jvs.SiftInstance(jvs.SiftConfig(**_cfg_kw()),
                         on_error=seen["jax"].append)
    t = vt.SiftInstance(vt.SiftConfig(**_cfg_kw()),
                        on_error=seen["torch"].append, device="cpu")
    with pytest.raises(jvs.DeviceError) as ej:
        j.detect_features(img, 0)
    with pytest.raises(vt.DeviceError) as et:
        t.detect_features(img, 0)
    assert et.value.__cause__ is exc and ej.value.__cause__ is exc
    assert seen["torch"] == [vt.Result.DEVICE_ERROR]
    assert [r.name for r in seen["jax"]] == ["DEVICE_ERROR"]


def test_match_failure_is_device_error_like_jax(monkeypatch):
    exc = ValueError("counts: expected one int32 on the descriptors' device")
    seen = {"jax": [], "torch": []}
    monkeypatch.setattr(jinstance, "match_2nn_auto", _raising(exc)())
    monkeypatch.setattr(tinstance, "match_2nn_fused", _raising(exc)())
    j = jvs.SiftInstance(jvs.SiftConfig(**_cfg_kw()),
                         on_error=seen["jax"].append)
    t = vt.SiftInstance(vt.SiftConfig(**_cfg_kw()),
                        on_error=seen["torch"].append, device="cpu")
    with pytest.raises(jvs.DeviceError) as ej:
        j.match_features(0, 1)
    with pytest.raises(vt.DeviceError) as et:
        t.match_features(0, 1)
    assert et.value.__cause__ is exc and ej.value.__cause__ is exc
    assert seen["torch"] == [vt.Result.DEVICE_ERROR]
    assert [r.name for r in seen["jax"]] == ["DEVICE_ERROR"]
    # The instance stays usable.
    t.upload_features(np.zeros(3, vt.FEATURE_DTYPE), 0)
    assert t.get_features_number(0) == 3


def test_invalid_input_passes_through_unchanged(monkeypatch):
    img = make_blob_image(64, 64, seed=1, nb_blobs=6)
    exc_t = vt.InvalidInputError("rejected inside the pipeline")
    exc_j = jvs.InvalidInputError("rejected inside the pipeline")
    monkeypatch.setattr(tinstance, "make_detect_fn", _raising(exc_t))
    monkeypatch.setattr(jinstance, "make_detect_fn", _raising(exc_j))
    monkeypatch.setattr(tinstance, "match_2nn_fused", _raising(exc_t)())
    seen = {"jax": [], "torch": []}
    j = jvs.SiftInstance(jvs.SiftConfig(**_cfg_kw()),
                         on_error=seen["jax"].append)
    t = vt.SiftInstance(vt.SiftConfig(**_cfg_kw()),
                        on_error=seen["torch"].append, device="cpu")
    with pytest.raises(jvs.InvalidInputError) as ej:
        j.detect_features(img, 0)
    with pytest.raises(vt.InvalidInputError) as et:
        t.detect_features(img, 0)
    assert ej.value is exc_j and et.value is exc_t
    with pytest.raises(vt.InvalidInputError) as et:
        t.match_features(0, 1)
    assert et.value is exc_t
    assert seen == {"jax": [], "torch": []}
