"""Build, load and dispatch the port's hand-written CUDA kernels.

Each source under ``vulkansift_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface, loaded
through ``ctypes``. The build runs at first use into the repository's
git-ignored ``build/`` directory, one ``nvcc`` per source, all started
together; a library whose name carries the hash of its source and flags is
reused. A failed build raises.

Every C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``. Wrappers call it through
:func:`launch`, which makes the call under the tensor's device (a C launch
goes to the calling thread's current device) with that device's current
stream, and raises on a non-zero code.

Dispatch rule of every wrapper (:func:`use_kernel`): a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel. The only way a
CUDA tensor reaches a plain version is an explicit :func:`force_plain`
block, which exists so that a run on the card can compare the whole
pipeline with its plain counterpart; the block holds for its own thread
only.

Every wrapper counts its launches in its ``launches`` attribute through
:func:`count_launch` (:func:`counted` gives it the attribute and reports
it in ``utils.trace.counters``). A launch made while its thread records a
CUDA graph (:func:`recording`) runs no kernel: it goes to the recording,
which the graph's owner adds to the counts at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..errors import DeviceError
from ..utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("blur_dog", "frontend", "orientation_hist", "descriptor",
           "match_2nn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Built with --fmad=false: the blur, the frontend's walk code and the
# histogram's per-cell terms reproduce the plain versions' float rounding,
# which a fused multiply-add would change (the integer matcher is kept as
# it was measured). The descriptor, held to a u8 tolerance, contracts
# freely.
NO_FMAD = ("blur_dog", "frontend", "orientation_hist", "match_2nn")


def nvcc_flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for the kernel source ``name``."""
    return NVCC_FLAGS + (("--fmad=false",) if name in NO_FMAD else ())

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_local = threading.local()  # .force_plain, .recording, .load_s (below)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise DeviceError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    # -Xptxas -v only reports, so it is not part of the hash.
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"libvks_{name}-{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Dict[str, dict]:
    """Compile every kernel source that has no up-to-date library, in
    parallel. Returns per source: the library path, whether it was built,
    the wall seconds of the whole build and nvcc's output (which holds the
    register and shared-memory report when ``verbose``)."""
    t0 = time.perf_counter()
    try:
        with trace.span("kernels.build"):
            return _build(verbose)
    finally:
        _loaded(time.perf_counter() - t0)


def _loaded(seconds: float) -> None:
    trace.count("kernels.load_s", seconds)
    _local.load_s = thread_load_seconds() + seconds


def thread_load_seconds() -> float:
    """Seconds the calling thread has spent building and loading the
    kernel libraries (its share of the ``kernels.load_s`` counter)."""
    return getattr(_local, "load_s", 0.0)


def _build(verbose: bool) -> Dict[str, dict]:
    extra = ("-Xptxas", "-v") if verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    info = {}
    for name in SOURCES:
        out = _lib_path(name)
        info[name] = {"path": str(out), "built": False, "log": ""}
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_flags(name), *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        info[name]["log"] = log
        info[name]["built"] = True
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        tmp.replace(out)
    if failed:
        raise DeviceError("kernel build failed: " + "\n".join(failed))
    secs = time.perf_counter() - t0
    for v in info.values():
        v["seconds"] = secs
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (building all at first
    use)."""
    with _lock:
        if name not in _libs:
            with trace.span("kernels.load", name):
                path = _lib_path(name)
                if not path.exists():
                    build()
                t0 = time.perf_counter()
                _libs[name] = ctypes.CDLL(str(path))
                _loaded(time.perf_counter() - t0)
        return _libs[name]


def entry(source: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of a kernel source's library, with its
    argument types set (pointers and the stream as ``c_void_p``) and an
    ``int`` (cudaError_t) result. Resolved once per (source, symbol) and
    kept, since the wrappers call this on every launch."""
    fn = _entries.get((source, symbol))
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(source, symbol)] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise DeviceError(f"CUDA kernel {name} failed to launch: "
                          f"cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(fn, t: torch.Tensor, name: str, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``t``'s device
    current, so that the kernel runs where ``t`` lies and not on whatever
    device the calling thread has current; raise if it returns an error."""
    with torch.cuda.device(t.device):
        rc = fn(*args, stream_of(t))
    check(rc, name)


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper given ``t`` must launch its kernel, False when
    it runs its plain version (a CPU tensor, or inside
    :func:`force_plain`). Any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise DeviceError(f"no kernel for device {t.device}")
    return not plain_forced()


def plain_forced() -> bool:
    """True inside :func:`force_plain` on the calling thread."""
    return getattr(_local, "force_plain", False)


@contextlib.contextmanager
def force_plain() -> Iterator[None]:
    """Run every wrapper's plain version, CUDA tensors included, inside the
    block and on the calling thread only (for comparing the whole pipeline
    with its plain counterpart). Other threads keep launching kernels."""
    prev = getattr(_local, "force_plain", False)
    _local.force_plain = True
    try:
        yield
    finally:
        _local.force_plain = prev


def counted(wrapper):
    """Give a kernel wrapper its ``launches`` count, reported as
    ``launches.<name>`` by ``utils.trace.counters``."""
    wrapper.launches = 0
    trace.gauge(f"launches.{wrapper.__name__}", lambda: wrapper.launches)
    return wrapper


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` for a launch of its kernel; inside
    :func:`recording` on this thread, add it to the recording instead."""
    rec = getattr(_local, "recording", None)
    if rec is None:
        wrapper.launches += 1
    else:
        rec[wrapper] = rec.get(wrapper, 0) + 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[object, int]]:
    """Collect the calling thread's launches inside the block as ``{wrapper:
    launches}`` without counting them (a CUDA graph's capture, whose
    launches run only when it is replayed)."""
    prev = getattr(_local, "recording", None)
    _local.recording = rec = {}
    try:
        yield rec
    finally:
        _local.recording = prev


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            ndim: Optional[int] = None) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
