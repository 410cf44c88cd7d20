"""Build, load and dispatch the port's hand-written CUDA kernels.

Each source under ``vulkansift_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface, loaded
through ``ctypes``. The build runs at first use into the repository's
git-ignored ``build/`` directory, one ``nvcc`` per source, all started
together; a library whose name carries the hash of its source and flags is
reused. A failed build raises.

Every C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.

Dispatch rule of every wrapper (:func:`use_kernel`): a CPU tensor takes the
plain PyTorch version, a CUDA tensor launches the kernel. The only way a
CUDA tensor reaches a plain version is an explicit :func:`force_plain`
block, which exists so that a run on the card can compare the whole
pipeline with its plain counterpart; the block holds for its own thread
only.
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
from typing import Dict, Iterator, Optional

import torch

from ..errors import DeviceError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("blur_dog", "frontend", "orientation_hist", "descriptor")
# --fmad=false: the blur and the Newton walk code reproduce the plain
# versions' float rounding, which a fused multiply-add would change.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_local = threading.local()  # .force_plain, set inside force_plain()


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
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvks_{name}-{digest.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Dict[str, dict]:
    """Compile every kernel source that has no up-to-date library, in
    parallel. Returns per source: the library path, whether it was built,
    the wall seconds of the whole build and nvcc's output (which holds the
    register and shared-memory report when ``verbose``)."""
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
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
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
            path = _lib_path(name)
            if not path.exists():
                build()
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def entry(source: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of a kernel source's library, with its
    argument types set (pointers and the stream as ``c_void_p``) and an
    ``int`` (cudaError_t) result."""
    fn = getattr(library(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise DeviceError(f"CUDA kernel {name} failed to launch: "
                          f"cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper given ``t`` must launch its kernel, False when
    it runs its plain version (a CPU tensor, or inside
    :func:`force_plain`). Any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise DeviceError(f"no kernel for device {t.device}")
    return not getattr(_local, "force_plain", False)


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


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            ndim: Optional[int] = None) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
