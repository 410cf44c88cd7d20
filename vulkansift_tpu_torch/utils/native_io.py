"""ctypes bindings for the native IO runtime (native/vksift_io.cpp).

Port of ``vulkansift_tpu/utils/native_io.py``, with the same API: PGM/PPM
decoding, a multi-threaded prefetching image loader (the host-side
analogue of the reference's double-buffered staging path), and
vksift_Feature-layout feature-file (de)serialization.

The library is built at first use from the repository's own
``native/vksift_io.cpp`` with ``g++`` and the flags of ``native/build.sh``,
into the git-ignored ``build/`` directory; a library whose name carries the
hash of the source and the flags is reused. Where there is no ``g++``,
:func:`available` returns False and pure-Python decode/serialize paths run
(no prefetching). Where ``g++`` is there and the build fails, the first
call raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..types import FEATURE_DTYPE

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "vksift_io.cpp"
BUILD_DIR = _ROOT / "build"
# native/build.sh's flags.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden",
             "-pthread")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvksift_io-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/vksift_io.cpp`` unless its library is up to date;
    returns the library's path. Raises when ``g++`` is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: cannot build the native IO library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native IO build failed (exit {res.returncode}):"
                           f"\n{res.stdout}{res.stderr}")
    tmp.replace(out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if shutil.which("g++") is None and not lib_path().exists():
            _lib = False
            return False
        lib = ctypes.CDLL(str(build()))
        lib.vksift_read_image_gray.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.vksift_read_image_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.vksift_free.argtypes = [ctypes.c_void_p]
        lib.vksift_loader_create.restype = ctypes.c_void_p
        lib.vksift_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.vksift_loader_next.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.vksift_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.vksift_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.vksift_save_features.restype = ctypes.c_int
        lib.vksift_save_features.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32]
        lib.vksift_load_features.restype = ctypes.c_void_p
        lib.vksift_load_features.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
        return lib


def available() -> bool:
    """True when the native library is built and loadable (building it
    at the first call where ``g++`` exists)."""
    return bool(_load())


# ---------------------------------------------------------------------------
# Image decode
# ---------------------------------------------------------------------------

def read_image_gray(path: str) -> np.ndarray:
    """Decode a PGM/PPM image to (H, W) uint8 grayscale."""
    lib = _load()
    if lib:
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = lib.vksift_read_image_gray(path.encode(), ctypes.byref(w),
                                         ctypes.byref(h))
        if not ptr:
            raise IOError(f"failed to decode {path}")
        try:
            arr = np.ctypeslib.as_array(ptr, (h.value, w.value)).copy()
        finally:
            lib.vksift_free(ptr)
        return arr
    return _read_pnm_python(path)


def _read_pnm_python(path: str) -> np.ndarray:
    """Pure-Python PGM/PPM fallback (binary variants)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens: List[bytes] = []
    i = 0
    while len(tokens) < 4 and i < len(data):
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        if data[i:i + 1].isspace():
            i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = (tokens[0], int(tokens[1]), int(tokens[2]),
                           int(tokens[3]))
    body = data[i + 1:]
    # Binary samples are 2-byte big-endian when maxval > 255 (matching the
    # native decoder); reading 1 byte/sample there would silently return a
    # wrong image (ADVICE round 1).
    wide = maxval > 255
    sdt = np.dtype(">u2") if wide else np.uint8
    nb = 2 if wide else 1
    if magic == b"P5":
        img = np.frombuffer(body[:w * h * nb], sdt).reshape(h, w)
        img = img.astype(np.uint32)
    elif magic == b"P6":
        rgb = np.frombuffer(body[:w * h * 3 * nb], sdt).reshape(h, w, 3)
        img = ((299 * rgb[..., 0].astype(np.uint32)
                + 587 * rgb[..., 1] + 114 * rgb[..., 2]) // 1000)
    elif magic in (b"P2", b"P3"):
        vals = np.array(body.split(), np.uint32)
        if magic == b"P2":
            img = vals[:w * h].reshape(h, w)
        else:
            rgb = vals[:w * h * 3].reshape(h, w, 3)
            img = (299 * rgb[..., 0] + 587 * rgb[..., 1]
                   + 114 * rgb[..., 2]) // 1000
        img = (img * 255 // maxval).astype(np.uint8)
    else:
        raise IOError(f"unsupported PNM magic {magic!r} in {path}")
    if magic in (b"P5", b"P6") and maxval != 255:
        img = img.astype(np.uint32) * 255 // maxval
    return img.astype(np.uint8)


# ---------------------------------------------------------------------------
# Prefetching loader
# ---------------------------------------------------------------------------

class ImageLoader:
    """Multi-threaded prefetching image loader (native; requires the built
    library). Iterate to receive (H, W) uint8 arrays in path order while
    worker threads decode ahead."""

    def __init__(self, paths: Sequence[str], nb_threads: int = 2,
                 prefetch: int = 4):
        lib = _load()
        if not lib:
            raise RuntimeError(
                "native IO library unavailable (no g++ to build it)")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.vksift_loader_create(arr, len(self._paths),
                                                nb_threads, prefetch)
        self._remaining = len(paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._remaining == 0:
            raise StopIteration
        w = ctypes.c_int()
        h = ctypes.c_int()
        ptr = self._lib.vksift_loader_next(self._handle, ctypes.byref(w),
                                           ctypes.byref(h))
        self._remaining -= 1
        if not ptr:
            raise IOError("decode failed in loader")
        try:
            return np.ctypeslib.as_array(ptr, (h.value, w.value)).copy()
        finally:
            self._lib.vksift_free(ptr)

    def close(self) -> None:
        if self._handle:
            self._lib.vksift_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Feature files
# ---------------------------------------------------------------------------

def save_features(path: str, feats: np.ndarray) -> None:
    """Write a FEATURE_DTYPE array as a binary feature file."""
    if feats.dtype != FEATURE_DTYPE:
        raise ValueError("expected FEATURE_DTYPE array")
    lib = _load()
    data = np.ascontiguousarray(feats)
    if lib:
        rc = lib.vksift_save_features(
            path.encode(), data.ctypes.data_as(ctypes.c_void_p), len(feats))
        if rc != 0:
            raise IOError(f"failed to write {path}")
        return
    with open(path, "wb") as f:
        f.write(np.array([0x54464956, len(feats)], np.uint32).tobytes())
        f.write(data.tobytes())


def load_features(path: str) -> np.ndarray:
    """Read a binary feature file into a FEATURE_DTYPE array."""
    lib = _load()
    if lib:
        nb = ctypes.c_uint32()
        ptr = lib.vksift_load_features(path.encode(), ctypes.byref(nb))
        if not ptr:
            raise IOError(f"failed to read {path}")
        try:
            buf = ctypes.string_at(ptr, nb.value * FEATURE_DTYPE.itemsize)
        finally:
            lib.vksift_free(ptr)
        return np.frombuffer(buf, FEATURE_DTYPE).copy()
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(8), np.uint32)
        if header[0] != 0x54464956:
            raise IOError(f"bad magic in {path}")
        return np.frombuffer(f.read(int(header[1]) * FEATURE_DTYPE.itemsize),
                             FEATURE_DTYPE).copy()
