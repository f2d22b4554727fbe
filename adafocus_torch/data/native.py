"""ctypes bindings for the native frame-loading core (native/frame_loader.cc).

The same API as adafocus_tpu/data/native.py. The library is built on first
use from the in-tree source with one ``g++ ... -ljpeg`` command into
``adafocus_torch/build/`` (named by a hash of the source, written to a
temporary name and renamed, so that concurrent builds never load a partial
file); nothing is written into ``native/``. Without g++ or libjpeg every
entry point returns None and ``FrameFolderSource`` decodes with PIL, the
JAX package's documented host path. ``describe()`` says which decoder is in
use, for the CLI's log.

The native core releases the GIL for the whole decode (ctypes foreign
calls drop it), so the thread pool of ``data/pipeline.py`` scales across
cores, and ``decode_batch`` fans one call out over an internal C++ worker
pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "frame_loader.cc")
BUILD_DIR = os.path.join(_ROOT, "adafocus_torch", "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_status = "not loaded yet"


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libframeloader-{digest}.so")


def _build() -> str:
    """The built library's path; raises ``OSError`` or
    ``subprocess.SubprocessError`` when it cannot be built."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", SOURCE,
             "-o", tmp, "-ljpeg", "-lpthread"],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_library() -> Optional[ctypes.CDLL]:
    """The shared library, building it if needed; None if unavailable."""
    global _lib, _tried, _status
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = _build()
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _status = (f"PIL (the native loader did not build or load: {e} "
                       f"{detail.decode(errors='replace').strip()[-300:]})")
            return None
        lib.afl_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.afl_decode_file.restype = ctypes.c_int
        lib.afl_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.afl_decode_batch.restype = ctypes.c_int
        _status = f"native libjpeg ({path})"
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def describe() -> str:
    """Which decoder ``FrameFolderSource`` uses: the native library or PIL,
    and why."""
    load_library()
    return _status


def decode_file(path: str, canvas: int) -> Optional[np.ndarray]:
    """Decode one JPEG to a (canvas, canvas, 3) uint8 array; None on error."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((canvas, canvas, 3), np.uint8)
    rc = lib.afl_decode_file(
        path.encode(), canvas,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None


def decode_batch(
    paths: Sequence[str], canvas: int, n_threads: int = 8
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Decode many JPEGs into one (N, canvas, canvas, 3) buffer with the
    C++ worker pool. Returns (frames, status) — status[i] != 0 marks a
    failed file (caller applies its fallback policy); (None, None) if the
    native library is unavailable."""
    lib = load_library()
    if lib is None:
        return None, None
    n = len(paths)
    out = np.empty((n, canvas, canvas, 3), np.uint8)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.afl_decode_batch(
        arr, n, canvas,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out, status
