"""Build and load the CUDA kernels of ``adafocus_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``adafocus_torch/build/`` at first use and loaded with ``ctypes``; the
library's file name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. Nothing here includes PyTorch's headers, which keeps a build
to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# launcher signatures: (function name, argtypes); every launcher returns the
# cudaError_t of its launch as an int
SIGNATURES = {
    "patch_extract": (
        "patch_extract",
        [_c_ptr, _c_ptr, _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int,
         _c_ptr],
    ),
    # x, w_exp, b_exp, w_dw, b_dw, w_prj, b_prj, out, n, h, w, cin, chid,
    # cout, stride, expand, use_res, th, tw, g, ch, elem_size, stream
    "fused_inv_residual": (
        "fused_inv_residual", [_c_ptr] * 8 + [_c_ll] + [_c_int] * 13 + [_c_ptr],
    ),
    # x, w1, b1, w2, b2, w3, b3, wd, bd, out, n, h, w, cin, chid, cout,
    # stride, mode, th, tw, g, elem_size, stream
    "fused_bottleneck": (
        "fused_bottleneck", [_c_ptr] * 10 + [_c_ll] + [_c_int] * 11 + [_c_ptr],
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}
# per-kernel nvcc output (``-Xptxas -v``: registers, shared memory, spills)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns the wall seconds."""
    names = list(SIGNATURES if names is None else names)
    start = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        # build into a private temp name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
