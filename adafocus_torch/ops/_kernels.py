"""Build and load the CUDA kernels of ``adafocus_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``adafocus_torch/build/`` at first use and loaded with ``ctypes``; the
library's file name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. Nothing here includes PyTorch's headers, which keeps a build
to seconds. A source of ``PARTS`` is compiled as several units at once,
each with its part's macro set, and the units are linked into its library:
its kernel instances then build in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# a source compiled as units: {name: (the macro that selects the unit, units)};
# each source says which instances each unit holds
PARTS = {"int8_conv": ("INT8_CONV_PART", 12),
         "fused_bottleneck": ("FUSED_BOTTLENECK_PART", 10),
         "fused_inv_residual": ("FUSED_INV_RESIDUAL_PART", 10)}

_c_ptr, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each library's functions: {function name: argtypes}; every function
# returns an int (a launcher: the cudaError_t of its launch)
SIGNATURES = {
    "patch_extract": {
        # frames, offsets, actions, out, n, h, w, c, p, elem_size, span, t,
        # sb, st, sk, rows, grid, stream
        "patch_extract": [_c_ptr] * 4 + [_c_ll] + [_c_int] * 7 + [_c_ll] * 3 + [_c_int] * 2
                         + [_c_ptr],
    },
    "fused_inv_residual": {
        # x, w_exp, b_exp, w_dw, b_dw, w_prj, b_prj, out, n, h, w, cin, chid,
        # cout, stride, expand, use_res, th, tw, g, ch, ns, elem_size, stream
        "fused_inv_residual": [_c_ptr] * 8 + [_c_ll] + [_c_int] * 14 + [_c_ptr],
        # cout, ns, elem_size, smem -> blocks per SM (0 on error)
        "fused_inv_residual_blocks_per_sm": [_c_int] * 4,
    },
    "fused_bottleneck": {
        # x, w1, b1, w2, b2, w3, b3, wd, bd, out, n, h, w, cin, chid, cout,
        # stride, mode, th, tw, g, ns, stages, depth, wide, elem_size, stream
        "fused_bottleneck": [_c_ptr] * 10 + [_c_ll] + [_c_int] * 15 + [_c_ptr],
        # chid, ns, wide, elem_size, smem -> blocks per SM (0 on error)
        "fused_bottleneck_blocks_per_sm": [_c_int] * 5,
    },
    "int8_conv": {
        # x, x_scale, w, rescale, bias, res, out, outq, q_scale, ws, m,
        # in_kind, out_kind, res_relu, act, h, w, cin, ho, wo, cout, k,
        # ksteps, bk, bn, cout_pad, kh, stride, pad, nc, splits, stream
        "int8_conv": [_c_ptr] * 10 + [_c_ll] + [_c_int] * 20 + [_c_ptr],
        # x, x_scale, w9, rescale, bias, out, outq, q_scale, in_kind,
        # out_kind, act, n, h, w, c, ho, wo, stride, stream
        "int8_dwconv": [_c_ptr] * 8 + [_c_int] * 10 + [_c_ptr],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
# per-kernel nvcc output (``-Xptxas -v``: registers, shared memory, spills)
build_logs: Dict[str, str] = {}
# per-kernel wall seconds of the last build, from the start of the build
build_seconds: Dict[str, float] = {}


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


def _commands(nvcc: str, name: str, out: str) -> tuple:
    """(the compile commands of ``name``, run at once, each with the object
    it writes or None; the link command after them, or None)."""
    src = str(CSRC / f"{name}.cu")
    if name not in PARTS:
        return [([nvcc, *NVCC_FLAGS, "-o", out, src], None)], None
    macro, units = PARTS[name]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{out}.{p}.o" for p in range(units)]
    compiles = [([nvcc, *flags, f"-D{macro}={p}", "-c", "-o", obj, src], obj)
                for p, obj in enumerate(objs)]
    return compiles, [nvcc, *NVCC_FLAGS, "-o", out, *objs]


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named kernels (default: all) that are not built yet: every
    ``nvcc`` of every source (one, or one a unit of ``PARTS``) started
    together. Returns the wall seconds."""
    names = list(SIGNATURES if names is None else names)
    start = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        # build into a private temp name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        compiles, link = _commands(nvcc, name, tmp)
        # each compiler's output into a file: no pipe fills while another is read
        procs = []
        for cmd, obj in compiles:
            log = tempfile.TemporaryFile("w+", dir=BUILD_DIR)
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                           text=True), log, obj))
        jobs.append((name, tmp, procs, link))

    def finish(job):
        name, tmp, procs, link = job
        logs, rc = [], 0
        for proc, log, obj in procs:
            rc = proc.wait() or rc
            log.seek(0)
            logs.append(log.read())
            log.close()
        if rc == 0 and link is not None:
            linked = subprocess.run(link, capture_output=True, text=True)
            logs.append(linked.stdout + linked.stderr)
            rc = linked.returncode
        for _, _, obj in procs:
            if obj is not None and os.path.exists(obj):
                os.unlink(obj)
        return name, tmp, rc, "".join(logs), time.perf_counter() - start

    with ThreadPoolExecutor(len(jobs)) as pool:   # each library's end, as it comes
        done = list(pool.map(finish, jobs))
    failed = []
    for name, tmp, rc, out, seconds in done:
        build_logs[name] = out
        build_seconds[name] = seconds
        if rc != 0:
            if os.path.exists(tmp):   # a failed link removes its output
                os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {rc}):\n{out}")
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
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
