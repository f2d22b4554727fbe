#!/usr/bin/env python3
"""Phase 2's kernel build, two or more checkouts of the port on one host.

    python3 port_build_times.py LABEL=TREE[:FLAGS] ...

Each TREE is the root of a checkout of this repository; FLAGS, split on
commas, are added to that tree's ``NVCC_FLAGS`` (for instance
``--split-compile=0``). Each variant builds every kernel library of its
tree as ``chip_smoke.build_kernels`` does (each library's
``_kernels.build`` in a thread of its own, every ``nvcc`` at once), in a
fresh process and a fresh build directory, in the order given and then in
the reverse order, so that each is built twice and a drift of the host
falls on all alike. Prints one JSON line a build (the wall seconds, and
each library's end from the build's start) and, on each variant's first
build, each library's SASS size and a hash of its sorted instructions (the
same hash: the same code), then one line of all of them.
"""

from __future__ import annotations

import json
import subprocess
import sys

_CHILD = r'''
import hashlib, json, os, subprocess, sys, tempfile, time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
root, extra, dump = sys.argv[1], [f for f in sys.argv[2].split(",") if f], sys.argv[3] == "1"
sys.path.insert(0, root)
from adafocus_torch.ops import _kernels
_kernels.BUILD_DIR = Path(tempfile.mkdtemp())
_kernels.NVCC_FLAGS = tuple(_kernels.NVCC_FLAGS) + tuple(extra)
ends = {}
start = time.perf_counter()
def one(lib):
    _kernels.build([lib])
    ends[lib] = time.perf_counter() - start
libs = list(_kernels.SIGNATURES)
with ThreadPoolExecutor(len(libs)) as pool:
    list(pool.map(one, libs))
total = time.perf_counter() - start
sass = {}
if dump:
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    for lib in libs:
        out = subprocess.run([tool, "-sass", str(_kernels.library_path(lib))],
                             capture_output=True, text=True).stdout
        ins = sorted(ln.strip() for ln in out.splitlines()
                     if ln.strip().startswith("/*") and "*/" in ln[4:])
        sass[lib] = {"lines": len(out.splitlines()),
                     "sorted_instructions_md5": hashlib.md5("\n".join(ins).encode()).hexdigest()}
print(json.dumps({"total": total, "ends": ends, "sass": sass}))
'''


def build_once(tree: str, flags: str, dump: bool) -> dict:
    """One build of ``tree``'s libraries in a fresh process."""
    r = subprocess.run([sys.executable, "-c", _CHILD, tree, flags, "1" if dump else "0"],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"build of {tree} {flags} failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    variants = {}
    for arg in argv:
        label, _, rest = arg.partition("=")
        tree, _, flags = rest.partition(":")
        variants[label] = (tree, flags)
    order = list(variants)
    results = {}
    for label in order + order[::-1]:
        out = build_once(*variants[label], dump=label not in results)
        results.setdefault(label, []).append(out)
        print(json.dumps({"variant": label, **out}), flush=True)
    print(json.dumps({"builds": {k: [r["total"] for r in v] for k, v in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
