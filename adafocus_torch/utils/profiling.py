"""Tracing and op attribution (counterpart of adafocus_tpu/utils/profiling.py).

  * ``trace(log_dir)``: ``torch.profiler`` over the CPU and, where there is
    one, the GPU, around the enclosed steps; writes a Chrome trace
    (``chrome://tracing``, Perfetto) into ``log_dir``;
  * ``StepTimer``: data-time / step-time meters, the reference's ('Data',
    'Time') pair, with the device synchronised so the timings are honest;
  * ``op_breakdown`` / ``top_ops``: read a captured trace and sum the
    device's time by kernel name (kernels, copies and memsets; the host's
    lanes are skipped);
  * ``load_trace`` / ``device_events``: the port's one trace reader, which
    ``port_patch_times.split_phases`` and ``chip_smoke.py`` read through.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

# the trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None) -> Iterator[profile]:
    """Capture a profile of the enclosed steps; yields the profiler. The
    device is synchronised before the capture ends, so the enclosed
    kernels are in it. The trace goes to ``log_dir/name`` (default
    ``<host>_<pid>.<ns>.pt.trace.json``, which ``op_breakdown(log_dir)``
    finds)."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    name = name or f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    os.makedirs(log_dir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()   # work enqueued before the capture stays out of it
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a
    tensor, or dicts, lists and tuples of them)."""
    devices = set()
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """data-time (host pipeline) + step-time (device) meters."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.count = 0
        self._t = time.perf_counter()

    def data_ready(self) -> None:
        now = time.perf_counter()
        self.data_time += now - self._t
        self._t = now

    def step_done(self, result=None) -> None:
        """Ends a step; waits for the devices of ``result`` first (the JAX
        package's ``block_until_ready``), since a CUDA call returns before
        its work is done."""
        if result is not None:
            _synchronize(result)
        now = time.perf_counter()
        self.step_time += now - self._t
        self._t = now
        self.count += 1

    def summary(self) -> str:
        n = max(self.count, 1)
        return (f"data {self.data_time / n * 1e3:.1f} ms/step, "
                f"step {self.step_time / n * 1e3:.1f} ms/step")


# ---------------------------------------------------------------------------
# Trace parsing / op attribution.
# ---------------------------------------------------------------------------


def _find_trace_file(log_dir: str) -> str:
    pats = [
        os.path.join(log_dir, "**", "*.trace.json.gz"),
        os.path.join(log_dir, "**", "*.trace.json"),
    ]
    hits: List[str] = []
    for p in pats:
        hits.extend(glob.glob(p, recursive=True))
    if not hits:
        raise FileNotFoundError(f"no trace.json[.gz] under {log_dir}")
    return max(hits, key=os.path.getmtime)  # latest capture


def load_trace(path: str) -> List[dict]:
    """The events of a Chrome trace: the file ``path`` (``.json`` or
    ``.json.gz``), or the latest capture under the directory ``path``."""
    if os.path.isdir(path):
        path = _find_trace_file(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events: List[dict]) -> List[dict]:
    """Kernels, copies and memsets on the device, by start time."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def op_breakdown(log_dir: str) -> Dict[str, Tuple[float, int]]:
    """Aggregate device time from a ``trace()`` capture (a directory or a
    trace file).

    Returns {kernel name: (total_ms, count)} over the device's kernels,
    copies ('Memcpy DtoD ...') and memsets, skipping the host's lanes (its
    operators, runtime calls and annotations) and the device's annotation
    lanes. Use ``top_ops`` for a sorted, name-grouped view.
    """
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for ev in device_events(load_trace(log_dir)):
        entry = agg[ev.get("name", "?")]
        entry[0] += ev.get("dur", 0) / 1e3  # us -> ms
        entry[1] += 1
    return {k: (v[0], v[1]) for k, v in agg.items()}


def _group_key(name: str) -> str:
    """Strip the per-instance suffix, keep the scope prefix:
    fusion.123 -> fusion; jit_glance/fusion.7 -> jit_glance/fusion;
    my_op.4.clone -> my_op — so same-named ops from different scopes
    stay in separate rows."""
    prefix, sep, base = name.rpartition("/")
    parts = base.split(".")
    while parts and (parts[-1].isdigit() or parts[-1] in ("clone", "remat")):
        parts.pop()
    return prefix + sep + (".".join(parts) or base)


def top_ops(
    log_dir: str, n: int = 20, group: bool = True
) -> List[Tuple[str, float, int]]:
    """[(name, total_ms, count)] sorted by total time, optionally grouping
    numbered instances of the same op (fusion.1, fusion.2, ...)."""
    raw = op_breakdown(log_dir)
    if group:
        agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for name, (ms, cnt) in raw.items():
            e = agg[_group_key(name)]
            e[0] += ms
            e[1] += cnt
        raw = {k: (v[0], v[1]) for k, v in agg.items()}
    rows = [(k, ms, cnt) for k, (ms, cnt) in raw.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:n]
