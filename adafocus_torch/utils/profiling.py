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
    ``port_patch_times.split_phases`` and ``chip_smoke.py`` read through;
  * ``events_ms`` / ``device_ms`` (``device_profile``) / ``host_bound``: a
    call's time two ways,
    by CUDA events around back-to-back calls (what a caller waits, the
    host's dispatch included where it is slower than the device) and by the
    device's own spans in a profile of the same calls; a row whose events
    exceed its device time by more than ``HOST_BOUND_RATIO`` is bound by the
    host.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import tempfile
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

# the trace's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a call is host-bound where its CUDA events exceed its device time by more
HOST_BOUND_RATIO = 1.5
# seconds a capture stays open before the device starts and after it is
# done: the profiler keeps only the device's spans inside its capture window,
# and the device's timestamps can stray milliseconds from the host's clock,
# ahead or behind (seen on an H100, more in a long-lived process), so
# without it the first or the last spans, or all of them, go missing
SETTLE_S = 0.015


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None,
          settle: float = SETTLE_S) -> Iterator[profile]:
    """Capture a profile of the enclosed steps; yields the profiler. The
    device is synchronised before the capture ends, so the enclosed
    kernels are in it, and the capture stays open ``settle`` seconds on
    each side of them (``SETTLE_S``). The trace goes to ``log_dir/name``
    (default ``<host>_<pid>.<ns>.pt.trace.json``, which
    ``op_breakdown(log_dir)`` finds)."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    name = name or f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    os.makedirs(log_dir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()   # work enqueued before the capture stays out of it
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(settle)
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(settle)
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


# ---------------------------------------------------------------------------
# A call's time: CUDA events against the device's own spans.
# ---------------------------------------------------------------------------


def events_ms(fn: Callable[[], object], iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call of ``fn`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` ones. Where the host
    dispatches a call more slowly than the device runs it, this is the
    host's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def per_call_ms(events: List[dict], calls: int,
                reference: Optional[List[dict]] = None) -> Optional[float]:
    """The device's time of one call in ms: the durations of the kernels,
    copies and memsets among a trace's ``events`` (``device_events``),
    summed, over ``calls``. None where the trace holds no device work, or
    work that ``calls`` calls cannot have made alike: spans went missing.
    Each name's count must then be a multiple of ``calls`` and, given the
    ``reference`` events of a one-call profile, ``calls`` times that name's
    count there (so a call whose spans share a name that lost whole calls is
    refused too)."""
    spans = device_events(events)
    counts = Counter(e.get("name") for e in spans)
    if not spans or any(n % calls for n in counts.values()):
        return None
    if reference is not None:
        one = Counter(e.get("name") for e in device_events(reference))
        if counts != Counter({k: n * calls for k, n in one.items()}):
            return None
    return sum(e.get("dur", 0) for e in spans) / 1e3 / calls


def as_trace_events(events) -> List[dict]:
    """A live profile's events (``prof.events()``) in a trace's form
    (``load_trace``): the device's as kernels, copies and memsets, the
    host's as operators."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        cat = "cpu_op"
        if e.device_type == DeviceType.CUDA:
            cat = ("gpu_memcpy" if e.name.startswith("Memcpy") else
                   "gpu_memset" if e.name.startswith("Memset") else "kernel")
        out.append({"ph": "X", "cat": cat, "name": e.name, "ts": e.time_range.start,
                    "dur": e.time_range.elapsed_us()})
    return out


def device_profile(fn: Callable[[], object], iters: int = 20, settle: float = SETTLE_S,
                   written: bool = False) -> List[dict]:
    """The events of a profile of ``iters`` calls of ``fn`` after one
    warm-up call, the capture kept open ``settle`` seconds before the first
    call and after the device is done (``SETTLE_S``): the device's activity
    alone, read from the live profile (``as_trace_events``), or with
    ``written`` the host's too, read from the trace ``trace`` writes (on the
    CPU, the host's). Late in a long-lived process the profiler loses some
    of the device's spans, and not the same ones both ways."""
    cuda = torch.cuda.is_available()
    fn()
    if written:
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp, "calls.json", settle):
                for _ in range(iters):
                    fn()
            return load_trace(os.path.join(tmp, "calls.json"))
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        if cuda:
            time.sleep(settle)
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
            time.sleep(settle)
    return as_trace_events(prof.events())


def device_ms(fn: Callable[[], object], iters: int = 20,
              settle: float = SETTLE_S) -> Optional[float]:
    """Mean device time of one call of ``fn`` in ms: ``per_call_ms`` of a
    ``device_profile`` of ``iters`` calls, held to one of a single call. The
    gaps between the device's spans, where it waits for the host, are left
    out. None where the profiler saw no device work (on the CPU) or not every
    call's."""
    reference = device_profile(fn, 1, settle)
    return per_call_ms(device_profile(fn, iters, settle), iters, reference)


def host_bound(events: float, device: Optional[float]) -> Optional[bool]:
    """Whether a call timed ``events`` ms by CUDA events and ``device`` ms by
    the profiler is bound by the host: its events exceed its device time by
    more than ``HOST_BOUND_RATIO``. None where the device time is unknown."""
    if device is None:
        return None
    return events > HOST_BOUND_RATIO * device
