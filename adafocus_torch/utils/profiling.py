"""Tracing and op attribution (counterpart of adafocus_tpu/utils/profiling.py).

  * ``trace(log_dir)``: ``torch.profiler`` over the CPU and, where there is
    one, the GPU, around the enclosed steps; writes a Chrome trace
    (``chrome://tracing``, Perfetto) into ``log_dir``;
  * ``span(name)`` / ``recording()``: the program's own phase spans (the
    serving entries' ``serve``, ``glance``, ``policy``, ``focus`` and
    ``classify``; the stage-1 step's ``train_step`` and ``optimizer``).
    Off by default, and then free; ``adafocus.<name>`` ranges in a
    ``torch.profiler`` trace while one is active; kept in memory, with the
    host's clock and CUDA events, while a ``Recorder`` is installed;
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
import dataclasses
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


# ---------------------------------------------------------------------------
# The program's own phase spans.
# ---------------------------------------------------------------------------

# the prefix of a span's range in a profiler's trace
SPAN_PREFIX = "adafocus."
# the recorder ``recording`` has installed, None while spans are off
_recorder: Optional["Recorder"] = None
_OFF = contextlib.nullcontext()


def span(name: str):
    """A phase of the program, as a context manager. Off (no profiler active
    and no recorder installed, the default) it is one shared null context:
    no profiler or CUDA call and no allocation. While a ``torch.profiler``
    capture is active it opens the range ``adafocus.<name>``, which lies in
    the capture's trace (a ``user_annotation``) on the profiler's clock
    beside the kernels its host code launched; while a recorder is
    installed (``recording``) the recorder keeps it."""
    if _recorder is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "_range", "_recorder", "_index")

    def __init__(self, name: str):
        self.name = name
        self._range = self._recorder = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self._range.__enter__()
        if _recorder is not None:
            self._recorder = _recorder
            self._index = _recorder._open(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._recorder is not None:
            self._recorder._close(self._index)
        if self._range is not None:
            self._range.__exit__(*exc)


@dataclasses.dataclass
class SpanRecord:
    """One recorded span: ``parent`` and ``unit`` index ``Recorder.spans``
    (``unit``: the outermost span it lies in, its own index for an
    outermost span, so the spans of one request or step share it); the
    host's clock at entry and exit; CUDA events recorded on the current
    stream at entry and exit (None where the process has not initialised
    CUDA)."""

    name: str
    parent: Optional[int]
    unit: int
    host_start_ns: int
    host_end_ns: Optional[int] = None
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None


class Recorder:
    """The spans opened, in one thread, while it is installed. It holds them
    in memory (two CUDA events each on the card) until ``summary`` reads
    them, so it is meant for a bounded stretch of requests or steps."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self._stack: List[int] = []
        self._cuda = torch.cuda.is_initialized()

    def _open(self, name: str) -> int:
        parent = self._stack[-1] if self._stack else None
        index = len(self.spans)
        rec = SpanRecord(name, parent, index if parent is None else self.spans[parent].unit,
                         time.perf_counter_ns())
        if self._cuda:
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        self.spans.append(rec)
        self._stack.append(index)
        return index

    def _close(self, index: int) -> None:
        rec = self.spans[index]
        if self._cuda:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record()
        rec.host_end_ns = time.perf_counter_ns()
        self._stack.pop()

    def summary(self) -> Dict[str, dict]:
        """Per span name, over the closed spans: ``count``, ``host_ms`` (the
        host's time inside them, summed) and ``host_self_ms`` (less what
        their child spans cover), ``device_ms`` (each span's
        ``start.elapsed_time(end)``, summed: the stream's time from reaching
        the span to finishing its last work, gaps where it waited for the
        host included) and ``device_self_ms``; the device's None without
        CUDA events. Synchronises the device once."""
        closed = [i for i, s in enumerate(self.spans) if s.host_end_ns is not None]
        timed = self._cuda and bool(closed)
        if timed:
            torch.cuda.synchronize()
        host, device = {}, {}
        for i in closed:
            s = self.spans[i]
            host[i] = (s.host_end_ns - s.host_start_ns) / 1e6
            device[i] = s.start.elapsed_time(s.end) if timed else None
        host_self, device_self = dict(host), dict(device)
        for i in closed:
            parent = self.spans[i].parent
            if parent in host_self:
                host_self[parent] -= host[i]
                if timed:
                    device_self[parent] -= device[i]
        out: Dict[str, dict] = {}
        for i in closed:
            row = out.setdefault(self.spans[i].name, {
                "count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                "device_ms": 0.0 if timed else None, "device_self_ms": 0.0 if timed else None})
            row["count"] += 1
            row["host_ms"] += host[i]
            row["host_self_ms"] += host_self[i]
            if timed:
                row["device_ms"] += device[i]
                row["device_self_ms"] += device_self[i]
        return out


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Installs a ``Recorder`` for the enclosed block, and yields it: every
    ``span`` opened meanwhile is kept. One recorder at a time."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already installed")
    _recorder = rec = Recorder()
    try:
        yield rec
    finally:
        _recorder = None


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
