"""The traced run: a ``torch.profiler`` capture of the window and the
arithmetic that turns its Chrome trace into the record the per-layer
metrics read (``record``).

The device's spans are attributed to the host's ``record_function`` ranges
by launch correlation: a kernel belongs to the innermost named range open
when the host launched it (a kernel whose launch the trace lacks goes with
the kernel before it on the stream). The reading of the trace is a copy of
the arithmetic of the program's own tools (``utils/profiling.py
device_events``, ``port_patch_times.split_phases``), kept here so that the
yardstick does not move with the program.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# seconds the capture stays open before the traced work and after the
# device is done: the device's timestamps stray from the host's by
# milliseconds, and spans outside the capture are dropped
SETTLE_S = 0.015
BREAKDOWN_ENTRIES = 10
# characters of a name in the breakdown
NAME_CHARS = 120
# host ranges looked back through for the one open at a time
WALK = 4096


def paced(work, device):
    """``(microseconds, work())``: the time the device's clock reads over
    ``work()``, run with no profiler, from an idle device to the end of the
    last of its work (CUDA events; the host's clock without a card). The
    per-layer metrics that need the program's pace take it from here: the
    profiler's own host cost slows the launches of the traced window."""
    if device.type != "cuda":
        start = time.perf_counter()
        out = work()
        return (time.perf_counter() - start) * 1e6, out
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = work()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3, out


@contextlib.contextmanager
def capture(out: dict) -> Iterator[None]:
    """Profiles the enclosed work (CPU and CUDA activity); on exit the
    events of its Chrome trace are in ``out["events"]``. The trace file is
    written to the run's temporary directory and removed."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        yield
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def device_events(events: List[dict]) -> List[dict]:
    """Kernels, copies and memsets on the device, by start time."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def union_us(spans: Sequence[tuple]) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _nested(spans) -> List[tuple]:
    """(start, end, name) spans by start, an outer span before an inner one
    that starts with it."""
    return sorted(spans, key=lambda r: (r[0], -r[1]))


def _ranges(events: List[dict], names: Sequence[str]) -> List[tuple]:
    return _nested((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") in names)


def _innermost(ranges: List[tuple], starts: List[float], ts: float) -> Optional[str]:
    """The name of the innermost of the nested (start, end, name) ``ranges``
    (sorted, ``starts`` their starts) that holds ``ts``: the latest-starting
    one that has not ended."""
    i = bisect.bisect_right(starts, ts) - 1
    for a, b, name in reversed(ranges[max(0, i - WALK):i + 1]):
        if b >= ts:
            return name
    return None


def record(events: List[dict], ranges: Sequence[str], window_range: str) -> dict:
    """The traced window's record: ``window_us`` (from the start of the
    first ``window_range`` range to the end of the last device span),
    ``busy_us`` (the union of the device's spans inside it), ``kernels``
    ({name: [durations in us]}), ``range_busy_us`` ({range name: device
    microseconds attributed to it}), ``breakdown`` (the device operations
    that took most time and the idle gaps by the host range open during
    them, seconds)."""
    dev = device_events(events)
    starts = [e["ts"] for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == window_range]
    if not dev or not starts:
        return {"window_us": 0.0, "busy_us": 0.0, "kernels": {}, "range_busy_us": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    t0 = min(starts)
    dev = [e for e in dev if e["ts"] + e["dur"] >= t0]
    t1 = max(e["ts"] + e["dur"] for e in dev)
    spans = [(max(e["ts"], t0), e["ts"] + e["dur"]) for e in dev]
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    named = _ranges(events, ranges)
    named_starts = [r[0] for r in named]
    range_busy: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, List[float]] = defaultdict(list)
    owner = None
    for e in dev:
        ts = launch.get(e.get("args", {}).get("correlation"))
        owner = _innermost(named, named_starts, ts) if ts is not None else owner
        if owner is not None:
            range_busy[owner] += e["dur"]
        kernels[e.get("name", "?")].append(e["dur"])
    return {"window_us": t1 - t0, "busy_us": union_us(spans), "kernels": dict(kernels),
            "range_busy_us": dict(range_busy),
            "breakdown": breakdown(events, kernels, spans, t0, t1)}


def breakdown(events: List[dict], kernels: Dict[str, List[float]], spans: List[tuple],
              t0: float, t1: float) -> dict:
    """The ``BREAKDOWN_ENTRIES`` device operations that took most time, and
    the idle time between the device's spans summed by what the host was in
    when each gap began: the innermost host range or operator open then
    (``idle`` where none was)."""
    ops = sorted(((name, sum(d) / 1e6) for name, d in kernels.items()), key=lambda r: -r[1])
    host = _nested((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("user_annotation", "cpu_op", "cuda_runtime")
                   and e.get("ph") == "X")
    host_starts = [r[0] for r in host]
    gaps: Dict[str, float] = defaultdict(float)
    end = t0
    for a, b in sorted(spans) + [(t1, t1)]:
        if a > end:
            gaps[_innermost(host, host_starts, end) or "idle"] += (a - end) / 1e6
        end = max(end, b)
    idle = sorted(gaps.items(), key=lambda r: -r[1])
    return {"device_ops": [[short(n), s] for n, s in ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": [[short(n), s] for n, s in idle[:BREAKDOWN_ENTRIES]]}


def short(name: str) -> str:
    """A kernel's name without ``void `` and anonymous namespaces, cut to
    ``NAME_CHARS`` characters (enough to keep its functor)."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "")[:NAME_CHARS]
