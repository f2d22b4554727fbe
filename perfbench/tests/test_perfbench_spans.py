"""The program's phase spans in the harness, on the CPU: the readers of
``spans.py`` on a hand-written summary (None without one, or without the
device's times); the trace arithmetic of ``tracing.record`` and the ten
per-layer metrics unchanged where the program's ``adafocus.*`` ranges lie
in the trace beside the harness's own, the idle gaps put down to them where
they are the innermost; and whole tiny traced runs, serving and training,
whose record carries the recorded stretch after the capture while the
captured window is judged as before."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from perfbench import common, peaks, spans, tracing  # noqa: E402
from test_perfbench_reference import few_threads, tiny_cell  # noqa: E402, F401
from test_perfbench_trace import _ann, trace  # noqa: E402

CPU = torch.device("cpu")
SERVE_RANGES = ("request", "glance", "focus")
TEN = ("idle_share.serve", "mfu.serve", "glance_ms.serve", "focus_ms.serve",
       "patch_roofline.serve", "int8_roofline.serve", "idle_share.train", "mfu.train",
       "focus_ms.train", "backward_ms.train")


def _row(host, device):
    return {"count": 4, "host_ms": host, "host_self_ms": host, "device_ms": device,
            "device_self_ms": device}


def test_readers_of_a_summary():
    rec = {"span_units": 4, "spans": {
        "serve": _row(20.0, 200.0), "glance": _row(8.0, 160.0), "policy": _row(6.0, 4.0),
        "focus": _row(2.0, 30.0), "classify": _row(1.0, 2.0),
        "train_step": _row(30.0, 360.0), "optimizer": _row(12.0, 60.0)}}
    got = {name: read(rec) for name, read in spans.READERS.items()}
    assert got == pytest.approx({
        "glance_span_ms.serve": 40.0, "focus_span_ms.serve": 7.5, "policy_ms.serve": 1.0,
        "classify_ms.serve": 0.5, "host_share.serve": 10.0, "optimizer_ms.train": 15.0,
        "host_share.train": 100 * 30 / 360})
    assert spans.coverage(rec) == pytest.approx(98.0)
    assert spans.tracing_cost(dict(rec, span_pace_us=800.0, pace_us=700.0, pace_units=4)) == \
        pytest.approx(800 / 700 - 1)
    on_the_cpu = {"span_units": 4, "spans": {k: _row(1.0, None) for k in rec["spans"]}}
    for read in spans.READERS.values():
        assert read({}) is None and read({"requests": 4}) is None
        assert read(on_the_cpu) is None
    assert spans.coverage(on_the_cpu) is None and spans.tracing_cost({}) is None
    alone = dict(rec, alone_spans={"serve": _row(4.0, 300.0)})
    assert spans.host_share_alone(alone, "serve") == pytest.approx(100 * 4 / 200)
    assert spans.host_share_alone(rec, "serve") is None
    assert spans.host_share_alone(dict(on_the_cpu, alone_spans=alone["alone_spans"]),
                                  "serve") is None


def _with_program_ranges(events):
    """The hand-written trace with the program's ranges around the
    harness's: each request a ``serve`` span, ``glance`` around the
    harness's glance, ``focus`` around its focus, and in the second request
    a ``classify`` span that the host is in when the device idles at 154."""
    out = list(events)
    for t0 in (0, 100):
        out += [_ann("adafocus.serve", t0, 60), _ann("adafocus.glance", t0, 22),
                _ann("adafocus.policy", t0 + 22, 6), _ann("adafocus.focus", t0 + 28, 24)]
    out.append(_ann("adafocus.classify", 150, 8))
    return out


def test_program_ranges_leave_the_harness_readings_as_they_were():
    before = tracing.record(trace(), SERVE_RANGES, "request")
    after = tracing.record(_with_program_ranges(trace()), SERVE_RANGES, "request")
    for key in ("window_us", "busy_us", "kernels", "range_busy_us"):
        assert after[key] == before[key]
    assert after["breakdown"]["device_ops"] == before["breakdown"]["device_ops"]
    extra = dict(requests=2, videos=128, batch=64, precision="bfloat16", patch=1e6,
                 flops_per_video=3.5e10, pace_us=250.0, pace_units=2, int8_bound_us=30.0,
                 steps=2)
    for name in TEN:
        read = common.metric_reader(name)
        assert read(dict(after, **extra)) == read(dict(before, **extra))
    gaps = dict(after["breakdown"]["idle_gaps"])
    # 154-164 now falls under the program's classify; 184-194 stays aten::copy_
    assert gaps == pytest.approx({"glance": 10e-6, "idle": 46e-6, "focus": 10e-6,
                                  "aten::copy_": 10e-6, "adafocus.classify": 10e-6})


@pytest.mark.parametrize("name", ["actnet-serve-b64", "sthsth-serve-b64",
                                  "actnet-serve-int8-b64", "actnet-train-s1-b64"])
def test_tiny_traced_run_records_the_stretch(monkeypatch, name):
    monkeypatch.setattr(common, "cell", lambda n, bench=None: tiny_cell(n))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setitem(peaks.FLOPS, "float32", 67e12)   # the tiny cells' precision
    line = spans.measure(name, 2**31 + 91, 0.5, CPU)
    assert line["correct"]
    traffic = tiny_cell(name)["traffic"]
    kind = "train" if "trace_steps" in traffic else "serve"
    if kind == "serve":
        units, names = traffic["trace_requests"], {"serve", "glance", "policy", "focus",
                                                   "classify"}
    else:
        units, names = traffic["trace_steps"], {"train_step", "optimizer"}
    assert line["span_units"] == units
    assert set(line["spans"]) == names
    assert all(row["count"] == units for row in line["spans"].values())
    assert {k: v["count"] for k, v in line["alone_spans"].items()} == \
        {k: v["count"] for k, v in line["spans"].items()}
    assert line["host_share_alone"] is None
    # on the CPU: no device times, so no reading
    assert all(row["device_ms"] is None for row in line["spans"].values())
    assert line["readings"] and all(v is None for v in line["readings"].values())
    assert set(line["readings"]) == {k for k in spans.READERS
                                     if k.endswith("." + kind)}
    assert tracing.capture.__module__ == "perfbench.tracing"
