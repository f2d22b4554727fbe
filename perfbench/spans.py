"""The program's own phase spans in a cell: the readings of its ``serve``,
``glance``, ``policy``, ``focus``, ``classify``, ``train_step`` and
``optimizer`` spans (``adafocus_torch/utils/profiling.py``), taken in the
cell's traced run.

    python3 perfbench/spans.py --workload <name> --seed <n> [--seconds <s>] [--out <file.jsonl>]

Runs the cell's traced run as ``run.py --trace 1`` does, with one stretch
added after the profiler's capture (so the capture runs where it did): as
many requests or steps as are traced, in the same closed loop or with the
same steps in flight, under ``profiling.recording()``, timed by the
device's clock as the paced stretch is (``tracing.paced``); then the same
units one at a time, each enqueued onto an idle device. The served actions
they add are dropped, so the reference judges the captured window's
requests as before. The record gains ``spans`` (the recorder's summary),
``span_units`` (the stretch's requests or steps), ``span_pace_us`` and
``alone_spans`` (the summary of the units one at a time).

Prints one JSON line: ``correct``; the cell's per-layer metrics of
``BENCHMARK.json`` read from the same record; ``spans``, the readings of
``READERS`` that the cell's kind has (``.serve`` or ``.train``); the
``coverage`` of ``serve``'s device time by its four phases;
``host_share_alone``; the tracing
cost (the recorded stretch's device time a unit over the paced stretch's,
less one); the traced window's ``breakdown``; the card and its power limit.
Not run by the benchmark's runs: the seven readings are not metrics of
``BENCHMARK.json``, since the traced run of ``serve.py`` and ``train.py``
does not record the stretch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import common, judge, serve, tracing, train  # noqa: E402


def _per_unit(name: str):
    """The span ``name``'s device ms a request or step."""
    def read(rec):
        row = rec.get("spans", {}).get(name)
        if not row or row.get("device_ms") is None or not rec.get("span_units"):
            return None
        return row["device_ms"] / rec["span_units"]
    return read


def _host_share(name: str):
    """100 x the span ``name``'s host ms over its device ms: the share of the
    device's time for a unit that the host needs to enqueue it (past 100
    the host sets the pace)."""
    def read(rec):
        row = rec.get("spans", {}).get(name)
        if not row or not row.get("device_ms"):
            return None
        return 100.0 * row["host_ms"] / row["device_ms"]
    return read


READERS = {
    "glance_span_ms.serve": _per_unit("glance"),
    "focus_span_ms.serve": _per_unit("focus"),
    "policy_ms.serve": _per_unit("policy"),
    "classify_ms.serve": _per_unit("classify"),
    "host_share.serve": _host_share("serve"),
    "optimizer_ms.train": _per_unit("optimizer"),
    "host_share.train": _host_share("train_step"),
}
PHASES = ("glance", "policy", "focus", "classify")


def coverage(rec):
    """The share, in %, of the ``serve`` span's device time that its four
    phases' spans cover."""
    spans = rec.get("spans", {})
    if not spans.get("serve", {}).get("device_ms"):
        return None
    return 100.0 * sum(spans[p]["device_ms"] for p in PHASES if p in spans) / \
        spans["serve"]["device_ms"]


def tracing_cost(rec):
    """The recorded stretch's device time a unit over the paced stretch's,
    less one."""
    if not rec.get("span_pace_us") or not rec.get("pace_us"):
        return None
    return (rec["span_pace_us"] / rec["span_units"]) / (rec["pace_us"] / rec["pace_units"]) - 1


def host_share_alone(rec, unit: str):
    """``host_share`` with the host's ms of the ``unit`` span taken where
    each unit is enqueued onto an idle device (one in flight), so that no
    full launch queue holds the host back."""
    alone, paced = rec.get("alone_spans", {}).get(unit), rec.get("spans", {}).get(unit)
    if not alone or not paced or not paced.get("device_ms"):
        return None
    return 100.0 * (alone["host_ms"] / alone["count"]) / (paced["device_ms"] / paced["count"])


def _recorded(work, device) -> tuple:
    """``(microseconds, (summary, units))``: ``units = work()`` run under a
    recorder and timed as ``tracing.paced`` times a stretch."""
    from adafocus_torch.utils import profiling

    def stretch():
        with profiling.recording() as rec:
            units = work()
        return rec, units
    us, (rec, units) = tracing.paced(stretch, device)
    return us, (rec.summary(), units)


@contextlib.contextmanager
def stretch_after_capture(kind: str, traffic: dict, device):
    """While the block runs, the traced run of a ``serve`` or ``train`` cell
    (``kind``) records the stretch after its capture."""
    window = {"on": False, "calls": []}
    real_capture, real_loop, real_build = tracing.capture, serve.closed_loop, train.build

    def loop(*a, **k):
        if window["on"]:
            window["calls"].append((a, k))
        return real_loop(*a, **k)

    def build(*a, **k):
        model, optimizer, step = real_build(*a, **k)

        def kept(*sa, **sk):
            if window["on"]:
                window["calls"].append((sa, dict(sk, mark=None)))
            return step(*sa, **sk)
        window["step"] = step
        return model, optimizer, kept

    def steps(in_flight):
        """The captured window's steps again, at most ``in_flight`` ahead of
        the device."""
        events = []
        for a, k in window["calls"]:
            if len(events) >= in_flight:
                events.pop(0).synchronize()
            window["step"](*a, **k)
            if device.type == "cuda":
                events.append(torch.cuda.Event())
                events[-1].record()
        return len(window["calls"])

    @contextlib.contextmanager
    def capture(out):
        window["on"] = True
        try:
            with real_capture(out):
                yield
        finally:
            window["on"] = False
        if kind == "serve":
            (a, k), = window["calls"]
            actions = a[0].actions
            kept = len(actions)

            def work(in_flight):
                return lambda: len(real_loop(a[0], a[1], in_flight, **k)["outputs"])
        else:
            def work(in_flight):
                return lambda: steps(in_flight)
        out["span_pace_us"], (out["spans"], out["span_units"]) = _recorded(
            work(traffic["in_flight"]), device)
        out["alone_spans"] = _recorded(work(1), device)[1][0]
        if kind == "serve":
            del actions[kept:]

    tracing.capture, serve.closed_loop, train.build = capture, loop, build
    try:
        yield
    finally:
        tracing.capture, serve.closed_loop, train.build = real_capture, real_loop, real_build


def measure(name: str, seed: int, seconds: float, device) -> dict:
    """The cell ``name``'s traced run with the recorded stretch: the line
    this script prints."""
    start = time.perf_counter()
    bench = common.manifest()
    cell = common.cell(name, bench)
    kind = cell["traffic"]["driver"]
    runner = serve if kind == "serve" else train
    with stretch_after_capture(kind, cell["traffic"], device):
        out = runner.run(cell, seed, seconds, True, device, lambda: time.perf_counter() - start)
    rec = out["record"]
    checks = judge.checks(name, out["values"])
    metrics = {m["name"]: common.finite_or_none(common.metric_reader(m["name"])(rec))
               for m in common.per_layer_metrics(bench, name)}
    line = {"workload": name, "seed": seed, "correct": judge.passed(checks),
            "metrics": metrics, "spans": rec["spans"], "span_units": rec["span_units"],
            "readings": {k: read(rec) for k, read in READERS.items()
                         if k.endswith("." + kind)},
            "coverage": coverage(rec) if kind == "serve" else None,
            "alone_spans": rec["alone_spans"],
            "host_share_alone": host_share_alone(rec, "serve" if kind == "serve"
                                                 else "train_step"),
            "tracing_cost": tracing_cost(rec), "pace_us": rec.get("pace_us"),
            "span_pace_us": rec["span_pace_us"], "units": rec.get("pace_units"),
            "busy_us": rec["busy_us"], "window_us": rec["window_us"],
            "breakdown": rec["breakdown"], "setup_s": out["metrics"]["setup_s"]}
    if device.type == "cuda":
        line["device"] = {"kind": torch.cuda.get_device_name(device),
                          "power_limit_w": common.power_limit_w()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: no CUDA device is visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = common.CUDNN_BENCHMARK
    line = json.dumps(measure(args.workload, args.seed, args.seconds, device))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
