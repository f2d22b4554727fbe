"""The benchmark of the PyTorch/CUDA AdaFocus port.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA device of this machine:
set-up (weights and inputs drawn from the seed on the device, the program's
model, a warm-up of the cell's shapes), a window of ``--seconds``, then the
plain reference's judgement of what the window produced. The last line on
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1``, its
per-layer metrics read from a profile of the window, and ``breakdown``),
``device`` and ``checks`` (each compared number with its limit, also the
last lines on standard error). Exits non-zero with no result where there
is no CUDA device, too few, or a forbidden module was loaded.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import common  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(name: str, seed: int, seconds: float, traced: bool, device,
            clock=lambda: time.perf_counter() - _START) -> dict:
    """One run of the cell ``name`` on ``device``: the result line's keys."""
    import importlib

    from perfbench import judge

    bench = common.manifest()
    cell = common.cell(name, bench)
    driver = importlib.import_module(f"perfbench.{cell['traffic']['driver']}")
    out = driver.run(cell, seed, seconds, traced, device, clock)
    checks = judge.checks(name, out["values"])
    read = {k: v for k, v in out["values"].items() if k not in checks}
    print(f"perfbench: {name} seed {seed}: set-up {out['metrics']['setup_s']!r} s (clock at "
          f"{ {k: round(v, 3) for k, v in out['setup'].items()} }), {out['attempted']} "
          f"attempted, judged in {out['check_s']!r} s; read, not compared: {read}",
          file=sys.stderr)
    result = {"correct": judge.passed(checks), "attempted": out["attempted"],
              "failed": out["failed"]}
    if traced:
        record = out["record"]
        metrics = {}
        for m in common.per_layer_metrics(bench, name):
            value = common.finite_or_none(common.metric_reader(m["name"])(record))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        units = {m["name"]: m["unit"] for m in common.end_to_end_metrics(bench, name)}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in out["metrics"].items() if k in units}
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": (__import__("torch").cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                        "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        record = out["record"]
        result["device"].update(busy_s=record["busy_us"] / 1e6,
                                window_s=record["window_us"] / 1e6)
        result["breakdown"] = record["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = common.manifest()
    cell = common.cell(args.workload, bench)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = common.CUDNN_BENCHMARK
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = common.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = common.power_limit_w()
    common.emit(result)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except common.Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        sys.exit(2)
