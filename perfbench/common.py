"""The harness's plumbing: the manifest and the files a cell names, the
check on what the run has imported, the device's description, and the
result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``configs/<config>.json``, and a traffic mix,
``traffic/<traffic>.json``; a per-layer metric is read by
``metrics/<metric>.py``. Nothing else names a cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may hold: the JAX package this program was
# ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "adafocus_tpu")
# cuDNN's autotuner, the same in every run of every cell: off. On, its picks
# are made anew in each process and may differ between two runs of one cell
# (bf16 convs have moved up to 2.3x between processes with it on), and its
# search adds seconds to every run's set-up
CUDNN_BENCHMARK = False


class Refused(Exception):
    """A run that cannot be made: no result is printed."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """The cell ``name``: its manifest entry, configuration and traffic."""
    bench = bench or manifest()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    return {"entry": entry,
            "config": load_json(os.path.join(HERE, "configs", entry["config"] + ".json")),
            "traffic": load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))}


def end_to_end_metrics(bench: dict, name: str) -> List[dict]:
    """The end-to-end metrics the cell ``name`` reports."""
    return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def per_layer_metrics(bench: dict, name: str) -> List[dict]:
    """The per-layer metrics read in the cell ``name``: those that list it,
    and those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_metrics(bench, name)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def metric_reader(name: str):
    """``read(record) -> number or None`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (``adafocus_torch`` is not ``adafocus_tpu``)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def emit(result: dict) -> None:
    """The run's last lines: each compared number beside its limit on
    standard error, then the result line (``checks`` its last key) on
    standard output."""
    checks = {k: {"value": v["value"] if math.isfinite(v["value"]) else str(v["value"]),
                  "limit": v["limit"]} for k, v in result.pop("checks").items()}
    for key, item in checks.items():
        print(f"check {key}: {item['value']!r} limit {item['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def finite_or_none(x: Optional[float]) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None
