#!/usr/bin/env python3
"""Throughput bench of the PyTorch/CUDA port on one GPU (counterpart of
bench.py for ``adafocus_torch``).

    python3 port_bench.py        # from the repository root; needs one CUDA GPU

Prints ONE JSON line:

- ``card``: the GPU's name and power limit, as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` gives them;
- ``metric`` / ``value`` / ``unit``: the ActivityNet flagship's videos/s
  (B=64, T=16, 224^2 frames, 96^2 patches, bf16) on the cuDNN path, and
  ``flagship``: that rate on both backbone paths (``fused="auto"``, library
  convs, and ``fused="on"``, the hand-written block kernels);
- ``batch1_latency_ms``: the flagship's latency at batch 1 on both paths
  (``time_inference(batch=1)``, inverted);
- ``matched_config``: the sth-sth configuration at 144^2 patches (8 + 12
  frames, TSM backbones, continuous policy, average consensus; the
  reference's published configuration) on both paths, each with
  ``vs_ref_gpu_same_config``, its videos/s over the reference's published
  143.8 videos/s (RTX 2080Ti, BASELINE.md);
- ``int8``: the int8 PTQ serving path (``time_inference(mode="int8")``:
  int8 backbones and frame transport, calibrated on seeded random data and
  prepared before the timed runs): videos/s of the flagship, of the matched
  configuration and of AdaFocus+ at ``plus_cfg((96, 8))`` (beside its bf16
  rate, which the lines above do not give), and the flagship's batch-1
  latency;
- ``uncontended``: False when a live holder of the device lock
  (``adafocus_torch.utils.device_lock``, a training run on the same card)
  outlived the wait before the timing (``ADAFOCUS_BENCH_WAIT_SECS``,
  default 1800 s), so the numbers may be contended. ``bench()``, which
  ``chip_smoke.py`` calls in process, does not wait.

Each rate is the best of ``BENCH_REPEATS`` (3) runs of ``BENCH_ITERS`` (10)
forwards at ``BENCH_BATCH`` (64) videos, timed by CUDA events after warm-up
forwards (``adafocus_torch.benchmark.time_inference``); weights random
from a seeded generator, inputs random on the card. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
PATHS = ("auto", "on")


def card_name() -> str:
    """The card's name and power limit, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bench(device, batch: int = 64, inner_iters: int = 10, repeats: int = 3) -> dict:
    """The bench's result as a dict (what ``main`` prints)."""
    import torch

    from adafocus_torch.benchmark import (
        REFERENCE_VIDEOS_PER_S, plus_cfg, sthsth_cfg, time_inference,
    )
    from adafocus_torch.models.gfv import GFV, flagship

    def model(cfg):
        return GFV(cfg, device=device, generator=torch.Generator().manual_seed(SEED))

    torch.backends.cudnn.benchmark = True
    flag = model(flagship())
    rates = {f: time_inference(flag, batch, inner_iters, repeats, SEED, fused=f)
             for f in PATHS}
    latency = {f: 1e3 / time_inference(flag, 1, inner_iters, repeats, SEED, fused=f)
               for f in PATHS}
    int8 = {"flagship": time_inference(flag, batch, inner_iters, repeats, SEED, mode="int8"),
            "batch1_latency_ms": 1e3 / time_inference(flag, 1, inner_iters, repeats, SEED,
                                                      mode="int8")}
    del flag
    matched = model(sthsth_cfg(144))
    matched_rates = {f: time_inference(matched, batch, inner_iters, repeats, SEED, fused=f)
                     for f in PATHS}
    int8["matched_config"] = time_inference(matched, batch, inner_iters, repeats, SEED,
                                            mode="int8")
    del matched
    plus = model(plus_cfg((96, 8)))
    int8["plus_96_8"] = time_inference(plus, batch, inner_iters, repeats, SEED, mode="int8")
    int8["plus_96_8_bf16"] = time_inference(plus, batch, inner_iters, repeats, SEED)
    del plus
    torch.cuda.empty_cache()
    return {
        "card": card_name(),
        "metric": f"videos/s (ActivityNet flagship, B={batch}, T=16, bf16, cuDNN path)",
        "value": rates["auto"],
        "unit": "videos/s",
        "flagship": rates,
        "batch1_latency_ms": latency,
        "matched_config": {
            "metric": f"videos/s (Sth-Sth 144^2, 8+12 frames, B={batch}, bf16)",
            "unit": "videos/s",
            "reference_videos_per_s": REFERENCE_VIDEOS_PER_S,
            **{f: {"value": v, "vs_ref_gpu_same_config": v / REFERENCE_VIDEOS_PER_S}
               for f, v in matched_rates.items()},
        },
        "int8": {"metric": f"videos/s, int8 PTQ serving, B={batch}", "unit": "videos/s",
                 **int8},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_bench: no CUDA device is visible", file=sys.stderr)
        return 1
    from adafocus_torch.ops import _kernels
    from adafocus_torch.utils.device_lock import wait_for_device

    # never time against a training run on the same card: wait for a live
    # holder of the device lock, bounded by ADAFOCUS_BENCH_WAIT_SECS
    uncontended = wait_for_device()
    _kernels.build()
    out = bench(torch.device("cuda"), int(os.environ.get("BENCH_BATCH", "64")),
                int(os.environ.get("BENCH_ITERS", "10")),
                int(os.environ.get("BENCH_REPEATS", "3")))
    out["uncontended"] = uncontended
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
