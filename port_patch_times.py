#!/usr/bin/env python3
"""Patch extraction of one checkout of the port, on one CUDA GPU.

    python3 port_patch_times.py TREE [OUT.json]

TREE is the root of a checkout of this repository (``.`` for this one).
Prints, as JSON lines, and writes to OUT.json (default
``profiles/patch_times.json`` beside this script; the forward's profiler
trace goes beside it):

- ``shapes``: TREE's ``extract_patches`` at the four shapes of ``SHAPES``
  (flagship, batch 1, sth-sth, int8 transport), beside its byte bound
  (each patch byte read once and written once, plus the offsets, over
  3.35 TB/s) and two ``Tensor.copy_`` yardsticks of the same bytes: a
  strided copy of one window of the frames, and a copy of a contiguous
  tensor of the patches' shape. Each is timed twice: by CUDA events around
  back-to-back calls (``*_us``: what a caller sees, host work included
  where the host is slower than the device) and by the profiler's kernel
  durations (``*_dev_us``: device time only);
- ``profile``: ``torch.profiler`` over a few bf16 flagship forwards at
  B=64, T=16 on the cuDNN path (``fused="auto"``), each phase inside a
  ``record_function`` range. For each phase: its device window (from the
  end of the previous phase's last kernel to the end of its own), the
  kernels' busy time in it, the device idle time in it, and the host time
  of its range; for the extraction phase also its patch kernel and its
  other (offset) kernels.

Run on the parent's tree and this tree in one call to compare them.
``chip_smoke.py`` calls the same functions for its own tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
PROFILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "profiles")
SEED = 0
# (name, N, frame size S, channels, patch size P, dtype)
SHAPES = (
    ("flagship B=64 T=16", 1024, 224, 3, 96, "bfloat16"),
    ("batch 1, T=16", 16, 224, 3, 96, "bfloat16"),
    ("sth-sth B=64, 12 focuser frames", 768, 224, 3, 144, "bfloat16"),
    ("int8 transport, flagship sizes", 1024, 224, 3, 96, "int8"),
)
PHASES = ("glance", "policy", "extract", "focus", "classify")


def events_us(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` in us, from CUDA events around ``iters`` calls."""
    import torch

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
    return start.elapsed_time(end) * 1e3 / iters


def device_us(fn, iters: int = 20):
    """Mean device time of ``fn`` in us: the durations of the kernels,
    copies and memsets that the profiler saw on the device over ``iters``
    calls, summed, over ``iters``. None when it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / iters


def make_inputs(shape, device, gen):
    """Random frames (N, S, S, C) and int32 (y, x) offsets in range."""
    import torch

    _, n, s, c, p, dtype = shape
    dt = getattr(torch, dtype)
    if dt.is_floating_point:
        frames = torch.randn((n, s, s, c), generator=gen, device=device, dtype=dt)
    else:
        frames = torch.randint(-128, 128, (n, s, s, c), generator=gen, device=device,
                               dtype=dt)
    offs = torch.randint(0, s - p + 1, (n, 2), generator=gen, device=device,
                         dtype=torch.int32)
    return frames, offs


def shape_bytes(shape) -> int:
    """Bytes the extraction must move: patches read once, written once, and
    the (N, 2) int32 offsets."""
    _, n, _, c, p, dtype = shape
    e = 1 if dtype == "int8" else 2 if dtype == "bfloat16" else 4
    return 2 * n * p * p * c * e + n * 2 * 4


def time_shapes(extracts, device, shapes=SHAPES) -> list:
    """Each ``extracts[label](frames, offsets, P)`` and both copy_
    yardsticks at each shape: events and profiler times in us (``us`` and
    ``dev_us`` for the label "kernel", ``<label>_us`` and ``<label>_dev_us``
    for the others), bound in us."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for shape in shapes:
        name, n, s, c, p, dtype = shape
        frames, offs = make_inputs(shape, device, gen)
        out = torch.empty((n, p, p, c), dtype=frames.dtype, device=device)
        window = frames[:, 64:64 + p, 64:64 + p, :]
        dense = torch.empty_like(out).copy_(window)
        fns = {label: (lambda f=f: f(frames, offs, p)) for label, f in extracts.items()}
        fns.update(strided_copy=lambda: out.copy_(window),
                   contiguous_copy=lambda: out.copy_(dense))
        row = {"shape": name, "n": n, "frames": f"{s}x{s}x{c}", "p": p, "dtype": dtype,
               "bytes": shape_bytes(shape),
               "bound_us": shape_bytes(shape) / HBM_BYTES_PER_S * 1e6}
        for key, fn in fns.items():
            pre = "" if key == "kernel" else key + "_"
            row[pre + "us"] = events_us(fn, iters=20 if key == "plain" else 50)
            row[pre + "dev_us"] = device_us(fn)
        row["tb_per_s"] = row["bytes"] / row["us"] / 1e6
        row["share_of_bound"] = row["bound_us"] / row["us"]
        rows.append(row)
        print(json.dumps({"patch_shape": row}), flush=True)
        del frames, offs, out, window, dense
        torch.cuda.empty_cache()
    return rows


def profile_phases(model, frames, small, n_forwards: int = 3,
                   path: str = os.path.join(PROFILES, "trace_forward.json")) -> dict:
    """The profile of the flagship forward's phases on the cuDNN path
    (see the module docstring). Times in ms, means over ``n_forwards``
    forwards after one warm-up forward."""
    import torch
    from torch.profiler import record_function

    from adafocus_torch.models.gfv import extract_for_frames, fuse_and_classify
    from adafocus_torch.utils.profiling import load_trace, trace

    cfg = model.cfg
    b, t = frames.shape[:2]

    def run(n):
        with torch.inference_mode():
            for _ in range(n):
                with record_function("glance"):
                    fmap, pooled = model.glance(small)
                with record_function("policy"):
                    roll = model.policy_rollout(fmap)
                with record_function("extract"):
                    patches = extract_for_frames(frames, roll["actions"], cfg.image_size,
                                                 cfg.patch_size)
                with record_function("focus"):
                    local = model.focus(patches).reshape(b, t, -1)
                with record_function("classify"):
                    fuse_and_classify(model, pooled, local)

    run(1)   # warm-up: cuDNN's algorithm search, the kernel's build and caches
    with trace(os.path.dirname(path), os.path.basename(path)):
        run(n_forwards)
    return split_phases(load_trace(path), n_forwards)


def split_phases(events: list, n_runs: int, phases: tuple = PHASES) -> dict:
    """Device busy and idle time of each phase of ``phases`` annotated in
    the trace, means over ``n_runs`` runs (see ``profile_phases``); the
    whole run's window, idle time and idle share under ``"total"``.
    ``events``: a trace's, as ``adafocus_torch.utils.profiling.load_trace``
    reads them."""
    from adafocus_torch.utils.profiling import device_events

    launch_ts = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "user_annotation" and e.get("name") in phases))

    def phase_of(host_ts):
        for i, (a0, a1, _) in enumerate(ranges):
            if a0 <= host_ts <= a1:
                return i
        return None

    dev = device_events(events)
    owner, prev = [], None
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        # a kernel whose launch the trace did not record (a library's own
        # runtime) belongs with the kernel before it on the stream
        prev = phase_of(ts) if ts is not None else prev
        owner.append(prev)
    out = {name: {"window_ms": 0.0, "busy_ms": 0.0, "idle_ms": 0.0, "host_ms": 0.0}
           for name in phases}
    if "extract" in out:
        out["extract"].update(patch_kernel_ms=0.0, other_kernels_ms=0.0, other_kernels=[])
    last_end = None
    for i, (a0, a1, name) in enumerate(ranges):
        mine = [e for e, o in zip(dev, owner) if o == i]
        out[name]["host_ms"] += (a1 - a0) / 1e3 / n_runs
        if not mine:
            continue
        end = max(e["ts"] + e["dur"] for e in mine)
        start = last_end if last_end is not None else mine[0]["ts"]
        busy = sum(e["dur"] for e in mine)
        out[name]["window_ms"] += (end - start) / 1e3 / n_runs
        out[name]["busy_ms"] += busy / 1e3 / n_runs
        out[name]["idle_ms"] += (end - start - busy) / 1e3 / n_runs
        if name == "extract":
            for e in mine:
                key = "patch_kernel_ms" if "patch" in e["name"] else "other_kernels_ms"
                out[name][key] += e["dur"] / 1e3 / n_runs
                if key == "other_kernels_ms" and e["name"] not in out[name]["other_kernels"]:
                    out[name]["other_kernels"].append(e["name"])
        last_end = end
    window = sum(v["window_ms"] for v in out.values())
    idle = sum(v["idle_ms"] for v in out.values())
    out["total"] = {"window_ms": window, "idle_ms": idle,
                    "idle_share": idle / window if window else None,
                    "device_events": len(dev), "runs": n_runs}
    return out


def flagship_inputs(model, device, b: int = 64):
    import torch

    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    frames = torch.randn((b, t, s, s, 3), generator=gen, device=device, dtype=torch.bfloat16)
    small = torch.randn((b, t, g, g, 3), generator=gen, device=device, dtype=torch.bfloat16)
    return frames, small


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    out_path = sys.argv[2] if len(sys.argv) > 2 else os.path.join(PROFILES, "patch_times.json")
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("port_patch_times: no CUDA device is visible", file=sys.stderr)
        return 1
    from adafocus_torch.models.gfv import GFV, flagship
    from adafocus_torch.ops.patch import extract_patches

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    tag = os.path.abspath(out_path)
    shapes = time_shapes({"kernel": extract_patches}, device)
    torch.backends.cudnn.benchmark = True
    model = GFV(flagship(), device=device, generator=torch.Generator().manual_seed(SEED))
    frames, small = flagship_inputs(model, device)
    prof = profile_phases(model, frames, small,
                          path=os.path.join(os.path.dirname(tag), "trace_forward.json"))
    print(json.dumps({"profile": prof}), flush=True)
    result = {"tree": sys.argv[1], "card": card, "shapes": shapes, "profile": prof}
    os.makedirs(os.path.dirname(tag), exist_ok=True)
    with open(tag, "w") as f:
        json.dump(result, f, indent=1)
    print(f"{sys.argv[1]}: patch times and extraction profile ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
