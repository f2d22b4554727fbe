#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adafocus_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each raising on failure:

  1. the card: exits non-zero when no CUDA device is visible; prints the
     card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from ``adafocus_torch/csrc``;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, plus edge and odd shapes (patch
     extraction is a copy: bit-identical), and times kernel, plain version
     and a library yardstick with CUDA events;
  4. drives the flagship deployment forward (``models.gfv.inference``, bf16,
     B=2, T=16, full depth and width, weights from a seeded generator) with
     every kernel's launch count set to 0 just before and read just after;
     checks the logits' shape and finiteness, and bf16 against float32 on
     the same weights with the float32 greedy actions injected;
  5. times the flagship forward at B=64, T=16, bf16 (videos/s, three runs)
     and each of its five phases.

Prints one JSON line per kernel table, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
# bf16 against float32 on injected actions: max|d| / max|f32| of the logits
BF16_REL_TOL = 3e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
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
    return start.elapsed_time(end) / iters


def _random_frames(shape, dtype, gen):
    import torch

    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, generator=gen,
                         device=gen.device, dtype=dtype)


def check_patch_kernel(device) -> dict:
    """Phase 3 for ``extract_patches``: bit-identical to the plain version in
    bf16, f32 and int8 at the flagship shape and at odd shapes, then timed at
    the main path's B=64 shape. Returns the kernel's table row (without
    ``launches``)."""
    import torch

    from adafocus_torch.ops.patch import extract_patches, extract_patches_reference

    gen = torch.Generator(device=device).manual_seed(SEED)
    # (N, H, W, C, P): flagship B=64 x T=16, odd square, H != W, N > 65535
    shapes = [(1024, 224, 224, 3, 96), (3, 100, 100, 3, 37),
              (7, 50, 77, 5, 13), (70000, 12, 10, 3, 5)]
    worst = 0.0
    for n, h, w, c, p in shapes:
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            frames = _random_frames((n, h, w, c), dtype, gen)
            y = torch.randint(0, h - p + 1, (n,), generator=gen, device=device)
            x = torch.randint(0, w - p + 1, (n,), generator=gen, device=device)
            # edges and out-of-range starts, which wrap and clamp as in
            # lax.dynamic_slice
            edge_y = [0, h - p, -5, h - p + 3, 10**6, 0]
            edge_x = [0, w - p, w - p + 1, -7, 0, -(10**6)]
            k = min(n, len(edge_y))
            y[:k] = torch.tensor(edge_y[:k], device=device)
            x[:k] = torch.tensor(edge_x[:k], device=device)
            offs = torch.stack([y, x], 1).to(torch.int32)
            got = extract_patches(frames, offs, p)
            want = extract_patches_reference(frames, offs, p)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(
                    f"extract_patches differs from the plain version at "
                    f"N={n} {h}x{w}x{c} P={p} {dtype}")
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            print(f"extract_patches N={n} {h}x{w}x{c} P={p} {dtype}: "
                  f"bit-identical", flush=True)

    n, s, c, p = 1024, 224, 3, 96
    frames = _random_frames((n, s, s, c), torch.bfloat16, gen)
    offs = torch.randint(0, s - p + 1, (n, 2), generator=gen, device=device,
                         dtype=torch.int32)
    window = frames[:, 64:64 + p, 64:64 + p, :]
    out = torch.empty((n, p, p, c), dtype=frames.dtype, device=device)
    ms = _time_ms(lambda: extract_patches(frames, offs, p))
    plain_ms = _time_ms(lambda: extract_patches_reference(frames, offs, p), iters=20)
    # yardstick: one strided copy of the same bytes (one window for all N)
    library_ms = _time_ms(lambda: out.copy_(window))
    moved = 2 * n * p * p * c * frames.element_size() + offs.numel() * 4
    return {
        "name": "extract_patches",
        "route": "cuda",
        "source": "adafocus_torch/csrc/patch_extract.cu",
        "replaces": "adafocus_tpu/ops/patch.py:164",
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "shape": f"N={n} {s}x{s}x{c} P={p} bf16",
    }


def flagship_forward(device) -> dict:
    """Phase 4: the main path once in bf16 with launch counts, then bf16
    against float32 on the same weights and injected actions."""
    import torch

    from adafocus_torch.models.gfv import (
        GFV, flagship, glance_policy_actions, inference, inference_with_actions,
    )
    from adafocus_torch.ops.patch import extract_patches

    # float32 means float32: no TF32 in cuDNN convs or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = flagship()
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    b, t, s, g = 2, cfg16.num_frames, cfg16.image_size, cfg16.glance_size
    gen = torch.Generator().manual_seed(SEED + 1)
    frames = torch.randn((b, t, s, s, 3), generator=gen).to(device)
    small = torch.randn((b, t, g, g, 3), generator=gen).to(device)
    model16 = GFV(cfg16, device=device, generator=torch.Generator().manual_seed(SEED))
    frames16, small16 = frames.bfloat16(), small.bfloat16()

    extract_patches.launches = 0
    logits = inference(model16, frames16, small16, device=device)
    torch.cuda.synchronize()
    launches = {"extract_patches": extract_patches.launches}
    if tuple(logits.shape) != (b, t, cfg16.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("bf16 logits are not finite")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    model32 = GFV(cfg32, device=device, generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        roll32 = glance_policy_actions(model32, small)[2]
        roll16 = glance_policy_actions(model16, small16)[2]
    logits32 = inference_with_actions(model32, frames, small, roll32["actions"],
                                      device=device)
    logits16 = inference_with_actions(model16, frames16, small16,
                                      roll32["actions"], device=device)
    torch.cuda.synchronize()
    if not torch.isfinite(logits32).all():
        raise AssertionError("float32 logits are not finite")
    rel = ((logits16.float() - logits32).abs().max()
           / logits32.abs().max()).item()
    agree = (roll16["action_idx"] == roll32["action_idx"]).float().mean().item()
    print(f"flagship B={b} T={t}: logits {tuple(logits.shape)} finite; "
          f"bf16 vs f32 on injected actions max|d|/max|f32| = {rel!r} "
          f"(limit {BF16_REL_TOL}); greedy action agreement bf16/f32 = "
          f"{agree!r}", flush=True)
    if not rel <= BF16_REL_TOL:
        raise AssertionError(f"bf16 logits off f32 by {rel} > {BF16_REL_TOL}")
    del model32
    return {"launches": launches, "model16": model16}


def flagship_throughput(model16, device, b: int = 64):
    """Phase 5: the bf16 flagship forward at B=64, T=16. Returns (videos/s
    of three timed runs, mean device ms of each phase over five forwards,
    timed by CUDA events between the phases)."""
    import torch

    from adafocus_torch.models.gfv import (
        extract_for_frames, fuse_and_classify, inference,
    )

    torch.backends.cudnn.benchmark = True
    cfg = model16.cfg
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    frames = torch.randn((b, t, s, s, 3), generator=gen, device=device,
                         dtype=torch.bfloat16)
    small = torch.randn((b, t, g, g, 3), generator=gen, device=device,
                        dtype=torch.bfloat16)
    vps = [b / (_time_ms(lambda: inference(model16, frames, small, device=device),
                         iters=10, warmup=3) / 1e3) for _ in range(3)]

    names = ("glance", "policy", "extract", "focus", "classify")
    phases = dict.fromkeys(names, 0.0)
    iters = 5
    with torch.inference_mode():
        for i in range(iters + 1):   # the first forward is warm-up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            fmap, pooled = model16.glance(small)
            ev[1].record()
            roll = model16.policy_rollout(fmap)
            ev[2].record()
            patches = extract_for_frames(frames, roll["actions"], s, cfg.patch_size)
            ev[3].record()
            local = model16.focus(patches).reshape(b, t, -1)
            ev[4].record()
            fuse_and_classify(model16, pooled, local)
            ev[5].record()
            torch.cuda.synchronize()
            if i:
                for k, name in enumerate(names):
                    phases[name] += ev[k].elapsed_time(ev[k + 1]) / iters
    return vps, phases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from adafocus_torch.ops import _kernels

    build_s = _kernels.build()
    print(f"kernels built in {build_s:.2f} s", flush=True)
    for name, log in _kernels.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    row = check_patch_kernel(device)
    fwd = flagship_forward(device)
    row["launches"] = fwd["launches"]["extract_patches"]
    vps, phases = flagship_throughput(fwd["model16"], device)
    print(f"flagship bf16 B=64 T=16: videos/s {vps!r}; phase ms "
          f"{json.dumps(phases)} ({card})", flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
