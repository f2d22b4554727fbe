#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adafocus_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each raising on failure:

  1. the card: exits non-zero when no CUDA device is visible; prints the
     card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from ``adafocus_torch/csrc``;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, plus edge and odd shapes (patch
     extraction is a copy: bit-identical; the fused blocks at every distinct
     block shape of the flagship in float32 and bf16, at N=4 and, in bf16,
     at N=1024), and times kernel, plain version and a library yardstick
     with CUDA events;
  4. drives the flagship deployment forward (``models.gfv.inference``, bf16,
     B=2, T=16, full depth and width, weights from a seeded generator) on
     both backbone paths, library convs (``fused="auto"``) and fused blocks
     (``fused="on"``), each with every kernel's launch count set to 0 just
     before and read just after; checks the logits' shape and finiteness,
     bf16 against float32 on the same weights with the float32 greedy
     actions injected, and fused against unfused in bf16 and in float32;
  5. times the flagship forward at B=64, T=16, bf16 on both paths
     (videos/s, three runs each) and each of its five phases.

Prints the per-shape table of the fused blocks and the kernel table as JSON
lines, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
# bf16 against float32 on injected actions: max|d| / max|f32| of the logits
BF16_REL_TOL = 3e-2
# fused blocks against unfused library convs, float32 with TF32 off: the
# two differ by where BatchNorm is applied and by summation order
FUSED_F32_REL_TOL = 1e-3
# a fused-block kernel against its plain version, max|d| / max|plain|:
# float32 differs by summation order only; in bf16 a hidden value whose
# rounding flips moves by one bf16 ulp
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM peak memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak (data sheet)
FUSED_LAUNCHES = {"extract_patches": 1, "fused_inverted_residual": 17,
                  "fused_bottleneck": 16}


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


def _block_shapes(model) -> dict:
    """The distinct residual blocks of the flagship's two backbones, in
    forward order: {kernel name: [{block, module, key, h, launches}]}, where
    ``key`` = (H, Cin, Chid, Cout, stride, expand or downsample) and
    ``launches`` counts the blocks of that shape in one forward."""
    from adafocus_torch.ops.fused_blocks import out_size

    cfg = model.cfg
    found = {"fused_inverted_residual": {}, "fused_bottleneck": {}}
    h = out_size(cfg.glance_size, 2)                 # after the stem
    for name in model.glancer.block_names:
        blk = getattr(model.glancer, name)
        stride, expand = blk.dw.conv.stride[0], blk.expand is not None
        key = (h, blk.dw.conv.in_channels if not expand else blk.expand.conv.in_channels,
               blk.dw.conv.out_channels, blk.project.conv.out_channels, stride, expand)
        found["fused_inverted_residual"].setdefault(
            key, {"block": f"glancer.{name}", "module": blk, "launches": 0})["launches"] += 1
        h = out_size(h, stride)
    h = out_size(out_size(cfg.patch_size, 2), 2)     # stem, then the max-pool
    for name in model.focuser.block_names:
        blk = getattr(model.focuser, name)
        stride = blk.conv2.conv.stride[0]
        key = (h, blk.conv1.conv.in_channels, blk.conv1.conv.out_channels,
               blk.conv3.conv.out_channels, stride, blk.down is not None)
        found["fused_bottleneck"].setdefault(
            key, {"block": f"focuser.{name}", "module": blk, "launches": 0})["launches"] += 1
        h = out_size(h, stride)
    return {k: [dict(v, key=key) for key, v in d.items()] for k, d in found.items()}


def _randomize_bn(module, gen):
    """Random BatchNorm scale, bias and running statistics, so that folded
    biases are not zero (a fresh model's are)."""
    import torch

    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.5, 0.5),
                              (m.running_mean, -0.5, 0.5), (m.running_var, 0.5, 1.5)):
                t.data.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)
    return module


def _rel_err(got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    return d / want.float().abs().max().item(), d


def _block_fns(kernel: str):
    from adafocus_torch.ops import fused_blocks as fb

    if kernel == "fused_inverted_residual":
        return (fb.fold_inv_residual, fb.fused_inverted_residual,
                fb.fused_inverted_residual_reference)
    return fb.fold_bottleneck, fb.fused_bottleneck, fb.fused_bottleneck_reference


def _block_args(kernel: str, module) -> dict:
    if kernel == "fused_inverted_residual":
        return {"stride": module.dw.conv.stride[0], "use_res": module.use_res}
    return {"stride": module.conv2.conv.stride[0], "use_res": True}


def _check_block(kernel, module, h, cin, gen, device, use_res=None, label=""):
    """One block's kernel against its plain version at N=4 in float32 and
    bf16, the block's BatchNorm randomised. Returns the largest |d|."""
    import torch

    fold, run, plain = _block_fns(kernel)
    blk = _randomize_bn(copy.deepcopy(module).float().cpu(), gen).to(device)
    args = _block_args(kernel, blk)
    if use_res is not None:
        args["use_res"] = use_res
    worst, rels = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        params = fold(blk, dtype)
        x = torch.randn((4, h, h, cin), generator=gen).to(device, dtype)
        got = run(x, params, **args)
        want = plain(x, params, **args)
        torch.cuda.synchronize()
        rels[name], d = _rel_err(got, want)
        if got.shape != want.shape or not rels[name] <= BLOCK_TOL[name]:
            raise AssertionError(f"{kernel} {label} {name} differs from its plain "
                                 f"version: {rels[name]} > {BLOCK_TOL[name]}")
        worst = max(worst, d)
    print(f"{kernel} {label} N=4 {h}x{h}x{cin} -> {tuple(got.shape[1:])} {args}: "
          f"max|d|/max|plain| {rels} (limits {BLOCK_TOL})", flush=True)
    return worst


def _block_cost(kernel: str, key, n: int) -> tuple:
    """(bytes, flops) that one call must move and do: x read once, out and
    the folded weights once (bf16 matrices, float32 depthwise and biases)."""
    from adafocus_torch.ops.fused_blocks import out_size

    h, cin, chid, cout, stride, flag = key
    ho = out_size(h, stride)
    px, po = n * h * h, n * ho * ho
    if kernel == "fused_inverted_residual":
        weights = 2 * (cin * chid * flag + chid * cout) + 4 * (9 * chid + 2 * chid + cout)
        macs = px * cin * chid * flag + po * chid * (9 + cout)
    else:
        weights = 2 * (cin * chid + 9 * chid * chid + chid * cout + cin * cout * flag)
        weights += 4 * (2 * chid + cout * (1 + flag))
        macs = px * cin * chid + po * chid * (9 * chid + cout) + po * cin * cout * flag
    return 2 * (px * cin + po * cout) + weights, 2 * macs


def check_fused_blocks(model16, device) -> tuple:
    """Phase 3 for the two fused-block kernels: each against its plain
    version at every distinct flagship block shape (N=4, float32 and bf16,
    BatchNorm randomised), at an odd stride-2 shape (9^2 -> 5^2) and with
    ``use_res=False``; then each shape timed at the main path's N=1024 in
    bf16 (kernel, plain version, and the port's unfused library-conv block
    as the yardstick) and checked against the plain version there too.
    Returns (kernel rows without ``launches``, per-shape rows)."""
    import torch

    from adafocus_torch.models.mobilenet import InvertedResidual
    from adafocus_torch.models.resnet import Bottleneck
    from adafocus_torch.ops.fused_blocks import plan_bottleneck, plan_inv_residual

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 3)
    shapes = _block_shapes(model16)
    worst = {k: 0.0 for k in shapes}
    for kernel, entries in shapes.items():
        for e in entries:
            h, cin = e["key"][:2]
            worst[kernel] = max(worst[kernel], _check_block(
                kernel, e["module"], h, cin, gen, device, label=e["block"]))
    extras = [
        ("fused_inverted_residual", InvertedResidual(8, 12, 2, 6), 9, 8, None, "odd 9->5"),
        ("fused_inverted_residual", InvertedResidual(16, 16, 2, 1), 9, 16, None,
         "odd 9->5, no expand"),
        ("fused_bottleneck", Bottleneck(64, 16, 2, True), 9, 64, None, "odd 9->5"),
    ]
    ir1, bn1, bn_down = (shapes["fused_inverted_residual"][2], shapes["fused_bottleneck"][1],
                         shapes["fused_bottleneck"][2])
    extras += [
        ("fused_inverted_residual", ir1["module"], ir1["key"][0], ir1["key"][1], False,
         f"{ir1['block']} use_res=False"),
        ("fused_bottleneck", bn1["module"], bn1["key"][0], bn1["key"][1], False,
         f"{bn1['block']} use_res=False"),
        ("fused_bottleneck", bn_down["module"], bn_down["key"][0], bn_down["key"][1], False,
         f"{bn_down['block']} use_res=False"),
    ]
    for kernel, module, h, cin, use_res, label in extras:
        worst[kernel] = max(worst[kernel], _check_block(
            kernel, module.to(device), h, cin, gen, device, use_res, label))

    n = 1024
    per_shape = []
    for kernel, entries in shapes.items():
        fold, run, plain = _block_fns(kernel)
        plan_fn = plan_inv_residual if kernel == "fused_inverted_residual" else plan_bottleneck
        for e in entries:
            h, cin, chid, cout, stride, flag = e["key"]
            module = e["module"]
            params, args = fold(module, torch.bfloat16), _block_args(kernel, module)
            x = torch.randn((n, h, h, cin), generator=gen).to(device, torch.bfloat16)
            rel, d = _rel_err(run(x, params, **args), plain(x, params, **args))
            if not rel <= BLOCK_TOL["bfloat16"]:
                raise AssertionError(f"{kernel} {e['block']} N={n} bf16: {rel}")
            worst[kernel] = max(worst[kernel], d)
            x_nchw = x.permute(0, 3, 1, 2)
            with torch.inference_mode():
                ms = _time_ms(lambda: run(x, params, **args), iters=10, warmup=2)
                plain_ms = _time_ms(lambda: plain(x, params, **args), iters=5, warmup=1)
                library_ms = _time_ms(lambda: module(x_nchw), iters=10, warmup=2)
            moved, flops = _block_cost(kernel, e["key"], n)
            bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
            row = {"kernel": kernel, "block": e["block"], "launches": e["launches"],
                   "shape": f"{h}x{h}x{cin} -> {chid} -> {cout} s{stride}",
                   "plan": plan_fn(h, h, cin, chid, cout, stride, flag, 2)._asdict(),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "bytes": moved, "flops": flops, "max_rel_err": rel}
            per_shape.append(row)
            print(f"{kernel} {e['block']} x{e['launches']} N={n} bf16 {row['shape']}: "
                  f"kernel {ms!r} ms, plain {plain_ms!r} ms, library block "
                  f"{library_ms!r} ms, bound {row['bound_ms']!r} ms ({row['bound_by']}); "
                  f"max|d|/max|plain| {rel!r}", flush=True)
            del x, x_nchw
            torch.cuda.empty_cache()

    sources = {"fused_inverted_residual": ("fused_inv_residual.cu", 247),
               "fused_bottleneck": ("fused_bottleneck.cu", 397)}
    rows = []
    for kernel, (src, line) in sources.items():
        mine = [r for r in per_shape if r["kernel"] == kernel]
        total = {k: sum(r["launches"] * r[k] for r in mine)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(r["launches"] * r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        rows.append({
            "name": kernel, "route": "cuda", "source": f"adafocus_torch/csrc/{src}",
            "replaces": f"adafocus_tpu/ops/fused_blocks.py:{line}",
            "max_abs_err": worst[kernel], **total,
            "bound_by": "bytes" if 2 * by_bytes >= total["bound_ms"] else "operations",
            "shape": f"every block of one flagship forward, N={n} bf16, summed",
        })
    return rows, per_shape


def _fused_with_actions(model, frames, small, actions):
    """The fused forward with injected actions, composed from the phases."""
    import torch

    from adafocus_torch.models.fused_inference import fused_focus, fused_glance
    from adafocus_torch.models.gfv import extract_for_frames, fuse_and_classify

    cfg = model.cfg
    b, t = small.shape[:2]
    with torch.inference_mode():
        _, pooled = fused_glance(model, small)
        patches = extract_for_frames(frames, actions, cfg.image_size, cfg.patch_size)
        local = fused_focus(model, patches).reshape(b, t, -1)
        return fuse_and_classify(model, pooled, local)


def _launch_counts(reset: bool = False) -> dict:
    from adafocus_torch.ops.fused_blocks import fused_bottleneck, fused_inverted_residual
    from adafocus_torch.ops.patch import extract_patches

    fns = {"extract_patches": extract_patches,
           "fused_inverted_residual": fused_inverted_residual,
           "fused_bottleneck": fused_bottleneck}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def flagship_forward(model16, device) -> dict:
    """Phase 4: the main path once in bf16 on each backbone path, with
    launch counts; then, on the same weights and injected float32 greedy
    actions, bf16 against float32 and fused against unfused."""
    import torch

    from adafocus_torch.models.gfv import (
        GFV, glance_policy_actions, inference, inference_with_actions,
    )
    from adafocus_torch.models.fused_inference import fused_glance

    # float32 means float32: no TF32 in cuDNN convs or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = model16.cfg
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    b, t, s, g = 2, cfg16.num_frames, cfg16.image_size, cfg16.glance_size
    gen = torch.Generator().manual_seed(SEED + 1)
    frames = torch.randn((b, t, s, s, 3), generator=gen).to(device)
    small = torch.randn((b, t, g, g, 3), generator=gen).to(device)
    frames16, small16 = frames.bfloat16(), small.bfloat16()

    launches = {}
    for fused in ("auto", "on"):
        _launch_counts(reset=True)
        logits = inference(model16, frames16, small16, device=device, fused=fused)
        torch.cuda.synchronize()
        launches[fused] = _launch_counts()
        print(f"flagship B={b} T={t} fused={fused!r}: launches {launches[fused]}",
              flush=True)
        if tuple(logits.shape) != (b, t, cfg16.num_classes):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"bf16 logits (fused={fused!r}) are not finite")
    if launches["auto"]["extract_patches"] < 1:
        raise AssertionError("kernel extract_patches was not launched on the main path")
    if launches["on"] != FUSED_LAUNCHES:
        raise AssertionError(f"fused path launches {launches['on']}, want {FUSED_LAUNCHES}")

    model32 = GFV(cfg32, device=device, generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        roll32 = glance_policy_actions(model32, small)[2]
        roll16 = glance_policy_actions(model16, small16)[2]
        roll16f = model16.policy_rollout(fused_glance(model16, small16)[0])
    acts = roll32["actions"]
    logits32 = inference_with_actions(model32, frames, small, acts, device=device)
    logits16 = inference_with_actions(model16, frames16, small16, acts, device=device)
    logits32f = _fused_with_actions(model32, frames, small, acts)
    logits16f = _fused_with_actions(model16, frames16, small16, acts)
    torch.cuda.synchronize()
    for name, v in (("float32", logits32), ("fused float32", logits32f)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"{name} logits are not finite")
    checks = [("bf16 vs f32", logits16, logits32, BF16_REL_TOL),
              ("fused bf16 vs f32", logits16f, logits32, BF16_REL_TOL),
              ("fused bf16 vs unfused bf16", logits16f, logits16, BF16_REL_TOL),
              ("fused f32 vs unfused f32 (TF32 off)", logits32f, logits32,
               FUSED_F32_REL_TOL)]
    agree = (roll16["action_idx"] == roll32["action_idx"]).float().mean().item()
    agree_f = (roll16f["action_idx"] == roll16["action_idx"]).float().mean().item()
    print(f"flagship B={b} T={t}: greedy action agreement bf16/f32 = {agree!r}, "
          f"fused/unfused bf16 = {agree_f!r}", flush=True)
    for name, got, want, tol in checks:
        rel = _rel_err(got, want)[0]
        print(f"flagship B={b} T={t} on injected actions, {name}: "
              f"max|d|/max|ref| = {rel!r} (limit {tol})", flush=True)
        if not rel <= tol:
            raise AssertionError(f"{name}: logits differ by {rel} > {tol}")
    del model32
    return {"launches": launches}


def flagship_throughput(model16, device, fused: str, b: int = 64, iters: int = 10):
    """Phase 5: the bf16 flagship forward at B=64, T=16 on one backbone path.
    Returns (videos/s of three timed runs, mean device ms of each phase over
    five forwards, timed by CUDA events between the phases)."""
    import torch

    from adafocus_torch.models.fused_inference import fused_focus, fused_glance
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
    vps = [b / (_time_ms(lambda: inference(model16, frames, small, device=device,
                                           fused=fused),
                         iters=iters, warmup=3) / 1e3) for _ in range(3)]

    on = fused == "on"
    glance = (lambda x: fused_glance(model16, x)) if on else model16.glance
    focus = (lambda x: fused_focus(model16, x)) if on else model16.focus
    names = ("glance", "policy", "extract", "focus", "classify")
    phases = dict.fromkeys(names, 0.0)
    n_timed = 5
    with torch.inference_mode():
        for i in range(n_timed + 1):   # the first forward is warm-up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            fmap, pooled = glance(small)
            ev[1].record()
            roll = model16.policy_rollout(fmap)
            ev[2].record()
            patches = extract_for_frames(frames, roll["actions"], s, cfg.patch_size)
            ev[3].record()
            local = focus(patches).reshape(b, t, -1)
            ev[4].record()
            fuse_and_classify(model16, pooled, local)
            ev[5].record()
            torch.cuda.synchronize()
            if i:
                for k, name in enumerate(names):
                    phases[name] += ev[k].elapsed_time(ev[k + 1]) / n_timed
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
        # -Xptxas -v: one "Used N registers" and one spill line per kernel
        usage = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"nvcc {name}: {'; '.join(usage)}", flush=True)

    from adafocus_torch.models.gfv import GFV, flagship

    model16 = GFV(flagship(), device=device,
                  generator=torch.Generator().manual_seed(SEED))
    rows = [check_patch_kernel(device)]
    fused_rows, per_shape = check_fused_blocks(model16, device)
    rows += fused_rows
    launches = flagship_forward(model16, device)["launches"]
    # each kernel's count from the run of its own path: the library-conv
    # path (slice 1) for extraction, the fused path for the blocks
    rows[0]["launches"] = launches["auto"]["extract_patches"]
    for row in fused_rows:
        row["launches"] = launches["on"][row["name"]]
    for fused, iters in (("auto", 10), ("on", 5)):
        vps, phases = flagship_throughput(model16, device, fused, iters=iters)
        print(f"flagship bf16 B=64 T=16 fused={fused!r}: videos/s {vps!r}; phase ms "
              f"{json.dumps(phases)} ({card})", flush=True)
    print(json.dumps({"fused_shapes": per_shape}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
