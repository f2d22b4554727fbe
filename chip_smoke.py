#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``adafocus_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA GPU

Phases, each raising on failure:

  1. the card: exits non-zero when no CUDA device is visible; prints the
     card's name and power limit (nvidia-smi);
  2. builds every CUDA kernel of the port from ``adafocus_torch/csrc``
     (every nvcc at once, ``int8_conv.cu`` as twelve units; each library's
     seconds), prints each kernel's registers and spills (``-Xptxas -v``)
     and, from ``cuobjdump -sass`` (the three dumps at once), the
     tensor-core instructions (HGMMA = wgmma, HMMA and IMMA = mma.sync) of
     each fused-block and int8 kernel instance;
     raises if a bf16 instance has no tensor-core instruction, or if an
     instance of the int8 GEMM kernel has no HGMMA or any mma.sync;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it, plus edge and odd shapes (patch
     extraction is a copy: bit-identical, at every misalignment of the
     source column, on an unaligned base and from actions, whose offsets
     must equal ``patch_offsets``'; the fused blocks
     at every distinct block shape of the flagship in float32 and bf16, at
     N=4 in two rounds of fresh inputs and, in bf16, at N=1024; and at
     every distinct block shape of the matched sth-sth configuration in its
     temporal-shift split, ``use_res=False``, at N=4 in float32 and bf16
     and in bf16 at N=512 glance frames and N=768 patches), and times
     kernel, plain version and a library yardstick (patch extraction at the
     four shapes of ``port_patch_times.SHAPES``, beside a strided and a
     contiguous ``copy_`` of the same bytes; the blocks beside cuDNN's
     block, or its branch in the TSM split): the kernel and the yardstick
     by CUDA events around back-to-back calls and by the profiler's device
     spans (``device_ms``; every share of a bound and every rate from
     those), a row whose events exceed its device time by more than 1.5x
     marked ``host_bound``; the plain version by events;
  4. drives the flagship deployment forward (``models.gfv.inference``, bf16,
     B=2, T=16, full depth and width, weights from a seeded generator) on
     both backbone paths, library convs (``fused="auto"``) and fused blocks
     (``fused="on"``), each with every kernel's launch count set to 0 just
     before and read just after; checks the logits' shape and finiteness,
     bf16 against float32 on the same weights with the float32 greedy
     actions injected, and fused against unfused in bf16 and in float32;
     holds the patch kernel from the policy's own actions
     (``extract_patches_at``) against ``patch_offsets`` and the plain
     version on the forward's frames;
  5. times the flagship forward at B=64, T=16, bf16 on both paths
     (videos/s, three runs each) and each of its five phases, checks the
     patch kernel from the policy's actions there as in phase 4, profiles
     three forwards on the cuDNN path (``torch.profiler``): each phase's
     device window, busy and idle time, the extraction phase split into its
     patch kernel, other kernels and device idle;
  6. training on the card (``adafocus_torch.train``): the patch kernel under
     autograd (forward and backward from actions and from offsets against
     the plain version on the CPU, bit for bit); the stage-1 step, slice
     5's main path, on the bf16 flagship at B=64 (float32 parameters,
     bf16 compute), two warm-up and five timed steps with the launch counts
     set to 0 just before: videos/s, the split into glance, extraction,
     focus, classify, backward and optimizer by CUDA events, peak memory,
     exactly one patch launch a step, a finite loss, the glancer and policy
     bit-identical and every focuser and classifier tensor moved; one step
     in bf16, float32 (TF32 off) and float64 on the same weights, batch and
     actions at B=8 (losses, and each trained component's gradient cosine
     and norm ratio: float32 against float64, bf16 against float32); stages
     0 and 3 and the eval step at B=2 with the same checks, untimed;
  7. the stage-2 (PPO) step, this slice's main path, on the bf16 flagship
     at B=64 (reward 'random'), two warm-up and five timed steps with the
     launch counts set to 0 just before: videos/s, the split into glance,
     rollout, extraction, focus, classify, baseline, returns and update by
     CUDA events, peak memory, exactly two patch launches a step (behavior
     and baseline actions), finite metrics, every step's mean PPO ratio
     within 1e-3 of 1, the glancer, focuser and classifier bit-identical
     and every policy parameter moved; one step in bf16, float32 (TF32 off)
     and float64 on the same weights, batch and injected behavior and
     baseline actions at B=8 (the PPO loss, the rewards and the policy's
     gradient: float32 against float64 held, bf16 against float32
     printed); 10^6 draws of the sampler on the card, each anchor's
     frequency within 5 sigma of its softmax probability. Three more
     stage-2 steps run under ``torch.profiler`` (each phase's device
     window, busy and idle time; the step's device idle share).
  8. the matched sth-sth configuration (``benchmark.sthsth_cfg(144)``: 8
     glance frames at 224^2, 12 focus frames cropped to 144^2, TSM
     backbones, continuous BatchNorm policy, sum consensus, 174 classes,
     bf16, full depth and width), this slice's main path
     (``models.gfv_sthsth.inference_sthsth``): at B=2 on both backbone
     paths with the launch counts set to 0 just before (one patch launch
     on the cuDNN path; 17 + 16 + 1 on the fused path), logits (2, 174)
     and finite; bf16 against float32 with the float32 actions injected
     (3e-2), fused against unfused (bf16 3e-2, float32 with TF32 off 1e-3);
     the patch kernel from the policy's continuous actions against
     ``patch_offsets`` and the plain version, bit for bit; then at B=64 on
     both paths, videos/s of three runs, each phase's mean ms by CUDA
     events and peak memory; then ``port_bench.bench`` once (its JSON on a
     line of its own).
  9. the port's CLI, this slice's main path (``adafocus_torch.cli.train``
     and ``cli.evaluate``, called in-process with ``--config
     configs/actnet_default.yaml``: the flagship width, bf16, B=32, 96
     synthetic videos in a device cache): stage 1 (two epochs), stage 2
     warm-started from it (two epochs), stage 3 from stage 2 (one epoch),
     then evaluate with the learned, random and center policies, each with
     the launch counts set to 0 just before: one patch launch a stage-1/3
     step and eval batch, two a stage-2 step, no fused-block launch; every
     frame batch from the device cache (no frame byte from the host after
     the fill); each warm start bit-exact for the components of
     ``STAGE_LOADS`` and the components a stage does not train unchanged
     by it; videos/s of each epoch (loader, batch prep and step) beside
     phases 6/7's step-only videos/s; the gather, batch prep and step ms
     over 21 batches (seven epochs of the cache) with cuDNN's autotuner
     off, the CLI's setting; a profile of the same 21 batches in sequence
     (each phase's device busy, idle and host time); the caches' fill
     seconds and bytes; peak memory; the batch prep on the card against
     the CPU's (train and eval, the same draws, float32, TF32 off, 1e-4);
     the patch kernel at the CLI's shape (N=512) on a batch of the cache,
     from random and from the policy's actions, bit for bit against the
     plain version.
 10. the sth-sth family's training, this slice's main path
     (``train.stages_sthsth``, the CLI's ``run.family=sthsth``), at the
     matched configuration with the recipe's TSN optimizer groups, bf16
     compute: stages 1, 2 (reward 'random') and 3 at B=64, two warm-up and
     five timed steps each with the launch counts set to 0 just before
     (videos/s, the phase split by CUDA events, peak memory, exactly 1, 2
     and 1 patch launches a step, every stage-2 ratio_mean within 1e-3 of 1,
     frozen components bit-identical, every trained tensor moved); the patch
     kernel on the stage-1 batch (N=768) bit for bit; the discrete
     BatchNorm-encoder policy's stage 2 at video_div=2, B=8 (ratios); one
     step of each stage in float32 (TF32 off) against float64 at B=4 on the
     same weights, batch and injected draws (phase 6's and 7's limits; bf16
     against float32 printed); 10^6 draws of the continuous sampler (the
     clamped shares and the unclamped mean within 5 sigma); remat on against
     off, one float32 stage-1 step at B=64 (loss, updates, running
     statistics updated once, both peak memories); the CLI with
     ``configs/sthsth_default.yaml`` (B=32, 64 synthetic dual-rate clips in
     a device cache): stages 1 -> 2 -> 3 and evaluate (learned, random,
     center), each with its patch launches counted.

 11. AdaFocus+ (``models.gfv_plus``, ``train.stages_plus``) at the serving
     point ``benchmark.plus_cfg((96, 8))`` (K=8 of T=16 frames focused,
     bf16, full depth and width), this slice's main path: ``inference_plus``
     at B=2 with the launch counts set to 0 just before (one patch launch,
     no fused-block launch), logits (2, 16, 200) finite, bf16 against
     float32 with float32's frame indices and actions injected (3e-2), the
     patch kernel on the gathered frames bit for bit, the greedy top-K on
     the card equal to the CPU's stable sort, ties included; at B=64
     videos/s of three runs, each phase's ms (glance, select, gather,
     policy, extraction, focus, scatter, classify), peak memory, and at
     N=512 the frame gather beside the patch kernel on the gathered frames
     (each beside its byte bound; the plain version, ``copy_`` and
     ``index_select`` yardsticks; each but the plain version also by its
     device time); the ST stage-1 and the joint stage-2
     step (``plus_rl``, reward 'random') at B=64, two warm-up and five
     timed steps (videos/s, phase split, peak memory, exactly 1 and 2 patch
     launches a step, every ratio_mean within 1e-3 of 1, frozen components
     bit-identical, every trained tensor moved); one step of each in
     float32 (TF32 off) against float64 at B=4 on injected draws (phases 6
     and 7's limits; bf16 against float32 printed); the ST stage-3 and eval
     steps at B=2; the CLI with ``model.frame_budget=8 model.plus_rl=true``
     (B=32, 64 synthetic clips in a device cache): stages 1 -> 2 -> 3 and
     evaluate, each with its patch launches counted.
 12. int8 PTQ serving (``models.quant_inference``, ``ops.quant``), this
     slice's main path. The two int8 kernels of ``csrc/int8_conv.cu`` (built
     in phase 2, with their registers and spills) against their plain
     versions at every int8 unit shape of the flagship's glancer (224^2)
     and focuser (96^2 patches), of the matched configuration's focuser
     (144^2) and of the flagship's heads at M = 1 and 64: the int32
     accumulators equal, the float32 outputs bit-identical but where the
     plain version's float64-emulated FMA double-rounds (counted, each
     within 1 ulp), the bf16 store the float32 output rounded; each
     backbone unit also with the fused options the int8 forward runs it
     with (its codes at the consumer's scale, its bf16 output where kept,
     the residual and the ReLU after it, an input quantized on load): bf16
     outputs bit-identical but for counted double roundings, codes equal
     but at those outputs (each within 1); each shape timed as the forward
     launches it at N=1024 (the B=64 forward's frames and patches) and N=64
     (the matched focuser at N=64, the heads at their M), by events and by
     its device time, beside the plain version and the yardstick
     (``torch._int_mm`` where it takes the product, else cuDNN's or
     cuBLAS's bf16 op; also by its device time) with its bound (the bytes
     each fused unit reads and writes). Each int8 backbone of the flagship
     and of the matched configuration (TSM) fused against the unfused
     composition (``quantize_act`` before every unit, the residual added
     apart) on the same kernels: no ``quantize_act`` in the fused one, its
     every unit's codes, map and pooled features equal. Then each family (the flagship, the
     matched configuration, ``plus_cfg((96, 8))``) in modes int8 and
     int8+heads at B=2, calibrated on two seeded batches: logits on int8
     transport frames against the port's bf16 and float32 forwards
     (tests/test_quant.py's cosine bars), int8 transport against float
     frames, the share of patch offsets agreeing with bf16's, launches
     (exactly 1 patch, 86 ``int8_conv``, 17 ``int8_dwconv`` and no fused
     block a forward in int8); at B=64 videos/s of 3 runs of 10 forwards
     in int8 beside bf16 (the flagship in int8+heads too), peak memory, the
     flagship's int8 phase split and batch-1 latency, calibration and
     ``prepare_q8`` seconds; the evaluate CLI with ``run.quantize=int8``
     (and ``run.quantize_heads=true``) on phase 9's synthetic clips from
     the device cache, its launches counted and no frame byte from the
     host.
 13. export (``adafocus_torch.serving``), this slice's main path: the
     flagship, the matched configuration and ``plus_cfg((96, 8))`` in bf16
     and the flagship in int8 (phase 12's scales), each exported with
     ``torch.export`` at B=64 (export s; two exporting processes at once,
     two cases each), saved (save s, MB), its eager logits taken; one fresh
     process that imports ``adafocus_torch.serving``
     (and the ops modules its loader imports), started with the phase,
     reloads each as it is saved (load s), holds every state tensor on the
     card; when all four are loaded, each eager forward's videos/s, then in
     the fresh process for each artifact one forward with the launch counts
     set to 0 just before (exactly 1 patch
     launch; int8 also 86 ``int8_conv`` and 17 ``int8_dwconv``; no fused
     block) and times it (3 runs of 10 forwards), and has imported no
     ``adafocus_torch.models`` module and no JAX; each artifact's logits
     against the eager ones (max|d| / max|eager| <= 1e-2). cuDNN's
     autotuner and TF32 are off in both processes.
 14. data parallelism (``adafocus_torch.parallel``), this slice's main
     path, on the one card. (a) A one-rank NCCL group at the flagship's
     width (bf16 compute over float32 parameters, B=64): one stage-1 and
     one stage-2 step (reward 'random') through the group against the
     plain step on the same weights, batch and injected actions, cuDNN's
     deterministic algorithms: parameters, running statistics and metrics
     bit-identical (an average over one rank is the identity), exactly 1
     and 2 patch launches a step with the counts set to 0 just before,
     the PPO ratio within 1e-3 of 1; then each step's ms with and without
     the group, and the gradient all-reduce's ms and bytes (the optimizer's
     parameters). (b) Two ranks sharing the card over gloo (processes of
     their own), float32 with TF32 off, B=8 a rank, two steps of stage 1
     and of stage 2: the replicas' weights bit-identical after every step,
     each rank's patch kernel bit-identical to the plain version on its
     shard, one and two launches a step; stage 1's averaged gradient and
     loss against this process's two B=8 plain steps averaged by hand
     (phase 6's float32 limits: the whole-batch step normalises
     differently), stage 2's against one plain step on the whole B=16
     batch (phase 7's). (c) ``python -m adafocus_torch.parallel.dryrun
     --ranks 1`` and its seconds, in a process that runs beside (b): it
     times nothing.
 15. the tooling (``utils.torch_weights``, ``utils.profiling``,
     ``ops.flops``, the ResNet variants), this slice's main path. (a) A
     torchvision-layout ResNet-50 and MobileNetV2 (tests/torch_ref_models.py,
     torch only; seeded, random BatchNorm statistics) saved as ``.pth`` and
     converted by ``python -m adafocus_torch.utils.torch_weights`` in two
     subprocesses; the port's backbones on the converted weights against the
     reference modules on theirs, float32 with TF32 off, max|d| / max|ref|
     <= 1e-4 (ResNet-50 on 64 patches of 96^2, MobileNetV2 on 16 frames of
     224^2); it times nothing and runs after (b) of phase 14, beside phase
     13's exports. (b) ``cli.train`` stage 1 warm-started from the converted
     focuser (phase 9's arguments: flagship width, bf16, B=32, synthetic
     clips in a device cache; one epoch), with the launch counts set to 0
     just before: the focuser equal to the converted tensors bit for bit in
     the state ``main`` builds, before its first step (the 1000-class head
     keeps its fresh value), one patch launch a step and eval batch. (c)
     ``utils.profiling.trace`` over three flagship forwards at B=64 through
     ``inference`` (bf16, cuDNN path) and three through ``inference_q8``
     (phase 12's scales), the launch counts set to 0 just before; the top 15
     rows of ``top_ops(group=True)`` of each; the patch kernel's row counts
     3 launches and, in bf16, its ms is within 10% of phase 5's; the rows
     sum to ``split_phases``' busy time of the same trace within 2%; the
     int8 forward's busy time split into ``int8_conv``, ``int8_dwconv``, the
     quantize passes (none may run a kernel: the backbones requantize inside
     the int8 kernels), the dequantize passes and the rest. (d)
     ``ops.flops.gflops_per_video`` of the flagship forward equal to
     ``benchmark.inference_gflops_per_video``. (e) ``resnet18``,
     ``resnet34``, ``resnet101``, ``resnet152`` and ``wide_resnet101`` over
     64 patches of 96^2 in bf16 against float32 (TF32 off), 3e-2, and each
     one's bf16 ms.

The untimed checks (the steps in three precisions, the small stages, the
B=2 forwards) run with cuDNN's autotuner off. Each phase's end prints its
seconds and those of each call in it.

Prints the per-shape tables of the patch kernel and of the fused blocks
(with each shape's plan, TFLOP/s, waves at N=1024 and tensor-core
instruction), the profile, the stage-1 and stage-2 timings, the matched
configuration's results, the bench, the CLI's results, phase 10's,
phase 11's, phase 12's, phase 13's, phase 14's and phase 15's results and the kernel
table (each kernel's launches on every path, its times at the flagship's and
the matched configuration's shapes; the int8 kernels' at phase 12's unit
shapes) as JSON lines: the calls' seconds, the card's name and power limit,
the run's and each phase's seconds (``{"seconds": ...}``), the kernel table
(``{"kernels": ...}``; each row and sub-row with ``ms`` and ``device_ms``,
``library_ms`` and ``library_device_ms``, ``host_bound`` and
``library_host_bound``), then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

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
SM_COUNT = 132              # H100 SXM
MATCHED_B = 64              # the matched configuration's batch (bench.py's, the reference's)
N4_ROUNDS = 2               # rounds of fresh inputs for the N=4 block checks


# device timings taken (``_times``): how many, the profiles they took beyond
# one each (a profile that missed device work is taken again), and their
# host seconds
PROFILED = {"calls": 0, "retakes": 0, "seconds": 0.0}
# host seconds of each call of a ``_seconds`` function, in the order the
# calls ended (an inner call before the call around it); printed at the end
CALL_SECONDS = []


def _seconds(fn):
    """``fn``, its host seconds of each call appended to CALL_SECONDS."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            CALL_SECONDS.append([fn.__name__, time.perf_counter() - t0])
    return timed


@contextlib.contextmanager
def _autotuner(on: bool):
    """cuDNN's autotuner on or off within the context (or the decorated
    function), as it was after. The untimed checks run with it off: its
    search at each new shape is what they would otherwise spend most of
    their time on, and which algorithm a check runs its tolerance covers."""
    import torch

    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = on
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


# the libraries whose SASS phase 2 reads
SASS_LIBS = ("fused_inv_residual", "fused_bottleneck", "int8_conv")


@_seconds
def build_kernels() -> tuple:
    """Phase 2's build: each kernel library built in a thread of its own
    (``_kernels.build``), so that every nvcc runs at once, and the SASS of
    each of SASS_LIBS dumped (``cuobjdump -sass`` of each of its cubins, all
    at once) as soon as it is built, beside the builds still running.
    Returns (the wall seconds, {library: SASS})."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from adafocus_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")

    def build(lib):
        _kernels.build([lib])
        if lib not in SASS_LIBS:
            return None
        # one cuobjdump disassembles a library's cubins one after another
        # (a source built as units has one a unit): each cubin apart, at once
        with tempfile.TemporaryDirectory() as tmp:
            subprocess.run([tool, "-xelf", "all", str(_kernels.library_path(lib))], cwd=tmp,
                           capture_output=True, check=True)
            cubins = sorted(f for f in os.listdir(tmp) if f.endswith(".cubin"))
            if not cubins:
                raise AssertionError(f"cuobjdump -xelf extracted no cubin of {lib}")
            outs = [os.path.join(tmp, c + ".sass") for c in cubins]
            procs = []
            for c, path in zip(cubins, outs):
                with open(path, "w") as out:
                    procs.append(subprocess.Popen([tool, "-sass", c], cwd=tmp, stdout=out))
            if any(p.wait() for p in procs):
                raise AssertionError(f"cuobjdump -sass failed on a cubin of {lib}")
            sass = []
            for path in outs:
                with open(path) as f:
                    sass.append(f.read())
            return "".join(sass)

    start = time.perf_counter()
    libs = list(_kernels.SIGNATURES)
    with ThreadPoolExecutor(len(libs)) as pool:
        dumps = dict(zip(libs, pool.map(build, libs)))
    return time.perf_counter() - start, {k: v for k, v in dumps.items() if v is not None}


@_seconds
def tensor_core_instructions(dumps: dict) -> dict:
    """Phase 2: {kernel instance: {"HGMMA": n, "HMMA": n, "IMMA": n}} of the
    fused-block and int8 libraries, counted in their ``cuobjdump -sass``
    (``dumps``: {library: SASS}). Raises if a bf16 instance
    (``*_tc_kernel``) has no tensor-core instruction, if a CUDA-core kernel
    was instantiated for bf16, or if an instance of the int8 GEMM kernel
    (``conv_kernel``) issues no wgmma (HGMMA) or any mma.sync (IMMA,
    HMMA)."""
    counts, int8 = {}, set()
    for lib, sass in dumps.items():
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = {"HGMMA": 0, "HMMA": 0, "IMMA": 0}
                if lib == "int8_conv" and "conv_kernel" in name:
                    int8.add(name)
            elif name is not None:
                for op in re.findall(r"\b(HGMMA|HMMA|IMMA)\.", line):
                    counts[name][op] += 1
    tc = {k: v for k, v in counts.items() if "tc_kernel" in k}
    if len(tc) < 2 or not int8:
        raise AssertionError(f"no tensor-core kernel instance in the SASS: {sorted(counts)}")
    for k, v in counts.items():
        print(f"sass {k}: HGMMA {v['HGMMA']}, HMMA {v['HMMA']}, IMMA {v['IMMA']}", flush=True)
        if k in tc and v["HGMMA"] + v["HMMA"] == 0:
            raise AssertionError(f"bf16 kernel {k} has no tensor-core instruction")
        if "tc_kernel" not in k and "bfloat16" in k:
            raise AssertionError(f"{k}: a CUDA-core fused kernel instantiated for bf16")
        if k in int8 and (v["HGMMA"] == 0 or v["HMMA"] + v["IMMA"]):
            raise AssertionError(f"int8 GEMM instance {k} is not on wgmma: {v}")
    return counts


def _instance(kernel: str, key, plan) -> str:
    """Mangled-name fragment of the bf16 kernel instance a plan launches."""
    from adafocus_torch.ops import fused_blocks as fb

    chid, cout = key[2:4]
    if kernel == "fused_inverted_residual":
        return f"inv_residual_tc_kernelILi{fb._bnp(cout, plan.ns)}E"
    return f"bottleneck_tc_kernelILi{fb._bn2(chid, plan.ns)}ELb{plan.wide}E"


def _blocks_per_sm(kernel: str, key, plan) -> int:
    from adafocus_torch.ops import _kernels

    chid, cout = key[2:4]
    if kernel == "fused_inverted_residual":
        return _kernels.load("fused_inv_residual").fused_inv_residual_blocks_per_sm(
            cout, plan.ns, 2, plan.smem)
    return _kernels.load("fused_bottleneck").fused_bottleneck_blocks_per_sm(
        chid, plan.ns, plan.wide, 2, plan.smem)


def _times(fn, iters: int, warmup: int) -> tuple:
    """(events ms, device ms) of one call of ``fn``: CUDA events around
    ``iters`` calls after ``warmup`` ones, then the profiler's device spans
    over ``iters`` more (``port_patch_times.measured_device_ms``)."""
    from adafocus_torch.utils.profiling import events_ms
    from port_patch_times import measured_device_ms

    ms = events_ms(fn, iters, warmup)
    t0 = time.perf_counter()
    dev, profiles = measured_device_ms(fn, iters)
    PROFILED["calls"] += 1
    PROFILED["retakes"] += profiles - 1
    PROFILED["seconds"] += time.perf_counter() - t0
    return ms, dev


def _row_times(kernel, library, iters: int, warmup: int) -> dict:
    """A table row's times: the kernel's and its library yardstick's
    (``_times``), each flagged host-bound by the 1.5x rule
    (``profiling.host_bound``)."""
    from adafocus_torch.utils.profiling import host_bound

    ms, dev = _times(kernel, iters, warmup)
    lib_ms, lib_dev = _times(library, iters, warmup)
    return {"ms": ms, "device_ms": dev, "host_bound": host_bound(ms, dev),
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "library_host_bound": host_bound(lib_ms, lib_dev)}


def _summed_times(parts: list) -> dict:
    """A summed row's times: each of ``_row_times``' times over the (weight,
    row) pairs of ``parts``, weighted, and the host-bound flags of the
    sums."""
    from adafocus_torch.utils.profiling import host_bound

    t = {k: sum(w * r[k] for w, r in parts)
         for k in ("ms", "device_ms", "library_ms", "library_device_ms")}
    t["host_bound"] = host_bound(t["ms"], t["device_ms"])
    t["library_host_bound"] = host_bound(t["library_ms"], t["library_device_ms"])
    return t


def _random_frames(shape, dtype, gen):
    import torch

    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, shape, generator=gen,
                         device=gen.device, dtype=dtype)


def _check_same(got, want, label):
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"extract_patches differs from the plain version at {label}")
    print(f"extract_patches {label}: bit-identical", flush=True)


def check_patch_at(frames, actions, image_size, patch_size, label) -> None:
    """The patch kernel as the main path calls it, from (B, T, 2) actions
    (``extract_patches_at``), against ``patch_offsets`` and the plain
    version on the same frames."""
    from adafocus_torch.ops.patch import (
        extract_patches_at, extract_patches_reference, patch_offsets,
    )

    b, t = frames.shape[:2]
    got = extract_patches_at(frames, actions, image_size, patch_size)
    offs = patch_offsets(actions.reshape(b * t, 2), image_size, patch_size)
    want = extract_patches_reference(frames.reshape((b * t,) + frames.shape[2:]), offs,
                                     patch_size)
    _check_same(got, want, f"{label}, offsets from (B, T, 2) actions")


def check_patch_edges(device) -> None:
    """Phase 3, the patch kernel at every misalignment residue of the
    source column (x*C*e mod 16) and on an unaligned base; and the offsets
    computed inside the kernel from actions against ``patch_offsets`` for
    the flagship's 49 anchor values plus 0 and 1."""
    import torch

    from adafocus_torch.models.policy import discrete_to_coords
    from adafocus_torch.ops.patch import (
        extract_patches, extract_patches_at, extract_patches_reference, patch_offsets,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    # x = 0..15: every residue x*C*e mod 16 there is for C=3 and e = 1, 2, 4
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        frames = _random_frames((16, 224, 224, 3), dtype, gen)
        offs = torch.stack([torch.randint(0, 129, (16,), generator=gen, device=device),
                            torch.arange(16, device=device)], 1).to(torch.int32)
        _check_same(extract_patches(frames, offs, 96), extract_patches_reference(frames, offs, 96),
                    f"x = 0..15 224x224x3 P=96 {dtype}")
    # a base one element past 16-byte alignment
    flat = _random_frames((16 * 224 * 224 * 3 + 1,), torch.bfloat16, gen)
    frames = flat[1:].view(16, 224, 224, 3)
    offs = torch.randint(-50, 200, (16, 2), generator=gen, device=device, dtype=torch.int32)
    _check_same(extract_patches(frames, offs, 96), extract_patches_reference(frames, offs, 96),
                "unaligned base N=16 224x224x3 P=96 bf16")
    # offsets inside the kernel: frames whose values are their own (y, x)
    s, p, b, t = 224, 96, 3, 17
    grid = discrete_to_coords(torch.arange(49), 49)
    acts = torch.cat([grid, torch.tensor([[0.0, 0.0], [1.0, 1.0]])]).reshape(t, b, 2)
    acts = acts.to(device).transpose(0, 1)     # (B, T, 2) as the policy lays it out
    yx = torch.arange(s * s, device=device, dtype=torch.int32).reshape(1, 1, s, s, 1)
    frames = yx.expand(b, t, s, s, 3).contiguous()
    got = extract_patches_at(frames, acts, s, p)
    offs = patch_offsets(acts.reshape(b * t, 2), s, p)
    torch.cuda.synchronize()
    found = torch.stack([got[:, 0, 0, 0] // s, got[:, 0, 0, 0] % s], 1)
    if not torch.equal(found, offs):
        raise AssertionError(f"offsets from actions {found.tolist()} != patch_offsets "
                             f"{offs.tolist()}")
    _check_same(got, extract_patches_reference(frames.reshape(b * t, s, s, 3), offs, p),
                "from actions, 49 anchors + 0 + 1, offsets equal patch_offsets'")


@_seconds
def check_patch_kernel(device) -> tuple:
    """Phase 3 for ``extract_patches``: bit-identical to the plain version in
    bf16, f32 and int8 at the flagship shape and at odd shapes, at the edges
    of ``check_patch_edges``, and at the four shapes of
    ``port_patch_times.SHAPES``; then each of those shapes timed (the
    kernel, the plain version and two ``copy_`` yardsticks). Returns (the
    kernel's table row without ``launches``, the per-shape rows)."""
    import torch

    from adafocus_torch.ops.patch import (
        extract_patches, extract_patches_reference, plan_patch_extract,
    )
    from port_patch_times import SHAPES, make_inputs, time_shapes

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

    check_patch_edges(device)

    plans = {}
    for shape in SHAPES:
        name, n, s, c, p, _ = shape
        frames, offs = make_inputs(shape, device, gen)
        _check_same(extract_patches(frames, offs, p), extract_patches_reference(frames, offs, p),
                    name)
        plans[name] = plan_patch_extract(n, p, c, frames.element_size())
        del frames, offs
    timed = time_shapes({"kernel": extract_patches, "plain": extract_patches_reference}, device)
    for row in timed:
        row["plan"] = plans[row["shape"]]._asdict()
    main = timed[0]   # the flagship's B=64 x T=16 call
    return {
        "name": "extract_patches",
        "route": "cuda",
        "source": "adafocus_torch/csrc/patch_extract.cu",
        "replaces": "adafocus_tpu/ops/patch.py:164",
        "max_abs_err": worst,
        **_patch_times(main),
        "shape": f"{main['shape']}: N={main['n']} {main['frames']} P={main['p']} bf16",
    }, timed


def _patch_times(row: dict) -> dict:
    """The table's times of one ``port_patch_times.time_shapes`` row, in ms;
    the library yardstick one strided copy of the same bytes (one window for
    all N)."""
    from adafocus_torch.utils.profiling import host_bound

    return {"ms": row["us"] / 1e3, "device_ms": row["dev_us"] / 1e3,
            "host_bound": row["host_bound"], "plain_ms": row["plain_us"] / 1e3,
            "bound_ms": row["bound_us"] / 1e3, "bound_by": "bytes",
            "library_ms": row["strided_copy_us"] / 1e3,
            "library_device_ms": row["strided_copy_dev_us"] / 1e3,
            "library_host_bound": host_bound(row["strided_copy_us"],
                                             row["strided_copy_dev_us"])}


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


@_seconds
def check_fused_blocks(model16, device, sass: dict) -> tuple:
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 3)
    shapes = _block_shapes(model16)
    worst = {k: 0.0 for k in shapes}
    for r in range(N4_ROUNDS):   # a race shows as a rare, input-dependent error
        for kernel, entries in shapes.items():
            for e in entries:
                h, cin = e["key"][:2]
                worst[kernel] = max(worst[kernel], _check_block(
                    kernel, e["module"], h, cin, gen, device, label=f"{e['block']} round {r}"))
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
    per_shape = _timed_block_rows(shapes, {k: n for k in shapes}, gen, device, sass, worst)
    return _kernel_rows(per_shape, worst,
                        f"every block of one flagship forward, N={n} bf16, summed"), per_shape


def _library_block(kernel: str, module, tsm: bool):
    """The library yardstick of one kernel call: the unfused block as cuDNN
    convs (NCHW views of channels-last memory), or in the temporal-shift
    split only its branch, which is what the kernel computes there."""
    if not tsm:
        return module
    if kernel == "fused_inverted_residual":
        return lambda x: module.project(module.dw(x if module.expand is None
                                                  else module.expand(x)))
    return lambda x: module.conv3(module.conv2(module.conv1(x)))


def _timed_block_rows(shapes: dict, n_of: dict, gen, device, sass: dict, worst: dict,
                      tsm: bool = False, label: str = "") -> list:
    """Each distinct block shape in bf16 at N = ``n_of[kernel]``: the kernel
    against its plain version (updating ``worst``), then timed beside the
    plain version and the library yardstick (``_library_block``), with its
    plan, occupancy and bound. ``tsm``: the temporal-shift split
    (``use_res=False``; the bottleneck's ``down`` runs outside the kernel,
    so neither its work nor its weights count)."""
    import torch

    from adafocus_torch.ops.fused_blocks import out_size, plan_bottleneck, plan_inv_residual
    from adafocus_torch.utils.profiling import events_ms

    # the inputs at N drawn on the card: the CPU's generator draws a row's
    # hundreds of millions of values serially, in seconds
    on_card = torch.Generator(device).manual_seed(int(torch.randint(2**62, (), generator=gen)))
    per_shape = []
    for kernel, entries in shapes.items():
        fold, run, plain = _block_fns(kernel)
        plan_fn = plan_inv_residual if kernel == "fused_inverted_residual" else plan_bottleneck
        n = n_of[kernel]
        for e in entries:
            module = e["module"]
            key = e["key"]
            if tsm and kernel == "fused_bottleneck":
                key = key[:5] + (False,)
            h, cin, chid, cout, stride, flag = key
            params, args = fold(module, torch.bfloat16), _block_args(kernel, module)
            if tsm:
                args["use_res"] = False
            x = torch.randn((n, h, h, cin), generator=on_card, device=device).bfloat16()
            rel, d = _rel_err(run(x, params, **args), plain(x, params, **args))
            if not rel <= BLOCK_TOL["bfloat16"]:
                raise AssertionError(f"{kernel} {label}{e['block']} N={n} bf16: {rel}")
            worst[kernel] = max(worst[kernel], d)
            x_nchw = x.permute(0, 3, 1, 2)
            library = _library_block(kernel, module, tsm)
            with torch.inference_mode():
                times = _row_times(lambda: run(x, params, **args), lambda: library(x_nchw),
                                   iters=10, warmup=2)
                plain_ms = events_ms(lambda: plain(x, params, **args), iters=5, warmup=1)
            moved, flops = _block_cost(kernel, key, n)
            bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
            plan = plan_fn(h, h, cin, chid, cout, stride, flag, 2, n)
            inst = _instance(kernel, key, plan)
            ops = next(v for k, v in sass.items() if inst in k)
            occ = _blocks_per_sm(kernel, key, plan)
            ho = out_size(h, stride)
            blocks = -(-n // plan.g) * -(-ho // plan.th) * -(-ho // plan.tw)
            row = {"kernel": kernel, "block": label + e["block"], "launches": e["launches"],
                   "n": n, "use_res": args["use_res"],
                   "shape": f"{h}x{h}x{cin} -> {chid} -> {cout} s{stride}",
                   "plan": plan._asdict(), "blocks": blocks, "blocks_per_sm": occ,
                   "waves": -(-blocks // (SM_COUNT * occ)) if occ else None,
                   "instr": "HGMMA" if ops["HGMMA"] else "HMMA",
                   **times, "plain_ms": plain_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "tflops": flops / times["device_ms"] / 1e9,
                   "bytes": moved, "flops": flops, "max_rel_err": rel}
            per_shape.append(row)
            print(f"{kernel} {row['block']} x{e['launches']} N={n} bf16 {row['shape']} "
                  f"use_res={args['use_res']}: kernel {times['ms']!r} ms "
                  f"({times['device_ms']!r} on the device, {row['tflops']!r} TFLOP/s, "
                  f"{row['instr']}, plan {tuple(plan)}, {blocks} blocks, {occ}/SM, "
                  f"{row['waves']} waves), plain {plain_ms!r} ms, library "
                  f"{'branch' if tsm else 'block'} {times['library_ms']!r} ms "
                  f"({times['library_device_ms']!r} on the device), bound "
                  f"{row['bound_ms']!r} ms ({row['bound_by']}); max|d|/max|plain| {rel!r}",
                  flush=True)
            del x, x_nchw
            torch.cuda.empty_cache()
    return per_shape


def _kernel_rows(per_shape: list, worst: dict, shape: str) -> list:
    """The two block kernels' table rows: each shape's times (events and
    device), library times and bound times its launches a forward,
    summed."""
    sources = {"fused_inverted_residual": ("fused_inv_residual.cu", 247),
               "fused_bottleneck": ("fused_bottleneck.cu", 397)}
    rows = []
    for kernel, (src, line) in sources.items():
        mine = [r for r in per_shape if r["kernel"] == kernel]
        total = _summed_times([(r["launches"], r) for r in mine])
        total.update({k: sum(r["launches"] * r[k] for r in mine) for k in ("plain_ms", "bound_ms")})
        by_bytes = sum(r["launches"] * r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
        rows.append({
            "name": kernel, "route": "cuda", "source": f"adafocus_torch/csrc/{src}",
            "replaces": f"adafocus_tpu/ops/fused_blocks.py:{line}",
            "max_abs_err": worst[kernel], **total,
            "bound_by": "bytes" if 2 * by_bytes >= total["bound_ms"] else "operations",
            "shape": shape,
        })
    return rows


@_seconds
def check_matched_blocks(model_sth, device, sass: dict) -> tuple:
    """Phase 3 for the two block kernels in the temporal-shift split of the
    matched sth-sth configuration (224^2 glance, 144^2 patches): every
    distinct block shape with ``use_res=False``, as that forward runs them,
    against the plain version at N=4 in float32 and bf16 (BatchNorm
    randomised), then in bf16 at the B=64 forward's N (512 glance frames,
    768 patches), timed there beside the block's branch as cuDNN convs.
    Returns (kernel rows summed over one forward, per-shape rows)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model_sth.cfg
    gen = torch.Generator().manual_seed(SEED + 5)
    shapes = _block_shapes(model_sth)
    worst = {k: 0.0 for k in shapes}
    for kernel, entries in shapes.items():
        for e in entries:
            h, cin = e["key"][:2]
            worst[kernel] = max(worst[kernel], _check_block(
                kernel, e["module"], h, cin, gen, device, use_res=False,
                label=f"matched {e['block']} TSM split"))
    n_of = {"fused_inverted_residual": MATCHED_B * cfg.num_frames,
            "fused_bottleneck": MATCHED_B * cfg.t_focuser}
    per_shape = _timed_block_rows(shapes, n_of, gen, device, sass, worst, tsm=True,
                                  label="matched ")
    return _kernel_rows(per_shape, worst, f"every block of one matched sth-sth forward "
                        f"in the TSM split, B={MATCHED_B} (N {n_of}), bf16, summed"), per_shape


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


@_seconds
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
    check_patch_at(frames16, roll16["actions"], s, cfg16.patch_size,
                   f"flagship B={b} T={t} bf16")
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


@_seconds
def flagship_throughput(model16, device, fused: str, b: int = 64, iters: int = 10):
    """Phase 5: the bf16 flagship forward at B=64, T=16 on one backbone path.
    Returns (videos/s of three timed runs, mean device ms of each phase over
    five forwards, timed by CUDA events between the phases)."""
    import torch

    from adafocus_torch.models.fused_inference import fused_focus, fused_glance
    from adafocus_torch.models.gfv import (
        extract_for_frames, fuse_and_classify, inference,
    )
    from adafocus_torch.utils.profiling import events_ms

    torch.backends.cudnn.benchmark = True
    cfg = model16.cfg
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    frames = torch.randn((b, t, s, s, 3), generator=gen, device=device,
                         dtype=torch.bfloat16)
    small = torch.randn((b, t, g, g, 3), generator=gen, device=device,
                        dtype=torch.bfloat16)
    vps = [b / (events_ms(lambda: inference(model16, frames, small, device=device,
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
        check_patch_at(frames, roll["actions"], s, cfg.patch_size,
                       f"flagship B={b} T={t} bf16 fused={fused!r}")
    return vps, phases


# phase 6, one stage-1 step in three precisions on the same weights, batch
# and actions. float32 (TF32 off) against float64: the loss and every
# trained component's gradient direction. bf16 against float32: the loss
# and the classifier's gradient direction; the focuser's bf16 gradient at
# random initialisation is decorrelated from the float32 one by the
# train-mode BatchNorm backward's conditioning (in the JAX package too), so
# only its norm is held
F32_LOSS_REL_TOL, F32_GRAD_MIN_COS = 1e-4, 0.99
BF16_LOSS_REL_TOL, BF16_CLASSIFIER_MIN_COS = 3e-2, 0.98
BF16_FOCUSER_NORM_RATIO = (0.8, 1.25)
TRAIN_B = 64                 # the reference's batch (configs/actnet_default.yaml)
TRAIN_COMPARE_B = 8          # batch of the precision checks
TRAIN_SMALL_B = 2            # stages 0 and 3 and eval
TRAIN_WARMUP, TRAIN_TIMED = 2, 5


def _train_batch(cfg, b, device, seed, dtype):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    t, s, g = cfg.num_frames, cfg.image_size, cfg.glance_size
    return {"frames": torch.randn((b, t, s, s, 3), generator=gen, device=device, dtype=dtype),
            "frames_small": torch.randn((b, t, g, g, 3), generator=gen, device=device,
                                        dtype=dtype),
            "labels": torch.randint(0, cfg.num_classes, (b,), generator=gen, device=device)}


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def check_train_update(before: dict, model, stage: int, label: str, labels: dict = None,
                       moving_stats: tuple = ()) -> None:
    """After train steps of ``stage``: every tensor (parameter or running
    statistic) of a frozen component bit-identical; every parameter of a
    trained component moved, except one that got a zero gradient and is
    zero (``focuser.fc.bias`` in stage 1: off the loss path, so weight
    decay leaves it at 0) or is trained by PPO's Adam, which has no weight
    decay (``policy.gru.weight_hh`` with one video division: the GRU's one
    step starts from a zero hidden); the running statistics of a trained
    backbone moved. ``labels`` overrides the freeze matrix row of ``stage``
    for some components; the running statistics of a frozen component in
    ``moving_stats`` may move (a backbone in train mode whose parameters are
    frozen, as AdaFocus+'s focuser in stage 3)."""
    import torch

    from adafocus_torch.train.optim import stage_trainable

    labels = {**stage_trainable(stage), **(labels or {})}
    grads = {name: p.grad for name, p in model.named_parameters()}
    after = model.state_dict()
    still = []
    for key, old in before.items():
        if key.endswith("num_batches_tracked"):
            continue
        comp = key.split(".")[0]
        same = torch.equal(old, after[key])
        if labels.get(comp, "frozen") == "frozen":
            moving = comp in moving_stats and key.endswith(("running_mean", "running_var"))
            if not same and not moving:
                raise AssertionError(f"{label}: frozen {key} changed")
        elif same:
            g = grads.get(key)
            if key in grads and (not old.any() or labels[comp] == "ppo") and \
                    (g is None or not g.any()):
                still.append(key)
            else:
                raise AssertionError(f"{label}: trained {key} did not move")
    print(f"{label}: frozen components bit-identical, every trained tensor moved "
          f"(zero, with zero gradient, so unmoved: {still})", flush=True)


@_seconds
def check_patch_backward(device) -> None:
    """The patch Function's backward on the card (from offsets with starts
    that wrap and clamp, and from actions) against the plain version on the
    CPU, bit for bit; the forward launches the kernel once."""
    import torch

    from adafocus_torch.ops.patch import extract_patches, extract_patches_at

    gen = torch.Generator().manual_seed(SEED + 6)
    b, t, s, p = 2, 16, 224, 96
    frames = torch.randn((b, t, s, s, 3), generator=gen).bfloat16()
    actions = torch.rand((b, t, 2), generator=gen)
    offs = torch.randint(-60, 260, (b * t, 2), generator=gen, dtype=torch.int32)
    cot = torch.randn((b * t, p, p, 3), generator=gen).bfloat16()
    for name, fn, args in (
            ("from actions", lambda f, a: extract_patches_at(f, a, s, p), (actions,)),
            ("from offsets", lambda f, o: extract_patches(f.reshape(b * t, s, s, 3), o, p),
             (offs,))):
        grads = []
        for dev in (device, torch.device("cpu")):
            src = frames.to(dev, copy=True).requires_grad_()
            before = _launch_counts()["extract_patches"]
            out = fn(src, *(a.to(dev) for a in args))
            if dev.type == "cuda" and _launch_counts()["extract_patches"] != before + 1:
                raise AssertionError("the patch Function did not launch the kernel once")
            out.backward(cot.to(dev))
            grads.append((out.detach().cpu(), src.grad.cpu()))
        (out_g, grad_g), (out_c, grad_c) = grads
        if not (torch.equal(out_g, out_c) and torch.equal(grad_g, grad_c)):
            raise AssertionError(f"patch Function {name}: the card's forward or backward "
                                 "differs from the plain version on the CPU")
        print(f"patch Function {name}, B={b} T={t} {s}^2 P={p} bf16: forward and backward "
              "on the card bit-identical to the CPU's plain version", flush=True)


def _timed_steps(step, batch, gen, device) -> dict:
    """TRAIN_WARMUP + TRAIN_TIMED calls of a train ``step(batch, gen,
    mark=)``, with every kernel's launch count and the peak memory reset just
    before. A CUDA event is recorded at the start of each step and at each
    ``mark``. Returns the metrics of every step (floats), the timed steps'
    ms and videos/s, each phase's mean ms over them, the launch counts and
    the peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _launch_counts(reset=True)
    steps, metrics = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(phase):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((phase, ev))

        metrics.append(step(batch, gen, mark=mark))
        if i >= TRAIN_WARMUP:
            steps.append(marks)
    torch.cuda.synchronize()
    step_ms = [m[0][1].elapsed_time(m[-1][1]) for m in steps]
    phase_ms = {}
    for m in steps:
        for (_, a), (name, b) in zip(m, m[1:]):
            phase_ms[name] = phase_ms.get(name, 0.0) + a.elapsed_time(b) / len(steps)
    b = batch["labels"].shape[0]
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
            "videos_per_s": [b / (ms / 1e3) for ms in step_ms], "step_ms": step_ms,
            "phase_ms": phase_ms, "launches": _launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


@_seconds
def train_stage1_timed(device, card: str) -> dict:
    """Phase 6, the main path: the stage-1 step on the bf16 flagship at
    B=64, TRAIN_WARMUP + TRAIN_TIMED steps with the launch counts set to 0
    just before; videos/s and each phase's ms by CUDA events over the timed
    steps, peak memory; exactly one patch launch a step; finite loss; frozen
    glancer and policy bit-identical, the focuser and classifier moved."""
    import torch

    from adafocus_torch.models.gfv import flagship
    from adafocus_torch.train.stages import create_train_state, make_stage_train_step

    cfg = flagship()
    state = create_train_state(cfg, 1, device=device,
                               generator=torch.Generator().manual_seed(SEED))
    model = state.model
    step = make_stage_train_step(model, 1, state.optimizer, state.scheduler)
    batch = _train_batch(cfg, TRAIN_B, device, SEED + 7, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    before = _snapshot(model)
    run = _timed_steps(step, batch, gen, device)
    launches, peak, step_ms, phase_ms, vps = (run[k] for k in (
        "launches", "peak_bytes", "step_ms", "phase_ms", "videos_per_s"))
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    if launches["extract_patches"] != n_steps:
        raise AssertionError(f"stage 1: {launches['extract_patches']} patch launches in "
                             f"{n_steps} steps, want exactly one a step")
    loss = [m["loss"] for m in run["metrics"]]
    if not all(math.isfinite(v) for v in loss):
        raise AssertionError(f"stage 1 losses {loss}")
    check_train_update(before, model, 1, f"stage 1 B={TRAIN_B}")
    print(f"train stage 1 bf16 B={TRAIN_B} T={cfg.num_frames}: videos/s {vps!r} (mean "
          f"{TRAIN_B * len(step_ms) / (sum(step_ms) / 1e3)!r}); step ms {step_ms!r}; phase ms "
          f"{json.dumps(phase_ms)}; peak memory {peak} B ({peak / 2**30:.2f} GiB); patch "
          f"launches {launches['extract_patches']} in {n_steps} steps; losses {loss} ({card})",
          flush=True)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return {"videos_per_s": vps, "step_ms": step_ms, "phase_ms": phase_ms, "peak_bytes": peak,
            "launches": launches, "losses": loss}


@_seconds
@_autotuner(False)
def train_precisions(device) -> dict:
    """Phase 6: one stage-1 step of the flagship in bf16 compute, float32
    (TF32 off) and float64, each over float32-initialised parameters from
    the same seed, on the same batch and injected actions at
    B=TRAIN_COMPARE_B; compares each trained component's gradient."""
    import torch

    from adafocus_torch.models.gfv import GFV, flagship
    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.train.optim import OptimConfig, make_stage_optimizer
    from adafocus_torch.train.stages import make_stage_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = flagship()
    b, t = TRAIN_COMPARE_B, cfg16.num_frames
    batch = _train_batch(cfg16, b, device, SEED + 9, torch.float32)
    actions = random_patch_actions((b, t), torch.Generator(device=device).manual_seed(SEED),
                                   device)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        # float32 parameters, except the float64 model's
        model = GFV(dataclasses.replace(cfg16, dtype=dtype), device=device,
                    generator=torch.Generator().manual_seed(SEED),
                    param_dtype=torch.promote_types(dtype, torch.float32))
        step = make_stage_train_step(model, 1, *make_stage_optimizer(model, 1, OptimConfig()))
        # float32 inputs for all three: each model casts them to its compute
        # dtype (exactly, for float64), after the patch kernel's copy
        loss = float(step(batch, None, actions=actions)["loss"])
        grads = {comp: torch.cat([p.grad.flatten().double()
                                  for p in getattr(model, comp).parameters()])
                 for comp in ("focuser", "classifier")}
        runs[str(dtype).removeprefix("torch.")] = (loss, grads)
        del model, step
        torch.cuda.empty_cache()

    def compare(name, ref):
        (loss, g), (loss_ref, g_ref) = runs[name], runs[ref]
        cos = {c: float(torch.nn.functional.cosine_similarity(g[c], g_ref[c], dim=0)) for c in g}
        norm = {c: float(g[c].norm() / g_ref[c].norm()) for c in g}
        rel = abs(loss - loss_ref) / abs(loss_ref)
        print(f"train stage 1 B={b}, {name} vs {ref} (TF32 off), one step on the same weights, "
              f"batch and actions: loss {loss!r} vs {loss_ref!r}, relative {rel!r}; gradient "
              f"cosine {cos}; gradient norm ratio {norm}", flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"{name} loss {loss}")
        return rel, cos, norm

    rel32, cos32, _ = compare("float32", "float64")
    rel16, cos16, norm16 = compare("bfloat16", "float32")
    checks = [("float32 loss", rel32 <= F32_LOSS_REL_TOL),
              ("bf16 loss", rel16 <= BF16_LOSS_REL_TOL),
              ("bf16 classifier cosine", cos16["classifier"] >= BF16_CLASSIFIER_MIN_COS),
              ("bf16 focuser norm", BF16_FOCUSER_NORM_RATIO[0] <= norm16["focuser"]
               <= BF16_FOCUSER_NORM_RATIO[1])]
    checks += [(f"float32 {c} cosine", v >= F32_GRAD_MIN_COS) for c, v in cos32.items()]
    failed = [name for name, ok in checks if not ok]
    print(f"precision limits: float32 vs float64 loss <= {F32_LOSS_REL_TOL}, cosine >= "
          f"{F32_GRAD_MIN_COS}; bf16 vs float32 loss <= {BF16_LOSS_REL_TOL}, classifier cosine "
          f">= {BF16_CLASSIFIER_MIN_COS}, focuser norm ratio in {BF16_FOCUSER_NORM_RATIO}; "
          f"failed: {failed}", flush=True)
    if failed:
        raise AssertionError(f"training precision checks failed: {failed}")
    return {"float32_vs_float64": {"loss_rel": rel32, "grad_cos": cos32},
            "bf16_vs_float32": {"loss_rel": rel16, "grad_cos": cos16, "grad_norm_ratio": norm16}}


@_seconds
@_autotuner(False)
def train_small_stages(device) -> dict:
    """Phase 6: stages 0 and 3 (two steps each) and then the eval step on
    the bf16 flagship at B=TRAIN_SMALL_B, each with its launch counts set to
    0 just before: one patch launch a step, finite loss, frozen components
    bit-identical and trained ones moved; the eval step leaves every tensor
    as it was and returns finite logits."""
    import torch

    from adafocus_torch.models.gfv import flagship
    from adafocus_torch.train.stages import (
        create_train_state, make_eval_step, make_stage_train_step,
    )

    cfg = flagship()
    batch = _train_batch(cfg, TRAIN_SMALL_B, device, SEED + 10, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    launches = {}
    for stage in (0, 3):
        state = create_train_state(cfg, stage, device=device,
                                   generator=torch.Generator().manual_seed(SEED))
        step = make_stage_train_step(state.model, stage, state.optimizer, state.scheduler)
        before = _snapshot(state.model)
        _launch_counts(reset=True)
        losses = [float(step(batch, gen)["loss"]) for _ in range(2)]
        launches[f"stage {stage}"] = _launch_counts()
        if launches[f"stage {stage}"]["extract_patches"] != 2:
            raise AssertionError(f"stage {stage}: {launches[f'stage {stage}']} in 2 steps")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"stage {stage} losses {losses}")
        check_train_update(before, state.model, stage, f"stage {stage} B={TRAIN_SMALL_B}")
        print(f"train stage {stage} bf16 B={TRAIN_SMALL_B}: losses {losses}, launches "
              f"{launches[f'stage {stage}']}", flush=True)
    model = state.model   # stage 3's
    before = _snapshot(model)
    _launch_counts(reset=True)
    logits, metrics = make_eval_step(model)(batch)
    torch.cuda.synchronize()
    launches["eval"] = _launch_counts()
    after = model.state_dict()
    if launches["eval"]["extract_patches"] != 1:
        raise AssertionError(f"eval: {launches['eval']}")
    if tuple(logits.shape) != (TRAIN_SMALL_B, cfg.num_frames, cfg.num_classes) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"eval logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits.float()).all())}")
    if any(not torch.equal(v, after[k]) for k, v in before.items()):
        raise AssertionError("the eval step changed the model")
    print(f"eval step bf16 B={TRAIN_SMALL_B}: logits {tuple(logits.shape)} finite, top1 "
          f"{float(metrics['top1'])}, top5 {float(metrics['top5'])}, launches "
          f"{launches['eval']}; the model unchanged", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return launches


# phase 7, the stage-2 (PPO) step. Every step's mean PPO ratio is 1: the
# behavior logprob and the evaluate pass compute the same log_softmax. One
# step in three precisions on the same weights, batch and injected behavior
# and baseline actions (TF32 off): float32 against float64 at phase 6's
# float32 limits, for the same reason (the card has no JAX); bf16 against
# float32 printed with no limit, since at random initialisation the reward
# is a difference of two confidences near 1/200, below bf16's resolution of
# the logits (phase 4's 3e-2)
RATIO_TOL = 1e-3
PPO_F32_LOSS_REL_TOL, PPO_F32_REWARD_REL_TOL, PPO_F32_GRAD_MIN_COS = 1e-4, 1e-3, 0.99
SAMPLER_DRAWS, SAMPLER_SIGMAS = 10**6, 5


STAGE2_PHASES = ("glance", "rollout", "extract", "focus", "classify", "baseline", "returns",
                 "update")


def profile_stage2(step, batch, gen, n_steps: int = 3) -> dict:
    """``torch.profiler`` over ``n_steps`` stage-2 steps, each phase a
    ``record_function`` range from the previous ``mark`` to its own: each
    phase's device window, busy and idle time and host time, the steps'
    idle share (``port_patch_times.split_phases``); the trace goes to
    ``profiles/trace_stage2.json`` beside this script."""
    from torch.profiler import record_function

    from adafocus_torch.utils.profiling import load_trace, trace
    from port_patch_times import PROFILES, split_phases

    def run():
        for _ in range(n_steps):
            phases = iter(STAGE2_PHASES)
            current = [next(phases), None]
            current[1] = record_function(current[0])
            current[1].__enter__()

            def mark(phase):
                if phase != current[0]:
                    raise AssertionError(f"stage-2 phase {phase}, expected {current[0]}")
                current[1].__exit__(None, None, None)
                current[0] = next(phases, None)
                if current[0] is not None:
                    current[1] = record_function(current[0])
                    current[1].__enter__()

            step(batch, gen, mark=mark)

    with trace(PROFILES, "trace_stage2.json"):
        run()
    return split_phases(load_trace(os.path.join(PROFILES, "trace_stage2.json")), n_steps,
                        STAGE2_PHASES)


@_seconds
def train_stage2_timed(device, card: str) -> dict:
    """Phase 7, this slice's main path: the stage-2 step on the bf16
    flagship at B=64 (reward 'random'), TRAIN_WARMUP + TRAIN_TIMED steps
    with the launch counts set to 0 just before: videos/s, each phase's ms,
    peak memory; exactly two patch launches a step (the behavior actions and
    the baseline's); every metric finite and every step's ratio_mean within
    RATIO_TOL of 1; glancer, focuser and classifier (running statistics
    included) bit-identical and every policy parameter moved."""
    import torch

    from adafocus_torch.models.gfv import flagship
    from adafocus_torch.train.stages import create_train_state, make_stage2_step

    cfg = flagship()
    state = create_train_state(cfg, 2, device=device,
                               generator=torch.Generator().manual_seed(SEED))
    model = state.model
    step = make_stage2_step(model, state.ppo)
    batch = _train_batch(cfg, TRAIN_B, device, SEED + 12, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    before = _snapshot(model)
    run = _timed_steps(step, batch, gen, device)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    if run["launches"]["extract_patches"] != 2 * n_steps:
        raise AssertionError(f"stage 2: {run['launches']['extract_patches']} patch launches "
                             f"in {n_steps} steps, want exactly two a step")
    metrics = run["metrics"]
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"stage 2 metrics {metrics}")
    ratios = [m["ppo/ratio_mean"] for m in metrics]
    if not all(abs(r - 1.0) <= RATIO_TOL for r in ratios):
        raise AssertionError(f"stage 2 ratio_mean {ratios}, want within {RATIO_TOL} of 1")
    check_train_update(before, model, 2, f"stage 2 B={TRAIN_B}")
    vps, step_ms, peak = run["videos_per_s"], run["step_ms"], run["peak_bytes"]
    print(f"train stage 2 bf16 B={TRAIN_B} T={cfg.num_frames}: videos/s {vps!r} (mean "
          f"{TRAIN_B * len(step_ms) / (sum(step_ms) / 1e3)!r}); step ms {step_ms!r}; phase ms "
          f"{json.dumps(run['phase_ms'])}; peak memory {peak} B ({peak / 2**30:.2f} GiB); "
          f"patch launches {run['launches']['extract_patches']} in {n_steps} steps; "
          f"ratio_mean {ratios!r} (limit |r - 1| <= {RATIO_TOL}); losses "
          f"{[m['ppo/loss'] for m in metrics]}; reward_mean "
          f"{[m['reward_mean'] for m in metrics]} ({card})", flush=True)
    run["profile"] = prof = profile_stage2(step, batch, gen)
    print(f"train stage 2 B={TRAIN_B}, profiled (3 steps, ms a step): " + "; ".join(
        f"{name} window {v['window_ms']!r}, busy {v['busy_ms']!r}, idle {v['idle_ms']!r}, "
        f"host {v['host_ms']!r}" for name, v in prof.items() if name in STAGE2_PHASES)
        + f"; device idle share {prof['total']['idle_share']!r} ({card})", flush=True)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return run


@_seconds
@_autotuner(False)
def train_stage2_precisions(device) -> dict:
    """Phase 7: one stage-2 step of the flagship at B=TRAIN_COMPARE_B in bf16
    compute, float32 (TF32 off) and float64, over float32-initialised
    parameters from the same seed, on the same batch and injected behavior
    and baseline actions: the PPO loss, the rewards and the policy's
    gradient, float32 against float64 (limits) and bf16 against float32
    (printed)."""
    import torch

    from adafocus_torch.models.gfv import GFV, flagship
    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.ppo.core import PPOConfig, ppo_init, ppo_update
    from adafocus_torch.train.optim import freeze_for_stage
    from adafocus_torch.train.stages import stage2_episode

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = flagship()
    b, t = TRAIN_COMPARE_B, cfg16.num_frames
    batch = _train_batch(cfg16, b, device, SEED + 14, torch.float32)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    behavior = torch.randint(0, cfg16.action_dim, (t, b), generator=gen, device=device)
    baseline = random_patch_actions((b, t), gen, device)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        model = GFV(dataclasses.replace(cfg16, dtype=dtype), device=device,
                    generator=torch.Generator().manual_seed(SEED),
                    param_dtype=torch.promote_types(dtype, torch.float32))
        freeze_for_stage(model, 2)
        ppo = ppo_init(model.policy, PPOConfig())
        episode = stage2_episode(model, batch, None, ppo.cfg, behavior, baseline)
        metrics = ppo_update(ppo, episode, model.autocast)
        grad = torch.cat([p.grad.flatten().double() for p in model.policy.parameters()])
        runs[str(dtype).removeprefix("torch.")] = (
            float(metrics["ppo/loss"]), episode["rewards"].double().flatten(), grad,
            float(metrics["ppo/ratio_mean"]))
        del model, ppo, episode
        torch.cuda.empty_cache()

    def compare(name, ref):
        (loss, r, g, ratio), (loss_ref, r_ref, g_ref, _) = runs[name], runs[ref]
        out = {"loss": loss, "loss_ref": loss_ref, "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
               "reward_rel": float((r - r_ref).abs().max() / r_ref.abs().max()),
               "reward_corr": float(torch.corrcoef(torch.stack([r, r_ref]))[0, 1]),
               "grad_cos": float(torch.nn.functional.cosine_similarity(g, g_ref, dim=0)),
               "grad_norm_ratio": float(g.norm() / g_ref.norm()), "ratio_mean": ratio}
        print(f"train stage 2 B={b}, {name} vs {ref} (TF32 off), one step on the same weights, "
              f"batch, behavior and baseline actions: {json.dumps(out)}", flush=True)
        if not (math.isfinite(loss) and torch.isfinite(g).all()):
            raise AssertionError(f"{name}: loss {loss}, gradient finite "
                                 f"{bool(torch.isfinite(g).all())}")
        return out

    f32 = compare("float32", "float64")
    bf16 = compare("bfloat16", "float32")
    checks = [("float32 ppo loss", f32["loss_rel"] <= PPO_F32_LOSS_REL_TOL),
              ("float32 rewards", f32["reward_rel"] <= PPO_F32_REWARD_REL_TOL),
              ("float32 policy gradient cosine", f32["grad_cos"] >= PPO_F32_GRAD_MIN_COS)]
    failed = [name for name, ok in checks if not ok]
    print(f"stage-2 precision limits, float32 vs float64: ppo loss <= {PPO_F32_LOSS_REL_TOL} "
          f"relative, rewards max|d|/max|float64| <= {PPO_F32_REWARD_REL_TOL}, policy gradient "
          f"cosine >= {PPO_F32_GRAD_MIN_COS}; bf16 vs float32 printed, no limit; failed: "
          f"{failed}", flush=True)
    if failed:
        raise AssertionError(f"stage-2 precision checks failed: {failed}")
    return {"float32_vs_float64": f32, "bf16_vs_float32": bf16}


@_seconds
def check_sampler(device) -> dict:
    """Phase 7: SAMPLER_DRAWS draws of ``sample_discrete`` over the 49
    anchors from one row of fixed logits on a CUDA generator; every class's
    frequency within SAMPLER_SIGMAS binomial sigmas of its softmax
    probability."""
    import torch

    from adafocus_torch.models.policy import sample_discrete

    logits = torch.randn(49, generator=torch.Generator().manual_seed(SEED + 16)).to(device) * 2
    draws, _ = sample_discrete(logits.expand(SAMPLER_DRAWS, 49),
                               torch.Generator(device=device).manual_seed(SEED + 17))
    freq = torch.bincount(draws, minlength=49).double() / SAMPLER_DRAWS
    p = torch.softmax(logits.double(), -1)
    z = float(((freq - p).abs() / (p * (1 - p) / SAMPLER_DRAWS).sqrt()).max())
    print(f"sampler: {SAMPLER_DRAWS} draws over 49 anchors on the card, largest deviation "
          f"{z!r} sigma (limit {SAMPLER_SIGMAS})", flush=True)
    if not z <= SAMPLER_SIGMAS:
        raise AssertionError(f"sampler frequencies off by {z} sigma")
    return {"draws": SAMPLER_DRAWS, "max_sigma": z}


# phase 8, the matched sth-sth configuration (adafocus_torch.benchmark
# sthsth_cfg(144)): the reference's published configuration, served by
# models.gfv_sthsth.inference_sthsth, this slice's main path. Limits as in
# phase 4.
MATCHED_PHASES = ("glance", "policy", "extract", "focus", "classify")


def _matched_with_actions(model, frames, small, actions_div, fused: bool):
    """The sth-sth forward with injected per-division actions, composed from
    the phases, on either backbone path."""
    import torch

    from adafocus_torch.models.fused_inference import fused_focus, fused_glance_logits
    from adafocus_torch.models.gfv import extract_for_frames
    from adafocus_torch.models.gfv_sthsth import (
        actions_per_frame, glance_logits, local_frame_logits, sum_consensus,
    )

    cfg = model.cfg
    b, tf = frames.shape[:2]
    with torch.inference_mode(), model.autocast():
        _, glob = (fused_glance_logits if fused else glance_logits)(model, small)
        patches = extract_for_frames(frames, actions_per_frame(actions_div, tf),
                                     cfg.image_size, cfg.patch_size)
        if fused:
            local = model.classify_frame_logits(fused_focus(model, patches).reshape(b, tf, -1))
        else:
            local = local_frame_logits(model, patches, b)
        return sum_consensus(glob, local, cfg.with_glancer)


@_seconds
@_autotuner(False)
def matched_forward(model, device) -> dict:
    """Phase 8 at B=2: the main path once in bf16 on each backbone path,
    with launch counts (one patch launch a forward on the cuDNN path; 17 +
    16 + 1 on the fused path); on the same weights and injected float32
    greedy actions, bf16 against float32 and fused against unfused; the
    patch kernel from the policy's continuous actions against
    ``patch_offsets`` and the plain version."""
    import torch

    from adafocus_torch.models.fused_inference import fused_glance_logits
    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.models.gfv_sthsth import (
        actions_per_frame, glance_division_rollout, inference_sthsth,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model.cfg
    b, tf, tg, s, g = 2, cfg.t_focuser, cfg.num_frames, cfg.image_size, cfg.glance_size
    gen = torch.Generator().manual_seed(SEED + 6)
    frames = torch.randn((b, tf, s, s, 3), generator=gen).to(device)
    small = torch.randn((b, tg, g, g, 3), generator=gen).to(device)
    frames16, small16 = frames.bfloat16(), small.bfloat16()

    launches = {}
    for fused in ("auto", "on"):
        _launch_counts(reset=True)
        logits = inference_sthsth(model, frames16, small16, device=device, fused=fused)
        torch.cuda.synchronize()
        launches[fused] = _launch_counts()
        print(f"matched sth-sth B={b} fused={fused!r}: launches {launches[fused]}", flush=True)
        if tuple(logits.shape) != (b, cfg.num_classes):
            raise AssertionError(f"matched logits shape {tuple(logits.shape)}")
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"matched bf16 logits (fused={fused!r}) are not finite")
    want_auto = {"extract_patches": 1, "fused_inverted_residual": 0, "fused_bottleneck": 0}
    if launches["auto"] != want_auto:
        raise AssertionError(f"matched cuDNN path launches {launches['auto']}, want {want_auto}")
    if launches["on"] != FUSED_LAUNCHES:
        raise AssertionError(f"matched fused path launches {launches['on']}, "
                             f"want {FUSED_LAUNCHES}")

    model32 = GFV(dataclasses.replace(cfg, dtype=torch.float32), device=device,
                  generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        roll32 = glance_division_rollout(model32, small)[2]
        roll16 = glance_division_rollout(model, small16)[2]
        roll16f = model.policy_rollout_div(fused_glance_logits(model, small16)[0])
    check_patch_at(frames16, actions_per_frame(roll16["actions"], tf), s, cfg.patch_size,
                   f"matched B={b} Tf={tf} bf16, continuous actions")
    acts = roll32["actions"]
    logits32, logits16, logits32f, logits16f = (
        _matched_with_actions(m, f, sm, acts, fu)
        for m, f, sm, fu in ((model32, frames, small, False), (model, frames16, small16, False),
                             (model32, frames, small, True), (model, frames16, small16, True)))
    torch.cuda.synchronize()
    for name, v in (("float32", logits32), ("fused float32", logits32f)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"matched {name} logits are not finite")
    print(f"matched B={b}: greedy actions {acts.tolist()} (float32); max|bf16 - f32| "
          f"{(roll16['actions'] - acts).abs().max().item()!r}, max|fused - unfused| bf16 "
          f"{(roll16f['actions'] - roll16['actions']).abs().max().item()!r}", flush=True)
    rels = {}
    for name, got, want, tol in (
            ("bf16 vs f32", logits16, logits32, BF16_REL_TOL),
            ("fused bf16 vs f32", logits16f, logits32, BF16_REL_TOL),
            ("fused bf16 vs unfused bf16", logits16f, logits16, BF16_REL_TOL),
            ("fused f32 vs unfused f32 (TF32 off)", logits32f, logits32, FUSED_F32_REL_TOL)):
        rels[name] = _rel_err(got, want)[0]
        print(f"matched B={b} on injected actions, {name}: max|d|/max|ref| = "
              f"{rels[name]!r} (limit {tol})", flush=True)
        if not rels[name] <= tol:
            raise AssertionError(f"matched {name}: logits differ by {rels[name]} > {tol}")
    del model32
    torch.cuda.empty_cache()
    return {"launches": launches, "max_rel_err": rels}


@_seconds
def matched_throughput(model, device, fused: str, iters: int = 10) -> dict:
    """Phase 8 at B=64 on one backbone path: videos/s of three timed runs
    (``benchmark.inference_rates``), the mean device ms of each phase over
    five forwards (CUDA events between the phases), peak memory, and the
    patch kernel from the policy's actions against the plain version."""
    import torch

    from adafocus_torch.benchmark import inference_rates, make_data
    from adafocus_torch.models.fused_inference import fused_focus, fused_glance_logits
    from adafocus_torch.models.gfv import extract_for_frames
    from adafocus_torch.models.gfv_sthsth import actions_per_frame, glance_logits, sum_consensus

    torch.backends.cudnn.benchmark = True
    cfg = model.cfg
    b, tf = MATCHED_B, cfg.t_focuser
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vps = inference_rates(model, b, iters, 3, SEED, fused=fused)
    data = make_data(cfg, b, device=device, seed=SEED + 7)
    frames, small = data["frames"], data["frames_small"]
    on = fused == "on"
    phases = dict.fromkeys(MATCHED_PHASES, 0.0)
    n_timed = 5
    with torch.inference_mode(), model.autocast():
        for i in range(n_timed + 1):   # the first forward is warm-up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            fmap, glob = (fused_glance_logits if on else glance_logits)(model, small)
            ev[1].record()
            roll = model.policy_rollout_div(fmap)
            ev[2].record()
            acts = actions_per_frame(roll["actions"], tf)
            patches = extract_for_frames(frames, acts, cfg.image_size, cfg.patch_size)
            ev[3].record()
            feats = (fused_focus(model, patches) if on else model.focus(patches))
            ev[4].record()
            sum_consensus(glob, model.classify_frame_logits(feats.reshape(b, tf, -1)),
                          cfg.with_glancer)
            ev[5].record()
            torch.cuda.synchronize()
            if i:
                for k, name in enumerate(MATCHED_PHASES):
                    phases[name] += ev[k].elapsed_time(ev[k + 1]) / n_timed
        check_patch_at(frames, acts, cfg.image_size, cfg.patch_size,
                       f"matched B={b} Tf={tf} bf16 fused={fused!r}")
    peak = torch.cuda.max_memory_allocated()
    return {"videos_per_s": vps, "phase_ms": phases, "peak_bytes": peak}


# phase 9, the port's CLI (adafocus_torch.cli.train / evaluate), this
# slice's main path, in-process at the flagship width of
# configs/actnet_default.yaml from a device cache of synthetic clips: stage
# 1, stage 2 warm-started from it, stage 3 from stage 2, then evaluate with
# three patch policies. CLI_VIDEOS synthetic videos give 3 steps an epoch
# at CLI_B; stages 1 and 2 run two epochs, so that the second one's
# videos/s is taken warm. The batch prep on the card is held to the CPU's
# at PREP_REL_TOL, float32, TF32 off: the resampling weights and products
# are float32 sums in another order
CLI_B = 32                   # the item-17 profile's batch (benchmarks/miniact_harness.py:99)
CLI_VIDEOS = 96
CLI_EPOCHS = {1: 2, 2: 2, 3: 1}
CLI_POLICIES = ("learned", "random", "center")
CLI_PASSES = 7               # epochs of the components' timing and profile: 21 batches
PREP_REL_TOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))


def _cli_args(tmp: str, *extra) -> list:
    return ["--config", os.path.join(ROOT, "configs", "actnet_default.yaml"),
            "run.synthetic_data=true", f"run.synthetic_videos={CLI_VIDEOS}",
            "loader.cache=device", f"loader.batch_size={CLI_B}", *extra]


@_seconds
def _run_cli(main, args: list, log_path: str):
    """``main(args)`` with its log lines sent to ``log_path``; its tail is
    printed if it raises."""
    with open(log_path, "a") as f, contextlib.redirect_stdout(f):
        try:
            return main(args)
        except BaseException:
            f.flush()
            with open(log_path) as g:
                sys.stderr.write("".join(g.readlines()[-40:]))
            raise


def _same_as_checkpoint(model, tree: dict, components, label: str) -> None:
    import torch

    for comp in components:
        src = tree["components"][comp]
        for key, value in getattr(model, comp).state_dict().items():
            if not torch.equal(value.cpu(), src[key]):
                raise AssertionError(f"{label}: {comp}.{key} differs from the checkpoint")


@_seconds
def check_cli_prep(cfg, loader, device) -> dict:
    """The batch prep on the card against the CPU's on one uint8 batch of
    the device cache (4 videos) with the same draws, train and eval, float32
    with TF32 off."""
    import torch

    from adafocus_torch.cli.common import make_batch_prep
    from adafocus_torch.data.transforms import draw_augment

    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=torch.float32))
    raw = next(iter(loader))
    raw = {"frames": raw["frames"][:4], "labels": raw["labels"][:4]}
    raw_cpu = {"frames": raw["frames"].cpu().numpy(), "labels": raw["labels"]}
    draws = draw_augment(4, cfg.loader.canvas_size, cfg.augment,
                         torch.Generator().manual_seed(SEED), torch.device("cpu"))
    errs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for train in (True, False):
        want, _, _ = make_batch_prep(cfg32, train, torch.device("cpu"))(raw_cpu, None, draws)
        got, _, _ = make_batch_prep(cfg32, train, device)(raw, None, draws)
        for key in ("frames", "frames_small"):
            errs[f"{'train' if train else 'eval'} {key}"] = e = (
                (got[key].cpu() - want[key]).abs().max() / want[key].abs().max()).item()
            if not e <= PREP_REL_TOL:
                raise AssertionError(f"batch prep on the card vs the CPU, {key} train={train}: "
                                     f"{e} > {PREP_REL_TOL}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(f"CLI batch prep on the card vs the CPU (4 videos of the device cache, the same "
          f"draws, float32, TF32 off): max|d|/max|cpu| {json.dumps(errs)} (limit "
          f"{PREP_REL_TOL})", flush=True)
    return errs


def _cli_batches(loader):
    """The training loader's raw batches over ``CLI_PASSES`` epochs."""
    for epoch in range(CLI_PASSES):
        loader.set_epoch(epoch)
        yield from loader


@_seconds
def check_cli_patch(cfg, loader, model, device) -> None:
    """The patch kernel at the shape the CLI gives it (B=32 x T=16 = 512
    frames, 224^2 -> 96^2, bf16: a grid plan of its own), on one batch of
    the device cache after the CLI's batch prep, from the random actions a
    stage-1 step draws and from the policy's greedy actions (a stage-3 step,
    evaluate): each bit-identical to the plain version."""
    import torch

    from adafocus_torch.cli.common import batch_generator, make_batch_prep
    from adafocus_torch.models.gfv import glance_policy_actions
    from adafocus_torch.ops.patch import random_patch_actions

    gen = batch_generator(SEED, 0, 0, device)
    batch, _, _ = make_batch_prep(cfg, True, device)(next(iter(loader)), gen)
    frames = batch["frames"]
    b, t = frames.shape[:2]
    s, p = cfg.model.image_size, cfg.model.patch_size
    label = f"CLI B={b} T={t} {s}^2 P={p} bf16, a batch of the device cache"
    check_patch_at(frames, random_patch_actions((b, t), gen, device), s, p,
                   f"{label}, stage 1's random draw")
    with torch.inference_mode(), model.autocast():
        actions = glance_policy_actions(model, batch["frames_small"])[2]["actions"]
    check_patch_at(frames, actions, s, p, f"{label}, the policy's greedy actions")


@_seconds
def time_cli_components(cfg, loader, state, device, card: str) -> dict:
    """Mean ms of the loader's gather (host clock to a synchronised batch),
    of the batch prep and of the stage-1 step (CUDA events), each over
    ``CLI_PASSES`` epochs of a fresh device-cached training loader with
    stage 1's trained state, cuDNN's autotuner off as the CLI keeps it."""
    import torch

    from adafocus_torch.cli.common import batch_generator, make_batch_prep
    from adafocus_torch.train.stages import make_stage_train_step

    fill_s = loader.fill()
    prep = make_batch_prep(cfg, True, device)
    step = make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
    gather, prep_ms, step_ms = [], [], []
    batches = _cli_batches(loader)
    for i in range(CLI_PASSES * len(loader)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = next(batches)
        torch.cuda.synchronize()
        gather.append((time.perf_counter() - t0) * 1e3)
        gen = batch_generator(SEED, 99, i, device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        batch, _, _ = prep(raw, gen)
        ev[1].record()
        step(batch, gen)
        ev[2].record()
        torch.cuda.synchronize()
        prep_ms.append(ev[0].elapsed_time(ev[1]))
        step_ms.append(ev[1].elapsed_time(ev[2]))
    mean_step = sum(step_ms) / len(step_ms)
    out = {"batches": len(step_ms), "gather_ms": sum(gather) / len(gather),
           "prep_ms": sum(prep_ms) / len(prep_ms), "step_ms": mean_step,
           "step_only_videos_per_s": CLI_B / (mean_step / 1e3), "fill_seconds": fill_s,
           "cache_bytes": loader.nbytes, "host_frame_bytes": prep.host_frame_bytes}
    print(f"CLI components, stage 1 bf16 B={CLI_B} from the device cache, mean over "
          f"{out['batches']} batches, cuDNN's autotuner off: gather {out['gather_ms']!r} ms "
          f"(host clock), batch prep {out['prep_ms']!r} ms, step {mean_step!r} ms "
          f"({out['step_only_videos_per_s']!r} videos/s step only); cache fill {fill_s!r} s, "
          f"{out['cache_bytes']} B on the card ({card})", flush=True)
    if out["host_frame_bytes"]:
        raise AssertionError(f"{out['host_frame_bytes']} frame bytes came from the host")
    return out


CLI_PHASES = ("gather", "prep", "step")


@_seconds
def profile_cli_batches(cfg, loader, state, device, card: str) -> dict:
    """``torch.profiler`` over ``CLI_PASSES`` epochs of the stage-1 loop at
    B=32 from the device cache, in sequence, with the gather, the batch prep
    and the step each a ``record_function`` range: each phase's device
    window, busy, idle and host ms a batch (``port_patch_times.split_phases``)
    and the idle share. The trace goes under ``profiles/`` beside this
    script."""
    from torch.profiler import record_function

    from adafocus_torch.cli.common import batch_generator, make_batch_prep
    from adafocus_torch.train.stages import make_stage_train_step
    from adafocus_torch.utils.profiling import load_trace, trace
    from port_patch_times import PROFILES, split_phases

    prep = make_batch_prep(cfg, True, device)
    step = make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
    n = CLI_PASSES * len(loader)

    def sequential():
        batches = _cli_batches(loader)
        for i in range(n):
            gen = batch_generator(SEED, 98, i, device)
            with record_function("gather"):
                raw = next(batches)
            with record_function("prep"):
                batch, _, _ = prep(raw, gen)
            with record_function("step"):
                step(batch, gen)

    with trace(PROFILES, "trace_cli_sequential.json"):
        sequential()
    out = split_phases(load_trace(os.path.join(PROFILES, "trace_cli_sequential.json")), n,
                       CLI_PHASES)
    out["batches"] = n
    print(f"CLI loop at B={CLI_B}, profiled over {n} batches in sequence, ms a batch: "
          + "; ".join(f"{name} window {v['window_ms']!r}, busy {v['busy_ms']!r}, idle "
                      f"{v['idle_ms']!r}, host {v['host_ms']!r}"
                      for name, v in out.items() if name in CLI_PHASES)
          + f"; idle share {out['total']['idle_share']!r} ({card})", flush=True)
    return out


@_seconds
@_autotuner(False)   # the CLI keeps torch's default; phase 5 turned it on
def cli_phase(device, card: str) -> dict:
    """Phase 9: the CLI's stages 1, 2 and 3 and evaluate at the flagship
    width, each with the launch counts set to 0 just before and read just
    after; one patch launch a stage-1/3 step and eval batch, two a stage-2
    step, no fused-block launch; every batch's frames from the device cache
    (no frame byte from the host after the fill); each warm start exact for
    the components of ``STAGE_LOADS``, and every component a stage does not
    train unchanged by it; finite results; videos/s of each epoch (loader,
    batch prep and step), peak memory, the caches' fill seconds and bytes."""
    import tempfile

    import torch

    from adafocus_torch.cli import evaluate as cli_evaluate
    from adafocus_torch.cli import train as cli_train
    from adafocus_torch.cli.common import build_loader
    from adafocus_torch.config import load_config
    from adafocus_torch.train import checkpoint as ckpt
    from adafocus_torch.train.optim import stage_trainable

    out = {"stages": {}, "evaluate": {}}
    n_val = -(-CLI_VIDEOS // CLI_B)
    real_build = cli_train.build_state
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "cli.log")
        prev = None
        for stage, epochs in CLI_EPOCHS.items():
            args = _cli_args(tmp, f"run.stage={stage}", f"run.epochs={epochs}",
                             f"run.ckpt_dir={tmp}/s{stage}",
                             *([f"run.warm_start={prev}"] if prev else []))
            tree, checked = None, []
            if prev:
                # the warm start main() makes, checked in the state it builds,
                # before it trains
                tree = ckpt.load_checkpoint(prev, best=True) or ckpt.load_checkpoint(prev)
                loaded = [c for c in ckpt.STAGE_LOADS[stage] if c in tree["components"]]

                def checked_build_state(*a, **kw):
                    built = real_build(*a, **kw)
                    _same_as_checkpoint(built[0].model, tree, loaded,
                                        f"stage {stage} warm start")
                    checked.append(stage)
                    return built

                cli_train.build_state = checked_build_state
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            _launch_counts(reset=True)
            try:
                res = _run_cli(cli_train.main, args, log)
            finally:
                cli_train.build_state = real_build
            torch.cuda.synchronize()
            launches = _launch_counts()
            if prev and checked != [stage]:
                raise AssertionError(f"CLI stage {stage}: main() built no state to check")
            steps = sum(e["steps"] for e in res["epochs"])
            want = (2 if stage == 2 else 1) * steps + n_val * epochs
            if launches != {"extract_patches": want, "fused_inverted_residual": 0,
                            "fused_bottleneck": 0}:
                raise AssertionError(f"CLI stage {stage}: launches {launches}, want {want} patch "
                                     f"launches ({steps} steps, {n_val * epochs} eval batches)")
            if res["host_frame_bytes"] or set(res["caches"]) != {"train", "val"}:
                raise AssertionError(f"CLI stage {stage}: frames from the host "
                                     f"{res['host_frame_bytes']} B, caches {res['caches']}")
            if not math.isfinite(res["best_acc"]):
                raise AssertionError(f"CLI stage {stage}: best_acc {res['best_acc']}")
            model = res["state"].model
            if tree is not None:
                frozen = [c for c, label in stage_trainable(stage).items()
                          if label == "frozen" and c in tree["components"]]
                _same_as_checkpoint(model, tree, frozen, f"stage {stage}, frozen")
            peak = torch.cuda.max_memory_allocated(device)
            out["stages"][stage] = {
                "epochs": res["epochs"], "launches": launches, "best_acc": res["best_acc"],
                "caches": res["caches"], "peak_bytes": peak}
            print(f"CLI train stage {stage} bf16 B={CLI_B}, {CLI_VIDEOS} synthetic videos from "
                  f"the device cache: videos/s by epoch (loader, batch prep and step) "
                  f"{[e['videos_per_s'] for e in res['epochs']]!r}; patch launches "
                  f"{launches['extract_patches']} ({steps} steps, {n_val * epochs} eval "
                  f"batches); caches {json.dumps(res['caches'])}; peak memory {peak} B "
                  f"({peak / 2**30:.2f} GiB); best acc {res['best_acc']!r} ({card})",
                  flush=True)
            if stage == 1:
                cfg1 = load_config(args[1], args[2:])
                loader = build_loader(cfg1, True, device)
                out["components"] = time_cli_components(cfg1, loader, res["state"], device, card)
                out["profile"] = profile_cli_batches(cfg1, loader, res["state"], device, card)
                out["prep"] = check_cli_prep(cfg1, loader, device)
                check_cli_patch(cfg1, loader, res["state"].model, device)
                del loader
            del res, model
            torch.cuda.empty_cache()
            prev = f"{tmp}/s{stage}"
        for policy in CLI_POLICIES:
            args = _cli_args(tmp, f"run.resume={prev}", f"run.ckpt_dir={tmp}/ev_{policy}",
                             f"run.eval_policy={policy}")
            _launch_counts(reset=True)
            res = _run_cli(cli_evaluate.main, args, log)
            torch.cuda.synchronize()
            launches = _launch_counts()
            if launches["extract_patches"] != n_val or \
                    not all(math.isfinite(v) for v in res.values()) or \
                    not 0.0 <= res["mAP"] <= 1.0:
                raise AssertionError(f"CLI evaluate {policy}: {res}, launches {launches}")
            out["evaluate"][policy] = {"results": res, "launches": launches}
        print(f"CLI evaluate bf16 B={CLI_B} of stage 3: " + "; ".join(
            f"{p} {json.dumps(v['results'])} ({v['launches']['extract_patches']} patch launches)"
            for p, v in out["evaluate"].items()) + f" ({card})", flush=True)
    return out


# phase 10, the sth-sth family's training (adafocus_torch.train.stages_sthsth
# and the CLI's run.family=sthsth), this slice's main path, at the matched
# configuration (benchmark.sthsth_cfg(144)) with the recipe's TSN optimizer
# groups (configs/sthsth_default.yaml), bf16 compute over float32
# parameters, at the recipe's B=64. The precision checks hold one step of
# each stage, float32 (TF32 off) against float64 at B=4, to phase 6's
# limits (stages 1 and 3) and phase 7's (stage 2). The continuous sampler's
# clamped shares and unclamped mean are held within SAMPLER_SIGMAS of the
# normal distribution's values. remat on against off: one float32 stage-1
# step (TF32 off), the loss and each trained component's update to phase
# 6's float32 limits, and the running statistics within REMAT_STATS_REL of
# each other relative to the step's change of them (a second update would
# move them by 0.9 of that change)
STH_B = 64                   # configs/sthsth_default.yaml loader.batch_size
STH_COMPARE_B = 4
STH_DISCRETE_B, STH_DISCRETE_STEPS = 8, 3
STH_SAMPLER_MEANS = (0.1, 0.8)
REMAT_STATS_REL = 1e-2
STH_CLI_VIDEOS, STH_CLI_B = 64, 32
STH_STAGES = (1, 2, 3)


def _sthsth_cfg(**kw):
    from adafocus_torch.benchmark import sthsth_cfg

    return dataclasses.replace(sthsth_cfg(144), **kw)


def _sthsth_batch(cfg, b, device, seed, dtype):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    s, g = cfg.image_size, cfg.glance_size
    return {"frames": torch.randn((b, cfg.t_focuser, s, s, 3), generator=gen, device=device,
                                  dtype=dtype),
            "frames_small": torch.randn((b, cfg.num_frames, g, g, 3), generator=gen,
                                        device=device, dtype=dtype),
            "labels": torch.randint(0, cfg.num_classes, (b,), generator=gen, device=device)}


def _sthsth_state(cfg, stage, device):
    import torch

    from adafocus_torch.train.optim import OptimConfig
    from adafocus_torch.train.stages import create_train_state

    return create_train_state(cfg, stage, OptimConfig(tsn_policies=True), device=device,
                              generator=torch.Generator().manual_seed(SEED))


def _sthsth_step(state, stage):
    from adafocus_torch.train.stages_sthsth import make_sthsth_stage2_step, make_sthsth_train_step

    if stage == 2:
        return make_sthsth_stage2_step(state.model, state.ppo)
    return make_sthsth_train_step(state.model, stage, state.optimizer, state.scheduler)


@_seconds
def sthsth_train_timed(device, card: str) -> dict:
    """Phase 10, the main path: each sth-sth stage's step at the matched
    configuration, B=STH_B, TRAIN_WARMUP + TRAIN_TIMED steps with the launch
    counts set to 0 just before: videos/s and each phase's ms by CUDA
    events, peak memory; exactly 1, 2 and 1 patch launches a step; finite
    metrics, every stage-2 step's ratio_mean within RATIO_TOL of 1; frozen
    components bit-identical and every trained tensor moved. The patch
    kernel on the stage-1 batch from random actions, bit for bit."""
    import torch

    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.train.stages import optimizer_stage

    cfg = _sthsth_cfg()
    batch = _sthsth_batch(cfg, STH_B, device, SEED + 20, torch.bfloat16)
    out = {}
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    for stage in STH_STAGES:
        state = _sthsth_state(cfg, stage, device)
        step = _sthsth_step(state, stage)
        gen = torch.Generator(device=device).manual_seed(SEED + 21 + stage)
        before = _snapshot(state.model)
        run = _timed_steps(step, batch, gen, device)
        want = (2 if stage == 2 else 1) * n_steps
        if run["launches"] != {"extract_patches": want, "fused_inverted_residual": 0,
                               "fused_bottleneck": 0}:
            raise AssertionError(f"sth-sth stage {stage}: launches {run['launches']} in "
                                 f"{n_steps} steps, want {want} patch launches")
        metrics = run["metrics"]
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"sth-sth stage {stage} metrics {metrics}")
        if stage == 2:
            ratios = [m["ppo/ratio_mean"] for m in metrics]
            if not all(abs(r - 1.0) <= RATIO_TOL for r in ratios):
                raise AssertionError(f"sth-sth stage 2 ratio_mean {ratios}, want within "
                                     f"{RATIO_TOL} of 1")
        check_train_update(before, state.model, optimizer_stage(cfg, stage),
                           f"sth-sth stage {stage} B={STH_B}")
        vps, step_ms, peak = run["videos_per_s"], run["step_ms"], run["peak_bytes"]
        loss_key = "ppo/loss" if stage == 2 else "loss"
        print(f"train sth-sth stage {stage} (TSN groups) bf16 B={STH_B} Tg={cfg.num_frames} "
              f"Tf={cfg.t_focuser} P={cfg.patch_size}: videos/s {vps!r} (mean "
              f"{STH_B * len(step_ms) / (sum(step_ms) / 1e3)!r}); step ms {step_ms!r}; phase "
              f"ms {json.dumps(run['phase_ms'])}; peak memory {peak} B ({peak / 2**30:.2f} "
              f"GiB); patch launches {run['launches']['extract_patches']} in {n_steps} steps; "
              f"{loss_key} {[m[loss_key] for m in metrics]}"
              + (f"; ratio_mean {[m['ppo/ratio_mean'] for m in metrics]!r}" if stage == 2
                 else "") + f" ({card})", flush=True)
        out[stage] = {k: run[k] for k in ("videos_per_s", "step_ms", "phase_ms", "peak_bytes",
                                          "launches", "metrics")}
        del state, step, before, run
        torch.cuda.empty_cache()
    actions = random_patch_actions((STH_B, cfg.t_focuser),
                                   torch.Generator(device=device).manual_seed(SEED), device)
    check_patch_at(batch["frames"], actions, cfg.image_size, cfg.patch_size,
                   f"sth-sth training batch B={STH_B} Tf={cfg.t_focuser} (N="
                   f"{STH_B * cfg.t_focuser}) {cfg.image_size}^2 P={cfg.patch_size} bf16")
    del batch
    torch.cuda.empty_cache()
    return out


@_seconds
@_autotuner(False)
def sthsth_discrete_ratio(device, card: str) -> dict:
    """Phase 10: STH_DISCRETE_STEPS stage-2 steps of the discrete
    BatchNorm-encoder policy over two video divisions at B=STH_DISCRETE_B:
    every step's ratio_mean within RATIO_TOL of 1, two patch launches a
    step."""
    import torch

    cfg = _sthsth_cfg(continuous_policy=False, video_div=2)
    state = _sthsth_state(cfg, 2, device)
    step = _sthsth_step(state, 2)
    batch = _sthsth_batch(cfg, STH_DISCRETE_B, device, SEED + 25, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 26)
    _launch_counts(reset=True)
    ratios = [float(step(batch, gen)["ppo/ratio_mean"]) for _ in range(STH_DISCRETE_STEPS)]
    launches = _launch_counts()["extract_patches"]
    print(f"train sth-sth stage 2, discrete BatchNorm-encoder policy, video_div=2, bf16 "
          f"B={STH_DISCRETE_B}: ratio_mean {ratios!r} (limit |r - 1| <= {RATIO_TOL}); patch "
          f"launches {launches} in {STH_DISCRETE_STEPS} steps ({card})", flush=True)
    if launches != 2 * STH_DISCRETE_STEPS or not all(abs(r - 1) <= RATIO_TOL for r in ratios):
        raise AssertionError(f"discrete sth-sth stage 2: ratios {ratios}, launches {launches}")
    del state, step
    torch.cuda.empty_cache()
    return {"ratio_mean": ratios, "launches": launches}


@_seconds
@_autotuner(False)
def sthsth_precisions(device) -> dict:
    """Phase 10: one step of each sth-sth stage at B=STH_COMPARE_B in bf16
    compute, float32 (TF32 off) and float64, from the same float32 initial
    weights, on the same batch and injected draws (stage 1's actions and
    dropout mask, stage 3's dropout mask and actions, stage 2's behavior
    noise and baseline actions): float32 against float64 held to phase 6's
    limits (stages 1 and 3: the loss, each trained component's gradient
    cosine) and phase 7's (stage 2: the PPO loss, the rewards, the policy's
    gradient cosine); bf16 against float32 printed."""
    import torch

    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.models.gfv_sthsth import actions_per_frame, glance_logits
    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.ppo.core import PPOConfig, ppo_init, ppo_update
    from adafocus_torch.train.optim import OptimConfig, freeze_for_stage, make_stage_optimizer
    from adafocus_torch.train.stages import optimizer_stage
    from adafocus_torch.train.stages_sthsth import make_sthsth_train_step, sthsth_stage2_episode

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = _sthsth_cfg()
    b, tf, d = STH_COMPARE_B, cfg16.t_focuser, cfg16.video_div
    batch = _sthsth_batch(cfg16, b, device, SEED + 27, torch.float32)
    gen = torch.Generator(device=device).manual_seed(SEED + 28)
    draws = {"actions": random_patch_actions((b, tf), gen, device),
             "keep": torch.rand((b, tf, cfg16.focus_dim), generator=gen, device=device) >= 0.5,
             "noise": torch.randn((d, b, 2), generator=gen, device=device),
             "baseline": random_patch_actions((b, d), gen, device)}
    init = None
    runs = {stage: {} for stage in STH_STAGES}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        model = GFV(dataclasses.replace(cfg16, dtype=dtype), device=device,
                    generator=torch.Generator().manual_seed(SEED),
                    param_dtype=torch.promote_types(dtype, torch.float32))
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
            # stage 3's greedy actions, taken once (the float64 model's)
            with torch.no_grad(), model.autocast():
                fmap, _ = glance_logits(model, batch["frames_small"])
                draws["greedy"] = actions_per_frame(
                    model.policy_rollout_div(fmap)["actions"], tf).float()
        for stage in STH_STAGES:
            model.load_state_dict(init)
            if stage == 2:
                freeze_for_stage(model, 2)
                ppo = ppo_init(model.policy, PPOConfig())
                episode = sthsth_stage2_episode(model, batch, None, ppo.cfg, draws["noise"],
                                                draws["baseline"])
                metrics = ppo_update(ppo, episode, model.autocast)
                runs[stage][name] = (float(metrics["ppo/loss"]), {"policy": torch.cat([
                    p.grad.flatten().double() for p in model.policy.parameters()])},
                    episode["rewards"].double().flatten())
                continue
            opt, sched = make_stage_optimizer(model, optimizer_stage(cfg16, stage),
                                              OptimConfig(tsn_policies=True))
            step = make_sthsth_train_step(model, stage, opt, sched)
            loss = float(step(batch, None, draws["actions" if stage == 1 else "greedy"],
                              draws["keep"])["loss"])
            runs[stage][name] = (loss, {comp: torch.cat([
                p.grad.flatten().double() for p in getattr(model, comp).parameters()])
                for comp in ("focuser", "classifier")}, None)
        del model
        torch.cuda.empty_cache()

    out, failed = {}, []
    for stage in STH_STAGES:
        for name, ref in (("float32", "float64"), ("bfloat16", "float32")):
            (loss, g, r), (loss_ref, g_ref, r_ref) = runs[stage][name], runs[stage][ref]
            cmp = {"loss": loss, "loss_ref": loss_ref,
                   "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
                   "grad_cos": {c: float(torch.nn.functional.cosine_similarity(
                       g[c], g_ref[c], dim=0)) for c in g},
                   "grad_norm_ratio": {c: float(g[c].norm() / g_ref[c].norm()) for c in g}}
            if r is not None:
                cmp["reward_rel"] = float((r - r_ref).abs().max() / r_ref.abs().max())
            print(f"train sth-sth stage {stage} B={b}, {name} vs {ref} (TF32 off), one step "
                  f"on the same weights, batch and draws: {json.dumps(cmp)}", flush=True)
            if not math.isfinite(loss):
                failed.append(f"stage {stage} {name} loss {loss}")
            if name == "float32":
                loss_tol = PPO_F32_LOSS_REL_TOL if stage == 2 else F32_LOSS_REL_TOL
                cos_min = PPO_F32_GRAD_MIN_COS if stage == 2 else F32_GRAD_MIN_COS
                if not cmp["loss_rel"] <= loss_tol:
                    failed.append(f"stage {stage} float32 loss")
                failed += [f"stage {stage} float32 {c} cosine"
                           for c, v in cmp["grad_cos"].items() if not v >= cos_min]
                if stage == 2 and not cmp["reward_rel"] <= PPO_F32_REWARD_REL_TOL:
                    failed.append("stage 2 float32 rewards")
            out[f"stage {stage} {name} vs {ref}"] = cmp
    print(f"sth-sth precision limits, float32 vs float64: stages 1 and 3 loss <= "
          f"{F32_LOSS_REL_TOL}, gradient cosine >= {F32_GRAD_MIN_COS}; stage 2 ppo loss <= "
          f"{PPO_F32_LOSS_REL_TOL}, rewards <= {PPO_F32_REWARD_REL_TOL}, policy gradient cosine "
          f">= {PPO_F32_GRAD_MIN_COS}; bf16 vs float32 printed; failed: {failed}", flush=True)
    if failed:
        raise AssertionError(f"sth-sth precision checks failed: {failed}")
    return out


def _normal_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _normal_pdf(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


@_seconds
def check_continuous_sampler(device) -> dict:
    """Phase 10: SAMPLER_DRAWS draws of ``sample_continuous`` (std 0.25)
    around each of STH_SAMPLER_MEANS on a CUDA generator: the shares clamped
    to 0 and to 1 and the mean of the unclamped draws, each within
    SAMPLER_SIGMAS standard errors of the normal distribution's value; the
    logprob that of the clamped action."""
    import torch

    from adafocus_torch.models.policy import gaussian_logprob, sample_continuous

    std = _sthsth_cfg().action_std
    means = torch.tensor(STH_SAMPLER_MEANS, device=device)
    actions, logp = sample_continuous(means.expand(SAMPLER_DRAWS, len(STH_SAMPLER_MEANS)), std,
                                      torch.Generator(device=device).manual_seed(SEED + 29))
    if not torch.equal(logp, gaussian_logprob(actions, means.expand_as(actions), std)):
        raise AssertionError("the sampler's logprob is not that of the clamped action")
    out, worst = [], 0.0
    n = SAMPLER_DRAWS
    for j, mu in enumerate(STH_SAMPLER_MEANS):
        a = actions[:, j].double()
        lo, hi = (0.0 - mu) / std, (1.0 - mu) / std
        p0, p1 = _normal_cdf(lo), 1.0 - _normal_cdf(hi)
        inside = (a > 0) & (a < 1)
        # the normal truncated to (0, 1): its mean and variance
        z_mass = _normal_cdf(hi) - _normal_cdf(lo)
        dpdf = (_normal_pdf(lo) - _normal_pdf(hi)) / z_mass
        t_mean = mu + std * dpdf
        t_var = std ** 2 * (1 + (lo * _normal_pdf(lo) - hi * _normal_pdf(hi)) / z_mass
                            - dpdf ** 2)
        got = {"share_0": float((a == 0).double().mean()),
               "share_1": float((a == 1).double().mean()),
               "mean_inside": float(a[inside].mean())}
        sig = {"share_0": (got["share_0"] - p0) / math.sqrt(p0 * (1 - p0) / n),
               "share_1": (got["share_1"] - p1) / math.sqrt(p1 * (1 - p1) / n),
               "mean_inside": (got["mean_inside"] - t_mean)
               / math.sqrt(t_var / int(inside.sum()))}
        worst = max(worst, max(abs(v) for v in sig.values()))
        out.append({"mean": mu, "got": got, "want": {"share_0": p0, "share_1": p1,
                                                     "mean_inside": t_mean}, "sigma": sig})
    print(f"continuous sampler: {n} draws (std {std}) around each of {STH_SAMPLER_MEANS} on the "
          f"card: {json.dumps(out)}; largest deviation {worst!r} sigma (limit "
          f"{SAMPLER_SIGMAS})", flush=True)
    if not worst <= SAMPLER_SIGMAS:
        raise AssertionError(f"continuous sampler off by {worst} sigma")
    return {"draws": n, "per_mean": out, "max_sigma": worst}


@_seconds
def check_sthsth_remat(device, card: str) -> dict:
    """Phase 10: one sth-sth stage-1 step at B=STH_B with ``remat`` on and
    off, float32 compute (TF32 off), the same initial weights, batch,
    actions and dropout mask: the loss (F32_LOSS_REL_TOL) and each trained
    component's update (cosine >= F32_GRAD_MIN_COS, norm ratio within
    1 -+ 1e-3); the running statistics updated once (their difference
    within REMAT_STATS_REL of the step's change of them); both peak
    memories printed."""
    import torch

    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.train.optim import OptimConfig, make_stage_optimizer
    from adafocus_torch.train.stages_sthsth import make_sthsth_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _sthsth_cfg(dtype=torch.float32)
    batch = _sthsth_batch(cfg, STH_B, device, SEED + 30, torch.float32)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    actions = random_patch_actions((STH_B, cfg.t_focuser), gen, device)
    keep = torch.rand((STH_B, cfg.t_focuser, cfg.focus_dim), generator=gen, device=device) >= 0.5
    runs = {}
    init = None
    for remat in (False, True):
        model = GFV(dataclasses.replace(cfg, remat=remat), device=device,
                    generator=torch.Generator().manual_seed(SEED))
        init = init or _snapshot(model)
        step = make_sthsth_train_step(model, 1, *make_stage_optimizer(
            model, 1, OptimConfig(tsn_policies=True)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        loss = float(step(batch, None, actions, keep)["loss"])
        torch.cuda.synchronize()
        runs[remat] = (loss, _snapshot(model), torch.cuda.max_memory_allocated(device))
        del model, step
        torch.cuda.empty_cache()
    (loss0, s0, peak0), (loss1, s1, peak1) = runs[False], runs[True]
    upd = {}
    for comp in ("focuser", "classifier"):
        keys = [k for k in s0 if k.startswith(comp + ".")
                and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
        u0 = torch.cat([(s0[k] - init[k]).flatten().double() for k in keys])
        u1 = torch.cat([(s1[k] - init[k]).flatten().double() for k in keys])
        upd[comp] = {"cos": float(torch.nn.functional.cosine_similarity(u0, u1, dim=0)),
                     "norm_ratio": float(u1.norm() / u0.norm())}
    stats = [k for k in s0 if k.endswith(("running_mean", "running_var"))]
    moved = torch.cat([(s0[k] - init[k]).flatten().double() for k in stats])
    apart = torch.cat([(s1[k] - s0[k]).flatten().double() for k in stats])
    stats_rel = float(apart.norm() / moved.norm())
    loss_rel = abs(loss1 - loss0) / abs(loss0)
    print(f"sth-sth stage 1 remat on vs off, float32 (TF32 off) B={STH_B}: loss {loss1!r} vs "
          f"{loss0!r} (relative {loss_rel!r}); update {json.dumps(upd)}; running statistics "
          f"apart {stats_rel!r} of their change; peak memory {peak1} B ({peak1 / 2**30:.2f} "
          f"GiB) on vs {peak0} B ({peak0 / 2**30:.2f} GiB) off ({card})", flush=True)
    if not (loss_rel <= F32_LOSS_REL_TOL and stats_rel <= REMAT_STATS_REL
            and all(v["cos"] >= F32_GRAD_MIN_COS and abs(v["norm_ratio"] - 1) <= 1e-3
                    for v in upd.values())):
        raise AssertionError(f"remat: loss {loss_rel}, update {upd}, statistics {stats_rel}")
    return {"loss_rel": loss_rel, "update": upd, "stats_rel": stats_rel,
            "peak_bytes": {"remat": peak1, "plain": peak0}}


def _sthsth_cli_args(*extra) -> list:
    return ["--config", os.path.join(ROOT, "configs", "sthsth_default.yaml"),
            "run.synthetic_data=true", f"run.synthetic_videos={STH_CLI_VIDEOS}",
            "loader.cache=device", f"loader.batch_size={STH_CLI_B}", *extra]


@_seconds
def sthsth_cli_phase(device, card: str) -> dict:
    """Phase 10: the CLI's run.family=sthsth (configs/sthsth_default.yaml,
    the recipe's discrete BatchNorm-encoder policy, TSN groups, bf16, B=
    STH_CLI_B, STH_CLI_VIDEOS synthetic dual-rate clips in the device
    cache): stage 1, stage 2 warm-started from it, stage 3 from stage 2, one
    epoch each, then evaluate with the learned, random and center policies,
    each with the launch counts set to 0 just before: one patch launch a
    stage-1/3 step and eval batch, two a stage-2 step, no fused-block
    launch; no frame byte from the host after the fill; finite results."""
    import tempfile

    import torch

    from adafocus_torch.cli import evaluate as cli_evaluate
    from adafocus_torch.cli import train as cli_train

    out = {"stages": {}, "evaluate": {}}
    n_val = -(-STH_CLI_VIDEOS // STH_CLI_B)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "cli.log")
        prev = None
        for stage in STH_STAGES:
            args = _sthsth_cli_args(f"run.stage={stage}", "run.epochs=1",
                                    f"run.ckpt_dir={tmp}/s{stage}",
                                    *([f"run.warm_start={prev}"] if prev else []))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            _launch_counts(reset=True)
            res = _run_cli(cli_train.main, args, log)
            torch.cuda.synchronize()
            launches = _launch_counts()
            steps = sum(e["steps"] for e in res["epochs"])
            want = (2 if stage == 2 else 1) * steps + n_val
            if launches != {"extract_patches": want, "fused_inverted_residual": 0,
                            "fused_bottleneck": 0}:
                raise AssertionError(f"sth-sth CLI stage {stage}: launches {launches}, want "
                                     f"{want} patch launches ({steps} steps, {n_val} eval "
                                     "batches)")
            if res["host_frame_bytes"] or not math.isfinite(res["best_acc"]):
                raise AssertionError(f"sth-sth CLI stage {stage}: {res['host_frame_bytes']} B "
                                     f"from the host, best_acc {res['best_acc']}")
            peak = torch.cuda.max_memory_allocated(device)
            out["stages"][stage] = {"epochs": res["epochs"], "launches": launches,
                                    "best_acc": res["best_acc"], "peak_bytes": peak}
            print(f"CLI sth-sth train stage {stage} bf16 B={STH_CLI_B}, {STH_CLI_VIDEOS} "
                  f"synthetic dual-rate videos from the device cache: videos/s "
                  f"{[e['videos_per_s'] for e in res['epochs']]!r} (loader, batch prep and "
                  f"step, a cold epoch); patch launches {launches['extract_patches']} ({steps} "
                  f"steps, {n_val} eval batches); peak memory {peak} B ({peak / 2**30:.2f} "
                  f"GiB); best acc {res['best_acc']!r} ({card})", flush=True)
            del res
            torch.cuda.empty_cache()
            prev = f"{tmp}/s{stage}"
        for policy in CLI_POLICIES:
            args = _sthsth_cli_args(f"run.resume={prev}", f"run.ckpt_dir={tmp}/ev_{policy}",
                                    f"run.eval_policy={policy}")
            _launch_counts(reset=True)
            res = _run_cli(cli_evaluate.main, args, log)
            torch.cuda.synchronize()
            launches = _launch_counts()
            if launches["extract_patches"] != n_val or \
                    not all(math.isfinite(v) for v in res.values()):
                raise AssertionError(f"sth-sth CLI evaluate {policy}: {res}, launches {launches}")
            out["evaluate"][policy] = {"results": res, "launches": launches}
        print(f"CLI sth-sth evaluate bf16 B={STH_CLI_B} of stage 3: " + "; ".join(
            f"{p} {json.dumps(v['results'])} ({v['launches']['extract_patches']} patch "
            "launches)" for p, v in out["evaluate"].items()) + f" ({card})", flush=True)
    return out


@_seconds
def sthsth_train_phase(device, card: str) -> dict:
    """Phase 10 as a whole. The remat check and the CLI run with cuDNN's
    autotuner off, the CLI's setting (phase 5 turned it on for this
    process): with it on, the plain step's peak memory grows by the
    workspaces of the algorithms it picks."""
    out = {"steps": sthsth_train_timed(device, card)}
    out["discrete_ratio"] = sthsth_discrete_ratio(device, card)
    out["precision"] = sthsth_precisions(device)
    out["sampler"] = check_continuous_sampler(device)
    with _autotuner(False):
        out["remat"] = check_sthsth_remat(device, card)
        out["cli"] = sthsth_cli_phase(device, card)
    return out


# phase 11, AdaFocus+ at the serving point benchmark.plus_cfg((96, 8)): the
# glancer scans all T=16 frames, the focuser K=8 of them. bf16 against
# float32 and float32 against float64 inject the reference's frame indices
# and patch actions, so that a top-K tie does not decide the comparison
PLUS_POINT = (96, 8)
PLUS_B = 64                  # benchmarks/run_benchmarks.py --batch
PLUS_SMALL_B = 2
PLUS_COMPARE_B = 4
PLUS_PHASES = ("glance", "select", "gather", "policy", "extract", "focus", "scatter",
               "classify")
PLUS_FORWARDS = 10           # forwards of the phase split
PLUS_CLI_VIDEOS, PLUS_CLI_B = 64, 32
NO_FUSED = {"fused_inverted_residual": 0, "fused_bottleneck": 0}


def _plus_cfg(**kw):
    from adafocus_torch.benchmark import plus_cfg

    return dataclasses.replace(plus_cfg(PLUS_POINT), **kw)


def _topk_ties(scores, k: int) -> int:
    """Rows whose K-th and (K+1)-th largest scores are equal."""
    top = scores.float().sort(dim=-1, descending=True).values
    return int((top[:, k - 1] == top[:, k]).sum())


@_seconds
@_autotuner(False)
def plus_forward(device, card: str) -> dict:
    """Phase 11, serving at B=PLUS_SMALL_B (``inference_plus``): with the
    launch counts set to 0 just before, exactly one patch launch and no
    fused-block launch; logits (B, T, 200) finite; bf16 against float32 on
    the same weights with float32's frame indices and actions injected
    (BF16_REL_TOL); the patch kernel on the gathered frames at the policy's
    actions bit-identical to the plain version; the greedy top-K on the
    card equal to the stable sort's on the CPU for the same scores and for
    scores with many ties."""
    import torch

    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.models.gfv_plus import (
        forward_plus, gather_frames, inference_plus, random_frame_selection, select_topk,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = _plus_cfg()
    cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
    b, t, s, g, k = PLUS_SMALL_B, cfg16.num_frames, cfg16.image_size, cfg16.glance_size, \
        cfg16.frame_budget
    model16 = GFV(cfg16, device=device, generator=torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(SEED + 30)
    frames = torch.randn((b, t, s, s, 3), generator=gen).to(device)
    small = torch.randn((b, t, g, g, 3), generator=gen).to(device)
    frames16, small16 = frames.bfloat16(), small.bfloat16()
    _launch_counts(reset=True)
    logits = inference_plus(model16, frames16, small16, device=device)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if launches != {"extract_patches": 1, **NO_FUSED}:
        raise AssertionError(f"AdaFocus+ forward launches {launches}, want one patch launch")
    if tuple(logits.shape) != (b, t, cfg16.num_classes) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"AdaFocus+ logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits.float()).all())}")
    model32 = GFV(cfg32, device=device, generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        _, aux32 = forward_plus(model32, frames, small, train=False, patch_mode="policy")
        _, aux16 = forward_plus(model16, frames16, small16, train=False, patch_mode="policy")
        scores = model16.frame_scores(model16.glance(small16)[1])
    idx32, act32 = aux32["frame_idx"], aux32["actions"]
    logits32 = inference_plus(model32, frames, small, device=device, frame_idx=idx32,
                              actions=act32)
    logits16 = inference_plus(model16, frames16, small16, device=device, frame_idx=idx32,
                              actions=act32)
    rel = _rel_err(logits16, logits32)[0]
    agree = float((aux16["frame_idx"] == idx32).float().mean())
    print(f"AdaFocus+ {PLUS_POINT} B={b}: launches {launches}; bf16 vs float32 on float32's "
          f"frame indices and actions: max|d|/max|ref| = {rel!r} (limit {BF16_REL_TOL}); frame "
          f"index agreement bf16/f32 {agree!r}", flush=True)
    if not (torch.isfinite(logits32).all() and rel <= BF16_REL_TOL):
        raise AssertionError(f"AdaFocus+ bf16 vs float32: {rel} > {BF16_REL_TOL}")
    check_patch_at(gather_frames(frames16, aux16["frame_idx"]), aux16["actions"], s,
                   cfg16.patch_size, f"AdaFocus+ B={b}, K={k} gathered frames, policy actions")
    # the top-K on the card against the stable sort on the CPU, ties included
    tied = torch.randint(0, 3, (PLUS_B, t), generator=gen).float()
    for name, sc in (("the selector's bf16-valued scores", scores),
                     ("scores of three levels", tied.to(device))):
        got = select_topk(sc, k, "top")[0].cpu()
        want = select_topk(sc.cpu(), k, "top")[0]
        noise = random_frame_selection(*sc.shape, k, noise=sc).cpu()
        if not (torch.equal(got, want) and torch.equal(noise, want)):
            raise AssertionError(f"AdaFocus+ top-K on the card differs from the CPU's on {name}")
        print(f"AdaFocus+ top-{k} of {t} on the card equals the CPU's stable sort on {name} "
              f"({_topk_ties(sc, k)} of {sc.shape[0]} rows tied at the K-th score)", flush=True)
    del model32
    torch.cuda.empty_cache()
    return {"model": model16, "launches": launches, "bf16_vs_float32": rel,
            "frame_index_agreement": agree}


@_seconds
def plus_throughput(model16, device, card: str, gather_rows: dict) -> dict:
    """Phase 11, serving at B=PLUS_B: videos/s of three runs of ten
    forwards (``benchmark.inference_rates``), peak memory, each phase's mean
    ms over PLUS_FORWARDS forwards by CUDA events; beside them the rows at N
    = B*K that ``plus_gather_and_patch`` timed early in the run."""
    import torch

    from adafocus_torch.benchmark import inference_rates, make_data
    from adafocus_torch.models.gfv_plus import inference_plus

    n, times = gather_rows["n"], gather_rows["times"]
    cfg = model16.cfg
    b, t, s, p, k = PLUS_B, cfg.num_frames, cfg.image_size, cfg.patch_size, cfg.frame_budget
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    vps = inference_rates(model16, b, inner_iters=10, repeats=3)
    peak = torch.cuda.max_memory_allocated(device)
    data = make_data(cfg, b, device=device)
    frames, small = data["frames"], data["frames_small"]
    runs = []
    for i in range(2 + PLUS_FORWARDS):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(phase, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((phase, ev))

        inference_plus(model16, frames, small, device=device, mark=mark)
        if i >= 2:
            runs.append(marks)
    torch.cuda.synchronize()
    phase_ms = {}
    for m in runs:
        for (_, a), (name, ev) in zip(m, m[1:]):
            phase_ms[name] = phase_ms.get(name, 0.0) + a.elapsed_time(ev) / len(runs)
    if tuple(phase_ms) != PLUS_PHASES:
        raise AssertionError(f"AdaFocus+ phases {tuple(phase_ms)}")
    res = {"videos_per_s": vps, "phase_ms": phase_ms, "peak_bytes": peak, "n": n,
           "gather_and_patch": times}
    print(f"AdaFocus+ {PLUS_POINT} bf16 B={b}: videos/s {vps!r}; phase ms "
          f"{json.dumps(phase_ms)}; peak memory {peak} B ({peak / 2**30:.2f} GiB); at N={n}: "
          f"{json.dumps(times)} ({card})", flush=True)
    del data, frames, small
    torch.cuda.empty_cache()
    return res


@_seconds
@_autotuner(True)   # phase 11's setting (phase 5 turned it on)
def plus_gather_and_patch(device) -> dict:
    """Phase 11's timed rows at N = B*K, run early in the run (``main``):
    the serving point's B=PLUS_B frames (``benchmark.make_data``) and the
    greedy forward's (B, K) frame indices and (B, K, 2) actions
    (``forward_plus`` on the seeded model); the patch kernel on the gathered
    frames bit for bit against the plain version; then the frame gather of
    the (B, T) frames, beside its byte bound (B*K frames read and written);
    the patch kernel on the gathered frames, beside its byte bound, the
    plain version, a strided and a contiguous ``copy_`` of the same bytes;
    and ``index_select`` of the same rows. Each by CUDA events and by the
    profiler's device spans (``_times``), the plain version by events only.
    Returns {"n": B*K, "times": {...}}."""
    import torch

    from adafocus_torch.benchmark import make_data
    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.models.gfv_plus import forward_plus, gather_frames
    from adafocus_torch.ops.patch import (
        extract_patches_at, extract_patches_reference, patch_offsets,
    )
    from adafocus_torch.utils.profiling import events_ms

    cfg = _plus_cfg()
    model16 = GFV(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    data = make_data(cfg, PLUS_B, device=device)
    frames, small = data["frames"], data["frames_small"]
    with torch.inference_mode():
        _, aux = forward_plus(model16, frames, small, train=False, patch_mode="policy")
    del model16
    idx, actions = aux["frame_idx"], aux["actions"]
    b, t, s = frames.shape[:3]
    p, k = cfg.patch_size, cfg.frame_budget
    n = idx.numel()
    gathered = gather_frames(frames, idx)
    check_patch_at(gathered, actions, s, p, f"AdaFocus+ B={b} K={k} (N={n}) gathered frames")
    flat = gathered.reshape(n, s, s, 3)
    offs = patch_offsets(actions.reshape(-1, 2), s, p)
    rows = (torch.arange(b, device=frames.device)[:, None] * t + idx).reshape(-1)
    frames_bt = frames.reshape(b * t, s, s, 3)
    out = torch.empty((n, p, p, 3), dtype=frames.dtype, device=frames.device)
    o = min(64, s - p)
    window = flat[:, o:o + p, o:o + p, :]
    dense = torch.empty_like(out).copy_(window)
    elem = frames.element_size()
    patch_bytes = 2 * n * p * p * 3 * elem + n * 2 * 4
    gather_bytes = 2 * n * s * s * 3 * elem
    times = {}
    for key, fn in (("gather", lambda: gather_frames(frames, idx)),
                    ("index_select", lambda: torch.index_select(frames_bt, 0, rows)),
                    ("patch", lambda: extract_patches_at(gathered, actions, s, p)),
                    ("strided_copy", lambda: out.copy_(window)),
                    ("contiguous_copy", lambda: out.copy_(dense))):
        times[f"{key}_ms"], times[f"{key}_device_ms"] = _times(fn, iters=50, warmup=5)
    times["patch_plain_ms"] = events_ms(lambda: extract_patches_reference(flat, offs, p),
                                        iters=20)
    times.update(patch_bound_ms=patch_bytes / HBM_BYTES_PER_S * 1e3,
                 gather_bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3)
    del data, frames, small, gathered, flat, out, window, dense, frames_bt
    torch.cuda.empty_cache()
    return {"n": n, "times": times}


@_seconds
def plus_train_timed(device, card: str) -> dict:
    """Phase 11: the ST stage-1 step and the joint stage-2 step (``plus_rl``,
    reward 'random') at B=PLUS_B, TRAIN_WARMUP + TRAIN_TIMED steps each with
    the launch counts set to 0 just before: videos/s, each phase's ms by
    CUDA events, peak memory; exactly one and two patch launches a step;
    finite metrics, every stage-2 ratio_mean within RATIO_TOL of 1; frozen
    components bit-identical, every trained tensor moved (the selector in
    stage 1; the policy and selector_ac in stage 2)."""
    import torch

    from adafocus_torch.train.stages import create_train_state
    from adafocus_torch.train.stages_plus import make_plus_stage2_joint_step, make_plus_train_step

    batch = _train_batch(_plus_cfg(), PLUS_B, device, SEED + 31, torch.bfloat16)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    out = {}
    for stage, rl in ((1, False), (2, True)):
        cfg = _plus_cfg(plus_rl=rl)
        state = create_train_state(cfg, stage, device=device,
                                   generator=torch.Generator().manual_seed(SEED))
        model = state.model
        step = make_plus_stage2_joint_step(model, state.ppo) if stage == 2 else \
            make_plus_train_step(model, 1, state.optimizer, state.scheduler)
        gen = torch.Generator(device=device).manual_seed(SEED + 32 + stage)
        before = _snapshot(model)
        run = _timed_steps(step, batch, gen, device)
        if run["launches"] != {"extract_patches": stage * n_steps, **NO_FUSED}:
            raise AssertionError(f"AdaFocus+ stage {stage}: launches {run['launches']} in "
                                 f"{n_steps} steps, want {stage} patch launches a step")
        metrics = run["metrics"]
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"AdaFocus+ stage {stage} metrics {metrics}")
        if stage == 2 and not all(abs(m["ppo/ratio_mean"] - 1.0) <= RATIO_TOL for m in metrics):
            raise AssertionError(f"AdaFocus+ stage 2 ratio_mean "
                                 f"{[m['ppo/ratio_mean'] for m in metrics]}")
        check_train_update(before, model, stage, f"AdaFocus+ stage {stage} B={PLUS_B}",
                           labels={"selector_ac": "ppo"} if stage == 2 else None)
        vps, step_ms, peak = run["videos_per_s"], run["step_ms"], run["peak_bytes"]
        key = "ppo/loss" if stage == 2 else "loss"
        print(f"train AdaFocus+ {'joint ' if stage == 2 else 'ST '}stage {stage} bf16 B={PLUS_B} "
              f"K={cfg.frame_budget} of T={cfg.num_frames}: videos/s {vps!r} (mean "
              f"{PLUS_B * len(step_ms) / (sum(step_ms) / 1e3)!r}); step ms {step_ms!r}; phase ms "
              f"{json.dumps(run['phase_ms'])}; peak memory {peak} B ({peak / 2**30:.2f} GiB); "
              f"patch launches {run['launches']['extract_patches']} in {n_steps} steps; {key} "
              f"{[m[key] for m in metrics]}"
              + (f"; ratio_mean {[m['ppo/ratio_mean'] for m in metrics]!r}" if stage == 2
                 else "") + f" ({card})", flush=True)
        out[stage] = {k: run[k] for k in ("videos_per_s", "step_ms", "phase_ms", "peak_bytes",
                                          "launches", "metrics")}
        del state, model, step, before, run
        torch.cuda.empty_cache()
    return out


@_seconds
@_autotuner(False)
def plus_precisions(device) -> dict:
    """Phase 11: one ST stage-1 step and one joint stage-2 step at
    B=PLUS_COMPARE_B in bf16 compute, float32 (TF32 off) and float64, from
    the same float32 initial weights, on the same batch and injected draws
    (stage 1: the frame indices and patch actions; stage 2: the selector's
    picks, the policy's anchors, the baseline's frames and patch actions):
    float32 against float64 at phase 6's limits (stage 1: the loss, each
    trained component's gradient cosine) and phase 7's (stage 2: the PPO
    loss, the rewards, the learner's gradient cosine); bf16 against float32
    printed."""
    import torch

    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.ppo.core import PPOConfig, ppo_init, ppo_update
    from adafocus_torch.train.optim import OptimConfig, freeze_for_stage, make_stage_optimizer
    from adafocus_torch.train.stages import joint_learner
    from adafocus_torch.train.stages_plus import (
        joint_loss, make_plus_train_step, plus_stage2_episode,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg16 = _plus_cfg()
    b, t, k = PLUS_COMPARE_B, cfg16.num_frames, cfg16.frame_budget
    batch = _train_batch(cfg16, b, device, SEED + 35, torch.float32)
    gen = torch.Generator(device=device).manual_seed(SEED + 36)
    picks = torch.rand((b, t), generator=gen, device=device).argsort(dim=1)[:, :k]
    actions = random_patch_actions((b, k), gen, device)
    draws = {"select": picks, "spatial": torch.randint(0, cfg16.action_dim, (k, b),
                                                       generator=gen, device=device),
             "base_idx": torch.randint(0, t, (b, k), generator=gen, device=device),
             "base_actions": random_patch_actions((b, k), gen, device)}
    st, joint = {}, {}
    for dtype in (torch.bfloat16, torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        pdtype = torch.promote_types(dtype, torch.float32)
        model = GFV(dataclasses.replace(cfg16, dtype=dtype), device=device,
                    generator=torch.Generator().manual_seed(SEED), param_dtype=pdtype)
        step = make_plus_train_step(model, 1, *make_stage_optimizer(model, 1, OptimConfig()))
        loss = float(step(batch, None, frame_idx=picks.sort(dim=1).values,
                          actions=actions)["loss"])
        st[name] = (loss, {comp: torch.cat([p.grad.flatten().double()
                                            for p in getattr(model, comp).parameters()])
                           for comp in ("focuser", "classifier", "selector")})
        del model, step
        model = GFV(dataclasses.replace(cfg16, dtype=dtype, plus_rl=True), device=device,
                    generator=torch.Generator().manual_seed(SEED), param_dtype=pdtype)
        freeze_for_stage(model, 2)
        ppo = ppo_init(joint_learner(model), PPOConfig())
        episode = plus_stage2_episode(model, batch, None, ppo.cfg, draws)
        metrics = ppo_update(ppo, episode, model.autocast, joint_loss)
        joint[name] = (float(metrics["ppo/loss"]), episode["rewards"].double().flatten(),
                       torch.cat([p.grad.flatten().double() for p in ppo.policy.parameters()]),
                       float(metrics["ppo/ratio_mean"]))
        del model, ppo, episode
        torch.cuda.empty_cache()

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

    out = {}
    for name, ref in (("float32", "float64"), ("bfloat16", "float32")):
        (loss, g), (loss_ref, g_ref) = st[name], st[ref]
        (jl, r, jg, ratio), (jl_ref, r_ref, jg_ref, _) = joint[name], joint[ref]
        out[f"{name}_vs_{ref}"] = cmp = {
            "stage1_loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "stage1_grad_cos": {c: cos(g[c], g_ref[c]) for c in g},
            "stage2_loss_rel": abs(jl - jl_ref) / abs(jl_ref),
            "stage2_reward_rel": float((r - r_ref).abs().max() / r_ref.abs().max()),
            "stage2_grad_cos": cos(jg, jg_ref), "stage2_ratio_mean": ratio}
        print(f"AdaFocus+ B={b}, {name} vs {ref} (TF32 off), one ST stage-1 and one joint "
              f"stage-2 step on the same weights, batch and draws: {json.dumps(cmp)}",
              flush=True)
        if not all(math.isfinite(v) for v in (loss, jl)):
            raise AssertionError(f"AdaFocus+ {name}: losses {loss}, {jl}")
    f32 = out["float32_vs_float64"]
    checks = [("stage 1 loss", f32["stage1_loss_rel"] <= F32_LOSS_REL_TOL),
              ("stage 2 ppo loss", f32["stage2_loss_rel"] <= PPO_F32_LOSS_REL_TOL),
              ("stage 2 rewards", f32["stage2_reward_rel"] <= PPO_F32_REWARD_REL_TOL),
              ("stage 2 gradient cosine", f32["stage2_grad_cos"] >= PPO_F32_GRAD_MIN_COS)]
    checks += [(f"stage 1 {c} cosine", v >= F32_GRAD_MIN_COS)
               for c, v in f32["stage1_grad_cos"].items()]
    failed = [name for name, ok in checks if not ok]
    print(f"AdaFocus+ precision limits, float32 vs float64 (phases 6 and 7): failed: {failed}",
          flush=True)
    if failed:
        raise AssertionError(f"AdaFocus+ precision checks failed: {failed}")
    return out


@_seconds
@_autotuner(False)
def plus_small_stages(device) -> dict:
    """Phase 11: the ST stage-3 step (two steps) and then the eval step at
    B=PLUS_SMALL_B, each with the launch counts set to 0 just before: one
    patch launch a step and eval, finite loss, frozen components
    bit-identical (the focuser's running statistics move: it runs in train
    mode, as in the JAX package), the classifier and selector moved; the
    eval step leaves the model as it was and returns finite logits."""
    import torch

    from adafocus_torch.train.stages import create_train_state
    from adafocus_torch.train.stages_plus import make_plus_eval_step, make_plus_train_step

    cfg = _plus_cfg()
    batch = _train_batch(cfg, PLUS_SMALL_B, device, SEED + 37, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 38)
    state = create_train_state(cfg, 3, device=device, generator=torch.Generator().manual_seed(SEED))
    model = state.model
    step = make_plus_train_step(model, 3, state.optimizer, state.scheduler)
    before = _snapshot(model)
    _launch_counts(reset=True)
    losses = [float(step(batch, gen)["loss"]) for _ in range(2)]
    launches = {"stage 3": _launch_counts()}
    if launches["stage 3"] != {"extract_patches": 2, **NO_FUSED} or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"AdaFocus+ stage 3: launches {launches['stage 3']}, losses {losses}")
    check_train_update(before, model, 3, f"AdaFocus+ stage 3 B={PLUS_SMALL_B}",
                       moving_stats=("focuser",))
    before = _snapshot(model)
    _launch_counts(reset=True)
    logits, metrics = make_plus_eval_step(model)(batch)
    torch.cuda.synchronize()
    launches["eval"] = _launch_counts()
    after = model.state_dict()
    if launches["eval"] != {"extract_patches": 1, **NO_FUSED} or \
            tuple(logits.shape) != (PLUS_SMALL_B, cfg.num_frames, cfg.num_classes) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"AdaFocus+ eval: launches {launches['eval']}, logits "
                             f"{tuple(logits.shape)}")
    if any(not torch.equal(v, after[k]) for k, v in before.items()):
        raise AssertionError("the AdaFocus+ eval step changed the model")
    print(f"AdaFocus+ stage 3 bf16 B={PLUS_SMALL_B}: losses {losses}, launches "
          f"{launches['stage 3']}; eval step: logits {tuple(logits.shape)} finite, top1 "
          f"{float(metrics['top1'])}, launches {launches['eval']}", flush=True)
    del state, model, step
    torch.cuda.empty_cache()
    return launches


def _plus_cli_args(*extra) -> list:
    return ["--config", os.path.join(ROOT, "configs", "actnet_default.yaml"),
            "run.synthetic_data=true", f"run.synthetic_videos={PLUS_CLI_VIDEOS}",
            "loader.cache=device", f"loader.batch_size={PLUS_CLI_B}",
            f"model.frame_budget={PLUS_POINT[1]}", "model.plus_rl=true", *extra]


@_seconds
def plus_cli_phase(device, card: str) -> dict:
    """Phase 11: the CLI with ``model.frame_budget=8 model.plus_rl=true``
    (configs/actnet_default.yaml, bf16, B=PLUS_CLI_B, PLUS_CLI_VIDEOS
    synthetic clips in the device cache): stages 1 -> 2 -> 3, one epoch
    each, each warm-started from the one before, then evaluate, each with
    the launch counts set to 0 just before: one patch launch a stage-1/3
    step and eval batch, two a joint stage-2 step, no fused-block launch;
    the selector actor-critic crosses from stage 2 to stage 3 bit for bit;
    no frame byte from the host after the fill; finite results."""
    import tempfile

    import torch

    from adafocus_torch.cli import evaluate as cli_evaluate
    from adafocus_torch.cli import train as cli_train
    from adafocus_torch.train import checkpoint as ckpt

    out = {"stages": {}}
    n_val = -(-PLUS_CLI_VIDEOS // PLUS_CLI_B)
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "cli.log")
        prev = None
        for stage in (1, 2, 3):
            args = _plus_cli_args(f"run.stage={stage}", "run.epochs=1",
                                  f"run.ckpt_dir={tmp}/p{stage}",
                                  *([f"run.warm_start={prev}"] if prev else []))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            _launch_counts(reset=True)
            res = _run_cli(cli_train.main, args, log)
            torch.cuda.synchronize()
            launches = _launch_counts()
            steps = sum(e["steps"] for e in res["epochs"])
            want = (2 if stage == 2 else 1) * steps + n_val
            if launches != {"extract_patches": want, **NO_FUSED}:
                raise AssertionError(f"AdaFocus+ CLI stage {stage}: launches {launches}, want "
                                     f"{want} ({steps} steps, {n_val} eval batches)")
            if res["host_frame_bytes"] or not math.isfinite(res["best_acc"]):
                raise AssertionError(f"AdaFocus+ CLI stage {stage}: {res['host_frame_bytes']} B "
                                     f"from the host, best_acc {res['best_acc']}")
            if stage == 3:
                tree = ckpt.load_checkpoint(prev, best=True) or ckpt.load_checkpoint(prev)
                _same_as_checkpoint(res["state"].model, tree, ("selector_ac", "glancer"),
                                    "AdaFocus+ CLI stage 3")
            peak = torch.cuda.max_memory_allocated(device)
            out["stages"][stage] = {"epochs": res["epochs"], "launches": launches,
                                    "best_acc": res["best_acc"], "peak_bytes": peak}
            print(f"CLI AdaFocus+ (plus_rl, K={PLUS_POINT[1]}) train stage {stage} bf16 "
                  f"B={PLUS_CLI_B}, {PLUS_CLI_VIDEOS} synthetic videos from the device cache: "
                  f"videos/s {[e['videos_per_s'] for e in res['epochs']]!r} (loader, batch prep "
                  f"and step, a cold epoch); patch launches {launches['extract_patches']} "
                  f"({steps} steps, {n_val} eval batches); peak memory {peak} B "
                  f"({peak / 2**30:.2f} GiB); best acc {res['best_acc']!r} ({card})", flush=True)
            del res
            torch.cuda.empty_cache()
            prev = f"{tmp}/p{stage}"
        _launch_counts(reset=True)
        res = _run_cli(cli_evaluate.main, _plus_cli_args(f"run.resume={prev}",
                                                         f"run.ckpt_dir={tmp}/pev"), log)
        torch.cuda.synchronize()
        launches = _launch_counts()
        if launches != {"extract_patches": n_val, **NO_FUSED} or \
                not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"AdaFocus+ CLI evaluate: {res}, launches {launches}")
        out["evaluate"] = {"results": res, "launches": launches}
        print(f"CLI AdaFocus+ evaluate bf16 B={PLUS_CLI_B} of stage 3: {json.dumps(res)} "
              f"({launches['extract_patches']} patch launches) ({card})", flush=True)
    return out


@_seconds
def plus_phase(device, card: str, gather_rows: dict) -> dict:
    """Phase 11 as a whole, with the rows ``plus_gather_and_patch`` timed
    early. The CLI runs with cuDNN's autotuner off, the CLI's setting."""
    import torch

    fwd = plus_forward(device, card)
    model16 = fwd.pop("model")
    out = {"forward": fwd, "serving": plus_throughput(model16, device, card, gather_rows)}
    del model16
    torch.cuda.empty_cache()
    out["train"] = plus_train_timed(device, card)
    out["precision"] = plus_precisions(device)
    out["small"] = plus_small_stages(device)
    with _autotuner(False):
        out["cli"] = plus_cli_phase(device, card)
    return out


# ---------------------------------------------------------------------------
# Phase 12: int8 PTQ serving.
# ---------------------------------------------------------------------------

INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core peak (data sheet)
INT8_CHECK_N = 2            # frames / patches of each unit shape's check against the plain version
INT8_TIME_N = (1024, 64)    # frames / patches of each unit shape's timing: the B=64 forward's
#                             N (16 frames and 16 patches a video), and N=64
INT8_HEAD_M = (1, 64)       # rows of the heads' products: batch 1, and B=64 videos
HEAD_STEPS = {"policy/gru/h": 16, "cls/gru/h": 16}   # the flagship's T GRU steps a forward


def _q8_unit_shapes(backbone, kind: str, size: int, device) -> list:
    """Every int8 unit of one backbone at input side ``size``, in forward
    order: (name, ConvBNAct, (H, W, Cin), fused options), from one pass at
    N=1 whose runner records each unit and runs it in float32. The options
    are those the int8 forward runs the unit with (``_UnitRunner``):
    ``codes_in`` (its producer writes its input's codes; else the input is
    quantized on load), ``to`` (the unit that reads its codes, or None),
    ``keep`` (its compute-dtype output written), ``residual``, ``res_relu``."""
    import torch

    from adafocus_torch.models import quant_inference as qi
    from adafocus_torch.models.fused_inference import _conv_bn

    seen = []

    class Record:
        def __call__(self, name, x, unit, to=None, keep=False, residual=None, res_relu=False):
            if name != "stem":
                seen.append((name, unit, tuple(x.y.shape[1:]),
                             {"to": to, "keep": keep or to is None,
                              "residual": residual is not None, "res_relu": res_relu}))
            y = _conv_bn(x.y, unit, torch.float32)
            if residual is not None:
                y = y + residual.y
                y = y.relu_() if res_relu else y
            return qi.Act(y)

    fn = qi._mbv2_backbone if kind == "mbv2" else qi._resnet_backbone
    with torch.inference_mode():
        fn(backbone, torch.zeros((1, size, size, 3), device=device), Record())
    producers = {opts["to"] for *_, opts in seen}
    return [(name, unit, shape, dict(opts, codes_in=name in producers))
            for name, unit, shape, opts in seen]


def _q8_head_shapes(model) -> list:
    """The flagship's int8 head products: (name, weight (out, in), bias,
    launches a forward in ``int8+heads``)."""
    p, c = model.policy, model.classifier
    return [("policy/proj", p.encoder.proj.weight[:, :, 0, 0], p.encoder.proj.bias, 1),
            ("policy/fc", p.encoder.fc.weight, p.encoder.fc.bias, 1),
            ("policy/gru/x", p.gru.weight_ih, p.gru.bias_ih, 1),
            ("policy/gru/h", p.gru.weight_hh, p.gru.bias_hh, HEAD_STEPS["policy/gru/h"]),
            ("policy/actor", p.actor.weight, p.actor.bias, 1),
            ("policy/critic", p.critic.weight, p.critic.bias, 1),
            ("cls/gru/x", c.gru.weight_ih, c.gru.bias_ih, 1),
            ("cls/gru/h", c.gru.weight_hh, c.gru.bias_hh, HEAD_STEPS["cls/gru/h"]),
            ("cls/fc", c.fc.weight, c.fc.bias, 1)]


def _int8_case(qc, x_q, stride: int, groups: int, act, dense: bool):
    """(kernel(out_dtype), the exact accumulators, the plain epilogue(out_dtype))
    of one unit."""
    from adafocus_torch.ops import quant as q

    if dense:
        def run(dtype):
            return q.int8_dense(x_q, qc, act, dtype)
        acc = x_q.double() @ qc.kernel_q.double().t()
    else:
        def run(dtype):
            return q.int8_conv(x_q, qc, stride, groups, act, dtype)
        acc = q.conv_acc_reference(x_q, qc.kernel_q, stride, groups)

    def plain(dtype):
        return q.epilogue_reference(acc, qc.rescale, qc.bias, act, dtype)

    return run, acc, plain


def _check_int8_case(run, acc, plain, label: str) -> dict:
    """One unit's kernel against its plain version: the int32 accumulators
    equal; the float32 outputs bit-identical but where the float64-emulated
    FMA double-rounds (counted, each within 1 float32 ulp); the bf16 output
    the float32 one rounded."""
    import torch

    got_acc = run(torch.int32)
    torch.cuda.synchronize()
    if got_acc.shape != acc.shape or not torch.equal(got_acc.double(), acc):
        raise AssertionError(f"int8 {label}: accumulators differ from the plain version "
                             f"(max |d| {(got_acc.double() - acc).abs().max().item()})")
    got, want = run(torch.float32), plain(torch.float32)
    diff = got != want
    n_diff = int(diff.sum())
    if n_diff:
        ulps = (got[diff].view(torch.int32).long() - want[diff].view(torch.int32).long()).abs()
        if ulps.max().item() > 1:
            raise AssertionError(f"int8 {label}: {n_diff} float32 outputs differ, up to "
                                 f"{ulps.max().item()} ulp")
    if not torch.equal(run(torch.bfloat16), got.to(torch.bfloat16)):
        raise AssertionError(f"int8 {label}: the bf16 store is not the float32 output rounded")
    return {"double_rounded": n_diff, "max_abs_err": (got - want).abs().max().item(),
            "values": got.numel()}


def _fused_case(qc, x_codes, stride: int, groups: int, act, opts: dict, gen):
    """A backbone unit as the int8 forward runs it (bf16, its fused options)
    on inputs made from the codes ``x_codes``: the codes themselves, or bf16
    values of their range to be quantized on load; a bf16 residual of the
    output's spread; the consumer's scale from the plain output's range.
    Returns (kernel(keep) -> (y, codes), plain() -> (y, codes))."""
    import torch

    from adafocus_torch.ops import quant as q

    x = x_codes if opts["codes_in"] else (x_codes.float() * qc.x_scale * 1.1).bfloat16()
    y0 = q.unit_reference(x, qc.kernel_q, stride, groups, qc.rescale, qc.bias, act,
                          torch.bfloat16, qc.x_scale)[0]
    residual = None
    if opts["residual"]:
        residual = (torch.randn(y0.shape, generator=gen, device=y0.device)
                    * y0.float().std()).bfloat16()
    out_scale = None
    if opts["to"] is not None:
        out_scale = (y0.float().abs().amax() / 127).clamp_min(1e-6).reshape(())

    def run(keep):
        return q.int8_unit(x, qc, stride, groups, act, torch.bfloat16, out_scale=out_scale,
                           keep=keep, residual=residual, res_relu=opts["res_relu"])

    def plain():
        return q.unit_reference(x, qc.kernel_q, stride, groups, qc.rescale, qc.bias, act,
                                torch.bfloat16, qc.x_scale, residual, opts["res_relu"],
                                out_scale)

    return run, plain


def _check_fused_case(run, plain, opts: dict, label: str) -> dict:
    """A unit's fused kernel against the plain composition: the bf16 outputs
    (written with ``keep``) bit-identical but where the plain version's
    float64-emulated FMA double-rounds (counted, each within 1 bf16 ulp); the
    int8 codes equal but at those outputs (counted, each within 1); the
    launch the forward makes (its own ``keep``) gives the same codes and
    outputs."""
    import torch

    y, codes = run(True)
    y_ref, codes_ref = plain()
    torch.cuda.synchronize()
    moved = y != y_ref
    n_moved = int(moved.sum())
    if n_moved:
        ulps = (y[moved].view(torch.int16).long() - y_ref[moved].view(torch.int16).long()).abs()
        if ulps.max().item() > 1:
            raise AssertionError(f"int8 {label} fused: {n_moved} bf16 outputs differ, up to "
                                 f"{ulps.max().item()} ulp")
    n_codes = 0
    if codes is not None:
        differ = codes != codes_ref
        n_codes = int(differ.sum())
        if n_codes and ((differ & ~moved).any() or
                        (codes.long() - codes_ref.long())[differ].abs().max().item() > 1):
            raise AssertionError(f"int8 {label} fused: {n_codes} codes differ, beyond the "
                                 f"{n_moved} double-rounded outputs or by more than 1")
    y_fwd, codes_fwd = run(opts["keep"])
    if (y_fwd is not None and not torch.equal(y_fwd, y)) or (
            codes is not None and not torch.equal(codes_fwd, codes)):
        raise AssertionError(f"int8 {label} fused: the forward's launch (keep={opts['keep']}) "
                             f"differs from the checked one")
    return {"fused_double_rounded": n_moved, "fused_codes_moved": n_codes,
            "fused_max_abs_err": (y.float() - y_ref.float()).abs().max().item()}


def _int8_cost(x, qc, out_shape, k: int, opts) -> tuple:
    """(bytes, operations) one call must move and do: its input read once
    (int8 codes, or the bf16 values it quantizes on load), the weight once,
    rescale and bias; what it writes once (the int8 codes, the bf16 output
    where it keeps it; a head its float32 output) and the residual it
    reads; two operations a multiply-add."""
    import math

    out = math.prod(out_shape)
    per_value = 4 if opts is None else (
        (1 if opts["to"] else 0) + (2 if opts["keep"] else 0) + (2 if opts["residual"] else 0))
    moved = (x.numel() * x.element_size() + qc.kernel_q.numel() + per_value * out
             + 8 * out_shape[-1])
    return moved, 2 * out * k


def _int8_library(x_q, qc, stride: int, groups: int, dense: bool):
    """The yardstick of one unit: ``torch._int_mm`` on the same int8 product
    where it takes it (a 1x1 stride-1 conv or a dense, M > 16, K and N
    multiples of 8), else the bf16 op at the same shape (cuDNN's conv, or a
    bf16 matmul). Returns (name, fn)."""
    import torch
    from torch.nn import functional as F

    w = qc.kernel_q
    cout = w.shape[0]
    k = w[0].numel()
    pointwise = dense or (w.dim() == 4 and w.shape[2] == 1 and stride == 1 and groups == 1)
    if pointwise:
        a = x_q.reshape(-1, k)
        if a.shape[0] > 16 and k % 8 == 0 and cout % 8 == 0:
            wt = w.reshape(cout, k).t()
            try:
                torch._int_mm(a, wt)
                return "torch._int_mm", lambda: torch._int_mm(a, wt)
            except RuntimeError:
                pass
        a16, w16 = a.bfloat16(), w.reshape(cout, k).bfloat16()
        return "bf16 matmul", lambda: a16 @ w16.t()
    x16 = x_q.permute(0, 3, 1, 2).bfloat16()
    w16 = w.bfloat16().contiguous(memory_format=torch.channels_last)
    pad = (w.shape[2] - 1) // 2
    return "cuDNN bf16 conv", lambda: F.conv2d(x16, w16, stride=stride, padding=pad,
                                               groups=groups)


def _int8_timed(qc, in_shape, stride, groups, act, opts, dense, n, gen, device,
                label: str) -> dict:
    """One unit shape at N=n as the forward launches it (bf16 with its fused
    options; a head float32): first held against the plain version on the
    same inputs (``_check_fused_case``; a head ``_check_int8_case``), since
    the launch plan depends on M (``plan_int8_conv``), then kernel, plain
    version and yardstick ms, with its bound: the kernel's and the
    yardstick's by CUDA events and by the profiler (``_row_times``), the
    plain version's by events."""
    import torch

    from adafocus_torch.utils.profiling import events_ms

    x = torch.randint(-127, 128, (n,) + in_shape, generator=gen, device=device,
                      dtype=torch.int8)
    k = qc.kernel_q[0].numel()
    if dense:
        run, acc, plain = _int8_case(qc, x, stride, groups, act, dense)
        check = _check_int8_case(run, acc, plain, f"{label} N={n}")
        fn, plain_fn, x_in = (lambda: run(torch.float32)), (lambda: plain(torch.float32)), x
        out_shape = tuple(acc.shape)
        del acc
    else:
        run, plain = _fused_case(qc, x, stride, groups, act, opts, gen)
        check = _check_fused_case(run, plain, opts, f"{label} N={n}")
        check["max_abs_err"] = check["fused_max_abs_err"]
        fn, plain_fn = (lambda: run(opts["keep"])), plain
        got = fn()
        out_shape = tuple((got[0] if got[0] is not None else got[1]).shape)
        x_in = x if opts["codes_in"] else x.bfloat16()
        del got
    torch.cuda.empty_cache()
    lib_name, lib = _int8_library(x, qc, stride, groups, dense)
    big = n > INT8_TIME_N[-1]
    with torch.inference_mode():
        times = _row_times(fn, lib, iters=20, warmup=3)
        plain_ms = events_ms(plain_fn, iters=1 if big else 3, warmup=1)
    moved, ops = _int8_cost(x_in, qc, out_shape, k, opts)
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS * 1e3
    del x
    torch.cuda.empty_cache()
    return {"n": n, **times, "plain_ms": plain_ms, "library": lib_name,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "tops": ops / times["device_ms"] / 1e9, "check": check}


def _moved(check: dict) -> str:
    if "fused_double_rounded" not in check:
        return f"{check['double_rounded']} float32 outputs double-rounded"
    return (f"{check['fused_double_rounded']} bf16 outputs double-rounded, "
            f"{check['fused_codes_moved']} codes moved by 1")


def _int8_unit_rows(units: list, dense: bool, n_check: int, n_times, gen, device,
                    label: str) -> list:
    """Each distinct unit shape of ``units`` ((name, weight qc, input shape,
    stride, groups, act, launches a forward, fused options or None for a
    head)): checked at ``n_check`` against the plain version (accumulators,
    float32 and bf16 outputs; a backbone unit also with its fused options),
    then timed at each N of ``n_times`` beside the plain version and the
    yardstick, with its bound. One row a shape, the launches of every unit
    of that shape summed; its top-level times at ``n_times[0]``."""
    import torch

    rows, by_key = [], {}
    for name, qc, in_shape, stride, groups, act, launches, opts in units:
        key = (in_shape, tuple(qc.kernel_q.shape), stride, groups, act,
               None if opts is None else tuple(sorted(opts.items())))
        if key in by_key:
            by_key[key]["launches"] += launches
            by_key[key]["units"].append(name)
            continue
        k = qc.kernel_q[0].numel()
        kind = "int8_dwconv" if groups > 1 else "int8_conv"
        x_chk = torch.randint(-127, 128, (n_check,) + in_shape, generator=gen, device=device,
                              dtype=torch.int8)
        run, acc, plain = _int8_case(qc, x_chk, stride, groups, act, dense)
        shape = (f"M={n_check}x{in_shape[0]} K={k} N={qc.kernel_q.shape[0]}" if dense else
                 f"{in_shape[0]}x{in_shape[1]}x{in_shape[2]} k{qc.kernel_q.shape[-1]} "
                 f"s{stride} -> {qc.kernel_q.shape[0]}{' dw' if groups > 1 else ''}")
        check = _check_int8_case(run, acc, plain, f"{label} {name} {shape}")
        if opts is not None:
            frun, fplain = _fused_case(qc, x_chk, stride, groups, act, opts, gen)
            check.update(_check_fused_case(frun, fplain, opts, f"{label} {name} {shape}"))
            check["max_abs_err"] = max(check["max_abs_err"], check["fused_max_abs_err"])
        del x_chk, acc
        times = {n: _int8_timed(qc, in_shape, stride, groups, act, opts, dense, n, gen,
                                device, f"{label} {name} {shape}") for n in n_times}
        check["max_abs_err"] = max([check["max_abs_err"]]
                                   + [t["check"]["max_abs_err"] for t in times.values()])
        row = by_key[key] = {"kernel": kind, "units": [name], "launches": launches,
                             "shape": shape, "options": opts, **times[n_times[0]],
                             "by_n": times, **check}
        rows.append(row)
        print(f"{kind} {label} {name} {shape} {opts}: "
              + "; ".join(f"N={n} kernel {t['ms']!r} ms ({t['device_ms']!r} on the device, "
                          f"{t['tops']!r} TOP/s), plain {t['plain_ms']!r} ms, {t['library']} "
                          f"{t['library_ms']!r} ms ({t['library_device_ms']!r} on the device), bound "
                          f"{t['bound_ms']!r} ms ({t['bound_by']}), held against plain "
                          f"({_moved(t['check'])})" for n, t in times.items())
              + f"; accumulators equal, {check['double_rounded']} of {check['values']} float32 "
              f"outputs double-rounded"
              + (f", fused: {check['fused_double_rounded']} bf16 outputs double-rounded, "
                 f"{check['fused_codes_moved']} codes moved by 1" if opts else ""), flush=True)
    return rows


def _backbone_units(backbone, kind: str, size: int, device) -> list:
    """``_int8_unit_rows``' entries of one backbone: the real folded weights
    quantized, a fixed input scale, each unit's fused options."""
    import torch

    from adafocus_torch.models.quant_inference import _ACT_NAMES
    from adafocus_torch.ops.fused_blocks import fold_bn
    from adafocus_torch.ops.quant import QConv, prepare_qconv, quantize_weight

    units = []
    for name, unit, in_shape, opts in _q8_unit_shapes(backbone, kind, size, device):
        kernel, bias = fold_bn(unit)
        kq, ws = quantize_weight(kernel)
        groups = unit.conv.groups
        qc = prepare_qconv(QConv(kq, ws, bias, torch.tensor(0.05, device=device)),
                           depthwise=groups > 1)
        units.append((name, qc, in_shape, unit.conv.stride[0], groups, _ACT_NAMES[unit.act], 1,
                      opts))
    return units


def _head_units(model, m: int, gen, device) -> list:
    import torch

    from adafocus_torch.ops.quant import QConv, prepare_qconv, quantize_weight

    units = []
    for name, weight, bias, launches in _q8_head_shapes(model):
        kq, ws = quantize_weight(weight.float())
        b = torch.randn(kq.shape[0], generator=gen, device=device) * 0.1
        qc = prepare_qconv(QConv(kq, ws, b, torch.ones((), device=device)))
        units.append((name, qc, (kq.shape[1],), 1, 1, None, launches, None))
    return units


def _int8_kernel_row(name: str, rows: list, line: int, shape: str) -> dict:
    """One kernel's line: each time summed over the forward's launches, at
    the rows' first N (top level) and at each N (``by_n``)."""
    def totals(by):
        t = _summed_times([(r["launches"], by(r)) for r in rows])
        t.update({k: sum(r["launches"] * by(r)[k] for r in rows) for k in ("plain_ms", "bound_ms")})
        by_bytes = sum(r["launches"] * by(r)["bound_ms"] for r in rows
                       if by(r)["bound_by"] == "bytes")
        t["bound_by"] = "bytes" if 2 * by_bytes >= t["bound_ms"] else "operations"
        return t

    out = {"name": name, "route": "cuda", "source": "adafocus_torch/csrc/int8_conv.cu",
           "replaces": f"adafocus_tpu/ops/quant.py:{line}",
           "max_abs_err": max(r["max_abs_err"] for r in rows), **totals(lambda r: r),
           "double_rounded": sum(r["double_rounded"] for r in rows), "shape": shape}
    if all("by_n" in r for r in rows):
        out["by_n"] = {n: totals(lambda r, n=n: r["by_n"][n]) for n in rows[0]["by_n"]}
    return out


@_seconds
@_autotuner(True)   # phase 12's setting (phase 5 turned it on): the yardsticks' algorithms
def check_int8_kernels(device) -> tuple:
    """Phase 12's kernel check: every int8 unit shape of the flagship's
    glancer (224^2) and focuser (96^2 patches) and of the matched
    configuration's focuser (144^2), with the fused options the int8 forward
    runs it with, and the flagship's heads at M = 1 and 64, against the
    plain version (accumulators equal, outputs bit-identical but for double
    rounding, codes equal but at a double-rounded output), then timed at
    N=1024 and N=64 (the heads at their M). Returns (the kernels line's
    rows for int8_conv and int8_dwconv, every shape's row)."""
    import torch

    from adafocus_torch.benchmark import sthsth_cfg
    from adafocus_torch.models.gfv import GFV, flagship

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    cpu_gen = torch.Generator().manual_seed(SEED + 12)
    flag = _randomize_bn(GFV(flagship(), device="cpu", generator=cpu_gen,
                             param_dtype=torch.float32), cpu_gen).to(device)
    flag_rows = (_int8_unit_rows(_backbone_units(flag.glancer, "mbv2", 224, device), False,
                                 INT8_CHECK_N, INT8_TIME_N, gen, device, "flagship glancer")
                 + _int8_unit_rows(_backbone_units(flag.focuser, "resnet", 96, device), False,
                                   INT8_CHECK_N, INT8_TIME_N, gen, device, "flagship focuser"))
    head_rows = {m: _int8_unit_rows(_head_units(flag, m, gen, device), True, m, (m,), gen,
                                    device, f"flagship heads M={m}") for m in INT8_HEAD_M}
    del flag
    matched = _randomize_bn(GFV(sthsth_cfg(144), device="cpu", generator=cpu_gen,
                                param_dtype=torch.float32), cpu_gen).to(device)
    matched_rows = _int8_unit_rows(_backbone_units(matched.focuser, "resnet", 144, device),
                                   False, INT8_CHECK_N, INT8_TIME_N[-1:], gen, device,
                                   "matched focuser")
    del matched
    torch.cuda.empty_cache()
    conv = [r for r in flag_rows if r["kernel"] == "int8_conv"]
    dw = [r for r in flag_rows if r["kernel"] == "int8_dwconv"]
    n = INT8_TIME_N[0]
    conv_row = _int8_kernel_row(
        "int8_conv", conv, 74, f"flagship int8 units, 224^2 glancer and 96^2 focuser, "
        f"N={n} frames and {n} patches (by_n: also N={INT8_TIME_N[1]}), summed over one "
        f"forward's units")
    conv_row["matched"] = _int8_kernel_row(
        "int8_conv", matched_rows, 74, f"matched focuser int8 units at 144^2, "
        f"N={INT8_TIME_N[-1]} patches, summed over one forward's units")
    conv_row["heads"] = {m: _int8_kernel_row(
        "int8_conv", rows, 86, f"flagship heads at M={m}, summed over one int8+heads "
        f"forward's products") for m, rows in head_rows.items()}
    dw_row = _int8_kernel_row(
        "int8_dwconv", dw, 74, f"flagship glancer depthwise units at 224^2, N={n} frames "
        f"(by_n: also N={INT8_TIME_N[1]}), summed over one forward's units")
    for row in (conv_row, dw_row):
        print(f"{row['name']}: {row['shape']}: kernel {row['ms']!r} ms ({row['device_ms']!r} on "
              f"the device), plain {row['plain_ms']!r} ms, library {row['library_ms']!r} ms "
              f"({row['library_device_ms']!r} on the device), bound "
              f"{row['bound_ms']!r} ms ({row['bound_by']}); by N {row.get('by_n')}; "
              f"{row['double_rounded']} double-rounded outputs", flush=True)
    shapes = flag_rows + matched_rows + [r for rows in head_rows.values() for r in rows]
    return [conv_row, dw_row], shapes


@_seconds
@_autotuner(False)
def check_fused_backbones(device, card: str) -> dict:
    """Phase 12: each int8 backbone of the flagship (bf16, glancer on
    Q8_SMALL_B x 16 frames of 224^2, focuser on as many 96^2 patches; and
    the matched configuration's TSM backbones) fused against the unfused
    composition on the card: no ``quantize_act`` inside the fused one, every
    unit's input codes (``code_tap``) and the map and pooled features
    equal. Both run the same kernel epilogue, so equal is the bar."""
    import torch

    from adafocus_torch.benchmark import sthsth_cfg
    from adafocus_torch.models import quant_inference as qi
    from adafocus_torch.models.gfv import GFV, flagship

    out = {}
    for cfg_name, cfg in (("flagship", flagship()), ("matched", sthsth_cfg(144))):
        model = GFV(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
        gen = torch.Generator(device=device).manual_seed(SEED + 125)
        for kind, module, size, n_frames in (
                ("mbv2", model.glancer, cfg.glance_size, cfg.num_frames if cfg.tsm else 0),
                ("resnet", model.focuser, cfg.patch_size, cfg.t_focuser if cfg.tsm else 0)):
            t = n_frames or cfg.num_frames
            xs = [torch.randn((Q8_SMALL_B * t, size, size, 3), generator=gen, device=device)
                  .bfloat16() for _ in range(2)]
            scales = qi.calibrate_backbone(kind, module, xs, n_frames, torch.bfloat16)
            fused = qi._UnitRunner(scales, torch.bfloat16, {})
            fn = qi._mbv2_backbone if kind == "mbv2" else qi._resnet_backbone
            taps, calls = [], []
            real = qi.quantize_act
            qi.quantize_act = lambda *a: calls.append(1) or real(*a)
            try:
                with torch.inference_mode():
                    fmap, pooled = fn(module, xs[0], fused, n_frames)
                    n_calls = len(calls)
                    qi.code_tap = lambda name, q: taps.append((name, q))
                    fn(module, xs[0], fused, n_frames)
            finally:
                qi.quantize_act, qi.code_tap = real, None
            unfused = qi._UnfusedRunner(scales, torch.bfloat16, fused.qw)
            with torch.inference_mode():
                want_map, want_pooled = fn(module, xs[0], unfused, n_frames)
            torch.cuda.synchronize()
            names = [n for n, _ in taps]
            differ = sum(int((a != b).sum()) for (_, a), (_, b) in zip(taps, unfused.codes))
            total = sum(a.numel() for _, a in taps)
            row = {"units": len(taps), "codes": total, "codes_differing": differ,
                   "quantize_act_calls": n_calls, "map_equal": torch.equal(fmap, want_map),
                   "pooled_equal": torch.equal(pooled, want_pooled)}
            print(f"int8 fused {cfg_name} {kind} backbone (N={xs[0].shape[0]}): {row} ({card})",
                  flush=True)
            if (n_calls or names != [n for n, _ in unfused.codes] or len(taps) != len(scales)
                    or differ or not row["map_equal"] or not row["pooled_equal"]):
                raise AssertionError(f"int8 fused {cfg_name} {kind} backbone against the "
                                     f"unfused composition: {row}")
            out[f"{cfg_name} {kind}"] = row
        del model
        torch.cuda.empty_cache()
    return out


# the int8 forward against the port's bf16 and float32 forwards: the JAX
# package's own bars (tests/test_quant.py:124 and :200 for the ActivityNet
# and sth-sth families, :164 for AdaFocus+, whose untrained selector sits
# on near-ties; :338 int8 transport frames against float frames)
Q8_COS = {"flagship": 0.95, "matched": 0.95, "plus": 0.85}
Q8_TRANSPORT_COS = 0.99
Q8_SMALL_B = 2               # the checks' batch; calibration on two such batches
Q8_B = 64                    # the timed batch
Q8_LAUNCHES = {"extract_patches": 1, "int8_conv": 86, "int8_dwconv": 17,
               "fused_inverted_residual": 0, "fused_bottleneck": 0}
Q8_PHASES = ("glance", "policy", "extract", "focus", "classify")


def _q8_counts(reset: bool = False) -> dict:
    from adafocus_torch.ops.fused_blocks import fused_bottleneck, fused_inverted_residual
    from adafocus_torch.ops.patch import extract_patches
    from adafocus_torch.ops.quant import int8_conv, int8_dwconv

    fns = {"extract_patches": extract_patches, "int8_conv": int8_conv,
           "int8_dwconv": int8_dwconv, "fused_inverted_residual": fused_inverted_residual,
           "fused_bottleneck": fused_bottleneck}
    if reset:
        for fn in fns.values():
            fn.launches = 0
        int8_conv.finish_launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm() + 1e-12)).item()


def _q8_configs() -> dict:
    from adafocus_torch.benchmark import plus_cfg, sthsth_cfg
    from adafocus_torch.models.gfv import flagship

    return {"flagship": flagship(), "matched": sthsth_cfg(144), "plus": plus_cfg(PLUS_POINT)}


def _q8_inputs(cfg, b: int, seed: int, device):
    """Frames of ImageNet-normalized uniform pixels (the transport format's
    range), float32: (B, Tf, S, S, 3) and (B, T, g, g, 3)."""
    import torch

    from adafocus_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    gen = torch.Generator().manual_seed(seed)
    mean, std = torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD)
    s, g = cfg.image_size, cfg.glance_size
    frames = (torch.rand((b, cfg.t_focuser, s, s, 3), generator=gen) - mean) / std
    small = (torch.rand((b, cfg.num_frames, g, g, 3), generator=gen) - mean) / std
    return frames.to(device), small.to(device)


@contextlib.contextmanager
def _patch_actions(store: list):
    """Every extraction's actions into ``store`` (the bf16 and the int8
    forwards' own calls)."""
    from adafocus_torch.models import gfv, gfv_sthsth
    from adafocus_torch.models import quant_inference as qi

    real = gfv.extract_for_frames

    def spy(frames, actions, *a, **k):
        store.append(actions.detach().float().clone())
        return real(frames, actions, *a, **k)

    mods = (gfv, gfv_sthsth, qi)
    for m in mods:
        m.extract_for_frames = spy
    try:
        yield
    finally:
        for m in mods:
            m.extract_for_frames = real


@_seconds
@_autotuner(False)
def q8_forward_checks(device, card: str) -> dict:
    """Phase 12 at B=2, each family (the flagship, the matched sth-sth
    configuration, AdaFocus+ at plus_cfg((96, 8))) in modes int8 and
    int8+heads: calibrated on two seeded batches (the family's deployment
    phases in bf16, ``calibration_batch``), weights prepared, the int8
    forward on int8 transport frames against the port's bf16 and float32
    forwards on the same weights and float frames (cosine bars
    ``Q8_COS``), the share of patch offsets the int8 and bf16 forwards
    agree on, and each forward's launches (exactly ``Q8_LAUNCHES`` at the
    flagship in int8); the flagship's int8 transport frames against float
    frames through the same int8+heads forward (``Q8_TRANSPORT_COS``).
    Returns the results and the bf16 models, kept for the timing."""
    import torch

    from adafocus_torch.benchmark import inference_fn
    from adafocus_torch.models import quant_inference as qi
    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.ops.quant import quantize_frames

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out, models = {}, {}
    for fam, cfg16 in _q8_configs().items():
        cfg32 = dataclasses.replace(cfg16, dtype=torch.float32)
        m16 = GFV(cfg16, device=device, generator=torch.Generator().manual_seed(SEED))
        m32 = GFV(cfg32, device=device, generator=torch.Generator().manual_seed(SEED))
        frames, small = _q8_inputs(cfg16, Q8_SMALL_B, SEED + 120, device)
        f16, s16 = frames.bfloat16(), small.bfloat16()
        batches = [qi.calibration_batch(m16, *(t.bfloat16() for t in _q8_inputs(
            cfg16, Q8_SMALL_B, SEED + 121 + i, device))) for i in range(2)]
        ref_actions = []
        with _patch_actions(ref_actions):
            ref16 = inference_fn(m16)(f16, s16)
        ref32 = inference_fn(m32)(frames, small)
        span = cfg16.image_size - cfg16.patch_size
        out[fam] = {}
        for heads in (False, True):
            mode = "int8+heads" if heads else "int8"
            t0 = time.perf_counter()
            scales = qi.calibrate_gfv(m16, batches, heads=heads)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            qw = qi.prepare_q8(m16, scales)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            acts = []
            fq, sq = quantize_frames(f16), quantize_frames(s16)
            _q8_counts(reset=True)
            with _patch_actions(acts):
                logits = qi.family_q8(cfg16)(m16, scales, fq, sq, device=device, qw=qw)
            torch.cuda.synchronize()
            launches = _q8_counts()
            if not torch.isfinite(logits.float()).all() or logits.shape != ref16.shape:
                raise AssertionError(f"{fam} {mode}: logits {tuple(logits.shape)} not finite "
                                     f"or not {tuple(ref16.shape)}")
            cos16, cos32 = _cosine(logits, ref16), _cosine(logits, ref32)
            agree = (torch.floor(acts[0] * span) == torch.floor(ref_actions[0] * span)
                     ).all(-1).float().mean().item()
            row = {"cos_vs_bf16": cos16, "cos_vs_float32": cos32, "action_agreement": agree,
                   "launches": launches, "calibrate_s": t1 - t0, "prepare_s": t2 - t1}
            print(f"int8 {fam} B={Q8_SMALL_B} {mode}: logits cosine vs bf16 {cos16!r}, vs "
                  f"float32 {cos32!r} (bar {Q8_COS[fam]}); patch offsets agreeing with bf16's "
                  f"{agree!r}; launches {launches}; calibrate {row['calibrate_s']!r} s, "
                  f"prepare_q8 {row['prepare_s']!r} s ({card})", flush=True)
            if not min(cos16, cos32) > Q8_COS[fam]:
                raise AssertionError(f"int8 {fam} {mode}: cosine {cos16}, {cos32} <= "
                                     f"{Q8_COS[fam]}")
            # every family runs the same backbones: 86 + 17 int8 launches a
            # forward in int8, the heads' on top in int8+heads
            want = dict(Q8_LAUNCHES, int8_conv=launches["int8_conv"] if heads else 86)
            if launches != want or (heads and launches["int8_conv"] <= 86):
                raise AssertionError(f"int8 {fam} {mode}: launches {launches}, want {want}")
            if heads and fam == "flagship":
                row["head_launches"] = launches["int8_conv"] - Q8_LAUNCHES["int8_conv"]
                print(f"int8 flagship int8+heads: {row['head_launches']} int8_conv launches of "
                      f"the heads a forward", flush=True)
                float_frames = qi.inference_q8(m16, scales, f16, s16, device=device, qw=qw)
                row["transport_cos"] = _cosine(logits, float_frames)
                print(f"int8 flagship int8+heads: int8 transport frames vs float frames, "
                      f"cosine {row['transport_cos']!r} (bar {Q8_TRANSPORT_COS})", flush=True)
                if not row["transport_cos"] > Q8_TRANSPORT_COS:
                    raise AssertionError(f"int8 transport: cosine {row['transport_cos']}")
            out[fam][mode] = row
        del m32
        models[fam] = m16
        torch.cuda.empty_cache()
    return out, models


@_seconds
def q8_throughput(models: dict, device, card: str) -> tuple:
    """Phase 12's timing at B=Q8_B: videos/s of 3 runs of 10 forwards in
    int8 beside bf16 in the same call, each family (the flagship also in
    int8+heads), the int8 flagship's phase split by CUDA events, its
    batch-1 latency in int8 and bf16, peak memory of each int8 run.
    Returns (the results, the flagship's scales of the phase split, which
    phase 13 exports with)."""
    import torch

    from adafocus_torch.benchmark import inference_rates
    from adafocus_torch.models import quant_inference as qi
    from adafocus_torch.models.gfv import extract_for_frames, fuse_and_classify
    from adafocus_torch.ops.quant import quantize_frames

    torch.backends.cudnn.benchmark = True
    out = {}
    for fam, model in models.items():
        modes = ("bf16", "int8", "int8+heads") if fam == "flagship" else ("bf16", "int8")
        out[fam] = {}
        for mode in modes:
            torch.cuda.reset_peak_memory_stats()
            rates = inference_rates(model, Q8_B, 10, 3, SEED, mode=mode)
            out[fam][mode] = {"videos_per_s": rates,
                              "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"int8 {fam} B={Q8_B}: videos/s " + "; ".join(
            f"{m} {v['videos_per_s']!r} (peak {v['peak_bytes'] / 2**30:.2f} GiB)"
            for m, v in out[fam].items()) + f" ({card})", flush=True)
    flag = models["flagship"]
    cfg = flag.cfg
    out["flagship"]["batch1_latency_ms"] = {
        mode: [1e3 / r for r in inference_rates(flag, 1, 10, 3, SEED, mode=mode)]
        for mode in ("bf16", "int8")}
    print(f"int8 flagship batch-1 latency ms: {json.dumps(out['flagship']['batch1_latency_ms'])}"
          f" ({card})", flush=True)
    frames, small = (t.bfloat16() for t in _q8_inputs(cfg, Q8_B, SEED + 130, device))
    scales = qi.calibrate_gfv(flag, [qi.calibration_batch(flag, frames[:2], small[:2])])
    qw = qi.prepare_q8(flag, scales)
    fq, sq = quantize_frames(frames), quantize_frames(small)
    del frames, small
    b, t = sq.shape[:2]
    phases = dict.fromkeys(Q8_PHASES, 0.0)
    n_timed = 5
    with torch.inference_mode():
        for i in range(n_timed + 1):   # the first forward is warm-up
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            fmap, pooled = qi.q8_glance(flag, scales, qi._dequant_frames(sq, cfg.dtype), qw)
            ev[1].record()
            roll = flag.policy_rollout(fmap)
            ev[2].record()
            patches = extract_for_frames(fq, roll["actions"], cfg.image_size, cfg.patch_size)
            ev[3].record()
            local = qi.q8_focus(flag, scales, qi._dequant_frames(patches, cfg.dtype), qw)
            ev[4].record()
            fuse_and_classify(flag, pooled, local.reshape(b, t, -1))
            ev[5].record()
            torch.cuda.synchronize()
            if i:
                for k, name in enumerate(Q8_PHASES):
                    phases[name] += ev[k].elapsed_time(ev[k + 1]) / n_timed
    out["flagship"]["int8_phase_ms"] = phases
    print(f"int8 flagship B={Q8_B} phase ms {json.dumps(phases)} ({card})", flush=True)
    return out, scales


@_seconds
def q8_cli(device, card: str) -> dict:
    """The evaluate CLI with ``run.quantize=int8`` (and with
    ``run.quantize_heads=true``) on phase 9's synthetic clips from the
    device cache, a fresh model of ``configs/actnet_default.yaml``: it
    calibrates on the val batches, prepares the int8 weights (one batch-1
    forward) and evaluates; exactly one patch launch a calibration batch,
    one for the preparation and one an eval batch; the int8 kernels launched
    by every int8 forward; no frame byte from the host after the fill."""
    import tempfile

    import torch

    from adafocus_torch.cli import evaluate as cli_evaluate

    n_val = -(-CLI_VIDEOS // CLI_B)
    preps, out = [], {}
    real_prep = cli_evaluate.make_batch_prep

    def prep_spy(*a, **k):
        preps.append(real_prep(*a, **k))
        return preps[-1]

    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    cli_evaluate.make_batch_prep = prep_spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for mode, extra in (("int8", ()), ("int8+heads", ("run.quantize_heads=true",))):
                args = _cli_args(tmp, "run.quantize=int8", f"run.ckpt_dir={tmp}/{mode}", *extra)
                _q8_counts(reset=True)
                t0 = time.perf_counter()
                res = _run_cli(cli_evaluate.main, args, os.path.join(tmp, "cli.log"))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = _q8_counts()
                host = preps[-1].host_frame_bytes
                forwards = n_val + 1
                if launches["extract_patches"] != 2 * n_val + 1 or host \
                        or launches["int8_dwconv"] != 17 * forwards \
                        or launches["int8_conv"] < 86 * forwards \
                        or not all(math.isfinite(v) for v in res.values()):
                    raise AssertionError(f"CLI int8 evaluate {mode}: {res}, launches {launches}, "
                                         f"{host} host frame bytes")
                out[mode] = {"results": res, "launches": launches, "seconds": seconds,
                             "host_frame_bytes": host}
                print(f"CLI evaluate run.quantize=int8 ({mode}) B={CLI_B}, {CLI_VIDEOS} clips: "
                      f"{json.dumps(res)}; launches {launches}; {seconds!r} s with the cache fill, "
                      f"calibration and prepare; 0 host frame bytes ({card})", flush=True)
    finally:
        cli_evaluate.make_batch_prep = real_prep
        torch.backends.cudnn.benchmark = autotune
    return out


@_seconds
def q8_phase(device, card: str, kernel_rows: tuple) -> dict:
    """Phase 12 as a whole: the int8 kernels against their plain versions and
    timed (``kernel_rows``: ``check_int8_kernels``' result, run early in the
    run), the int8 forwards' checks and launches, the timing, the CLI."""
    import torch

    start = time.perf_counter()
    rows, shapes = kernel_rows
    fused = check_fused_backbones(device, card)
    checks, models = q8_forward_checks(device, card)
    timing, scales = q8_throughput(models, device, card)
    del models
    torch.cuda.empty_cache()
    cli = q8_cli(device, card)
    for row in rows:
        row["launches"] = checks["flagship"]["int8"]["launches"][row["name"]]
    return {"kernel_rows": rows, "shapes": shapes, "fused_backbones": fused, "checks": checks,
            "timing": timing, "cli": cli, "flagship_scales": scales,
            "seconds": time.perf_counter() - start}


# ---------------------------------------------------------------------------
# phase 13, export (adafocus_torch.serving, this slice's main path): the serving
# forward of each family in bf16 and the flagship's in int8, exported with
# torch.export at B=64, saved, and reloaded in a fresh process that imports
# adafocus_torch.serving (and the ops modules its loader imports), nothing of
# the model code and no JAX. The reloaded program launches the hand-written
# kernels through their custom ops: exactly EXPORT_LAUNCHES a forward. Its
# logits against the eager forward's on the same inputs: the same ATen ops
# run, so equal is the prediction and EXPORT_REL_TOL the limit.
# ---------------------------------------------------------------------------

EXPORT_B = 64                # the serving batch of phases 5, 8, 11 and 12
EXPORT_REL_TOL = 1e-2        # reloaded vs eager logits, max|d| / max|eager|
EXPORT_RUNS = (3, 10)        # timed runs of forwards each, as benchmark.time_inference
_NO_FUSED = {"fused_inverted_residual": 0, "fused_bottleneck": 0}
EXPORT_LAUNCHES = {"bf16": {"extract_patches": 1, "int8_conv": 0, "int8_dwconv": 0, **_NO_FUSED},
                   "int8": {"extract_patches": 1, "int8_conv": 86, "int8_dwconv": 17,
                            **_NO_FUSED}}
EXPORT_FORBIDDEN = ("adafocus_torch.models", "jax", "jaxlib", "flax", "adafocus_tpu")
# the fresh process: load each artifact through adafocus_torch.serving alone,
# in serve_reloaded (this file imports only the standard library at its top);
# it takes its work on its standard input, line by line
_RELOAD = (
    "import sys, time\n"
    "t0 = time.perf_counter()\n"
    "import torch\n"
    "from adafocus_torch.serving import load_exported\n"
    "import chip_smoke\n"
    "chip_smoke.serve_reloaded(load_exported, time.perf_counter() - t0, sys.stdin, sys.stdout)\n"
)


def _export_backends() -> None:
    """The library settings of both processes of phase 13: cuDNN's
    autotuner off (the CLI's setting: it may pick another algorithm in each
    process, and a bf16 rounding that moves a greedy argmax moves a patch)
    and TF32 off, so that the eager and the reloaded forward run the same
    kernels."""
    import torch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _videos_per_s(fn, frames, small) -> list:
    """Videos/s of ``EXPORT_RUNS`` runs of forwards after ``WARMUP`` ones,
    each run between two CUDA events (``benchmark.time_inference``'s
    method; the host clock on the CPU)."""
    import torch

    warmup = 3   # adafocus_torch.benchmark.WARMUP
    repeats, iters = EXPORT_RUNS
    for _ in range(warmup):
        fn(frames, small)
    rates = []
    for _ in range(repeats):
        if frames.is_cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn(frames, small)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(frames, small)
            seconds = time.perf_counter() - t0
        rates.append(frames.shape[0] * iters / seconds)
    return rates


def serve_reloaded(load, start_s: float, commands, out) -> None:
    """The fresh process's half of phase 13. Each line of ``commands`` before
    ``serve`` is a JSON [artifact, inputs, logits] triple of paths: the
    artifact loaded (``load``, timed), its inputs read onto their device,
    every state tensor of the reloaded module on that device; a line
    ``{"loaded": i, "load_s": s}`` on ``out`` answers it. At ``serve``, for
    each artifact in turn: one forward with the launch counts set to 0 just
    before (its logits saved), the reloaded module's videos/s. Then: no model
    code and no JAX imported; the answer is ``{"start_s": s, "rows": [...]}``
    on ``out``."""
    import torch

    _export_backends()
    loaded = []
    for line in commands:
        if line.strip() == "serve":
            break
        artifact, inputs_path, out_path = json.loads(line)
        t0 = time.perf_counter()
        fn = load(artifact)
        load_s = time.perf_counter() - t0
        inputs = torch.load(inputs_path)
        frames, small = inputs["frames"], inputs["frames_small"]
        state = dict(fn.state_dict())
        state.update((k, v) for k, v in vars(fn).items() if isinstance(v, torch.Tensor))
        off = sorted(k for k, v in state.items() if v.device != frames.device)
        if off:
            raise AssertionError(f"{artifact}: {len(off)} state tensors of the reloaded module "
                                 f"are not on {frames.device}: {off[:5]}")
        loaded.append((fn, frames, small, out_path, {"artifact": artifact, "load_s": load_s,
                                                     "state_tensors": len(state)}))
        print(json.dumps({"loaded": len(loaded) - 1, "load_s": load_s}), file=out, flush=True)
    rows = []
    for fn, frames, small, out_path, row in loaded:
        _q8_counts(reset=True)
        logits = fn(frames, small)
        if frames.is_cuda:
            torch.cuda.synchronize()
        row["launches"] = _q8_counts()
        torch.save(logits.cpu(), out_path)
        row["videos_per_s"] = _videos_per_s(fn, frames, small)
        rows.append(row)
    bad = sorted(m for m in sys.modules
                 if any(m == f or m.startswith(f + ".") for f in EXPORT_FORBIDDEN))
    if bad:
        raise AssertionError(f"loading the artifacts imported {bad}")
    print(json.dumps({"start_s": start_s, "rows": rows}), file=out, flush=True)


def _export_cases(q8_scales) -> list:
    """(name, config, mode, scales): the flagship, the matched sth-sth
    configuration and AdaFocus+ at plus_cfg((96, 8)) in bf16, the flagship
    in int8 with phase 12's scales."""
    from adafocus_torch.benchmark import plus_cfg, sthsth_cfg
    from adafocus_torch.models.gfv import flagship

    return [("flagship", flagship(), "bf16", None), ("matched", sthsth_cfg(144), "bf16", None),
            ("plus", plus_cfg(PLUS_POINT), "bf16", None),
            ("flagship", flagship(), "int8", q8_scales)]


# the cases each exporting process of phase 13 exports, by _export_cases'
# index: export_run's own, and its helper's (export_helper), at once
EXPORT_SPLIT = ((0, 2), (1, 3))
# the helper exporting process: export_helper on the card, the scales loaded
_EXPORT_HELPER = (
    "import sys, torch\n"
    "import chip_smoke\n"
    "chip_smoke.export_helper(torch.device(sys.argv[1]), torch.load(sys.argv[2]), sys.argv[3],\n"
    "                         [int(i) for i in sys.argv[4:]])\n"
)
# the exporting process of phase 13: export_run on the card, given the
# scales' file (it starts its helpers before it imports torch)
_EXPORT = (
    "import json, sys\n"
    "import chip_smoke\n"
    "out = chip_smoke.export_run(sys.argv[1], sys.argv[2], sys.argv[3], gate=sys.stdin.readline)\n"
    "print(json.dumps(out))\n"
)


@_seconds
def export_phase(device, card: str, q8_scales, beside=lambda: None) -> tuple:
    """Phase 13 as a whole, in a fresh process of its own (``export_run``):
    in this one, cuDNN's autotuner picked algorithms for the same shapes in
    earlier phases, and a library keeps those picks, so this process's eager
    forward would run other kernels than the reloaded one's. ``beside()``,
    untimed work, runs here while that process exports; it times nothing
    until ``beside`` has returned and this process tells it to go on.
    Returns (the phase's result, ``beside()``'s)."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp, open(os.path.join(tmp, "err"), "w+") as err:
        path = os.path.join(tmp, "scales.pt")
        torch.save(q8_scales, path)
        proc = subprocess.Popen([sys.executable, "-c", _EXPORT, str(device), card, path],
                                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=err, text=True)
        try:
            result = beside()
            try:
                proc.stdin.write("go\n")
                proc.stdin.flush()
            except OSError:   # it died: its error is below
                pass
            out, _ = proc.communicate(timeout=1000)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        errors = err.read()
    lines = out.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"export: the exporting process failed (rc {proc.returncode}):\n"
                             f"{errors[-4000:]}")
    return json.loads(lines[-1]), result


def _export_case(i: int, case: tuple, device, tmp: str) -> tuple:
    """Case ``i`` of ``_export_cases``: the seeded model exported at
    B=EXPORT_B (export s), saved (save s, MB) into ``tmp`` beside its inputs,
    its eager logits saved there too. Returns (its key, its row, the paths
    [artifact, inputs, reloaded logits], (the eager forward, frames,
    small))."""
    import torch

    from adafocus_torch.benchmark import inference_fn, make_data
    from adafocus_torch.models.gfv import GFV
    from adafocus_torch.models.quant_inference import family_q8, prepare_q8
    from adafocus_torch.serving import export_inference, save_exported

    name, cfg, mode, scales = case
    model = GFV(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    data = make_data(cfg, EXPORT_B, device=device, seed=SEED + 140)
    frames, small = data["frames"], data["frames_small"]
    t0 = time.perf_counter()
    ep = export_inference(model, EXPORT_B, mode=mode, scales=scales)
    t1 = time.perf_counter()
    path = os.path.join(tmp, f"{i}.pt2")
    save_exported(ep, path)
    t2 = time.perf_counter()
    del ep
    torch.save(data, os.path.join(tmp, f"{i}_in.pt"))
    if mode == "int8":
        qw = prepare_q8(model, scales)
        forward = family_q8(cfg)

        def eager(f, s):
            return forward(model, scales, f, s, device=device, qw=qw)
    else:
        eager = inference_fn(model)
    torch.save(eager(frames, small).float().cpu(), os.path.join(tmp, f"{i}_want.pt"))
    row = {"export_s": t1 - t0, "save_s": t2 - t1, "mb": os.path.getsize(path) / 1e6}
    paths = [path, os.path.join(tmp, f"{i}_in.pt"), os.path.join(tmp, f"{i}_out.pt")]
    return f"{name} {mode}", row, paths, (eager, frames, small)


def export_helper(device, q8_scales, tmp: str, indices: list) -> None:
    """Phase 13's helper exporting process: the cases ``indices`` of
    ``_export_cases`` exported (``_export_case``) beside ``export_run``'s
    own, a line ``{"key", "row", "paths"}`` on the standard output as each is
    saved; then, at a ``go`` line on the standard input, each one's eager
    videos/s, in a last line ``{"eager": {key: videos/s}}``."""
    _export_backends()
    cases, runs = _export_cases(q8_scales), {}
    for i in indices:
        key, row, paths, runs[key] = _export_case(i, cases[i], device, tmp)
        print(json.dumps({"key": key, "row": row, "paths": paths}), flush=True)
    sys.stdin.readline()
    print(json.dumps({"eager": {k: _videos_per_s(*run) for k, run in runs.items()}}),
          flush=True)


def export_run(device: str, card: str, scales_path: str, gate=lambda: None) -> dict:
    """Phase 13's exporting process (``device`` a name, phase 12's scales
    in the file ``scales_path``). One fresh process that reloads and serves
    every artifact (``serve_reloaded``) starts first of all, before this
    process imports torch, so that its start-up and loads run beside the
    exports, and a helper exporting process (``export_helper``) with it:
    each exports its share of
    ``_export_cases`` (``EXPORT_SPLIT``, ``_export_case``: export s, save
    s, MB, the eager logits), and each artifact goes to the serving process
    to load as soon as it is saved. When that process has loaded all four
    and ``gate()`` has returned (the parent's untimed work beside this phase
    is done), each case's eager videos/s is timed, this process's cases
    first, then the helper's, then the serving process's forwards and
    videos/s: each timing with the card otherwise idle. Each artifact's
    logits are held against the eager ones."""
    import tempfile
    import threading

    start = time.perf_counter()
    rows, paths, runs, helped = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp, open(os.path.join(tmp, "err"), "w+") as err, \
            open(os.path.join(tmp, "helper_err"), "w+") as helper_err:
        t_proc = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", _RELOAD], cwd=ROOT, text=True,
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err)
        helper = subprocess.Popen(
            [sys.executable, "-c", _EXPORT_HELPER, device, scales_path, tmp,
             *map(str, EXPORT_SPLIT[1])], cwd=ROOT, text=True, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=helper_err)
        import torch

        device = torch.device(device)
        _export_backends()
        cases = _export_cases(torch.load(scales_path))
        lock = threading.Lock()   # both hand artifacts to the serving process

        def hand_over(artifact_paths):
            with lock:
                proc.stdin.write(json.dumps(artifact_paths) + "\n")
                proc.stdin.flush()

        def relay():   # the helper's artifacts, as it saves them
            for _ in EXPORT_SPLIT[1]:
                line = helper.stdout.readline()
                if not line:
                    return
                done = json.loads(line)
                rows[done["key"]], paths[done["key"]] = done["row"], done["paths"]
                helped[done["key"]] = True
                hand_over(done["paths"])

        relay_thread = threading.Thread(target=relay)
        relay_thread.start()
        try:
            for i in EXPORT_SPLIT[0]:
                key, rows[key], paths[key], runs[key] = _export_case(i, cases[i], device, tmp)
                hand_over(paths[key])
            relay_thread.join(timeout=900)
            if len(helped) != len(EXPORT_SPLIT[1]):
                raise ValueError("the helper exporting process exported "
                                 f"{sorted(helped)} of cases {EXPORT_SPLIT[1]}")
            for _ in cases:   # the serving process has loaded every artifact
                json.loads(proc.stdout.readline())
            gate()
            for key, run in runs.items():
                rows[key]["eager_videos_per_s"] = _videos_per_s(*run)
            del runs, run
            torch.cuda.empty_cache()
            helper.stdin.write("go\n")
            helper.stdin.flush()
            for key, rates in json.loads(helper.stdout.readline())["eager"].items():
                rows[key]["eager_videos_per_s"] = rates
            helper.wait(timeout=900)
            proc.stdin.write("serve\n")
            proc.stdin.close()
            served = json.loads(proc.stdout.readline())
            proc.wait(timeout=900)
        except (OSError, ValueError, subprocess.TimeoutExpired) as e:
            # a process died or hung: a broken pipe, no answer
            for p in (proc, helper):
                if p.poll() is None:
                    p.kill()
                p.wait()
            relay_thread.join()
            err.seek(0)
            helper_err.seek(0)
            raise AssertionError(f"export: a process failed (serving rc {proc.returncode}, "
                                 f"helper rc {helper.returncode}): {e}\n{err.read()[-3000:]}"
                                 f"\n{helper_err.read()[-3000:]}") from e
        process_s = time.perf_counter() - t_proc
        if proc.returncode != 0 or helper.returncode != 0:
            err.seek(0)
            helper_err.seek(0)
            raise AssertionError(f"export: a process failed (serving rc {proc.returncode}, "
                                 f"helper rc {helper.returncode}):\n{err.read()[-3000:]}\n"
                                 f"{helper_err.read()[-3000:]}")
        print(f"export: one fresh process served {len(cases)} artifacts in {process_s!r} s "
              f"(start-up and imports {served['start_s']!r} s; started with the phase, its "
              f"loads beside two exporting processes) ({card})", flush=True)
        served_rows = {r.pop("artifact"): r for r in served["rows"]}
        out = {}
        for name, _, mode, _ in cases:   # the cases' order
            key = f"{name} {mode}"
            row = out[key] = rows[key]
            artifact, _, out_path = paths[key]
            want = torch.load(artifact[:-len(".pt2")] + "_want.pt")
            got = torch.load(out_path).float()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"export {key}: logits {tuple(got.shape)} not finite or "
                                     f"not {tuple(want.shape)}")
            rel = ((got - want).abs().max() / want.abs().max()).item()
            row.update(served_rows[artifact], rel_err=rel)
            print(f"export {key} B={EXPORT_B}: export {row['export_s']!r} s, save "
                  f"{row['save_s']!r} s (both beside the other exporting process and phases 14 "
                  f"(b), (c) and 15 (a): not comparable with a serial export's), {row['mb']!r} MB "
                  f"({row['state_tensors']} state "
                  f"tensors on the card); fresh-process load {row['load_s']!r} s; launches "
                  f"{row['launches']}; reloaded vs eager logits max|d|/max|eager| {rel!r} "
                  f"(limit {EXPORT_REL_TOL}); videos/s reloaded {row['videos_per_s']!r}, eager "
                  f"{row['eager_videos_per_s']!r} ({card})", flush=True)
            if row["launches"] != EXPORT_LAUNCHES[mode]:
                raise AssertionError(f"export {key}: launches {row['launches']}, want "
                                     f"{EXPORT_LAUNCHES[mode]}")
            if not rel <= EXPORT_REL_TOL:
                raise AssertionError(f"export {key}: reloaded vs eager {rel} > {EXPORT_REL_TOL}")
    return {"artifacts": out, "process": {"seconds": process_s, "start_s": served["start_s"]},
            "seconds": time.perf_counter() - start}


# phase 14, data parallelism (adafocus_torch.parallel). A one-rank group's
# averages are identities, so its steps equal the plain ones bit for bit
# (cuDNN's deterministic algorithms on both). Two ranks on the one card
# share it over gloo, whose collectives take CUDA tensors; their float32
# results are held to phases 6's and 7's limits against one process.
DP_B = 64                    # phase 6's batch, one rank
DP_SHARED_B = 8              # a rank's batch when two ranks share the card
DP_TIMED = 3                 # timed steps with and without the group
DP_ALLREDUCE_REPS = 5
DP_TIMEOUT = 300             # seconds for each process of (b) and (c)
_DP_RANK = (
    "import sys; sys.path.insert(0, {root!r}); import chip_smoke as cs; "
    "cs.dp_shared_rank(int(sys.argv[1]), sys.argv[2])"
)


def _dp_deterministic(on: bool) -> None:
    import torch

    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def _mean_step_ms(step, args, n: int) -> float:
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    ev[0].record()
    for k in range(n):
        step(*args)
        ev[k + 1].record()
    torch.cuda.synchronize()
    return sum(ev[k].elapsed_time(ev[k + 1]) for k in range(n)) / n


def _dp_state_like(model, stage: int):
    """A train state of ``stage`` over a copy of ``model``'s weights: what
    ``create_train_state`` gives from the same seed, without another build
    of the model on the host."""
    from adafocus_torch.ppo.core import PPOConfig, ppo_init
    from adafocus_torch.train.optim import OptimConfig, freeze_for_stage, make_stage_optimizer
    from adafocus_torch.train.stages import TrainState

    model = copy.deepcopy(model)
    if stage == 2:
        freeze_for_stage(model, 2)
        return TrainState(model, None, None, ppo_init(model.policy, PPOConfig()))
    return TrainState(model, *make_stage_optimizer(model, stage, OptimConfig()))


def _dp_step(state, stage: int, replicas):
    from adafocus_torch.train.stages import make_stage2_step, make_stage_train_step

    if stage == 2:
        return make_stage2_step(state.model, state.ppo, replicas)
    return make_stage_train_step(state.model, stage, state.optimizer, state.scheduler, replicas)


def _dp_states(cfg, stage: int, device, replicas):
    """The plain and the group step of ``stage`` on two models of the same
    weights: ((state, step), (state, step))."""
    import torch

    from adafocus_torch.train.stages import create_train_state

    plain = create_train_state(cfg, stage, device=device,
                               generator=torch.Generator().manual_seed(SEED))
    group = _dp_state_like(plain.model, stage)
    return (plain, _dp_step(plain, stage, None)), (group, _dp_step(group, stage, replicas))


@_seconds
def dp_one_rank(device, card: str, tmp: str) -> dict:
    """Phase 14 (a): the one-rank NCCL group at the flagship's width."""
    import torch

    from adafocus_torch.models.gfv import flagship
    from adafocus_torch.ops.patch import random_patch_actions
    from adafocus_torch.parallel import mesh

    cfg = flagship()
    replicas = mesh.init_replicas(f"file://{tmp}/one_rank", 1, 0, "cuda",
                                  local_rank=device.index or 0)
    out = {"launches": {}}
    try:
        for stage in (1, 2):
            (plain_state, plain), (dp_state, dp) = _dp_states(cfg, stage, device, replicas)
            gen = torch.Generator(device=device).manual_seed(SEED + 140 + stage)
            batch = _train_batch(cfg, DP_B, device, SEED + 142 + stage, torch.bfloat16)
            t = cfg.num_frames
            if stage == 1:
                draws = (random_patch_actions((DP_B, t), gen, device),)
            else:
                draws = (torch.randint(0, cfg.action_dim, (t, DP_B), generator=gen,
                                       device=device),
                         random_patch_actions((DP_B, t), gen, device))
            _dp_deterministic(True)
            metrics = [{k: float(v) for k, v in plain(batch, None, *draws).items()}]
            torch.cuda.synchronize()
            _q8_counts(reset=True)
            metrics.append({k: float(v) for k, v in dp(batch, None, *draws).items()})
            torch.cuda.synchronize()
            one_step = _q8_counts()
            _dp_deterministic(False)
            want = 1 if stage == 1 else 2
            if one_step["extract_patches"] != want:
                raise AssertionError(f"data-parallel stage {stage}: "
                                     f"{one_step['extract_patches']} patch launches, want {want}")
            a, b = plain_state.model.state_dict(), dp_state.model.state_dict()
            differ = [k for k in a if not torch.equal(a[k], b[k])]
            if differ or metrics[0] != metrics[1]:
                raise AssertionError(f"data-parallel stage {stage} over one rank differs from "
                                     f"the plain step: tensors {differ[:5]}, metrics {metrics}")
            if stage == 2 and not abs(metrics[1]["ppo/ratio_mean"] - 1.0) <= RATIO_TOL:
                raise AssertionError(f"data-parallel stage 2 ratio_mean {metrics[1]}")
            opt = dp_state.optimizer if stage == 1 else dp_state.ppo.optimizer
            params = [p for g in opt.param_groups for p in g["params"]]
            n_values = sum(p.numel() for p in params)
            allreduce_ms = _mean_step_ms(lambda: mesh.average_grads_(opt, replicas), (),
                                         DP_ALLREDUCE_REPS)
            # timed in turns (plain, group, group, plain) after a warm-up
            # step of each; the group's launches counted over all its steps
            plain(batch, gen)
            _q8_counts(reset=True)
            dp(batch, gen)
            torch.cuda.synchronize()
            launches = {k: one_step[k] + v for k, v in _q8_counts().items()}
            n_steps = 2
            runs = {"plain": [], "group": []}
            for name in ("plain", "group", "group", "plain"):
                _q8_counts(reset=True)
                runs[name].append(_mean_step_ms(plain if name == "plain" else dp, (batch, gen),
                                                DP_TIMED))
                if name == "group":
                    n_steps += DP_TIMED
                    launches = {k: launches[k] + v for k, v in _q8_counts().items()}
            ms = {k: sum(v) / len(v) for k, v in runs.items()}
            if launches["extract_patches"] != want * n_steps:
                raise AssertionError(f"data-parallel stage {stage}: {launches} in "
                                     f"{n_steps} steps")
            out["launches"][stage] = launches
            out[stage] = {"metrics": metrics[1], "step_ms": ms, "allreduce_ms": allreduce_ms,
                          "allreduce_bytes": 4 * n_values, "trained_values": n_values}
            print(f"data-parallel stage {stage}, one-rank NCCL group, flagship bf16 B={DP_B}: "
                  f"parameters, running statistics and metrics bit-identical to the plain "
                  f"step; patch launches {launches['extract_patches']} in {n_steps} "
                  f"steps; step ms plain {ms['plain']!r}, group {ms['group']!r} (mean of "
                  f"{2 * DP_TIMED} each, timed in turns); gradient all-reduce "
                  f"{allreduce_ms!r} ms for {n_values} float32 values ({4 * n_values} B, the "
                  f"optimizer's parameters); metrics "
                  f"{json.dumps(metrics[1])} ({card})", flush=True)
            del plain_state, dp_state, plain, dp, batch
            torch.cuda.empty_cache()
    finally:
        mesh.shutdown(replicas)
    return out


def _dp_shared_inputs(cfg, device):
    """The global B=2*DP_SHARED_B batch and each step's draws of (b), the
    same in every process: {stage: (batch, [draws of step 0, of step 1])}."""
    import torch

    from adafocus_torch.ops.patch import random_patch_actions

    b, t = 2 * DP_SHARED_B, cfg.num_frames
    gen = torch.Generator(device=device).manual_seed(SEED + 150)
    out = {}
    for stage in (1, 2):
        batch = _train_batch(cfg, b, device, SEED + 150 + stage, torch.float32)
        draws = []
        for _ in range(2):
            if stage == 1:
                draws.append((random_patch_actions((b, t), gen, device),))
            else:
                draws.append((torch.randint(0, cfg.action_dim, (t, b), generator=gen,
                                            device=device),
                              random_patch_actions((b, t), gen, device)))
        out[stage] = (batch, draws)
    return out


def _dp_shard_draws(draws, rank: int):
    """A rank's rows of the draws: actions (B, T, 2) by rows, behavior
    indices (T, B) by columns."""
    n = DP_SHARED_B
    if len(draws) == 1:
        return (draws[0][rank * n:(rank + 1) * n],)
    return (draws[0][:, rank * n:(rank + 1) * n], draws[1][rank * n:(rank + 1) * n])


def _dp_cfg32():
    from adafocus_torch.models.gfv import flagship
    import torch

    return dataclasses.replace(flagship(), dtype=torch.float32)


def dp_shared_rank(rank: int, tmp: str) -> None:
    """Phase 14 (b), one of the two ranks sharing the card (a process of its
    own). Raises if the replicas' weights differ after a step or the patch
    kernel differs from the plain version on its shard; rank 0 writes the
    averaged gradients and metrics of each stage's first step."""
    import torch

    from adafocus_torch.models.gfv import extract_for_frames
    from adafocus_torch.ops.patch import extract_patches
    from adafocus_torch.parallel import mesh
    from adafocus_torch.train.stages import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _dp_deterministic(True)
    device = torch.device("cuda", 0)
    replicas = mesh.init_replicas(f"file://{tmp}/shared", 2, rank, "cuda", local_rank=0,
                                  backend="gloo")
    cfg = _dp_cfg32()
    out = {}
    try:
        # each rank starts from weights of its own seed; replicate gives
        # every rank rank 0's
        base = create_train_state(cfg, 1, device=device,
                                  generator=torch.Generator().manual_seed(SEED + rank))
        mesh.replicate(base, replicas)
        states = {1: base, 2: _dp_state_like(base.model, 2)}
        for stage, (batch, draws) in _dp_shared_inputs(cfg, device).items():
            state = states.pop(stage)
            step = _dp_step(state, stage, replicas)
            shard = mesh.shard_batch(batch, replicas)
            res = {"metrics": [], "launches": 0}
            for k, step_draws in enumerate(draws):
                mine = _dp_shard_draws(step_draws, rank)
                before = extract_patches.launches
                res["metrics"].append({m: float(v) for m, v in
                                       step(shard, None, *mine).items()})
                torch.cuda.synchronize()
                res["launches"] += extract_patches.launches - before
                digests = mesh.gather_objects(mesh.digest(state.model), replicas)
                if len(set(digests)) != 1:
                    raise AssertionError(f"stage {stage} step {k}: the replicas differ")
                if k == 0:
                    opt = state.optimizer if stage == 1 else state.ppo.optimizer
                    trained = {id(q) for g in opt.param_groups for q in g["params"]}
                    res["grads"] = {n: p.grad.detach().double().cpu()
                                    for n, p in state.model.named_parameters()
                                    if id(p) in trained}
            if stage == 1:
                actions = _dp_shard_draws(draws[1], rank)[0]
                got = extract_for_frames(shard["frames"], actions, cfg.image_size,
                                         cfg.patch_size)
                want = extract_for_frames(shard["frames"].cpu(), actions.cpu(), cfg.image_size,
                                          cfg.patch_size)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"rank {rank}: the patch kernel differs from the "
                                         "plain version on its shard")
            out[stage] = res
    finally:
        mesh.shutdown(replicas)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _dp_reference(device) -> dict:
    """Phase 14 (b)'s references in this process: stage 1's two B=8 plain
    steps' gradients averaged by hand, stage 2's plain step on the whole
    batch; float32, TF32 off."""
    import torch

    from adafocus_torch.train.stages import create_train_state

    cfg = _dp_cfg32()
    inputs = _dp_shared_inputs(cfg, device)
    init = create_train_state(cfg, 1, device=device,
                              generator=torch.Generator().manual_seed(SEED)).model
    out = {}
    batch, draws = inputs[1]
    runs = []
    for rank in range(2):
        state = _dp_state_like(init, 1)
        n = DP_SHARED_B
        shard = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        loss = float(_dp_step(state, 1, None)(shard, None,
                                              *_dp_shard_draws(draws[0], rank))["loss"])
        runs.append((loss, {n_: p.grad.detach().double().cpu()
                            for n_, p in state.model.named_parameters() if p.grad is not None}))
        del state
    out[1] = {"loss": (runs[0][0] + runs[1][0]) / 2,
              "grads": {k: (runs[0][1][k] + runs[1][1][k]) / 2 for k in runs[0][1]}}
    batch, draws = inputs[2]
    state = _dp_state_like(init, 2)
    del init
    metrics = _dp_step(state, 2, None)(batch, None, *draws[0])
    out[2] = {"loss": float(metrics["ppo/loss"]),
              "grads": {n: p.grad.detach().double().cpu()
                        for n, p in state.model.named_parameters() if p.grad is not None}}
    del state
    torch.cuda.empty_cache()
    return out


@_seconds
def dp_two_ranks(device, card: str, tmp: str) -> dict:
    """Phase 14 (b): two ranks sharing the card, against this process."""
    import torch

    start = time.perf_counter()
    code = _DP_RANK.format(root=ROOT)
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(2)]
    procs = []
    for r, path in enumerate(logs):
        with open(path, "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code, str(r), tmp], cwd=ROOT,
                                          stdout=log, stderr=subprocess.STDOUT))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _dp_deterministic(True)
        ref = _dp_reference(device)
        _dp_deterministic(False)
        deadline = start + DP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(path) as f:
                text = f.read()
            raise AssertionError(f"phase 14 (b) rank {r} exited {p.returncode}:\n{text[-4000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    out = {"seconds": time.perf_counter() - start}
    failed = []
    for stage, (loss_tol, cos_min) in ((1, (F32_LOSS_REL_TOL, F32_GRAD_MIN_COS)),
                                       (2, (PPO_F32_LOSS_REL_TOL, PPO_F32_GRAD_MIN_COS))):
        got, want = ranks[0][stage], ref[stage]
        key = "loss" if stage == 1 else "ppo/loss"
        loss = got["metrics"][0][key]
        rel = abs(loss - want["loss"]) / abs(want["loss"])
        comps = ("focuser", "classifier") if stage == 1 else ("policy",)
        cos = {}
        for comp in comps:
            names = sorted(k for k in got["grads"] if k.startswith(comp + "."))
            g = torch.cat([got["grads"][k].flatten() for k in names])
            w = torch.cat([want["grads"][k].flatten() for k in names])
            cos[comp] = float(torch.nn.functional.cosine_similarity(g, w, dim=0))
        launches = [ranks[r][stage]["launches"] for r in range(2)]
        want_launches = 2 * (1 if stage == 1 else 2)
        out[stage] = {"loss": loss, "loss_ref": want["loss"], "loss_rel": rel, "grad_cos": cos,
                      "launches": launches, "metrics": got["metrics"]}
        failed += [f"stage {stage} loss"] if not rel <= loss_tol else []
        failed += [f"stage {stage} {c} cosine" for c, v in cos.items() if not v >= cos_min]
        failed += [f"stage {stage} launches"] if launches != [want_launches] * 2 else []
        print(f"data-parallel stage {stage}, two ranks sharing the card over gloo, float32 "
              f"B={DP_SHARED_B} a rank, two steps: replicas bit-identical after each, each "
              f"rank's patch kernel bit-identical to the plain version on its shard; "
              f"patch launches a rank {launches}; averaged loss {loss!r} vs "
              + ("two B=8 plain steps averaged by hand" if stage == 1
                 else "one plain step on the whole B=16 batch")
              + f" {want['loss']!r} (relative {rel!r}, limit {loss_tol}); gradient cosine "
              f"{cos} (limit {cos_min}) ({card})", flush=True)
    if failed:
        raise AssertionError(f"phase 14 (b) failed: {failed}")
    return out


@_seconds
def dp_dryrun(card: str, beside) -> tuple:
    """Phase 14 (c): the dry run over one rank, in a process of its own. It
    times nothing, so it runs while ``beside()`` (untimed work) runs here.
    Returns (its result, ``beside()``'s)."""
    import tempfile
    import threading

    start = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen([sys.executable, "-m", "adafocus_torch.parallel.dryrun",
                                 "--ranks", "1"], cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        ended = []   # the process's end on the host clock
        watch = threading.Thread(target=lambda: ended.append((proc.wait(), time.perf_counter())))
        watch.start()
        try:
            result = beside()
            watch.join(timeout=max(1.0, start + DP_TIMEOUT - time.perf_counter()))
        finally:
            if proc.poll() is None:
                proc.kill()
            watch.join()
        log.seek(0)
        text = log.read()
    seconds = ended[0][1] - start
    ok = [ln for ln in text.splitlines() if "dryrun --ranks 1" in ln and " ok:" in ln]
    if proc.returncode != 0 or not ok:
        raise AssertionError(f"dry run exited {proc.returncode}:\n{text[-6000:]}")
    print(f"{ok[0]} -- {seconds!r} s in all, the process's start included; it ran beside "
          f"phase 14 (b) and 15 (a) ({card})", flush=True)
    return {"seconds": seconds, "line": ok[0]}, result


# ---------------------------------------------------------------------------
# phase 15, the tooling (utils.torch_weights, utils.profiling, ops.flops, the
# ResNet variants), this slice's main path. (a) torchvision-layout ResNet-50
# and MobileNetV2 (tests/torch_ref_models.py, torch only), seeded with random
# BatchNorm statistics, saved as .pth and converted by the port's CLI in
# subprocesses; the port's backbones on the converted weights against the
# reference modules on their own, float32 with TF32 off: the same arithmetic,
# only the convolution algorithm free, so CONVERT_REL_TOL. (b) the train CLI's
# stage 1 warm-started from the converted focuser at the flagship width
# (phase 9's arguments, one epoch): the focuser bit-exact to the converted
# tensors before the first step (the ImageNet head, 1000 classes against 200,
# keeps its fresh value), one patch launch a step and eval batch. (c)
# utils.profiling.trace and top_ops over TOOL_FORWARDS flagship forwards at
# B=64 through the serving entry points, bf16 on the cuDNN path and int8 with
# phase 12's scales, each forward a "forward" range: the patch kernel's row
# counts TOOL_FORWARDS launches, its ms within PATCH_MS_REL of phase 5's, and
# the rows' sum within BUSY_REL of split_phases' busy total of the same trace
# (the same kernels read two ways); for int8 the split of the device's busy
# time into int8_conv, int8_dwconv, the quantize passes (quantize_act), the
# dequantize passes (_dequant_frames) and the rest, each in a range of its
# own. (d) ops.flops.gflops_per_video of the flagship forward against
# benchmark.inference_gflops_per_video: the same count, equal. (e) each ResNet
# variant over the focus shape (VARIANT_N patches of 96^2), bf16 against
# float32 (TF32 off) on the same weights, phase 4's class of limit, and its
# bf16 ms.
# ---------------------------------------------------------------------------
CONVERT_REL_TOL = 1e-4
CONVERT_SHAPES = {"resnet50": (64, 96), "mobilenet_v2": (16, 224)}   # (N, size)
CONVERT_TIMEOUT = 300        # seconds for each converter process
TOOL_FORWARDS = 3
TOOL_B = 64
PATCH_MS_REL = 0.10
BUSY_REL = 0.02
VARIANTS = ("resnet18", "resnet34", "resnet101", "resnet152", "wide_resnet101")
VARIANT_N = 64
VARIANT_REL_TOL = BF16_REL_TOL


@contextlib.contextmanager
def _tf32_off():
    import torch

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@_seconds
def tool_convert(device, card: str, tmp: str) -> dict:
    """(a): the converter's CLI on both reference architectures, the port's
    backbones against the references. Returns (the results, the converted
    focuser's state dict)."""
    import torch

    from adafocus_torch.models.mobilenet import MobileNetV2
    from adafocus_torch.models.resnet import resnet50
    import importlib.util

    from adafocus_torch.train import checkpoint as ckpt

    # by its path: a package named ``tests`` elsewhere on sys.path may shadow
    # the repository's test directory
    spec = importlib.util.spec_from_file_location(
        "torch_ref_models", os.path.join(ROOT, "tests", "torch_ref_models.py"))
    ref_models = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_models)
    refs = {"resnet50": ref_models.torch_resnet50,
            "mobilenet_v2": ref_models.torch_mobilenet_v2}
    ports = {"resnet50": resnet50, "mobilenet_v2": MobileNetV2}
    gen = torch.Generator().manual_seed(SEED + 150)
    models, procs, out = {}, {}, {}
    start = time.perf_counter()
    for arch, make in refs.items():
        torch.manual_seed(SEED + 150 + len(arch))
        models[arch] = _randomize_bn(make(num_classes=1000), gen).eval()
        pth = os.path.join(tmp, f"{arch}.pth")
        torch.save(models[arch].state_dict(), pth)
        procs[arch] = subprocess.Popen(
            [sys.executable, "-m", "adafocus_torch.utils.torch_weights", pth,
             os.path.join(tmp, f"{arch}_converted"), "--arch", arch],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for arch, proc in procs.items():
        log, _ = proc.communicate(timeout=CONVERT_TIMEOUT)
        if proc.returncode:
            raise AssertionError(f"converting {arch}: exit {proc.returncode}\n{log}")
        out[arch] = {"log": log.strip().splitlines()[-1]}
    convert_s = time.perf_counter() - start
    with _tf32_off(), torch.inference_mode():
        for arch, (n, size) in CONVERT_SHAPES.items():
            tree = ckpt.load_checkpoint(os.path.join(tmp, f"{arch}_converted"))
            converted = next(iter(tree["components"].values()))
            port = ports[arch](num_classes=1000)
            port.load_state_dict(converted)   # strict: every key converted
            port = port.to(device).eval()
            ref = models[arch].to(device)
            x = torch.randn((n, 3, size, size), generator=gen).to(device)
            want = ref(x)
            got = port(x) if arch == "resnet50" else port.classify(port.features(x)[1])
            rel, d = _rel_err(got, want)
            if not rel <= CONVERT_REL_TOL:
                raise AssertionError(f"converted {arch}: max|d|/max|ref| {rel!r} > "
                                     f"{CONVERT_REL_TOL}")
            out[arch].update(rel_err=rel, max_abs_err=d, n=n, size=size,
                             component=next(iter(tree["components"])))
            if arch == "resnet50":
                focuser = converted
            print(f"converted {arch} (torchvision layout -> port, the CLI in a subprocess): "
                  f"logits at N={n} {size}^2 float32, TF32 off, max|d| {d!r}, max|d|/max|ref| "
                  f"{rel!r} (limit {CONVERT_REL_TOL}) ({card})", flush=True)
            del port, ref, x, want, got
    del models
    torch.cuda.empty_cache()
    out["convert_s"] = convert_s
    return out, focuser


@_seconds
def tool_warm_start_cli(device, card: str, tmp: str, converted: dict) -> dict:
    """(b): the train CLI's stage 1 from the converted focuser (phase 9's
    arguments, one epoch); the focuser checked in the state that ``main``
    builds, before its first step."""
    import torch

    from adafocus_torch.cli import train as cli_train

    real_build = cli_train.build_state
    seen = {}

    def checked_build_state(cfg, *args, **kw):
        state, start_epoch, best_acc = real_build(cfg, *args, **kw)
        focuser = state.model.focuser.state_dict()
        seen["kept"] = sorted(k for k, v in focuser.items()
                              if k not in converted or converted[k].shape != v.shape)
        seen["differ"] = sorted(k for k, v in focuser.items() if k in converted
                                and converted[k].shape == v.shape
                                and not torch.equal(v.cpu(), converted[k]))
        return state, start_epoch, best_acc

    n_val = -(-CLI_VIDEOS // CLI_B)
    args = _cli_args(tmp, "run.stage=1", "run.epochs=1", f"run.ckpt_dir={tmp}/warm_s1",
                     f"run.warm_start={tmp}/resnet50_converted")
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False   # the CLI's setting
    cli_train.build_state = checked_build_state
    try:
        torch.cuda.synchronize()
        _launch_counts(reset=True)
        res = _run_cli(cli_train.main, args, os.path.join(tmp, "warm_cli.log"))
        torch.cuda.synchronize()
        launches = _launch_counts()
    finally:
        cli_train.build_state = real_build
        torch.backends.cudnn.benchmark = autotune
    if seen.get("differ") or seen.get("kept") != ["fc.bias", "fc.weight"]:
        raise AssertionError(f"warm start from the converted focuser: differing {seen}")
    steps = sum(e["steps"] for e in res["epochs"])
    want = steps + n_val
    if launches != {"extract_patches": want, "fused_inverted_residual": 0,
                    "fused_bottleneck": 0} or not math.isfinite(res["best_acc"]):
        raise AssertionError(f"warm-started CLI stage 1: launches {launches}, want {want} patch "
                             f"launches ({steps} steps, {n_val} eval batches); {res['best_acc']}")
    out = {"epochs": res["epochs"], "launches": launches, "best_acc": res["best_acc"],
           "steps": steps, "eval_batches": n_val, "kept_fresh": seen["kept"]}
    print(f"CLI stage 1 bf16 B={CLI_B} warm-started from the converted ResNet-50: the focuser "
          f"bit-exact to the converted tensors before the first step (kept fresh: "
          f"{seen['kept']}); patch launches {launches['extract_patches']} ({steps} steps, "
          f"{n_val} eval batches); videos/s {[e['videos_per_s'] for e in res['epochs']]!r} "
          f"({card})", flush=True)
    del res
    torch.cuda.empty_cache()
    return out


def _int8_split(events: list, rows: list) -> dict:
    """The int8 forward's device busy time by kind, ms a forward: the two
    int8 kernels (by name; split K's second pass counts as int8_conv), the
    quantize and dequantize passes (kernels launched inside their ranges)
    and the rest. Raises if a quantize pass ran a kernel: the backbones
    requantize inside the int8 kernels, and mode int8 has no int8 head."""
    from port_patch_times import split_phases

    total = sum(r[1] for r in rows)
    conv = sum(r[1] for r in rows if re.search(r"\b(conv_kernel|splitk_finish)\b", r[0]))
    dw = sum(r[1] for r in rows if re.search(r"\bdw_kernel\b", r[0]))
    passes = split_phases(events, 1, ("quantize", "dequantize"))
    split = {"int8_conv": conv, "int8_dwconv": dw, "quantize": passes["quantize"]["busy_ms"],
             "dequantize": passes["dequantize"]["busy_ms"]}
    split["rest"] = total - sum(split.values())
    if split["quantize"] != 0:
        raise AssertionError(f"int8 forward: quantize passes ran kernels, {split['quantize']!r} "
                             f"ms over {TOOL_FORWARDS} forwards")
    return {k: {"ms": v / TOOL_FORWARDS, "share_of_busy": v / total} for k, v in split.items()}


@_seconds
def tool_profiles(device, card: str, tmp: str, q8_scales, patch_ms: float) -> dict:
    """(c) and (d) on the bf16 flagship (the weights of phases 4, 5 and 12)."""
    import torch
    from torch.profiler import record_function

    from adafocus_torch.benchmark import inference_fn, inference_gflops_per_video, make_data
    from adafocus_torch.models import quant_inference as qi
    from adafocus_torch.models.gfv import GFV, flagship, inference
    from adafocus_torch.ops import flops
    from adafocus_torch.ops.quant import int8_conv, quantize_frames
    from adafocus_torch.utils.profiling import load_trace, top_ops, trace
    from port_patch_times import flagship_inputs, split_phases

    model = GFV(flagship(), device=device, generator=torch.Generator().manual_seed(SEED))
    frames, small = flagship_inputs(model, device, TOOL_B)
    fq, sq = (quantize_frames(t.bfloat16()) for t in _q8_inputs(model.cfg, TOOL_B, SEED + 130,
                                                                  device))
    qw = qi.prepare_q8(model, q8_scales)
    forwards = {"bf16": lambda: inference(model, frames, small, device=device),
                "int8": lambda: qi.inference_q8(model, q8_scales, fq, sq, device=device, qw=qw)}
    real = qi.quantize_act, qi._dequant_frames

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapped

    out = {}
    autotune = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True   # the serving bench's setting, as phase 5
    try:
        for mode, fn in forwards.items():
            fn()   # warm-up: cuDNN's algorithm search
            log_dir = os.path.join(tmp, f"profile_{mode}")
            qi.quantize_act, qi._dequant_frames = (ranged("quantize", real[0]),
                                                   ranged("dequantize", real[1]))
            _q8_counts(reset=True)
            try:
                with trace(log_dir):
                    for _ in range(TOOL_FORWARDS):
                        with record_function("forward"):
                            fn()
            finally:
                qi.quantize_act, qi._dequant_frames = real
            launches = _q8_counts()
            finish_launches = int8_conv.finish_launches
            rows = top_ops(log_dir, n=10**9, group=True)
            events = load_trace(log_dir)
            busy = split_phases(events, TOOL_FORWARDS, ("forward",))["forward"]["busy_ms"]
            total = sum(r[1] for r in rows)
            patch = [r for r in rows if "patch_kernel" in r[0]]
            res = {"top15": [list(r) for r in rows[:15]], "rows": len(rows),
                   "busy_ms_per_forward": total / TOOL_FORWARDS,
                   "split_phases_busy_ms_per_forward": busy, "launches": launches,
                   "splitk_finish_launches": finish_launches,
                   "patch_kernel": {"count": sum(r[2] for r in patch),
                                    "ms_per_forward": sum(r[1] for r in patch) / TOOL_FORWARDS}}
            want = {"extract_patches": TOOL_FORWARDS, "fused_inverted_residual": 0,
                    "fused_bottleneck": 0,
                    "int8_conv": TOOL_FORWARDS * Q8_LAUNCHES["int8_conv"] if mode == "int8" else 0,
                    "int8_dwconv": TOOL_FORWARDS * Q8_LAUNCHES["int8_dwconv"]
                    if mode == "int8" else 0}
            if launches != want or res["patch_kernel"]["count"] != TOOL_FORWARDS:
                raise AssertionError(f"profiled {mode} forwards: launches {launches}, want {want};"
                                     f" patch rows {patch}")
            if not abs(total / TOOL_FORWARDS - busy) <= BUSY_REL * busy:
                raise AssertionError(f"profiled {mode} forwards: top_ops' sum {total!r} ms over "
                                     f"{TOOL_FORWARDS} forwards against split_phases' busy "
                                     f"{busy!r} ms a forward")
            if mode == "bf16":
                got = res["patch_kernel"]["ms_per_forward"]
                res["phase5_patch_kernel_ms"] = patch_ms
                if not abs(got - patch_ms) <= PATCH_MS_REL * patch_ms:
                    raise AssertionError(f"profiled patch kernel {got!r} ms a forward, phase 5's "
                                         f"{patch_ms!r}")
            else:
                res["split"] = _int8_split(events, rows)
            out[mode] = res
            print(f"profile, {TOOL_FORWARDS} flagship {mode} forwards at B={TOOL_B} "
                  f"(utils.profiling.top_ops, grouped), ms over the {TOOL_FORWARDS}, top 15: "
                  + "; ".join(f"{name[:90]} {ms!r} ({n})" for name, ms, n in rows[:15])
                  + f". Device busy {total / TOOL_FORWARDS!r} ms a forward (split_phases "
                  f"{busy!r}); patch kernel {res['patch_kernel']} ({card})", flush=True)
            if mode == "int8":
                print("int8 forward's device busy time, ms a forward (share): " + "; ".join(
                    f"{k} {v['ms']!r} ({v['share_of_busy']!r})" for k, v in res["split"].items())
                    + f" ({card})", flush=True)
    finally:
        torch.backends.cudnn.benchmark = autotune
    del frames, small, fq, sq, qw
    data = make_data(model.cfg, 8, device=device)
    counted = flops.gflops_per_video(inference_fn(model, "off"), 8, data["frames"],
                                     data["frames_small"])
    bench = inference_gflops_per_video(model, 8, mac_convention=False)
    if counted != bench:
        raise AssertionError(f"ops.flops {counted!r} GFLOPs a video, benchmark {bench!r}")
    out["gflops_per_video"] = {"ops.flops": counted, "benchmark": bench,
                               "mac_convention": inference_gflops_per_video(model, 8)}
    print(f"flagship GFLOPs a video (2 a multiply-add): ops.flops.gflops_per_video {counted!r}, "
          f"benchmark.inference_gflops_per_video {bench!r}; multiply-add = 1: "
          f"{out['gflops_per_video']['mac_convention']!r}", flush=True)
    del model, data
    torch.cuda.empty_cache()
    return out


@_seconds
def tool_variants(device, card: str) -> dict:
    """(e): each variant's pooled features in bf16 against float32 and its
    bf16 ms, at the focus shape, timed with cuDNN's autotuner off and then
    on (what an earlier phase left would otherwise decide the
    algorithms)."""
    import torch

    from adafocus_torch.models import resnet
    from adafocus_torch.utils.profiling import events_ms

    gen = torch.Generator().manual_seed(SEED + 151)
    x32 = torch.randn((VARIANT_N, 3, 96, 96), generator=gen).to(device)
    x16 = x32.bfloat16()
    out = {}
    autotune = torch.backends.cudnn.benchmark
    with _tf32_off(), torch.inference_mode():
        for i, name in enumerate(VARIANTS):
            torch.manual_seed(SEED + 151 + i)
            m32 = _randomize_bn(getattr(resnet, name)(num_classes=1000), gen).to(device).eval()
            m16 = copy.deepcopy(m32).bfloat16()
            want = m32.features(x32)[1]
            got = m16.features(x16)[1]
            rel, d = _rel_err(got, want)
            if not rel <= VARIANT_REL_TOL:
                raise AssertionError(f"{name}: bf16 against float32 {rel!r} > {VARIANT_REL_TOL}")
            ms = {}
            for tune in (False, True):
                torch.backends.cudnn.benchmark = tune
                ms[f"autotuner_{'on' if tune else 'off'}"] = events_ms(
                    lambda: m16.features(x16), iters=10, warmup=3)
            out[name] = {"rel_err": rel, "max_abs_err": d, "bf16_ms": ms,
                         "params": sum(p.numel() for p in m32.parameters()),
                         "feature_dim": m32.feature_dim}
            del m32, m16, want, got
            torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = autotune
    print(f"ResNet variants over {VARIANT_N} patches of 96^2: " + "; ".join(
        f"{k} bf16 ms {json.dumps(v['bf16_ms'])}, bf16 vs float32 {v['rel_err']!r}"
        for k, v in out.items())
        + f" (limit {VARIANT_REL_TOL}) ({card})", flush=True)
    return out


@_seconds
def tool_phase(device, card: str, q8_scales, patch_ms: float, tmp: str, converted) -> dict:
    """Phase 15: (b) to (e), each raising on failure, after (a)
    (``tool_convert``, run beside phase 13; ``converted`` its result, its
    files in ``tmp``)."""
    start = time.perf_counter()
    convert, focuser = converted
    out = {"convert": convert, "cli": tool_warm_start_cli(device, card, tmp, focuser)}
    out["profiles"] = tool_profiles(device, card, tmp, q8_scales, patch_ms)
    out["variants"] = tool_variants(device, card)
    out["seconds"] = time.perf_counter() - start
    return out


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    start = time.perf_counter()
    phase_s, last = {}, [start, 0]   # each phase's host seconds; its first call

    def done(what):
        now = time.perf_counter()
        phase_s[what] = now - last[0]
        calls = "; ".join(f"{n} {t:.1f}" for n, t in CALL_SECONDS[last[1]:])
        last[:] = now, len(CALL_SECONDS)
        print(f"{what} done at {now - start:.1f} s ({phase_s[what]:.1f} s; calls, s: {calls})",
              flush=True)

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from adafocus_torch.ops import _kernels

    build_s, dumps = build_kernels()
    print(f"kernels built in {max(_kernels.build_seconds.values()):.2f} s (each library: "
          f"{json.dumps(_kernels.build_seconds)}); built and SASS dumped in {build_s:.2f} s",
          flush=True)
    for name in _kernels.SIGNATURES:
        # -Xptxas -v: per kernel, its entry name, then its spill and register lines
        fn = ""
        for ln in _kernels.build_logs[name].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
            elif ("Used" in ln and "registers" in ln) or "spill stores" in ln:
                print(f"nvcc {name} {fn}: {ln.split(':', 1)[-1].strip()}", flush=True)
    sass = tensor_core_instructions(dumps)
    done("phase 2 (build, SASS)")

    from adafocus_torch.benchmark import sthsth_cfg
    from adafocus_torch.models.gfv import GFV, flagship
    from adafocus_torch.utils.profiling import host_bound
    from port_patch_times import flagship_inputs, profile_phases

    model16 = GFV(flagship(), device=device,
                  generator=torch.Generator().manual_seed(SEED))
    model_sth = GFV(sthsth_cfg(144), device=device,
                    generator=torch.Generator().manual_seed(SEED))
    patch_row, patch_shapes = check_patch_kernel(device)
    for row in patch_shapes:
        print(f"extract_patches {row['shape']} (plan {tuple(row['plan'].values())}): kernel "
              f"{row['us']!r} us ({row['dev_us']!r} on the device, {row['tb_per_s']!r} TB/s, "
              f"{row['share_of_bound']!r} of the bound; host-bound {row['host_bound']}), plain "
              f"{row['plain_us']!r} us, strided copy_ {row['strided_copy_us']!r} us "
              f"({row['strided_copy_dev_us']!r} on the device), contiguous copy_ "
              f"{row['contiguous_copy_us']!r} us ({row['contiguous_copy_dev_us']!r} on the "
              f"device), bound {row['bound_us']!r} us ({card})", flush=True)
    rows = [patch_row]
    done("phase 3, patch kernel")
    fused_rows, per_shape = check_fused_blocks(model16, device, sass)
    rows += fused_rows
    done("phase 3, fused blocks")
    matched_rows, matched_shapes = check_matched_blocks(model_sth, device, sass)
    done("phase 3, fused blocks in the matched configuration's TSM split")
    # the timed kernel rows of phases 12 and 11 run here, early: late in this
    # long-lived process the profiler loses device spans (a few of them, or
    # all; port_patch_times.measured_device_ms), early it sees them all
    int8_rows = check_int8_kernels(device)
    plus_rows = plus_gather_and_patch(device)
    done("phases 12 and 11, their kernel rows, run early")
    launches = flagship_forward(model16, device)["launches"]
    done("phase 4")
    # each kernel's count from the run of its own path: the library-conv
    # path (slice 1) for extraction, the fused path for the blocks
    rows[0]["launches"] = launches["auto"]["extract_patches"]
    for row in fused_rows:
        row["launches"] = launches["on"][row["name"]]
    for fused, iters in (("auto", 10), ("on", 5)):
        vps, phases = flagship_throughput(model16, device, fused, iters=iters)
        print(f"flagship bf16 B=64 T=16 fused={fused!r}: videos/s {vps!r}; phase ms "
              f"{json.dumps(phases)} ({card})", flush=True)
    torch.backends.cudnn.benchmark = True
    frames, small = flagship_inputs(model16, device)
    prof = _seconds(profile_phases)(model16, frames, small)
    ext = prof["extract"]
    print(f"extraction phase, profiled, bf16 B=64 T=16 cuDNN path: window "
          f"{ext['window_ms']!r} ms = patch kernel {ext['patch_kernel_ms']!r} + other kernels "
          f"{ext['other_kernels_ms']!r} + device idle {ext['idle_ms']!r}; host "
          f"{ext['host_ms']!r} ms; forward idle share {prof['total']['idle_share']!r} "
          f"({card})", flush=True)
    if not ext["patch_kernel_ms"] > 0:
        raise AssertionError(f"the profile shows no patch kernel in the extraction phase: {prof}")
    del frames, small, model16
    torch.cuda.empty_cache()
    done("phase 5")
    check_patch_backward(device)
    train = train_stage1_timed(device, card)
    train["precision"] = train_precisions(device)
    train_launches = train_small_stages(device)
    done("phase 6")
    stage2 = train_stage2_timed(device, card)
    stage2["precision"] = train_stage2_precisions(device)
    stage2["sampler"] = check_sampler(device)
    done("phase 7")
    matched = matched_forward(model_sth, device)
    for fused, iters in (("auto", 10), ("on", 5)):
        run = matched[fused] = matched_throughput(model_sth, device, fused, iters)
        print(f"matched sth-sth 144^2 bf16 B={MATCHED_B} fused={fused!r}: videos/s "
              f"{run['videos_per_s']!r}; phase ms {json.dumps(run['phase_ms'])}; peak memory "
              f"{run['peak_bytes']} B ({run['peak_bytes'] / 2**30:.2f} GiB) ({card})", flush=True)
    del model_sth
    torch.cuda.empty_cache()
    import port_bench

    bench = _seconds(port_bench.bench)(device)
    done("phase 8")
    cli = cli_phase(device, card)
    step_only = {1: train["videos_per_s"], 2: stage2["videos_per_s"]}
    for stage in (1, 2):
        print(f"CLI stage {stage} at B={CLI_B}, videos/s of its warm epoch (loader, batch prep "
              f"and step): {cli['stages'][stage]['epochs'][-1]['videos_per_s']!r}; phase "
              f"{5 + stage}'s step only at B={TRAIN_B}: {step_only[stage]!r}"
              + (f"; step only at B={CLI_B} from the CLI's batches: "
                 f"{cli['components']['step_only_videos_per_s']!r}" if stage == 1 else "")
              + f" ({card})", flush=True)
    done("phase 9")
    sthsth = sthsth_train_phase(device, card)
    done("phase 10")
    plus = plus_phase(device, card, plus_rows)
    done("phase 11")
    q8 = q8_phase(device, card, int8_rows)
    done("phase 12")
    q8_scales = q8.pop("flagship_scales")
    # phase 14 (a) times steps: it runs alone, first; phase 13's exports and
    # loads, 14 (b), 14 (c) and 15 (a) time nothing: they run at once, then
    # phase 13's timings run with the card otherwise idle
    with tempfile.TemporaryDirectory() as dp_tmp, tempfile.TemporaryDirectory() as tool_tmp:
        dp = {"one_rank": dp_one_rank(device, card, dp_tmp)}
        done("phase 14 (a)")
        export, (dp["dryrun"], (dp["two_ranks"], converted)) = export_phase(
            device, card, q8_scales,
            beside=lambda: dp_dryrun(card, lambda: (dp_two_ranks(device, card, dp_tmp),
                                                    tool_convert(device, card, tool_tmp))))
        done("phase 13, with 14 (b), (c) and 15 (a) beside its exports")
        tools = tool_phase(device, card, q8_scales, ext["patch_kernel_ms"], tool_tmp, converted)
    done("phase 15")
    # each kernel's count from the run of this slice's main path (phase 14,
    # the patch kernel; below), for the int8 kernels phase 13's and for the
    # blocks the matched sth-sth forward's fused path; the counts of the
    # other paths beside them
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    sth_cli = sthsth["cli"]
    n_sth_val = -(-STH_CLI_VIDEOS // STH_CLI_B)
    n_plus_val = -(-PLUS_CLI_VIDEOS // PLUS_CLI_B)
    tool_cli = tools["cli"]
    paths = {f"CLI train stage 1 warm-started from a converted ResNet-50, {tool_cli['steps']} "
             f"steps and {tool_cli['eval_batches']} eval batches": tool_cli["launches"],
             **{f"flagship {mode} inference, {TOOL_FORWARDS} forwards under the profiler":
                v["launches"] for mode, v in tools["profiles"].items()
                if mode in ("bf16", "int8")},
             **{f"data-parallel stage {st}": c for st, c in dp["one_rank"]["launches"].items()},
             **{f"CLI AdaFocus+ train stage {st}, {sum(e['steps'] for e in v['epochs'])} steps "
                f"and {n_plus_val} eval batches": v["launches"]
                for st, v in plus["cli"]["stages"].items()},
             f"CLI AdaFocus+ evaluate, {n_plus_val} batches": plus["cli"]["evaluate"]["launches"],
             "AdaFocus+ inference, 1 forward": plus["forward"]["launches"],
             f"train AdaFocus+ ST stage 1, {n_steps} steps": plus["train"][1]["launches"],
             f"train AdaFocus+ joint stage 2, {n_steps} steps": plus["train"][2]["launches"],
             "train AdaFocus+ ST stage 3, 2 steps": plus["small"]["stage 3"],
             "AdaFocus+ eval, 1 step": plus["small"]["eval"],
             **{f"CLI sth-sth train stage {st}, {sum(e['steps'] for e in v['epochs'])} steps "
                f"and {n_sth_val} eval batches": v["launches"]
                for st, v in sth_cli["stages"].items()},
             **{f"CLI sth-sth evaluate {p}, {n_sth_val} batches": v["launches"]
                for p, v in sth_cli["evaluate"].items()},
             **{f"train sth-sth stage {st}, {n_steps} steps": v["launches"]
                for st, v in sthsth["steps"].items()},
             **{f"CLI train stage {st}, {sum(e['steps'] for e in v['epochs'])} steps and "
                f"{-(-CLI_VIDEOS // CLI_B) * len(v['epochs'])} eval batches": v["launches"]
                for st, v in cli["stages"].items()},
             **{f"CLI evaluate {p}, {-(-CLI_VIDEOS // CLI_B)} batches": v["launches"]
                for p, v in cli["evaluate"].items()},
             "matched sth-sth inference, cuDNN path, 1 forward": matched["launches"]["auto"],
             "matched sth-sth inference, fused path, 1 forward": matched["launches"]["on"],
             "flagship inference, cuDNN path, 1 forward": launches["auto"],
             "flagship inference, fused path, 1 forward": launches["on"],
             f"train stage 1, {n_steps} steps": train["launches"],
             **{f"{k}, {1 if k == 'eval' else 2} step(s)": v
                for k, v in train_launches.items()},
             f"train stage 2, {n_steps} steps": stage2["launches"],
             **{f"{fam} {mode} inference, 1 forward": row["launches"]
                for fam, modes in q8["checks"].items() for mode, row in modes.items()},
             **{f"CLI evaluate run.quantize=int8 ({mode}), {-(-CLI_VIDEOS // CLI_B)} "
                f"calibration batches, the preparation and as many eval batches": v["launches"]
                for mode, v in q8["cli"].items()},
             **{f"export {key}, reloaded in a fresh process, 1 forward": row["launches"]
                for key, row in export["artifacts"].items()}}
    patch_matched = patch_shapes[2]   # port_patch_times.SHAPES: the sth-sth B=64 call
    gp = plus["serving"]["gather_and_patch"]
    rows[0]["plus"] = {
        "ms": gp["patch_ms"], "device_ms": gp["patch_device_ms"],
        "host_bound": host_bound(gp["patch_ms"], gp["patch_device_ms"]),
        "plain_ms": gp["patch_plain_ms"], "bound_ms": gp["patch_bound_ms"], "bound_by": "bytes",
        "library_ms": gp["strided_copy_ms"], "library_device_ms": gp["strided_copy_device_ms"],
        "library_host_bound": host_bound(gp["strided_copy_ms"], gp["strided_copy_device_ms"]),
        "gather_ms": gp["gather_ms"], "gather_device_ms": gp["gather_device_ms"],
        "gather_bound_ms": gp["gather_bound_ms"],
        "shape": f"AdaFocus+ B={PLUS_B} K={PLUS_POINT[1]}: N={plus['serving']['n']} gathered "
                 f"224x224x3 frames P={PLUS_POINT[0]} bf16"}
    rows[0]["matched"] = {
        **_patch_times(patch_matched),
        "shape": f"{patch_matched['shape']}: N={patch_matched['n']} "
                 f"{patch_matched['frames']} P={patch_matched['p']} bf16"}
    for row, mrow in zip(rows[1:], matched_rows):
        row["launches"] = matched["launches"]["on"][row["name"]]
        row["matched"] = {k: mrow[k] for k in (
            "ms", "device_ms", "host_bound", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "library_host_bound", "max_abs_err", "shape")}
    rows += q8["kernel_rows"]
    # the export path, the flagship's int8 artifact reloaded in a fresh
    # process, launches the patch kernel and both int8 kernels through their
    # custom ops; the fused blocks stay ctypes calls, off every export path
    # (JAX exports the library path), with their counts from phase 8
    ops = {"extract_patches": "adafocus_torch::extract_patches_at",
           "int8_conv": "adafocus_torch::int8_conv", "int8_dwconv": "adafocus_torch::int8_dwconv"}
    for row in rows:
        row["custom_op"] = ops.get(row["name"])
        if row["name"] in ops:
            row["launches"] = export["artifacts"]["flagship int8"]["launches"][row["name"]]
    # this slice's main path, phase 15: the patch kernel's count from the
    # warm-started CLI run, the int8 kernels' from the profiled int8 forwards
    rows[0]["launches"] = tool_cli["launches"]["extract_patches"]
    # (int8_conv's count is conv_kernel's, one an op call; split K's second
    # pass, splitk_finish, is counted apart)
    for row in rows:
        if row["name"] in ("int8_conv", "int8_dwconv"):
            row["launches"] = tools["profiles"]["int8"]["launches"][row["name"]]
        if row["name"] == "int8_conv":
            row["splitk_finish_launches"] = tools["profiles"]["int8"]["splitk_finish_launches"]
    # a path's count of a kernel it was not counted for (the int8 kernels
    # before phase 12) is None
    for row in rows:
        row["launches_by_path"] = {p: c.get(row["name"]) for p, c in paths.items()}
    print(json.dumps({"extraction_profile": prof}), flush=True)
    print(json.dumps({"patch_shapes": patch_shapes}), flush=True)
    print(json.dumps({"fused_shapes": per_shape}), flush=True)
    print(json.dumps({"matched_fused_shapes": matched_shapes}), flush=True)
    print(json.dumps({"train_stage1": train}), flush=True)
    print(json.dumps({"train_stage2": stage2}), flush=True)
    print(json.dumps({"matched": matched}), flush=True)
    print(json.dumps({"port_bench": bench}), flush=True)
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"sthsth_train": sthsth}), flush=True)
    print(json.dumps({"plus": plus}), flush=True)
    print(json.dumps({"int8": {k: v for k, v in q8.items() if k != "kernel_rows"}}), flush=True)
    print(json.dumps({"export": export}), flush=True)
    print(json.dumps({"data_parallel": dp}), flush=True)
    print(json.dumps({"tooling": tools}), flush=True)
    print(json.dumps({"call_seconds": CALL_SECONDS}), flush=True)
    print(card, flush=True)
    print(json.dumps({"seconds": {"total": time.perf_counter() - start, "phases": phase_s,
                                  "device_timings": PROFILED}}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
