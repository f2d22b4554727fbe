"""Fused conv blocks for inference (counterpart of adafocus_tpu/ops/fused_blocks.py).

Each residual block of the backbones runs as one kernel with its hidden
activations kept on chip, BatchNorm folded into per-channel scale and bias:

  inverted residual:  [1x1 expand + b + relu6] -> [3x3 depthwise (stride
                      1/2) + b + relu6] -> [1x1 project + b] (+ x)
  bottleneck:         [1x1 + b + relu] -> [3x3 (stride 1/2) + b + relu]
                      -> [1x1 + b] + (1x1 downsample, or x) -> relu

Tensors are channels-last (N, H, W, C), bf16 or float32. Rounding points
are the JAX kernels': the compute dtype is the input's for bf16 and
float32 otherwise; every sum is float32; the hidden of the inverted
residual (after the expand), its depthwise output, and the bottleneck's
``h1`` and ``h2`` are rounded to the compute dtype; the bottleneck's
``h3`` stays float32 until the residual; the output is cast once. The
depthwise weights are float32 in every dtype.

``fused_inverted_residual`` and ``fused_bottleneck`` launch the CUDA
kernels (``csrc/fused_inv_residual.cu``, ``csrc/fused_bottleneck.cu``) for
a CUDA tensor and run the plain versions (``*_reference``) for a CPU
tensor. The TPU kernels' Mosaic shape (full-width stride-2 outputs
subsampled outside, odd-width padding, the 128-lane group chooser) is not
carried over: the kernels compute only the strided outputs, and the tile
each block owns comes from ``plan_inv_residual`` / ``plan_bottleneck``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.ops import _kernels

# shared-memory layout of the kernels (csrc/fused_gemm.cuh): the product's
# staging tiles, then the block's own buffers
STAGE_BYTES = (32 * 68 + 32 * 64) * 4
SMEM_MAX = 232448              # dynamic shared memory a block may use on sm_90
SMEM_TWO_BLOCKS = 113 * 1024   # at most this, and two blocks fit on one SM
_BLOCK_OVERHEAD = 1 << 18      # a block's fixed cost in the planner, in MACs


@torch.no_grad()
def fold_bn(unit, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into the preceding conv of a ``ConvBNAct``.

    Returns the conv weight (out, in / groups, kh, kw) times
    gamma * rsqrt(var + 1e-5), cast to ``dtype``, and the float32 bias
    beta - mean * mult. The product is taken in float32. In a bf16 model the
    conv weight is already bf16 when it is folded, so ``w * mult`` is
    rounded twice; the JAX package folds from float32 parameters.
    """
    bn = unit.bn
    mult = bn.weight.float() * torch.rsqrt(bn.running_var.float() + 1e-5)
    w = unit.conv.weight.float() * mult.reshape(-1, 1, 1, 1)
    return w.to(dtype), bn.bias.float() - bn.running_mean.float() * mult


def _pointwise(unit, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """A folded 1x1 conv as an (in, out) matrix and its bias."""
    w, b = fold_bn(unit, dtype)
    return w[:, :, 0, 0].t().contiguous(), b


def out_size(h: int, stride: int) -> int:
    """Conv output size for kernel 3, padding 1: (h - 1) // stride + 1."""
    return (h - 1) // stride + 1


# ---------------------------------------------------------------------------
# Folded parameters.
# ---------------------------------------------------------------------------


class InvResidualParams(NamedTuple):
    """Folded inference parameters of one inverted residual block."""

    w_expand: Optional[torch.Tensor]  # (Cin, Chid), compute dtype; None when expand_ratio == 1
    b_expand: Optional[torch.Tensor]  # (Chid,) float32
    w_dw: torch.Tensor                # (9, Chid) float32, tap dy * 3 + dx
    b_dw: torch.Tensor                # (Chid,) float32
    w_project: torch.Tensor           # (Chid, Cout), compute dtype
    b_project: torch.Tensor           # (Cout,) float32


def fold_inv_residual(block, dtype=torch.float32) -> InvResidualParams:
    """Fold an ``InvertedResidual`` (models/mobilenet.py) into kernel-ready
    tensors on the block's device."""
    if block.expand is not None:
        w_exp, b_exp = _pointwise(block.expand, dtype)
    else:
        w_exp = b_exp = None
    kdw, b_dw = fold_bn(block.dw)   # (Chid, 1, 3, 3) float32 in every dtype
    w_dw = kdw.reshape(kdw.shape[0], 9).t().contiguous()
    w_prj, b_prj = _pointwise(block.project, dtype)
    return InvResidualParams(w_exp, b_exp, w_dw, b_dw, w_prj, b_prj)


class BottleneckParams(NamedTuple):
    """Folded inference parameters of one ResNet bottleneck block."""

    w1: torch.Tensor            # (Cin, Chid), compute dtype
    b1: torch.Tensor            # (Chid,) float32
    w2: torch.Tensor            # (9, Chid, Chid): tap dy * 3 + dx, [in, out]
    b2: torch.Tensor            # (Chid,)
    w3: torch.Tensor            # (Chid, Cout)
    b3: torch.Tensor            # (Cout,)
    wd: Optional[torch.Tensor]  # (Cin, Cout) downsample, or None
    bd: Optional[torch.Tensor]  # (Cout,)


def fold_bottleneck(block, dtype=torch.float32) -> BottleneckParams:
    """Fold a ``Bottleneck`` (models/resnet.py) into kernel-ready tensors on
    the block's device."""
    w1, b1 = _pointwise(block.conv1, dtype)
    k2, b2 = fold_bn(block.conv2, dtype)   # (out, in, 3, 3)
    w2 = k2.permute(2, 3, 1, 0).reshape(9, k2.shape[1], k2.shape[0]).contiguous()
    w3, b3 = _pointwise(block.conv3, dtype)
    if block.down is not None:
        wd, bd = _pointwise(block.down, dtype)
    else:
        wd = bd = None
    return BottleneckParams(w1, b1, w2, b2, w3, b3, wd, bd)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _check_inv_res_flags(x, p: InvResidualParams, stride: int, use_res: bool) -> None:
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if use_res and (stride != 1 or x.shape[-1] != p.w_project.shape[-1]):
        raise ValueError("residual requires stride 1 and Cin == Cout")


def fused_inverted_residual_reference(x: torch.Tensor, p: InvResidualParams,
                                      stride: int = 1, use_res: bool = False
                                      ) -> torch.Tensor:
    """Plain PyTorch version: float32 matmuls and a depthwise ``F.conv2d``
    with the kernel's rounding points (on a GPU, run it with TF32 off)."""
    _check_inv_res_flags(x, p, stride, use_res)
    acc = _acc_dtype(x)
    xf = x.float()
    hid = xf if p.w_expand is None else (xf @ p.w_expand.float() + p.b_expand).clamp(0, 6)
    hid = _round(hid, acc).permute(0, 3, 1, 2)
    c = hid.shape[1]
    dw = F.conv2d(hid, p.w_dw.t().reshape(c, 1, 3, 3), stride=stride, padding=1,
                  groups=c)
    dw = _round((dw + p.b_dw.reshape(1, -1, 1, 1)).clamp(0, 6), acc).permute(0, 2, 3, 1)
    out = dw @ p.w_project.float() + p.b_project
    if use_res:
        out = out + xf
    return out.to(x.dtype).contiguous()


def _check_bottleneck_flags(x, p: BottleneckParams, stride: int, use_res: bool) -> bool:
    """Whether the downsample runs; raises on flags the block cannot take."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    downsample = p.wd is not None and use_res
    if use_res and not downsample and (stride != 1 or x.shape[-1] != p.w3.shape[-1]):
        raise ValueError("identity residual requires stride 1, Cin == Cout")
    return downsample


def fused_bottleneck_reference(x: torch.Tensor, p: BottleneckParams,
                               stride: int = 1, use_res: bool = True) -> torch.Tensor:
    """Plain PyTorch version: float32 matmuls and ``F.conv2d`` with the
    kernel's rounding points (on a GPU, run it with TF32 off).
    ``use_res=False`` returns the branch before the residual and the relu."""
    downsample = _check_bottleneck_flags(x, p, stride, use_res)
    acc = _acc_dtype(x)
    xf = x.float()
    h1 = _round((xf @ p.w1.float() + p.b1).relu(), acc).permute(0, 3, 1, 2)
    c = p.w2.shape[1]
    w2 = p.w2.float().permute(2, 1, 0).reshape(-1, c, 3, 3)
    h2 = F.conv2d(h1, w2, stride=stride, padding=1) + p.b2.reshape(1, -1, 1, 1)
    h2 = _round(h2.relu(), acc).permute(0, 2, 3, 1)
    out = h2 @ p.w3.float() + p.b3
    if downsample:
        xs = x[:, ::stride, ::stride]
        out = (out + (_round(xs, acc) @ p.wd.float() + p.bd)).relu()
    elif use_res:
        out = (out + xf).relu()
    return out.to(x.dtype).contiguous()


# ---------------------------------------------------------------------------
# Plans: the output tile (th x tw), the samples (g) and, for the inverted
# residual, the hidden-channel chunk (ch) of one CUDA block.
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    th: int
    tw: int
    g: int       # samples per block (> 1 only when a tile is the whole map)
    ch: int      # hidden channels per chunk (the bottleneck keeps them all)
    smem: int    # dynamic shared memory, bytes


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def _gemm_macs(m: int, n: int, k: int) -> int:
    """MACs of block_gemm, whose tiles are 64 x 64 and whose depth goes in
    chunks of 32."""
    return _ceil_to(m, 64) * _ceil_to(n, 64) * _ceil_to(k, 32)


def _region(t: int, stride: int, size: int) -> int:
    """Input rows that a tile of t output rows reads (3x3, pad 1), clipped."""
    return min((t - 1) * stride + 3, size)


def _tiles(size_out: int):
    return sorted({size_out, *(t for t in (4, 6, 7, 8, 12, 14, 16) if t < size_out)})


def _pick(options):
    """The plan of least modelled cost per sample; a plan that leaves room
    for only one block per SM pays half again."""
    def cost(item):
        macs, plan = item
        return (macs * (1.5 if plan.smem > SMEM_TWO_BLOCKS else 1.0), plan.smem)
    if not options:
        raise ValueError("no tile of this block fits in shared memory")
    return min(options, key=cost)[1]


@functools.lru_cache(maxsize=None)
def plan_inv_residual(h: int, w: int, cin: int, chid: int, cout: int, stride: int,
                      expand: bool, itemsize: int) -> Plan:
    h_out, w_out = out_size(h, stride), out_size(w, stride)
    options = []
    for th in _tiles(h_out):
        for tw in _tiles(w_out):
            rh, rw = _region(th, stride, h), _region(tw, stride, w)
            tiles = math.ceil(h_out / th) * math.ceil(w_out / tw)
            whole = th == h_out and tw == w_out
            for g in range(1, 9) if whole else (1,):
                for ch in sorted({min(c, chid) for c in (64, 128, 192, 256)} | {chid}):
                    smem = (STAGE_BYTES + g * th * tw * cout * 4
                            + g * (rh * rw + th * tw) * ch * itemsize)
                    if smem > SMEM_MAX:
                        continue
                    mr, mo = g * rh * rw, g * th * tw
                    macs = _BLOCK_OVERHEAD + mo * cout
                    for c0 in range(0, chid, ch):
                        cw = min(ch, chid - c0)
                        macs += (_gemm_macs(mr, cw, cin) if expand else mr * cw)
                        macs += mo * cw * 9 + _gemm_macs(mo, cout, cw)
                    options.append((tiles * macs / g, Plan(th, tw, g, ch, smem)))
    return _pick(options)


@functools.lru_cache(maxsize=None)
def plan_bottleneck(h: int, w: int, cin: int, chid: int, cout: int, stride: int,
                    downsample: bool, itemsize: int) -> Plan:
    h_out, w_out = out_size(h, stride), out_size(w, stride)
    options = []
    for th in _tiles(h_out):
        for tw in _tiles(w_out):
            rh, rw = _region(th, stride, h), _region(tw, stride, w)
            tiles = math.ceil(h_out / th) * math.ceil(w_out / tw)
            whole = th == h_out and tw == w_out
            for g in range(1, 9) if whole else (1,):
                smem = STAGE_BYTES + g * (rh * rw + th * tw) * chid * itemsize
                if smem > SMEM_MAX:
                    continue
                mr, mo = g * rh * rw, g * th * tw
                macs = (_BLOCK_OVERHEAD + _gemm_macs(mr, chid, cin)
                        + _gemm_macs(mo, chid, 9 * chid)
                        + _gemm_macs(mo, cout, chid + (cin if downsample else 0)))
                options.append((tiles * macs / g, Plan(th, tw, g, chid, smem)))
    return _pick(options)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _check_tensors(x: torch.Tensor, named) -> None:
    """x: (N, H, W, C) contiguous bf16 or float32; ``named``: (name, tensor,
    dtype, shape) of each parameter, each contiguous on x's device."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported dtype {x.dtype}: bf16 or float32")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (channels-last)")
    for name, t, dtype, shape in named:
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} {shape} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_inverted_residual(x: torch.Tensor, p: InvResidualParams, stride: int = 1,
                            use_res: bool = False) -> torch.Tensor:
    """One fused MobileNetV2 inverted residual (inference).

    x: (N, H, W, Cin) -> (N, H', W', Cout), H' = (H - 1) // stride + 1.
    On a CUDA tensor this always launches the CUDA kernel (and raises if it
    cannot be built or launched); on a CPU tensor it runs
    ``fused_inverted_residual_reference``.
    """
    _check_inv_res_flags(x, p, stride, use_res)
    if x.device.type == "cpu":
        return fused_inverted_residual_reference(x, p, stride, use_res)
    if x.device.type != "cuda":
        raise ValueError(f"no fused-block kernel for device {x.device}")
    n, h, w, cin = x.shape
    chid, cout = p.w_dw.shape[1], p.w_project.shape[1]
    expand = p.w_expand is not None
    f32 = torch.float32
    named = [("w_dw", p.w_dw, f32, (9, chid)), ("b_dw", p.b_dw, f32, (chid,)),
             ("w_project", p.w_project, x.dtype, (chid, cout)),
             ("b_project", p.b_project, f32, (cout,))]
    if expand:
        named += [("w_expand", p.w_expand, x.dtype, (cin, chid)),
                  ("b_expand", p.b_expand, f32, (chid,))]
    elif chid != cin:
        raise ValueError(f"without an expand the hidden is x: Chid {chid} != Cin {cin}")
    _check_tensors(x, named)
    plan = plan_inv_residual(h, w, cin, chid, cout, stride, expand, x.element_size())
    lib = _kernels.load("fused_inv_residual")
    out = torch.empty((n, out_size(h, stride), out_size(w, stride), cout),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_inv_residual(
            x.data_ptr(), p.w_expand.data_ptr() if expand else None,
            p.b_expand.data_ptr() if expand else None, p.w_dw.data_ptr(),
            p.b_dw.data_ptr(), p.w_project.data_ptr(), p.b_project.data_ptr(),
            out.data_ptr(), n, h, w, cin, chid, cout, stride, int(expand),
            int(use_res), plan.th, plan.tw, plan.g, plan.ch, x.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_inv_residual launch failed: CUDA error {err}")
    fused_inverted_residual.launches += 1
    return out


def fused_bottleneck(x: torch.Tensor, p: BottleneckParams, stride: int = 1,
                     use_res: bool = True) -> torch.Tensor:
    """One fused ResNet bottleneck (inference).

    x: (N, H, W, Cin) -> (N, H', W', Cout). The downsample runs when the
    block has one and ``use_res`` is set; ``use_res=False`` (the
    temporal-shift variant) returns the branch before the residual and the
    relu. On a CUDA tensor this always launches the CUDA kernel; on a CPU
    tensor it runs ``fused_bottleneck_reference``.
    """
    downsample = _check_bottleneck_flags(x, p, stride, use_res)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, p, stride, use_res)
    if x.device.type != "cuda":
        raise ValueError(f"no fused-block kernel for device {x.device}")
    n, h, w, cin = x.shape
    chid, cout = p.w1.shape[1], p.w3.shape[1]
    f32 = torch.float32
    named = [("w1", p.w1, x.dtype, (cin, chid)), ("b1", p.b1, f32, (chid,)),
             ("w2", p.w2, x.dtype, (9, chid, chid)), ("b2", p.b2, f32, (chid,)),
             ("w3", p.w3, x.dtype, (chid, cout)), ("b3", p.b3, f32, (cout,))]
    if downsample:
        named += [("wd", p.wd, x.dtype, (cin, cout)), ("bd", p.bd, f32, (cout,))]
    _check_tensors(x, named)
    mode = 1 if downsample else (0 if use_res else 2)
    plan = plan_bottleneck(h, w, cin, chid, cout, stride, downsample, x.element_size())
    lib = _kernels.load("fused_bottleneck")
    out = torch.empty((n, out_size(h, stride), out_size(w, stride), cout),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_bottleneck(
            x.data_ptr(), p.w1.data_ptr(), p.b1.data_ptr(), p.w2.data_ptr(),
            p.b2.data_ptr(), p.w3.data_ptr(), p.b3.data_ptr(),
            p.wd.data_ptr() if downsample else None,
            p.bd.data_ptr() if downsample else None, out.data_ptr(), n, h, w, cin,
            chid, cout, stride, mode, plan.th, plan.tw, plan.g, x.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck launch failed: CUDA error {err}")
    fused_bottleneck.launches += 1
    return out


# kernel launches since the last reset; tests and chip_smoke.py read them to
# show that a run went through the CUDA kernels
fused_inverted_residual.launches = 0
fused_bottleneck.launches = 0
