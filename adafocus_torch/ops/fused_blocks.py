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
bf16 runs on the tensor cores (wgmma, two warpgroups a block); float32
keeps its CUDA-core product, so that float32 stays the exact yardstick.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.ops import _kernels

# shared-memory layout of the float32 kernels (csrc/fused_gemm.cuh
# block_gemm): the product's staging tiles, then the block's own buffers
STAGE_BYTES = (32 * 68 + 32 * 64) * 4
SMEM_MAX = 232448              # dynamic shared memory a block may use on sm_90
SMEM_TWO_BLOCKS = 113 * 1024   # at most this, and two blocks fit on one SM
_BLOCK_OVERHEAD = 1 << 18      # a block's fixed cost in the float32 planner, in MACs

# the bf16 kernels (csrc/fused_gemm.cuh namespace tc, and the kCH / kBN3 of
# each .cu): the ring's stages (least and most) and depths, A-row padding,
# the hidden chunk, the bottleneck's conv3 width per warpgroup
MIN_STAGES, MAX_STAGES, RING_DEPTHS, A_PAD = 3, 8, (32, 64), 8
TC_CHUNK, BN3 = 64, 128
BN2_SIZES = (16, 32, 64, 128, 256)                    # bottleneck_tc_kernel instances
BNP_SIZES = (16, 24, 32, 64, 96, 128, 160, 256)       # inv_residual_tc_kernel instances
SM_COUNT = 132                 # H100 SXM
SMEM_PER_SM = 233472           # shared memory of one SM; each block also holds 1 KiB


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
# residual, the hidden-channel chunk (ch) of one CUDA block; for bf16 also
# how the two warpgroups share the products (ns).
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    th: int
    tw: int
    g: int       # samples per block (> 1 only when a tile is the whole map)
    ch: int      # hidden channels per chunk (the float32 bottleneck keeps them all)
    smem: int    # dynamic shared memory, bytes
    ns: int = 1      # bf16: the warpgroups split the wide product's width (2) or its rows (1)
    stages: int = 0  # bf16 bottleneck: the ring's stages
    depth: int = 0   # bf16 bottleneck: the depth of a ring stage (32 or 64)
    wide: int = 0    # bf16 bottleneck: one hidden chunk of every channel (1) or of TC_CHUNK


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


def _tc_tiles(size_out: int):
    """Tile sides of the bf16 plans, whose tiles hold at most 128 outputs."""
    return sorted({size_out, *(t for t in (*range(1, 17), 24, 28, 32) if t < size_out)})


def _pick(options):
    """The plan of least modelled cost per sample; a plan that leaves room
    for only one block per SM pays half again."""
    def cost(item):
        macs, plan = item
        return (macs * (1.5 if plan.smem > SMEM_TWO_BLOCKS else 1.0), plan.smem)
    if not options:
        raise ValueError("no tile of this block fits in shared memory")
    return min(options, key=cost)[1]


def _fit(sizes, need: int) -> Optional[int]:
    return next((v for v in sizes if need <= v), None)


def _bn2(chid: int, ns: int) -> Optional[int]:
    """conv2's width per warpgroup in the bf16 bottleneck (bn2_of)."""
    return _fit(BN2_SIZES, -(-chid // ns))


def _bnp(cout: int, ns: int) -> Optional[int]:
    """The project's width per warpgroup in the bf16 inverted residual (bnp_of)."""
    return _fit(BNP_SIZES, -(-cout // ns))


def _align128(v: int) -> int:
    return _ceil_to(v, 128)


def _chunk(chid_p: int, wide: int) -> int:
    """The bottleneck's hidden chunk (fused_bottleneck.cu chunk_of)."""
    return chid_p if wide else TC_CHUNK


def bottleneck_smem(g: int, rh: int, rw: int, chid: int, ns: int, stages: int,
                    depth: int, wide: int) -> int:
    """Shared memory of the bf16 bottleneck (fused_bottleneck.cu tc_layout):
    the ring, one buffer for the h1 chunk or h2 (rows padded by A_PAD), a
    zero row and the ring's mbarriers."""
    mt, chid_p = 2 // ns, ns * _bn2(chid, ns)
    cw, mt1 = _chunk(chid_p, wide), (mt if wide else 2)
    a_tile = 64 * (depth + A_PAD) * 2
    stage = max(mt1 * a_tile + depth * cw * 2, depth * chid_p * 2,
                mt * a_tile + depth * ns * BN3 * 2)
    h1 = g * rh * rw * (cw + A_PAD) * 2
    h2 = 64 * mt * (chid_p + A_PAD) * 2
    return (stages * stage + _align128(max(h1, h2)) + _align128((max(cw, chid_p) + A_PAD) * 2)
            + _align128(MAX_STAGES * 8))


def inv_residual_smem(g: int, rh: int, rw: int, cin: int, cout: int, expand: bool,
                      ns: int) -> int:
    """Shared memory of the bf16 inverted residual (fused_inv_residual.cu
    tc_layout): the x region, the chunk's expand weights, the hidden, the
    depthwise output, the chunk's project weights, a zero row, and each
    output row's depthwise taps (two ints)."""
    mr, cin_p, rows = g * rh * rw, _ceil_to(cin, 16), 64 * (2 // ns)
    ldx = cin_p + A_PAD
    return (_align128(mr * ldx * 2)
            + (_align128(cin_p * TC_CHUNK * 2) + _align128(mr * (TC_CHUNK + A_PAD) * 2)
               if expand else 0)
            + _align128(rows * (TC_CHUNK + A_PAD) * 2)
            + _align128(TC_CHUNK * ns * _bnp(cout, ns) * 2) + _align128(ldx * 2)
            + _align128(rows * 2 * 4))


# The bf16 planners' cost models, in SM cycles: least-squares fits to plans
# of the flagship's block shapes timed on the H100 at N=1024
# (``python3 -m adafocus_torch.time_plans``). A launch takes waves of SM_COUNT x
# (blocks per SM).
# Bottleneck, a block: tensor-core MACs (padded to the tiles) at 605 a
# cycle, x re-read per hidden chunk at 4.8 bytes a cycle, 1026 cycles a
# ring step (a barrier, a wait for the stage's copies, one for its
# products), 86000 a block; a wave of two blocks an SM takes 1.2 times one.
_BN_TC_RATE, _BN_X_RATE, _BN_STEP, _BN_BLOCK, _BN_TWO_BLOCKS = 605, 4.8, 1026, 86000, 1.2
# Inverted residual, a wave of occ blocks an SM: occ x (tensor-core MACs at
# 650 a cycle, depthwise MACs at 490, x region and output bytes at 0.89
# cycles each) + 7818 cycles a hidden chunk.
_IR_TC_RATE, _IR_CC_RATE, _IR_BYTE_CYCLES, _IR_CHUNK = 650, 490, 0.89, 7818


def blocks_per_sm(smem: int, most: int) -> int:
    """Blocks that fit on one SM by shared memory, at most `most`: the
    blocks the kernel instance's registers allow (its __launch_bounds__)."""
    return max(1, min(most, SMEM_PER_SM // (smem + 1024)))


def _waves(n: int, g: int, tiles: int, occ: int) -> int:
    """Waves of SM_COUNT x occ blocks for n samples, g a block, tiles a sample."""
    return -(-(-(-n // g) * tiles) // (SM_COUNT * occ))


def _tc_options(h_out: int, w_out: int, cap: int):
    """(th, tw, g) with at most cap output rows in a block."""
    for th in _tc_tiles(h_out):
        for tw in _tc_tiles(w_out):
            whole = th == h_out and tw == w_out
            for g in range(1, cap // (th * tw) + 1) if whole else (1,):
                if g * th * tw <= cap:
                    yield th, tw, g


def inv_residual_options(h, w, cin, chid, cout, stride, expand, n):
    """Every bf16 plan of the block that fits, as (modelled cycles at n
    samples, shared memory, plan)."""
    h_out, w_out = out_size(h, stride), out_size(w, stride)
    chunks, cin_p = -(-chid // TC_CHUNK), _ceil_to(cin, 16)
    options = []
    for ns in (1, 2):
        bnp = _bnp(cout, ns)
        if bnp is None:
            continue
        mt, most = 2 // ns, (3 if bnp <= 32 else 2 if bnp <= 96 else 1)
        for th, tw, g in _tc_options(h_out, w_out, 64 * mt):
            rh, rw = _region(th, stride, h), _region(tw, stride, w)
            smem = inv_residual_smem(g, rh, rw, cin, cout, expand, ns)
            if smem > SMEM_MAX:
                continue
            mr, mo = g * rh * rw, g * th * tw
            tc = chunks * 64 * mt * ns * bnp * TC_CHUNK
            if expand:
                tc += chunks * _ceil_to(-(-mr // 64), 2) * 64 * TC_CHUNK * cin_p
            cc = chunks * 64 * mt * TC_CHUNK * 9
            occ = blocks_per_sm(smem, most)
            wave = (occ * (tc / _IR_TC_RATE + cc / _IR_CC_RATE
                           + (mr * cin + mo * cout) * 2 * _IR_BYTE_CYCLES)
                    + chunks * _IR_CHUNK)
            tiles = -(-h_out // th) * -(-w_out // tw)
            options.append((_waves(n, g, tiles, occ) * wave, smem,
                            Plan(th, tw, g, TC_CHUNK, smem, ns)))
    return options


def bottleneck_options(h, w, cin, chid, cout, stride, downsample, n):
    """Every bf16 plan of the block that fits, as (modelled cycles at n
    samples, shared memory, plan)."""
    h_out, w_out = out_size(h, stride), out_size(w, stride)
    options = []
    for ns, depth, wide in itertools.product((1, 2), RING_DEPTHS, (0, 1)):
        bn2 = _bn2(chid, ns)
        if bn2 is None or (wide and bn2 < 64):
            continue
        mt, chid_p, cin_p = 2 // ns, ns * bn2, _ceil_to(cin, depth)
        cw = _chunk(chid_p, wide)
        chunks, mt1 = -(-chid // cw), (mt if wide else 2)
        tiles3 = -(-cout // (ns * BN3))
        ks3 = -(-chid_p // depth) + (cin_p // depth if downsample else 0)
        for th, tw, g in _tc_options(h_out, w_out, 64 * mt):
            rh, rw = _region(th, stride, h), _region(tw, stride, w)

            def smem_at(s):
                return bottleneck_smem(g, rh, rw, chid, ns, s, depth, wide)

            if smem_at(MIN_STAGES) > SMEM_MAX:
                continue
            most = 2 if bn2 <= 64 else 1   # bottleneck_tc_kernel's __launch_bounds__
            occ = blocks_per_sm(smem_at(MIN_STAGES), most)
            # as many stages as keep the blocks per SM
            stages = max(s for s in range(MIN_STAGES, MAX_STAGES + 1)
                         if smem_at(s) <= SMEM_MAX and blocks_per_sm(smem_at(s), most) == occ)
            smem = smem_at(stages)
            mr = g * rh * rw
            groups1 = -(-(-(-mr // 64)) // mt1)
            tc = chunks * (groups1 * mt1 * 64 * cw * cin_p + 9 * cw * 64 * mt * chid_p)
            tc += tiles3 * 64 * mt * ns * BN3 * ks3 * depth
            steps = chunks * (groups1 * cin_p // depth + 9 * cw // depth) + tiles3 * ks3
            per_block = (tc / _BN_TC_RATE + chunks * mr * cin * 2 / _BN_X_RATE
                         + steps * _BN_STEP + _BN_BLOCK)
            tiles = -(-h_out // th) * -(-w_out // tw)
            wave = per_block * (1.0 if occ == 1 else _BN_TWO_BLOCKS)
            options.append((_waves(n, g, tiles, occ) * wave, smem,
                            Plan(th, tw, g, TC_CHUNK, smem, ns, stages, depth, wide)))
    return options


@functools.lru_cache(maxsize=None)
def plan_inv_residual(h: int, w: int, cin: int, chid: int, cout: int, stride: int,
                      expand: bool, itemsize: int, n: int = 1024) -> Plan:
    """The block's plan: bf16 (itemsize 2) by the tensor-core cost model at
    n samples, float32 by padded MACs per sample."""
    if itemsize == 2:
        options = inv_residual_options(h, w, cin, chid, cout, stride, expand, n)
        if not options:
            raise ValueError("no bf16 tile of this block fits in shared memory")
        return min(options)[2]
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
                    downsample: bool, itemsize: int, n: int = 1024) -> Plan:
    """The block's plan: bf16 (itemsize 2) by the tensor-core cost model at
    n samples, float32 by padded MACs per sample."""
    if itemsize == 2:
        options = bottleneck_options(h, w, cin, chid, cout, stride, downsample, n)
        if not options:
            raise ValueError(f"no bf16 plan for a bottleneck {chid} hidden channels wide "
                             f"(at most {2 * BN2_SIZES[-1]})")
        return min(options)[2]
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


def pack_tiles(w: torch.Tensor, depth: int, nb: int, k_total: int) -> torch.Tensor:
    """A (..., K, N) weight as B tiles of the bf16 kernels' ring, for one
    bulk copy each: [...][N / nb][k_total / depth] tiles, each depth x nb in
    the wgmma layout (8 x 8 core matrices, n-groups of 8 side by side,
    k-groups of 8 rows after them), zero past K and N."""
    *lead, k, n = w.shape
    n_p = _ceil_to(n, nb)
    t = F.pad(w, (0, n_p - n, 0, k_total - k))
    t = t.reshape(*lead, k_total // depth, depth // 8, 8, n_p // nb, nb // 8, 8)
    d = len(lead)
    return t.permute(*range(d), d + 3, d, d + 1, d + 4, d + 2, d + 5).contiguous()


def pack_bottleneck(p: BottleneckParams, plan: Plan, downsample: bool):
    """The bf16 bottleneck's weights as the kernel's ring tiles (the order
    of fused_bottleneck.cu BottleneckArgs): w1 in hidden chunks, w2 per tap
    over chunks of its depth, w3 and wd per output tile."""
    cin, chid = p.w1.shape
    depth = plan.depth
    chid_p = plan.ns * _bn2(chid, plan.ns)
    cw, nb3 = _chunk(chid_p, plan.wide), plan.ns * BN3
    w1 = pack_tiles(p.w1, depth, cw, _ceil_to(cin, depth))
    w2 = pack_tiles(p.w2, depth, chid_p, _ceil_to(chid, cw))
    w3 = pack_tiles(p.w3, depth, nb3, _ceil_to(chid_p, depth))
    wd = pack_tiles(p.wd, depth, nb3, _ceil_to(cin, depth)) if downsample else None
    return w1, w2, w3, wd


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
    plan = plan_inv_residual(h, w, cin, chid, cout, stride, expand, x.element_size(), n)
    lib = _kernels.load("fused_inv_residual")
    out = torch.empty((n, out_size(h, stride), out_size(w, stride), cout),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_inv_residual(
            x.data_ptr(), p.w_expand.data_ptr() if expand else None,
            p.b_expand.data_ptr() if expand else None, p.w_dw.data_ptr(),
            p.b_dw.data_ptr(), p.w_project.data_ptr(), p.b_project.data_ptr(),
            out.data_ptr(), n, h, w, cin, chid, cout, stride, int(expand),
            int(use_res), plan.th, plan.tw, plan.g, plan.ch, plan.ns, x.element_size(),
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
    plan = plan_bottleneck(h, w, cin, chid, cout, stride, downsample, x.element_size(), n)
    lib = _kernels.load("fused_bottleneck")
    out = torch.empty((n, out_size(h, stride), out_size(w, stride), cout),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            w1, w2, w3, wd = pack_bottleneck(p, plan, downsample)
        else:
            w1, w2, w3, wd = p.w1, p.w2, p.w3, p.wd
        err = lib.fused_bottleneck(
            x.data_ptr(), w1.data_ptr(), p.b1.data_ptr(), w2.data_ptr(),
            p.b2.data_ptr(), w3.data_ptr(), p.b3.data_ptr(),
            wd.data_ptr() if downsample else None,
            p.bd.data_ptr() if downsample else None, out.data_ptr(), n, h, w, cin,
            chid, cout, stride, mode, plan.th, plan.tw, plan.g, plan.ns, plan.stages,
            plan.depth, plan.wide, x.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_bottleneck launch failed: CUDA error {err}")
    fused_bottleneck.launches += 1
    return out


# kernel launches since the last reset; tests and chip_smoke.py read them to
# show that a run went through the CUDA kernels
fused_inverted_residual.launches = 0
fused_bottleneck.launches = 0
