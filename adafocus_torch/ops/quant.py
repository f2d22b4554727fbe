"""Post-training int8 quantization (PTQ) primitives of the serving forward
(counterpart of adafocus_tpu/ops/quant.py).

The scheme is the JAX package's, symmetric PTQ:

  * weights: per-output-channel int8, scale = max|w| / 127 over each output
    channel, after the BatchNorm fold (``ops.fused_blocks.fold_bn``). The
    port's conv weights are (Cout, Cin/groups, kh, kw) and its dense weights
    (out, in), so the abs-max reduces over dims 1.. where JAX's HWIO and
    (in, out) kernels reduce over the leading dims: the scales and the codes
    are the same numbers;
  * activations: int8 with calibrated abs-max scales, per tensor for the
    backbone units, per input channel for the heads
    (models/quant_inference.py);
  * an int8 x int8 product accumulates in int32; the epilogue rescales by
    ``x_scale * w_scale`` (float32, computed once outside the product, as
    JAX computes it), adds the folded bias and applies the activation;
  * frames travel as int8 at the static ``FRAME_SCALE``.

``int8_conv`` (dense convs, 1x1 and 3x3, and through ``int8_dense`` the
heads' matmuls) and ``int8_dwconv`` (depthwise 3x3) launch the hand-written
Hopper kernels of ``csrc/int8_conv.cu`` on a CUDA tensor and run their
plain versions on a CPU tensor, through the ``torch.library`` custom ops
``adafocus_torch::int8_conv`` and ``adafocus_torch::int8_dwconv``, so that
``torch.export`` traces the int8 serving forward (``serving.py``). The JAX
package runs these products as XLA ops (``lax.conv_general_dilated`` and
``jnp.dot`` with ``preferred_element_type=int32``), not as Pallas kernels:
PyTorch has no CUDA int8 convolution with per-channel scales, so the
kernels are new work.

``int8_unit`` is a backbone unit with JAX's requantize fused into the
kernel's epilogue, as XLA fuses it for JAX: the output rounded to the
compute dtype, a residual added in float32 and rounded once (ReLU after the
add where asked), and the int8 codes at the consumer's scale written beside
or instead of the compute-dtype values; an input in the compute dtype is
quantized on load at the unit's own scale. The codes equal ``quantize_act``
of the unfused path's output bit for bit: the same division, the same
rounding.

The plain versions: the product in float64 (exact, every partial sum is an
integer below 2^53), the accumulator rounded to float32, and the epilogue
as a float64 multiply-add rounded once to float32. XLA:CPU contracts JAX's
``acc * rescale + bias`` into one fused multiply-add and the kernels use
``__fmaf_rn``; the float64 emulation equals a true FMA except where the
float64 sum itself rounds onto a float32 tie (double rounding, at most one
float32 ulp). Rounding is half to even everywhere (``torch.round``, as
``jnp.round``). The fused options are composed of the same pieces:
``quantize_act``, ``conv_acc_reference``, ``epilogue_reference``, the cast
to the compute dtype, the residual add.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from adafocus_torch.ops import _kernels

# the GEMM kernel's tiles (csrc/int8_conv.cu): BN output channels and a
# depth step of BK bytes, picked for each weight by ``conv_tiles``; the
# packed weight's depth is padded to a multiple of BK (32 for the K = 16
# and 24 expand units)
CONV_BN = (32, 64, 96, 128)
CONV_BK = (128, 64, 32)
ACTS = {None: 0, "relu": 1, "relu6": 2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_IN_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


class QConv(NamedTuple):
    """A quantized conv or dense unit: int8 weight and per-channel rescale.

    ``kernel_q`` is (Cout, Cin/groups, kh, kw) for a conv, (Cout, Cin) for a
    dense. ``packed`` and ``rescale`` are the kernel-ready forms that
    ``prepare_qconv`` makes once (the GEMM's (Cout, kh*kw*Cin) matrix padded
    to the tile, or the depthwise (9, C) taps; ``x_scale * w_scale``); left
    None they are made at each call."""

    kernel_q: torch.Tensor          # int8
    w_scale: torch.Tensor           # (Cout,) float32, per-output-channel weight scale
    bias: torch.Tensor              # (Cout,) float32, the folded bias
    x_scale: torch.Tensor           # () float32, the calibrated input scale
    packed: Optional[torch.Tensor] = None
    rescale: Optional[torch.Tensor] = None


def quantize_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a (Cout, ...) weight. Returns
    (int8 weight, (Cout,) float32 scales)."""
    k = kernel.float()
    absmax = k.abs().amax(dim=tuple(range(1, k.dim()))) if k.dim() > 1 else k.abs()
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.round(k / scale.reshape((-1,) + (1,) * (k.dim() - 1)))
    return q.clamp_(-127, 127).to(torch.int8), scale


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with the calibrated scale: a () scale per tensor, or a
    (C,) scale per channel of the last dim."""
    return torch.round(x.float() / scale).clamp_(-127, 127).to(torch.int8)


def act_scale_from_absmax(absmax) -> torch.Tensor:
    return torch.as_tensor(absmax, dtype=torch.float32).clamp_min(1e-12) / 127.0


def dequantize(x_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x_q.float() * scale


def _frame_absmax() -> float:
    """Static bound on ImageNet-normalized pixels: the largest
    max(mean_c, 1 - mean_c) / std_c, no calibration needed."""
    return max(max(m, 1.0 - m) / s for m, s in zip(IMAGENET_MEAN, IMAGENET_STD))


# int8 transport scale of normalized frames and patches: the serving input
# format, frames quantized once where they are made, cropped by the patch
# kernel at one byte a value, dequantized before the backbone stems
FRAME_SCALE = _frame_absmax() / 127.0


def quantize_frames(frames: torch.Tensor) -> torch.Tensor:
    """Normalized float frames -> the int8 transport format (FRAME_SCALE)."""
    return quantize_act(frames, torch.tensor(FRAME_SCALE, dtype=torch.float32,
                                             device=frames.device))


# ---------------------------------------------------------------------------
# Kernel-ready weights.
# ---------------------------------------------------------------------------


def conv_tiles(cout: int, k: int) -> Tuple[int, int]:
    """The GEMM kernel's (BN, BK) for a (Cout, K) weight: BN the width that
    pads Cout least, each tile costing 32 columns more for the input rows it
    reads again; BK the depth step that pads K least, the deeper on a tie
    (the K = 16 and 24 expand units step 32 deep)."""
    bn = min(CONV_BN, key=lambda b: (-(-cout // b) * (b + 32), -b))
    bk = min(CONV_BK, key=lambda b: (-(-k // b) * b, -b))
    return bn, bk


def pack_conv_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """The GEMM kernel's weight: (Cout, Cin, kh, kw) or (Cout, Cin) int8 ->
    (Cout_pad / BN, K_pad / BK, BK / 16, BN / 8, 8, 16) int8: one BN x BK
    tile of the (Cout_pad, K_pad) matrix (row c the tap-major depth (ky, kx,
    ci) of output channel c, zero-padded) after another, each in the layout
    the tensor cores read from shared memory (8-row x 16-byte core matrices,
    depth-chunk major), so that one bulk copy brings one tile. (BN, BK) from
    ``conv_tiles``."""
    cout = kernel_q.shape[0]
    w = kernel_q.permute(0, 2, 3, 1) if kernel_q.dim() == 4 else kernel_q
    w = w.reshape(cout, -1)
    k = w.shape[1]
    bn, bk = conv_tiles(cout, k)
    nt, ks = -(-cout // bn), -(-k // bk)
    full = torch.zeros((nt * bn, ks * bk), dtype=torch.int8, device=kernel_q.device)
    full[:cout, :k] = w
    return full.reshape(nt, bn // 8, 8, ks, bk // 16, 16).permute(0, 3, 4, 1, 2, 5).contiguous()


def pack_dw_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """The depthwise kernel's weight: (C, 1, 3, 3) int8 -> (9, C), tap
    ky * 3 + kx."""
    return kernel_q.reshape(kernel_q.shape[0], 9).t().contiguous()


def prepare_qconv(unit: QConv, depthwise: bool = False) -> QConv:
    """``unit`` with its kernel-ready forms made once: the packed weight,
    which the ops take on every device, and the float32 rescale."""
    packed = (pack_dw_weight if depthwise else pack_conv_weight)(unit.kernel_q)
    return unit._replace(packed=packed, rescale=unit.x_scale * unit.w_scale)


def unpack_conv_weight(packed: torch.Tensor, cout: int, kh: int, cin: int) -> torch.Tensor:
    """``pack_conv_weight``'s inverse: -> (Cout, Cin, kh, kh) int8."""
    nt, ks, c16, r8 = packed.shape[:4]
    full = packed.permute(0, 3, 4, 1, 2, 5).reshape(nt * r8 * 8, ks * c16 * 16)
    return full[:cout, :kh * kh * cin].reshape(cout, kh, kh, cin).permute(0, 3, 1, 2)


def unpack_dw_weight(packed: torch.Tensor) -> torch.Tensor:
    """``pack_dw_weight``'s inverse: (9, C) -> (C, 1, 3, 3) int8."""
    return packed.t().reshape(packed.shape[1], 1, 3, 3)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "relu6":
        return F.relu6(y)
    if act is not None:
        raise ValueError(f"unknown activation {act!r}: None, 'relu' or 'relu6'")
    return y


def epilogue_reference(acc: torch.Tensor, rescale: torch.Tensor, bias: torch.Tensor,
                       act: Optional[str] = None, out_dtype=torch.float32) -> torch.Tensor:
    """The kernels' epilogue on float64 accumulators (..., Cout): the
    accumulator rounded to float32, ``acc * rescale + bias`` in float64
    rounded once to float32 (the fused multiply-add), the activation, the
    cast. ``out_dtype=torch.int32`` returns the accumulator itself."""
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    y = acc.float().double() * rescale.double() + bias.double()
    return _act(y.float(), act).to(out_dtype)


def conv_acc_reference(x_q: torch.Tensor, kernel_q: torch.Tensor, strides: int = 1,
                       groups: int = 1) -> torch.Tensor:
    """The int8 convolution's accumulators, exact in float64: x_q (N, H, W,
    Cin) int8, kernel_q (Cout, Cin/groups, kh, kw) int8, padding
    (kh - 1) // 2 -> (N, Ho, Wo, Cout) float64."""
    pad = (kernel_q.shape[2] - 1) // 2
    y = F.conv2d(x_q.permute(0, 3, 1, 2).double(), kernel_q.double(), stride=strides,
                 padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def _rescale(unit: QConv) -> torch.Tensor:
    return unit.x_scale * unit.w_scale if unit.rescale is None else unit.rescale


def unit_reference(x: torch.Tensor, kernel_q: torch.Tensor, stride: int, groups: int,
                   rescale: torch.Tensor, bias: torch.Tensor, act: Optional[str],
                   out_dtype: torch.dtype, x_scale: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None, res_relu: bool = False,
                   out_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of a fused unit, JAX's unfused composition: x's
    codes (x itself when int8, else ``quantize_act(x, x_scale)``), the exact
    accumulators, the epilogue rounded to ``out_dtype``, the residual added
    in float32 and rounded once (ReLU after the add with ``res_relu``), and
    with ``out_scale`` the int8 codes of that output. Returns (output in
    ``out_dtype``, codes or None)."""
    x_q = x if x.dtype == torch.int8 else quantize_act(x, x_scale)
    y = epilogue_reference(conv_acc_reference(x_q, kernel_q, stride, groups), rescale, bias,
                           act, out_dtype)
    if residual is not None:
        y = y.float() + residual.float()
        y = (F.relu(y) if res_relu else y).to(out_dtype)
    return y, None if out_scale is None else quantize_act(y, out_scale)


# ---------------------------------------------------------------------------
# The kernels as torch.library custom ops.
# ---------------------------------------------------------------------------
#
# Each op takes tensors and primitive arguments only: the input (int8 codes,
# or the compute dtype to be quantized on load at ``x_scale``), the packed
# weight, the rescale, the bias, the geometry, the activation code
# (``ACTS``), the output dtype and the fused options: a residual (the conv
# only), the consumer's scale ``out_scale`` of the int8 output, ``keep``
# (write the compute-dtype output). It returns (output, codes), each empty
# when not asked for. Its CUDA implementation launches the kernel, reading
# every pointer there, never while a trace runs; its CPU implementation is
# the plain version on the weight unpacked from the same packed form; its
# fake implementation gives the outputs' shapes and dtypes, so that
# ``torch.export`` traces the int8 serving forward through them.


def _on_device(dev: torch.device, launcher, *args) -> int:
    """``launcher(*args, stream)`` on ``dev``'s current stream, switching
    the current device only when it differs."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return launcher(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return launcher(*args, torch.cuda.current_stream(dev).cuda_stream)


def _conv_out(x_q: torch.Tensor, kh: int, stride: int) -> Tuple[int, int]:
    """(Ho, Wo) of a kh x kh conv at padding (kh - 1) // 2."""
    pad = (kh - 1) // 2
    return tuple((d + 2 * pad - kh) // stride + 1 for d in x_q.shape[1:3])


_ACT_OF_CODE = {code: name for name, code in ACTS.items()}


def _outputs(y: torch.Tensor, q: Optional[torch.Tensor], keep: bool):
    """An op's (output, codes), each an empty tensor when not asked for."""
    return (y if keep else y.new_empty(0),
            q if q is not None else y.new_empty(0, dtype=torch.int8))


def _allocate(x: torch.Tensor, shape, out_dtype, keep: bool, out_scale):
    """The CUDA implementations' (output, codes), empty when not asked for."""
    out = torch.empty(shape if keep else (0,), dtype=out_dtype, device=x.device)
    q = torch.empty(shape if out_scale is not None else (0,), dtype=torch.int8, device=x.device)
    return out, q


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None or t.numel() == 0 else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_int8_conv(m: int, n_tiles: int, ksteps: int, sms: int = 132) -> Tuple[int, int]:
    """The GEMM kernel's launch plan for M rows, n_tiles column tiles and
    ksteps depth steps: (consumer warpgroups, K slices). Two consumers (128-
    row tiles) where those fill the card's ``sms`` SMs, else one; where the
    tiles leave more than half the SMs idle (the heads, tiny maps), the depth
    is cut into slices of at least two steps, up to two blocks an SM."""
    nc = 2 if -(-m // 128) * n_tiles >= sms else 1
    tiles = -(-m // (64 * nc)) * n_tiles
    splits = 1
    if 2 * tiles < sms and ksteps >= 4:
        splits = min(ksteps // 2, -(-2 * sms // tiles))
        per = -(-ksteps // splits)
        splits = -(-ksteps // per)
    return nc, splits


@torch.library.custom_op("adafocus_torch::int8_conv", mutates_args=(), device_types="cpu")
def _int8_conv_op(x: torch.Tensor, packed: torch.Tensor, rescale: torch.Tensor,
                  bias: torch.Tensor, kh: int, stride: int, act: int, out_dtype: torch.dtype,
                  x_scale: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
                  res_relu: bool = False, out_scale: Optional[torch.Tensor] = None,
                  keep: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, Cin), packed (``pack_conv_weight``) -> ((N, Ho, Wo, Cout)
    in ``out_dtype``, its int8 codes)."""
    w = unpack_conv_weight(packed, bias.shape[0], kh, x.shape[-1])
    y, q = unit_reference(x, w, stride, 1, rescale, bias, _ACT_OF_CODE[act], out_dtype,
                          x_scale, residual, res_relu, out_scale)
    return _outputs(y, q, keep)


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x, packed, rescale, bias, kh, stride, act, out_dtype, x_scale=None,
                    residual=None, res_relu=False, out_scale=None, keep=True):
    n, h, w, cin = x.shape
    cout = bias.shape[0]
    ho, wo = _conv_out(x, kh, stride)
    m = n * ho * wo
    n_tiles, ksteps, c16, r8 = packed.shape[:4]
    bn, bk = 8 * r8, 16 * c16
    nc, splits = plan_int8_conv(m, n_tiles, ksteps, _sm_count(x.device.index or 0))
    out, q = _allocate(x, (n, ho, wo, cout), out_dtype, keep, out_scale)
    ws = (torch.empty((splits, m, n_tiles * bn), dtype=torch.int32, device=x.device)
          if splits > 1 else None)
    err = _on_device(x.device, _kernels.load("int8_conv").int8_conv, x.data_ptr(),
                     _ptr(x_scale), packed.data_ptr(), rescale.data_ptr(), bias.data_ptr(),
                     _ptr(residual), _ptr(out), _ptr(q), _ptr(out_scale), _ptr(ws), m,
                     _IN_KINDS[x.dtype], _OUT_KINDS[out_dtype], int(res_relu), act, h, w, cin,
                     ho, wo, cout, kh * kh * cin, ksteps, bk, bn, n_tiles * bn, kh, stride,
                     (kh - 1) // 2, nc, splits)
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}")
    int8_conv.launches += 1
    if splits > 1:
        int8_conv.finish_launches += 1
    return out, q


@_int8_conv_op.register_fake
def _int8_conv_fake(x, packed, rescale, bias, kh, stride, act, out_dtype, x_scale=None,
                    residual=None, res_relu=False, out_scale=None, keep=True):
    shape = (x.shape[0],) + _conv_out(x, kh, stride) + (bias.shape[0],)
    return (x.new_empty(shape if keep else (0,), dtype=out_dtype),
            x.new_empty(shape if out_scale is not None else (0,), dtype=torch.int8))


@torch.library.custom_op("adafocus_torch::int8_dwconv", mutates_args=(), device_types="cpu")
def _int8_dwconv_op(x: torch.Tensor, packed: torch.Tensor, rescale: torch.Tensor,
                    bias: torch.Tensor, stride: int, act: int, out_dtype: torch.dtype,
                    x_scale: Optional[torch.Tensor] = None,
                    out_scale: Optional[torch.Tensor] = None,
                    keep: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C), packed (9, C) -> ((N, Ho, Wo, C) in ``out_dtype``,
    its int8 codes)."""
    y, q = unit_reference(x, unpack_dw_weight(packed), stride, x.shape[-1], rescale, bias,
                          _ACT_OF_CODE[act], out_dtype, x_scale, out_scale=out_scale)
    return _outputs(y, q, keep)


@_int8_dwconv_op.register_kernel("cuda")
def _int8_dwconv_cuda(x, packed, rescale, bias, stride, act, out_dtype, x_scale=None,
                      out_scale=None, keep=True):
    n, h, w, c = x.shape
    ho, wo = _conv_out(x, 3, stride)
    out, q = _allocate(x, (n, ho, wo, c), out_dtype, keep, out_scale)
    err = _on_device(x.device, _kernels.load("int8_conv").int8_dwconv, x.data_ptr(),
                     _ptr(x_scale), packed.data_ptr(), rescale.data_ptr(), bias.data_ptr(),
                     _ptr(out), _ptr(q), _ptr(out_scale), _IN_KINDS[x.dtype],
                     _OUT_KINDS[out_dtype], act, n, h, w, c, ho, wo, stride)
    if err != 0:
        raise RuntimeError(f"int8_dwconv launch failed: CUDA error {err}")
    int8_dwconv.launches += 1
    return out, q


@_int8_dwconv_op.register_fake
def _int8_dwconv_fake(x, packed, rescale, bias, stride, act, out_dtype, x_scale=None,
                      out_scale=None, keep=True):
    shape = (x.shape[0],) + _conv_out(x, 3, stride) + (x.shape[3],)
    return (x.new_empty(shape if keep else (0,), dtype=out_dtype),
            x.new_empty(shape if out_scale is not None else (0,), dtype=torch.int8))


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, unit: QConv, out_dtype, out_scale, residual, keep) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x.device}")
    if x.dtype not in _IN_KINDS or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (N, H, W, C) int8 codes, float32 or bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    if out_dtype == torch.int32 and (out_scale is not None or residual is not None):
        raise ValueError("the int32 accumulators take no residual and no int8 output")
    if not keep and out_scale is None:
        raise ValueError("keep=False without out_scale asks for no output")
    names = ("w_scale", "bias") + (() if x.dtype == torch.int8 else ("x_scale",))
    tensors = [getattr(unit, name) for name in names]
    if out_scale is not None:
        names, tensors = names + ("out_scale",), tensors + [out_scale]
    for name, t in zip(names, tensors):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}")
    if out_scale is not None and out_scale.numel() != 1:
        raise ValueError("out_scale must be one per-tensor scale")
    if residual is not None and (residual.dtype != out_dtype or not residual.is_contiguous()
                                 or residual.device != x.device):
        raise ValueError(f"residual must be contiguous {out_dtype} on {x.device}")


def int8_unit(x: torch.Tensor, unit: QConv, strides: int = 1, groups: int = 1,
              act: Optional[str] = None, out_dtype: torch.dtype = torch.float32, *,
              out_scale: Optional[torch.Tensor] = None, keep: bool = True,
              residual: Optional[torch.Tensor] = None, res_relu: bool = False
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One int8 unit with the requantize fused: x (N, H, W, Cin), int8 codes
    at ``unit.x_scale`` or the compute dtype (quantized on load at
    ``unit.x_scale``) -> (y, codes). y = ``act(acc * x_scale * w_scale +
    bias)`` rounded to ``out_dtype``; with ``residual`` ((N, Ho, Wo, Cout) in
    ``out_dtype``, the dense conv only) y = round(y + residual), ReLU after
    the add with ``res_relu``; codes = ``quantize_act(y, out_scale)`` when
    ``out_scale`` is given. y is returned (and written) only with ``keep``,
    codes only with ``out_scale``: the other is None. ``groups`` 1, or the
    channel count (depthwise 3x3). On a CUDA tensor one launch of the GEMM
    kernel (or of the depthwise one); on a CPU tensor the plain version."""
    if x.device.type != "cpu":
        _check(x, unit, out_dtype, out_scale, residual, keep)
    if groups != 1:
        if groups != x.shape[-1] or unit.kernel_q.shape[:2] != (groups, 1):
            raise ValueError(f"groups={groups}: only a depthwise conv is supported")
        if residual is not None:
            raise ValueError("the depthwise kernel takes no residual")
        y, q = _dwconv(x, unit, strides, act, out_dtype, out_scale, keep)
    else:
        y, q = _conv(x, unit, strides, act, out_dtype, out_scale, keep, residual, res_relu)
    return (y if keep else None), (q if out_scale is not None else None)


def int8_conv(x_q: torch.Tensor, unit: QConv, strides: int = 1, groups: int = 1,
              act: Optional[str] = None, out_dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """int8 conv with its epilogue: x_q (N, H, W, Cin) int8 quantized with
    ``unit.x_scale`` -> (N, Ho, Wo, Cout) in ``out_dtype``,
    ``act(acc * x_scale * w_scale + bias)`` (JAX's ``int8_conv`` is the
    default, no activation and float32). Padding (kh - 1) // 2; kh = kw in
    {1, 3}; ``groups`` 1, or the channel count (depthwise 3x3,
    ``int8_dwconv``). ``int8_unit`` without its fused options."""
    return int8_unit(x_q, unit, strides, groups, act, out_dtype)[0]


def _in_scale(x: torch.Tensor, unit: QConv) -> Optional[torch.Tensor]:
    """The op's ``x_scale``: the unit's, for an input quantized on load."""
    return None if x.dtype == torch.int8 else unit.x_scale


def _conv(x, unit: QConv, strides, act, out_dtype, out_scale, keep, residual, res_relu):
    """The GEMM op on ``unit``'s packed weight (packed now when ``unit`` was
    not prepared), after the kernel's checks on a CUDA tensor."""
    wq = unit.kernel_q
    cin = x.shape[-1]
    kh = wq.shape[2] if wq.dim() == 4 else 1
    packed = pack_conv_weight(wq) if unit.packed is None else unit.packed
    if x.device.type != "cpu":
        if wq.dim() == 4 and (wq.shape[1] != cin or wq.shape[3] != kh or kh not in (1, 3)):
            raise ValueError(f"weight {tuple(wq.shape)} does not fit input channels {cin}")
        if wq.dim() == 2 and wq.shape[1] != cin:
            raise ValueError(f"dense weight {tuple(wq.shape)} does not fit depth {cin}")
        if strides not in (1, 2):
            raise ValueError(f"stride {strides}: 1 or 2")
        cout, k = wq.shape[0], kh * kh * cin
        if packed.dim() != 6 or packed.shape[4:] != (8, 16):
            raise ValueError(f"packed weight {tuple(packed.shape)}: not pack_conv_weight's")
        nt, ks, c16, r8 = packed.shape[:4]
        if (8 * r8 not in CONV_BN or 16 * c16 not in CONV_BK or nt != -(-cout // (8 * r8))
                or ks != -(-k // (16 * c16))):
            raise ValueError(f"packed weight {tuple(packed.shape)} does not fit ({cout}, {k})")
    return _int8_conv_op(x, packed, _rescale(unit).contiguous(), unit.bias, kh, strides,
                         ACTS[act], out_dtype, x_scale=_in_scale(x, unit), residual=residual,
                         res_relu=res_relu, out_scale=out_scale, keep=keep)


def _dwconv(x, unit: QConv, strides, act, out_dtype, out_scale, keep):
    c = x.shape[-1]
    if x.device.type != "cpu" and (tuple(unit.kernel_q.shape) != (c, 1, 3, 3)
                                   or strides not in (1, 2)):
        raise ValueError(f"depthwise weight {tuple(unit.kernel_q.shape)}, stride "
                         f"{strides}: want ({c}, 1, 3, 3), 1 or 2")
    packed = pack_dw_weight(unit.kernel_q) if unit.packed is None else unit.packed
    return _int8_dwconv_op(x, packed, _rescale(unit).contiguous(), unit.bias, strides,
                           ACTS[act], out_dtype, x_scale=_in_scale(x, unit),
                           out_scale=out_scale, keep=keep)


def int8_dwconv(x_q: torch.Tensor, unit: QConv, strides: int = 1, act: Optional[str] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Depthwise 3x3 int8 conv with the epilogue of ``int8_conv``: x_q (N, H,
    W, C), ``unit.kernel_q`` (C, 1, 3, 3), padding 1, stride 1 or 2. On a
    CUDA tensor one launch of the depthwise kernel; on a CPU tensor the plain
    version."""
    return int8_unit(x_q, unit, strides, x_q.shape[-1], act, out_dtype)[0]


def int8_dense(x_q: torch.Tensor, unit: QConv, act: Optional[str] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 (M, Cin) x (Cout, Cin)^T -> (M, Cout), ``acc * x_scale * w_scale
    + bias`` (JAX's ``int8_dense``): the GEMM op as a 1x1 conv over (M, 1, 1,
    Cin), any M (a batch-1 GRU step has M = 1; a small M splits the depth
    across the SMs, ``plan_int8_conv``): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    m, k = x_q.shape
    return int8_conv(x_q.reshape(m, 1, 1, k), unit, 1, 1, act, out_dtype).reshape(m, -1)


# kernel launches since the last reset; tests and chip_smoke.py read them to
# show that a run went through the CUDA kernels. int8_conv.launches counts
# conv_kernel's launches, one a call (int8_dense's too: it launches the same
# kernel); int8_conv.finish_launches counts split K's second pass
# (splitk_finish), launched after it where the plan cuts the depth
int8_conv.launches = 0
int8_conv.finish_launches = 0
int8_dwconv.launches = 0
