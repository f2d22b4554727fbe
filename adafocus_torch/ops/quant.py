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

The plain versions: the product in float64 (exact, every partial sum is an
integer below 2^53), the accumulator rounded to float32, and the epilogue
as a float64 multiply-add rounded once to float32. XLA:CPU contracts JAX's
``acc * rescale + bias`` into one fused multiply-add and the kernels use
``__fmaf_rn``; the float64 emulation equals a true FMA except where the
float64 sum itself rounds onto a float32 tie (double rounding, at most one
float32 ulp). Rounding is half to even everywhere (``torch.round``, as
``jnp.round``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from adafocus_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from adafocus_torch.ops import _kernels

# the GEMM kernel's tile (csrc/int8_conv.cu BM, BN, BK): the packed weight's
# rows are padded to a multiple of TILE_N, its depth to a multiple of TILE_K
TILE_N, TILE_K = 64, 64
ACTS = {None: 0, "relu": 1, "relu6": 2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


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


def pack_conv_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """The GEMM kernel's weight: (Cout, Cin, kh, kw) or (Cout, Cin) int8 ->
    (Cout_pad, K_pad) int8, row c the tap-major depth (ky, kx, ci) of output
    channel c, zero-padded to the kernel's tile."""
    cout = kernel_q.shape[0]
    w = kernel_q.permute(0, 2, 3, 1) if kernel_q.dim() == 4 else kernel_q
    w = w.reshape(cout, -1)
    k = w.shape[1]
    out = torch.zeros((-(-cout // TILE_N) * TILE_N, -(-k // TILE_K) * TILE_K),
                      dtype=torch.int8, device=kernel_q.device)
    out[:cout, :k] = w
    return out


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
    """``pack_conv_weight``'s inverse: (Cout_pad, K_pad) -> (Cout, Cin, kh,
    kh) int8 (a view)."""
    return packed[:cout, :kh * kh * cin].reshape(cout, kh, kh, cin).permute(0, 3, 1, 2)


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


# ---------------------------------------------------------------------------
# The kernels as torch.library custom ops.
# ---------------------------------------------------------------------------
#
# Each op takes tensors and primitive arguments only: the int8 input, the
# packed weight, the rescale, the bias, the geometry, the activation code
# (``ACTS``) and the output dtype. Its CUDA implementation launches the
# kernel, reading every pointer there, never while a trace runs; its CPU
# implementation is the plain version on the weight unpacked from the same
# packed form; its fake implementation gives the output's shape and dtype,
# so that ``torch.export`` traces the int8 serving forward through them.


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


@torch.library.custom_op("adafocus_torch::int8_conv", mutates_args=(), device_types="cpu")
def _int8_conv_op(x_q: torch.Tensor, packed: torch.Tensor, rescale: torch.Tensor,
                  bias: torch.Tensor, kh: int, stride: int, act: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """x_q (N, H, W, Cin) int8, packed (Cout_pad, K_pad) -> (N, Ho, Wo, Cout)."""
    w = unpack_conv_weight(packed, bias.shape[0], kh, x_q.shape[-1])
    return epilogue_reference(conv_acc_reference(x_q, w, stride), rescale, bias,
                              _ACT_OF_CODE[act], out_dtype)


@_int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(x_q, packed, rescale, bias, kh, stride, act, out_dtype):
    n, h, w, cin = x_q.shape
    cout = bias.shape[0]
    ho, wo = _conv_out(x_q, kh, stride)
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x_q.device)
    vec = int(cin % 16 == 0 and x_q.data_ptr() % 16 == 0)
    err = _on_device(x_q.device, _kernels.load("int8_conv").int8_conv, x_q.data_ptr(),
                     packed.data_ptr(), rescale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), n * ho * wo, h, w, cin, ho, wo, cout, kh * kh * cin,
                     packed.shape[1], packed.shape[0], kh, stride, (kh - 1) // 2, act, vec,
                     _OUT_KINDS[out_dtype])
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: CUDA error {err}")
    int8_conv.launches += 1
    return out


@_int8_conv_op.register_fake
def _int8_conv_fake(x_q, packed, rescale, bias, kh, stride, act, out_dtype):
    return x_q.new_empty((x_q.shape[0],) + _conv_out(x_q, kh, stride) + (bias.shape[0],),
                         dtype=out_dtype)


@torch.library.custom_op("adafocus_torch::int8_dwconv", mutates_args=(), device_types="cpu")
def _int8_dwconv_op(x_q: torch.Tensor, packed: torch.Tensor, rescale: torch.Tensor,
                    bias: torch.Tensor, stride: int, act: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """x_q (N, H, W, C) int8, packed (9, C) -> (N, Ho, Wo, C)."""
    acc = conv_acc_reference(x_q, unpack_dw_weight(packed), stride, groups=x_q.shape[-1])
    return epilogue_reference(acc, rescale, bias, _ACT_OF_CODE[act], out_dtype)


@_int8_dwconv_op.register_kernel("cuda")
def _int8_dwconv_cuda(x_q, packed, rescale, bias, stride, act, out_dtype):
    n, h, w, c = x_q.shape
    ho, wo = _conv_out(x_q, 3, stride)
    out = torch.empty((n, ho, wo, c), dtype=out_dtype, device=x_q.device)
    vec = int(c % 16 == 0 and x_q.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0)
    err = _on_device(x_q.device, _kernels.load("int8_conv").int8_dwconv, x_q.data_ptr(),
                     packed.data_ptr(), rescale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), n, h, w, c, ho, wo, stride, act, vec,
                     _OUT_KINDS[out_dtype])
    if err != 0:
        raise RuntimeError(f"int8_dwconv launch failed: CUDA error {err}")
    int8_dwconv.launches += 1
    return out


@_int8_dwconv_op.register_fake
def _int8_dwconv_fake(x_q, packed, rescale, bias, stride, act, out_dtype):
    return x_q.new_empty((x_q.shape[0],) + _conv_out(x_q, 3, stride) + (x_q.shape[3],),
                         dtype=out_dtype)


# ---------------------------------------------------------------------------
# The kernels' wrappers.
# ---------------------------------------------------------------------------


def _check(x_q: torch.Tensor, unit: QConv, out_dtype) -> None:
    if x_q.device.type != "cuda":
        raise ValueError(f"no int8 kernel for device {x_q.device}")
    if x_q.dtype != torch.int8 or x_q.dim() != 4 or not x_q.is_contiguous():
        raise ValueError(f"x_q must be contiguous int8 (N, H, W, C), got {x_q.dtype} "
                         f"{tuple(x_q.shape)}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    for name in ("w_scale", "bias"):
        t = getattr(unit, name)
        if t.device != x_q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x_q.device}")


def int8_conv(x_q: torch.Tensor, unit: QConv, strides: int = 1, groups: int = 1,
              act: Optional[str] = None, out_dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """int8 conv with its epilogue: x_q (N, H, W, Cin) int8 quantized with
    ``unit.x_scale`` -> (N, Ho, Wo, Cout) in ``out_dtype``,
    ``act(acc * x_scale * w_scale + bias)`` (JAX's ``int8_conv`` is the
    default, no activation and float32). Padding (kh - 1) // 2; kh = kw in
    {1, 3}; ``groups`` 1, or the channel count (depthwise 3x3,
    ``int8_dwconv``). On a CUDA tensor one launch of the GEMM kernel (or of
    the depthwise one); on a CPU tensor the plain version."""
    if groups != 1:
        if groups != x_q.shape[-1] or unit.kernel_q.shape[:2] != (groups, 1):
            raise ValueError(f"groups={groups}: only a depthwise conv is supported")
        return int8_dwconv(x_q, unit, strides, act, out_dtype)
    return _conv(x_q, unit, strides, act, out_dtype)


def _conv(x_q, unit: QConv, strides, act, out_dtype) -> torch.Tensor:
    """The GEMM op on ``unit``'s packed weight (packed now when ``unit`` was
    not prepared), after the kernel's checks on a CUDA tensor."""
    wq = unit.kernel_q
    cin = x_q.shape[-1]
    kh = wq.shape[2] if wq.dim() == 4 else 1
    packed = pack_conv_weight(wq) if unit.packed is None else unit.packed
    if x_q.device.type != "cpu":
        _check(x_q, unit, out_dtype)
        if wq.dim() == 4 and (wq.shape[1] != cin or wq.shape[3] != kh or kh not in (1, 3)):
            raise ValueError(f"weight {tuple(wq.shape)} does not fit input channels {cin}")
        if wq.dim() == 2 and wq.shape[1] != cin:
            raise ValueError(f"dense weight {tuple(wq.shape)} does not fit depth {cin}")
        if strides not in (1, 2):
            raise ValueError(f"stride {strides}: 1 or 2")
        cout, k = wq.shape[0], kh * kh * cin
        if packed.shape[0] < cout or packed.shape[1] < k or packed.shape[1] % TILE_K:
            raise ValueError(f"packed weight {tuple(packed.shape)} does not fit ({cout}, {k})")
    return _int8_conv_op(x_q, packed, _rescale(unit).contiguous(), unit.bias, kh, strides,
                         ACTS[act], out_dtype)


def int8_dwconv(x_q: torch.Tensor, unit: QConv, strides: int = 1, act: Optional[str] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Depthwise 3x3 int8 conv with the epilogue of ``int8_conv``: x_q (N, H,
    W, C), ``unit.kernel_q`` (C, 1, 3, 3), padding 1, stride 1 or 2. On a
    CUDA tensor one launch of the depthwise kernel; on a CPU tensor the plain
    version."""
    c = x_q.shape[-1]
    if x_q.device.type != "cpu":
        _check(x_q, unit, out_dtype)
        if tuple(unit.kernel_q.shape) != (c, 1, 3, 3) or strides not in (1, 2):
            raise ValueError(f"depthwise weight {tuple(unit.kernel_q.shape)}, stride "
                             f"{strides}: want ({c}, 1, 3, 3), 1 or 2")
    packed = pack_dw_weight(unit.kernel_q) if unit.packed is None else unit.packed
    return _int8_dwconv_op(x_q, packed, _rescale(unit).contiguous(), unit.bias, strides,
                           ACTS[act], out_dtype)


def int8_dense(x_q: torch.Tensor, unit: QConv, act: Optional[str] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 (M, Cin) x (Cout, Cin)^T -> (M, Cout), ``acc * x_scale * w_scale
    + bias`` (JAX's ``int8_dense``): the GEMM op as a 1x1 conv over (M, 1, 1,
    Cin), any M (a batch-1 GRU step has M = 1): the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    m, k = x_q.shape
    return _conv(x_q.reshape(m, 1, 1, k), unit, 1, act, out_dtype).reshape(m, -1)


# kernel launches since the last reset; tests and chip_smoke.py read them to
# show that a run went through the CUDA kernels (int8_dense counts as
# int8_conv: it launches the same kernel)
int8_conv.launches = 0
int8_dwconv.launches = 0
