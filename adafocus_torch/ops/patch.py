"""Batched dynamic patch extraction (counterpart of adafocus_tpu/ops/patch.py).

The contract is the JAX package's ``extract_patches_slice`` over unpadded
frames: ``out[n] = frames[n, y:y+P, x:x+P, :]`` for (N, H, W, C) frames and
(N, 2) int32 (y, x) offsets, each start handled as ``lax.dynamic_slice``
handles it: a negative start counts from the end (``start + dim``), then the
start is clamped so that the window fits. The TPU kernel's lane-padded layout, its
multiple-of-8 rules and its grid chunking are Mosaic constraints and are
not carried over: the CUDA kernel takes any H, W, P and C.

``extract_patches`` launches the CUDA kernel (``csrc/patch_extract.cu``)
for a CUDA tensor and runs the plain version for a CPU tensor.
``extract_patches_at`` does the same from [0, 1] actions, with
``patch_offsets`` computed inside the kernel. The kernel copies 16-byte
words over a grid of row bands, which ``plan_patch_extract`` sizes. Both
reach it through ``torch.library`` custom ops
(``adafocus_torch::extract_patches``, ``adafocus_torch::extract_patches_at``),
so that ``torch.export`` traces the serving forward through them and a
reloaded artifact launches the kernel (``serving.py``).

Both are differentiable with respect to the frames when a gradient is asked
for (each op's registered autograd). The backward is the JAX package's VJP
``_extract_bwd``: each patch's cotangent goes into a zero frame at its
window. That VJP is an XLA scatter, not a Pallas kernel, so here it is
plain PyTorch (advanced indexing into ``zeros``) on every device; it is no
library stand-in for a TPU kernel. The training steps never ask for it, since
frames are inputs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from adafocus_torch.ops import _kernels

# element sizes (bytes) the kernel copies; the copy is bitwise, so any dtype
# of these widths works (bf16, f16, f32, int8, uint8, ...)
_ELEMENT_SIZES = (1, 2, 4)

SM_COUNT = 132                 # H100 SXM
# 256 threads a block, a grid of BLOCKS_PER_SM blocks an SM (8 resident at a
# time): 16 was faster than 8 on an H100 (PERF.md)
BLOCKS_PER_SM = 16
# an item (one band of one patch) moves at most STAGE_CAP bytes each way;
# at least MIN_ITEMS_PER_SM items an SM exist, so that at N=16 every SM
# still has two
STAGE_CAP = 16 * 1024
MIN_ITEMS_PER_SM = 2


class PatchPlan(NamedTuple):
    """How one call is split: ``rows`` a band (R), ``bands`` a patch
    (ceil(P / R)) and ``grid`` blocks."""

    rows: int
    bands: int
    grid: int


@functools.lru_cache(maxsize=256)
def plan_patch_extract(n: int, p: int, c: int, elem_size: int,
                       sms: int = SM_COUNT) -> PatchPlan:
    """The work split for extracting N (P, P) patches of C channels of
    ``elem_size``-byte elements: the tallest band of at most ``STAGE_CAP``
    bytes that still cuts the N patches into ``MIN_ITEMS_PER_SM`` items an
    SM or more (one-row bands where none does), and a grid of at most
    ``BLOCKS_PER_SM`` blocks an SM striding over the items."""
    row_bytes = p * c * elem_size
    rmax = max(1, min(p, STAGE_CAP // row_bytes))
    rows, bands = 1, p
    for b in range(-(-p // rmax), p + 1):
        r = -(-p // b)
        if -(-p // r) == b and n * b >= MIN_ITEMS_PER_SM * sms:
            rows, bands = r, b
            break
    return PatchPlan(rows, bands, max(1, min(n * bands, BLOCKS_PER_SM * sms)))


def patch_offsets(actions: torch.Tensor, image_size: int, patch_size: int
                  ) -> torch.Tensor:
    """[0, 1]^2 actions (..., 2) ordered (y, x) -> int32 offsets in [0, S - P].

    ``floor(a * (S - P))`` in float32, so a = 1.0 maps to S - P.
    """
    span = image_size - patch_size
    offs = torch.floor(actions.to(torch.float32) * span).to(torch.int32)
    return offs.clamp(0, span)


def random_patch_actions(shape: Tuple[int, ...], generator: torch.Generator,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """Uniform random patch actions in [0, 1), (*shape, 2) float32, the
    stage-1 random-patch baseline, drawn from ``generator`` on ``device``
    (the generator's device when None)."""
    return torch.rand(tuple(shape) + (2,), generator=generator,
                      device=generator.device if device is None else device)


def _windows(shape: torch.Size, offsets: torch.Tensor, patch_size: int):
    """Index tensors (batch, rows, cols) of the (P, P) window of each of the
    N frames of ``shape`` (N, H, W, C) at ``offsets`` (N, 2), each start
    handled as ``lax.dynamic_slice`` handles it."""
    n, h, w, _ = shape
    p = patch_size
    offsets = offsets.to(torch.long)
    y, x = offsets[:, 0], offsets[:, 1]
    y = torch.where(y < 0, y + h, y).clamp(0, h - p)
    x = torch.where(x < 0, x + w, x).clamp(0, w - p)
    ar = torch.arange(p, device=offsets.device)
    rows = (y[:, None] + ar)[:, :, None]
    cols = (x[:, None] + ar)[:, None, :]
    batch = torch.arange(n, device=offsets.device)[:, None, None]
    return batch, rows, cols


def extract_patches_reference(frames: torch.Tensor, offsets: torch.Tensor,
                              patch_size: int) -> torch.Tensor:
    """Plain PyTorch version, by advanced indexing.

    frames (N, H, W, C), offsets (N, 2) integer (y, x) -> (N, P, P, C).
    """
    return frames[_windows(frames.shape, offsets.to(frames.device), patch_size)]


def scatter_patches(grad: torch.Tensor, offsets: torch.Tensor, shape: torch.Size,
                    dtype: torch.dtype) -> torch.Tensor:
    """The VJP of extraction (JAX ``_extract_bwd``): patch cotangents (N, P,
    P, C) into zero frames of ``shape`` (N, H, W, C) and ``dtype``, each at
    its window. A sample's window covers distinct pixels, so nothing is
    accumulated and the result is exact on every device."""
    out = torch.zeros(shape, dtype=dtype, device=grad.device)
    out[_windows(shape, offsets.to(grad.device), grad.shape[1])] = grad.to(dtype)
    return out


def _check_frames(frames: torch.Tensor, patch_size: int) -> None:
    if frames.device.type != "cuda":
        raise ValueError(f"no patch-extraction kernel for device {frames.device}")
    if frames.dim() != 4:
        raise ValueError(f"frames must be (N, H, W, C), got {tuple(frames.shape)}")
    _, h, w, _ = frames.shape
    if not 1 <= patch_size <= min(h, w):
        raise ValueError(f"patch size {patch_size} does not fit frames {h}x{w}")
    if frames.element_size() not in _ELEMENT_SIZES or frames.is_complex():
        raise TypeError(f"unsupported frame dtype {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")


def _check_offsets(frames: torch.Tensor, offsets: torch.Tensor) -> None:
    n = frames.shape[0]
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (n, 2):
        raise ValueError(
            f"offsets must be int32 of shape ({n}, 2), got "
            f"{offsets.dtype} {tuple(offsets.shape)}"
        )
    if offsets.device != frames.device or not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous and on the frames' device")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_launcher = None


def _launch(frames: torch.Tensor, patch_size: int, offsets: Optional[torch.Tensor] = None,
            actions: Optional[torch.Tensor] = None, span: int = 0) -> torch.Tensor:
    """One launch of the kernel from ``offsets`` ((N, 2) int32) or from
    ``actions`` ((B, T, 2) float32, any strides, with ``span`` = S - P).
    Every pointer, the SM count and the stream are read here, inside the
    custom op's CUDA implementation, never while a trace runs."""
    global _launcher
    if _launcher is None:
        _launcher = _kernels.load("patch_extract").patch_extract
    n, h, w, c = frames.shape
    elem = frames.element_size()
    dev = frames.device
    plan = plan_patch_extract(n, patch_size, c, elem, sms=_sm_count(dev.index))
    out = torch.empty((n, patch_size, patch_size, c), dtype=frames.dtype, device=dev)
    if actions is None:
        act_ptr, t, strides = None, 1, (0, 0, 0)
    else:
        act_ptr, t, strides = actions.data_ptr(), actions.shape[1], actions.stride()
    args = (frames.data_ptr(), None if offsets is None else offsets.data_ptr(), act_ptr,
            out.data_ptr(), n, h, w, c, patch_size, elem, span, t, *strides,
            plan.rows, plan.grid)
    if dev.index == torch.cuda.current_device():
        err = _launcher(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = _launcher(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"patch_extract launch failed ({plan}): CUDA error {err}")
    extract_patches.launches += 1
    return out


# The kernel as two ``torch.library`` custom ops, from explicit offsets and
# from actions, so that ``torch.export`` traces them (a fake tensor has no
# ``data_ptr``) and a reloaded artifact launches the kernel. Each op has the
# kernel as its CUDA implementation, the plain version as its CPU one, a
# fake implementation (shapes only) and the scatter VJP as its autograd.
# An op is registered once, when this module is first imported.


@torch.library.custom_op("adafocus_torch::extract_patches", mutates_args=(),
                         device_types="cpu")
def _patches_op(frames: torch.Tensor, offsets: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, C) frames at (N, 2) integer offsets -> (N, P, P, C)."""
    return extract_patches_reference(frames, offsets, patch_size)


@_patches_op.register_kernel("cuda")
def _patches_cuda(frames, offsets, patch_size):
    return _launch(frames, patch_size, offsets=offsets)


@torch.library.custom_op("adafocus_torch::extract_patches_at", mutates_args=(),
                         device_types="cpu")
def _patches_at_op(frames: torch.Tensor, actions: torch.Tensor, image_size: int,
                   patch_size: int) -> torch.Tensor:
    """(N, H, W, C) frames at ``patch_offsets`` of (B, T, 2) actions, B*T =
    N -> (N, P, P, C)."""
    offsets = patch_offsets(actions.reshape(-1, 2), image_size, patch_size)
    return extract_patches_reference(frames, offsets, patch_size)


@_patches_at_op.register_kernel("cuda")
def _patches_at_cuda(frames, actions, image_size, patch_size):
    return _launch(frames, patch_size, actions=actions.to(torch.float32),
                   span=image_size - patch_size)


@_patches_op.register_fake
def _patches_fake(frames, offsets, patch_size):
    return frames.new_empty((frames.shape[0], patch_size, patch_size, frames.shape[3]))


@_patches_at_op.register_fake
def _patches_at_fake(frames, actions, image_size, patch_size):
    return _patches_fake(frames, None, patch_size)


def _setup_context(ctx, inputs, output):
    """Saves the offsets (or the actions they come from) and the frames'
    shape and dtype, never the frames: the frames are an input, so keeping
    them would only hold memory."""
    frames, where = inputs[:2]
    ctx.save_for_backward(where)
    ctx.sizes = tuple(inputs[2:])   # (P,) from offsets, (S, P) from actions
    ctx.frames = (frames.shape, frames.dtype)


def _backward(ctx, grad):
    (where,) = ctx.saved_tensors
    if len(ctx.sizes) == 2:
        where = patch_offsets(where.reshape(-1, 2), *ctx.sizes)
    return (scatter_patches(grad, where, *ctx.frames),) + (None,) * (1 + len(ctx.sizes))


_patches_op.register_autograd(_backward, setup_context=_setup_context)
_patches_at_op.register_autograd(_backward, setup_context=_setup_context)


def extract_patches(frames: torch.Tensor, offsets: torch.Tensor,
                    patch_size: int) -> torch.Tensor:
    """Extract (P, P) patches at per-sample offsets: (N, H, W, C) -> (N, P, P, C).

    On a CUDA tensor this always launches the CUDA kernel (and raises if it
    cannot be built or launched); on a CPU tensor it runs
    ``extract_patches_reference``. Differentiable with respect to
    ``frames``.
    """
    if frames.device.type != "cpu":
        _check_frames(frames, patch_size)
        _check_offsets(frames, offsets)
    return _patches_op(frames, offsets, patch_size)


# kernel launches since the last reset; tests and chip_smoke.py read it to
# show that a run went through the CUDA kernel
extract_patches.launches = 0


def extract_patches_at(frames: torch.Tensor, actions: torch.Tensor, image_size: int,
                       patch_size: int) -> torch.Tensor:
    """(B, T, H, W, C) frames and (B, T, 2) [0, 1] actions -> (B*T, P, P, C):
    ``extract_patches(frames.reshape(B*T, ...), patch_offsets(actions,
    image_size, patch_size), patch_size)``.

    On a CUDA tensor one kernel launch computes the offsets and the patches,
    reading the actions where they lie; on a CPU tensor it runs the two
    plain steps. Differentiable with respect to ``frames``.
    """
    b, t = frames.shape[:2]
    flat = frames.reshape((b * t,) + frames.shape[2:])
    if frames.device.type != "cpu":
        _check_frames(flat, patch_size)
        if tuple(actions.shape) != (b, t, 2) or actions.device != frames.device:
            raise ValueError(f"actions must be ({b}, {t}, 2) on the frames' device, got "
                             f"{tuple(actions.shape)} on {actions.device}")
    return _patches_at_op(flat, actions, image_size, patch_size)
