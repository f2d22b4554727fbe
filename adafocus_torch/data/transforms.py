"""On-device batched augmentation (counterpart of adafocus_tpu/data/transforms.py).

The host pipeline only decodes JPEGs to a fixed uint8 canvas; every
augmentation runs batched on the device, on tensors:

  * multi-scale crop: one (scale pair, offset, flip) draw per video from the
    reference's discrete grid (scales [1, .875, .75, .66], 13 fixed offsets,
    max_distort pairing), applied to all T frames of the video as one
    resampling: two (out, in) weight matrices per video, one per axis, and
    two batched products;
  * horizontal flip on a per-video mask; normalize (x/255 - mean)/std.

The resampler is JAX's ``scale_and_translate(method="linear")`` with its
default ``antialias=True`` (``compute_weight_mat`` of jax/_src/image/scale.py):
when the crop is larger than the output, the triangle kernel widens by
1/scale; a sample point outside [-0.5, in - 0.5] gets zero weight and the
others are renormalised. ``F.interpolate`` and ``grid_sample`` compute none
of this, so the weights are built here, in float32 as JAX builds them, and
applied with ``torch.einsum``: library products of the work that JAX also
leaves to XLA. ``glance_downsample`` (``jax.image.resize(..., "linear")``)
goes through the same weights with scale out/in and no translation.

The draws come from an explicit ``torch.Generator`` on the device, or are
injected (``draws``) so that tests can replay the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EPS32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    input_size: int = 224          # final H = W fed to the model
    scales: Tuple[float, ...] = (1.0, 0.875, 0.75, 0.66)
    max_distort: int = 1           # max |i - j| between the h/w scale picks
    more_fix_crop: bool = True     # 13 offsets instead of 5
    flip: bool = True              # sth-sth disables flip (label semantics)
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    # test-time crops: 'center', 'oversample' (4 corners + center) or
    # 'full_res' (left/center/right); the non-center modes add a mirrored
    # copy of each crop when ``flip`` is set
    eval_crops: str = "center"


@dataclasses.dataclass(frozen=True)
class AugmentDraws:
    """One video's draws each: the index into ``_crop_pairs`` and into
    ``_offset_grid`` (int64), and the flip (bool); each (B,)."""

    pair: torch.Tensor
    offset: torch.Tensor
    flip: torch.Tensor


def to_device(values, device: torch.device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """A host array or list as a tensor on ``device``. To a GPU it goes
    through pinned memory without blocking: a copy from pageable memory
    would wait for the device's queue first, and the batch prep runs ahead
    of the training step on another thread."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def normalize(images: torch.Tensor, cfg: AugmentConfig,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float [0, 255] channels-last -> normalized ``dtype``."""
    x = images.float() / 255.0
    mean = to_device(cfg.mean, x.device, torch.float32)
    std = to_device(cfg.std, x.device, torch.float32)
    return ((x - mean) / std).to(dtype)


def _crop_pairs(canvas: int, cfg: AugmentConfig) -> np.ndarray:
    """The discrete (crop_h, crop_w) menu: sizes canvas*scale, snapped to
    input_size when within 3 px, paired with |i - j| <= max_distort.
    (P, 2) float32 (h, w)."""
    sizes = []
    for s in cfg.scales:
        v = int(canvas * s)
        sizes.append(cfg.input_size if abs(v - cfg.input_size) < 3 else v)
    pairs = [
        (sizes[i], sizes[j])
        for i in range(len(sizes))
        for j in range(len(sizes))
        if abs(i - j) <= cfg.max_distort
    ]
    return np.asarray(pairs, np.float32)


def _offset_grid(cfg: AugmentConfig) -> np.ndarray:
    """The 13 (or 5) fixed offsets as fractions of (canvas - crop) in
    quarter steps (e.g. center = (2/4, 2/4)). (K, 2) float32 (h, w)."""
    quarters = [(0, 0), (4, 0), (0, 4), (4, 4), (2, 2)]
    if cfg.more_fix_crop:
        quarters += [(0, 2), (4, 2), (2, 4), (2, 0), (1, 1), (3, 1), (1, 3), (3, 3)]
    return np.asarray(quarters, np.float32) / np.float32(4.0)


def resample_weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """JAX's ``compute_weight_mat`` with the triangle kernel and antialiasing,
    batched: float32 1/scale and translation (B,) -> weights (B, out, in),
    so that out[o] = sum_i w[o, i] * in[i]. Output pixel o samples the
    input at (o + 0.5 - t) / s - 0.5; a downscale (s < 1) widens the
    kernel by 1/s."""
    dev = inv_scale.device
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    # XLA contracts (o + 0.5) * inv_scale - t * inv_scale into one fused
    # multiply-add, a single rounding: the float64 product of two float32
    # values is exact, so one subtraction in float64 rounds as the FMA does
    # (a sample point one float32 ulp off moves a weight by ~1e-5)
    centers = torch.arange(out_size, dtype=torch.float64, device=dev) + 0.5
    sample_f = ((centers * inv_scale.double()[:, None]
                 - (translation * inv_scale).double()[:, None]).float() - 0.5)
    x = (sample_f[:, None, :] - torch.arange(in_size, dtype=torch.float32,
                                             device=dev)[None, :, None]).abs()
    weights = torch.clamp(1.0 - (x / kernel_scale[:, None, None]).abs(), min=0.0)
    total = weights.sum(dim=1, keepdim=True)                       # (B, 1, out)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)      # (B, out)
    weights = torch.where(inside[:, None, :], weights, torch.zeros_like(weights))
    return weights.transpose(1, 2)                                 # (B, out, in)


def _resample(videos: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) and per-video weights wh (B, S, H), ww (B, S', W) ->
    (B, T, S, S', C) float32, contiguous: rows, then columns. (``einsum``
    leaves its result in the batched product's layout, rows and columns
    swapped in memory; the backbones and the patch kernel then each pay for
    a copy or a strided read.)"""
    x = torch.einsum("boh,bthwc->btowc", wh, videos)
    return torch.einsum("bpw,btowc->btopc", ww, x).contiguous()


def draw_augment(b: int, canvas: int, cfg: AugmentConfig,
                 generator: torch.Generator, device: torch.device) -> AugmentDraws:
    """B videos' draws from ``generator`` (on ``device``): a crop pair, an
    offset and a flip each, uniform, as the JAX package draws them."""
    n_pairs = len(_crop_pairs(canvas, cfg))
    n_offsets = len(_offset_grid(cfg))
    return AugmentDraws(
        torch.randint(0, n_pairs, (b,), generator=generator, device=device),
        torch.randint(0, n_offsets, (b,), generator=generator, device=device),
        torch.rand((b,), generator=generator, device=device) < 0.5)


def augment_train(videos: torch.Tensor, generator: Optional[torch.Generator],
                  cfg: AugmentConfig, draws: Optional[AugmentDraws] = None
                  ) -> torch.Tensor:
    """(B, T, H, W, C) uint8 canvases -> (B, T, S, S, C) normalized float32.

    One (scale pair, offset, flip) draw per video, shared by its T frames,
    from ``generator`` or given as ``draws``."""
    b, _, h, w, _ = videos.shape
    dev = videos.device
    if draws is None:
        draws = draw_augment(b, h, cfg, generator, dev)
    pair = to_device(_crop_pairs(h, cfg), dev)[draws.pair.to(dev)]  # (B, 2) (h, w)
    frac = to_device(_offset_grid(cfg), dev)[draws.offset.to(dev)]
    # the fixed offsets quantise to quarter steps of the residual span,
    # in float32 as the JAX package computes them
    canvas_hw = to_device([h, w], dev, torch.float32)
    off = torch.floor((canvas_hw - pair) / 4.0) * 4.0 * frac
    # a true float32 division (``int / tensor`` would multiply by the
    # reciprocal, which rounds differently)
    scale = torch.full_like(pair, float(cfg.input_size)) / pair
    translation = -off * scale
    inv_scale = 1.0 / scale
    s = cfg.input_size
    wh = resample_weights(h, s, inv_scale[:, 0], translation[:, 0])
    ww = resample_weights(w, s, inv_scale[:, 1], translation[:, 1])
    out = _resample(videos.float(), wh, ww)
    if cfg.flip:
        out = torch.where(draws.flip.to(dev)[:, None, None, None, None],
                          out.flip(3), out)
    return normalize(out, cfg)


def augment_eval(videos: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """Center crop to input_size + normalize: (B, T, H, W, C) uint8 ->
    (B, T, S, S, C) float32."""
    h, w = videos.shape[2], videos.shape[3]
    s = cfg.input_size
    y0, x0 = (h - s) // 2, (w - s) // 2
    return normalize(videos[:, :, y0:y0 + s, x0:x0 + s, :], cfg)


def eval_crop_offsets(h: int, w: int, s: int, mode: str):
    """Static (y0, x0) anchors of the test-time crops. 'oversample': 4
    corners + center; 'full_res': left/right/center at the vertical
    midline; 'center': the center crop. Quarter steps of the residual
    span, as the reference computes them."""
    h_step, w_step = (h - s) // 4, (w - s) // 4
    if mode == "center":
        return [((h - s) // 2, (w - s) // 2)]
    if mode == "oversample":
        quarters = [(0, 0), (0, 4), (4, 0), (4, 4), (2, 2)]
    elif mode == "full_res":
        quarters = [(2, 0), (2, 4), (2, 2)]
    else:
        raise ValueError(f"unknown eval_crops mode {mode!r}")
    return [(hq * h_step, wq * w_step) for hq, wq in quarters]


def num_eval_views(cfg: AugmentConfig) -> int:
    """How many test-time views ``augment_eval_views`` produces."""
    n = len(eval_crop_offsets(8, 8, 0, cfg.eval_crops))
    return n * 2 if (cfg.flip and cfg.eval_crops != "center") else n


def augment_eval_views(videos: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """(B, T, H, W, C) uint8 canvases -> (B, V, T, S, S, C) normalized
    float32: the test-time crops of ``cfg.eval_crops``, each followed by its
    mirror when ``flip`` is set (not for 'center')."""
    s = cfg.input_size
    views = []
    for y0, x0 in eval_crop_offsets(videos.shape[2], videos.shape[3], s, cfg.eval_crops):
        crop = videos[:, :, y0:y0 + s, x0:x0 + s, :]
        views.append(crop)
        if cfg.flip and cfg.eval_crops != "center":
            views.append(crop.flip(3))
    return normalize(torch.stack(views, dim=1), cfg)


def glance_downsample(frames: torch.Tensor, glance_size: int) -> torch.Tensor:
    """(..., S, S, C) -> (..., g, g, C): ``jax.image.resize(..., "linear")``,
    antialiased when it shrinks; the identity when g = S (the reference's
    published 224^2 glance)."""
    *lead, h, w, c = frames.shape
    if (h, w) == (glance_size, glance_size):
        return frames
    x = frames.float().reshape(1, -1, h, w, c)
    dev = frames.device
    zero = torch.zeros(1, device=dev)
    # jax.image.resize takes scale = out / in as a Python float and
    # samples with its reciprocal rounded to float32; an axis whose size
    # stays is left as it is
    weights = []
    for n in (h, w):
        inv = to_device([1.0 / (glance_size / n)], dev, torch.float32)
        weights.append(resample_weights(n, glance_size, inv, zero)
                       if n != glance_size else torch.eye(n, device=dev)[None])
    out = _resample(x, *weights)
    return out.reshape(*lead, glance_size, glance_size, c).to(frames.dtype)
