"""Patch visualization — render where the policy looked. A copy of
adafocus_tpu/utils/visualize.py (the port imports nothing of the JAX
package).

Parity with the reference's visualize/save_images renderer
(the reference's sthsth/ops/utils.py:12-110): de-normalize frames, draw
the chosen patch rectangle per frame, tile (video x time) into one image.
PIL-based, host-side; intended for qualitative policy debugging.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# copies of data/transforms.py's constants: the module imports torch,
# and this one stays numpy only
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def denormalize(frames: np.ndarray) -> np.ndarray:
    """Normalized NHWC floats -> uint8 RGB (reference ops/utils.py:84-87)."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    x = frames.astype(np.float32) * std + mean
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def draw_patch_boxes(
    frames: np.ndarray,
    offsets: np.ndarray,
    patch_size: int,
    color: Tuple[int, int, int] = (255, 32, 32),
    width: int = 2,
) -> np.ndarray:
    """Draw the patch rectangle on each frame.

    frames: (N, H, W, 3) uint8; offsets: (N, 2) int (y, x).
    """
    out = frames.copy()
    h, w = frames.shape[1:3]
    p = patch_size
    c = np.asarray(color, np.uint8)
    for i in range(frames.shape[0]):
        y, x = int(offsets[i, 0]), int(offsets[i, 1])
        y2, x2 = min(y + p, h), min(x + p, w)
        out[i, y:y2, x : min(x + width, w)] = c
        out[i, y:y2, max(x2 - width, 0) : x2] = c
        out[i, y : min(y + width, h), x:x2] = c
        out[i, max(y2 - width, 0) : y2, x:x2] = c
    return out


def save_patch_grid(
    path: str,
    frames: np.ndarray,
    offsets: np.ndarray,
    patch_size: int,
    denorm: bool = True,
) -> None:
    """Tile (B, T, H, W, 3) frames with patch boxes into one PNG
    (rows = videos, cols = time), like the reference's save_images."""
    from PIL import Image

    b, t, h, w, _ = frames.shape
    flat = frames.reshape(b * t, h, w, 3)
    if denorm:
        flat = denormalize(flat)
    boxed = draw_patch_boxes(flat, offsets.reshape(b * t, 2), patch_size)
    grid = (
        boxed.reshape(b, t, h, w, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(b * h, t * w, 3)
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)
