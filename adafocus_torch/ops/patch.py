"""Batched dynamic patch extraction (counterpart of adafocus_tpu/ops/patch.py).

The contract is the JAX package's ``extract_patches_slice`` over unpadded
frames: ``out[n] = frames[n, y:y+P, x:x+P, :]`` for (N, H, W, C) frames and
(N, 2) int32 (y, x) offsets, each start handled as ``lax.dynamic_slice``
handles it: a negative start counts from the end (``start + dim``), then the
start is clamped so that the window fits. The TPU kernel's lane-padded layout, its
multiple-of-8 rules and its grid chunking are Mosaic constraints and are
not carried over: the CUDA kernel takes any H, W, P and C.

``extract_patches`` launches the CUDA kernel (``csrc/patch_extract.cu``)
for a CUDA tensor and runs the plain version for a CPU tensor. There is no
backward yet; the JAX VJP is a scatter and comes with the training slice.
"""

from __future__ import annotations

import torch

from adafocus_torch.ops import _kernels

# element sizes (bytes) the kernel copies; the copy is bitwise, so any dtype
# of these widths works (bf16, f16, f32, int8, uint8, ...)
_ELEMENT_SIZES = (1, 2, 4)


def patch_offsets(actions: torch.Tensor, image_size: int, patch_size: int
                  ) -> torch.Tensor:
    """[0, 1]^2 actions (..., 2) ordered (y, x) -> int32 offsets in [0, S - P].

    ``floor(a * (S - P))`` in float32, so a = 1.0 maps to S - P.
    """
    span = image_size - patch_size
    offs = torch.floor(actions.to(torch.float32) * span).to(torch.int32)
    return offs.clamp(0, span)


def extract_patches_reference(frames: torch.Tensor, offsets: torch.Tensor,
                              patch_size: int) -> torch.Tensor:
    """Plain PyTorch version, by advanced indexing.

    frames (N, H, W, C), offsets (N, 2) integer (y, x) -> (N, P, P, C).
    """
    n, h, w, _ = frames.shape
    p = patch_size
    offsets = offsets.to(device=frames.device, dtype=torch.long)
    y, x = offsets[:, 0], offsets[:, 1]
    y = torch.where(y < 0, y + h, y).clamp(0, h - p)
    x = torch.where(x < 0, x + w, x).clamp(0, w - p)
    ar = torch.arange(p, device=frames.device)
    rows = (y[:, None] + ar)[:, :, None]
    cols = (x[:, None] + ar)[:, None, :]
    batch = torch.arange(n, device=frames.device)[:, None, None]
    return frames[batch, rows, cols]


def _check_kernel_args(frames: torch.Tensor, offsets: torch.Tensor,
                       patch_size: int) -> None:
    if frames.dim() != 4:
        raise ValueError(f"frames must be (N, H, W, C), got {tuple(frames.shape)}")
    n, h, w, _ = frames.shape
    if not 1 <= patch_size <= min(h, w):
        raise ValueError(f"patch size {patch_size} does not fit frames {h}x{w}")
    if frames.element_size() not in _ELEMENT_SIZES or frames.is_complex():
        raise TypeError(f"unsupported frame dtype {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (n, 2):
        raise ValueError(
            f"offsets must be int32 of shape ({n}, 2), got "
            f"{offsets.dtype} {tuple(offsets.shape)}"
        )
    if offsets.device != frames.device or not offsets.is_contiguous():
        raise ValueError("offsets must be contiguous and on the frames' device")


def extract_patches(frames: torch.Tensor, offsets: torch.Tensor,
                    patch_size: int) -> torch.Tensor:
    """Extract (P, P) patches at per-sample offsets: (N, H, W, C) -> (N, P, P, C).

    On a CUDA tensor this always launches the CUDA kernel (and raises if it
    cannot be built or launched); on a CPU tensor it runs
    ``extract_patches_reference``.
    """
    if frames.device.type == "cpu":
        return extract_patches_reference(frames, offsets, patch_size)
    if frames.device.type != "cuda":
        raise ValueError(f"no patch-extraction kernel for device {frames.device}")
    _check_kernel_args(frames, offsets, patch_size)
    lib = _kernels.load("patch_extract")
    n, h, w, c = frames.shape
    out = torch.empty((n, patch_size, patch_size, c), dtype=frames.dtype,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.patch_extract(
            frames.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, h, w, c,
            patch_size, frames.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"patch_extract launch failed: CUDA error {err}")
    extract_patches.launches += 1
    return out


# kernel launches since the last reset; tests and chip_smoke.py read it to
# show that a run went through the CUDA kernel
extract_patches.launches = 0
