"""Temporal Shift Module (counterpart of adafocus_tpu/models/tsm.py).

Plain PyTorch, as it is plain XLA in the JAX package: a shift is a few
slice copies, no kernel. The output is channels-last (N, H, W, C)
contiguous memory, so that the backbones, which run on NCHW views of
channels-last memory, keep cuDNN's layout across every shifted block.
"""

from __future__ import annotations

import torch


def temporal_shift(x: torch.Tensor, n_frames: int, shift_div: int = 8) -> torch.Tensor:
    """Shift channel groups across time.

    x: (B*T, H, W, C) frame features, T = ``n_frames`` consecutive frames a
    clip. Returns (B*T, H, W, C) contiguous: channels [0, C/div) hold frame
    t+1's, [C/div, 2C/div) frame t-1's, zeros at the clip boundaries; the
    rest is unchanged.
    """
    bt, h, w, c = x.shape
    if bt % n_frames != 0:
        raise ValueError(f"batch*time={bt} not divisible by n_frames={n_frames}")
    fold = c // shift_div
    xt = x.reshape(bt // n_frames, n_frames, h, w, c)
    out = torch.empty(xt.shape, dtype=x.dtype, device=x.device)
    out[:, :-1, ..., :fold] = xt[:, 1:, ..., :fold]          # out[t] = in[t + 1]
    out[:, -1, ..., :fold].zero_()   # (a stored Python 0 would be a CPU constant when exported)
    out[:, 1:, ..., fold:2 * fold] = xt[:, :-1, ..., fold:2 * fold]   # out[t] = in[t - 1]
    out[:, 0, ..., fold:2 * fold].zero_()
    out[..., 2 * fold:] = xt[..., 2 * fold:]
    return out.reshape(bt, h, w, c)


def temporal_shift_nchw(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """``temporal_shift`` of an (N, C, H, W) tensor, returned as an NCHW view
    of channels-last memory (free when ``x`` is channels-last already)."""
    return temporal_shift(x.permute(0, 2, 3, 1), n_frames).permute(0, 3, 1, 2)
