"""A copy of adafocus_tpu/data/sampling.py (the port imports nothing of
the JAX package).

TSN segment sampling — pure numpy index math.

Parity with the reference samplers (the reference
actnet/ops/dataset.py:115-173 and sthsth/ops/dataset.py:108-199): train =
one random frame per uniform segment; val = segment centers; test = centers,
'twice' (centers + segment starts), or 'dense' (10 sliding 64-frame clips).
All functions return 1-based frame indices like the reference (frame files
are 1-indexed on disk).

Unlike the reference — which buries these in Dataset methods using global
numpy RNG — they are standalone functions taking an explicit
``np.random.Generator`` so sampling is seedable per worker and testable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _train_indices(
    num_frames: int, num_segments: int, rng: np.random.Generator
) -> np.ndarray:
    """Random position within each of ``num_segments`` uniform segments
    (dataset.py:128-136)."""
    avg = num_frames // num_segments
    if avg > 0:
        offsets = np.arange(num_segments) * avg + rng.integers(avg, size=num_segments)
    elif num_frames > num_segments:
        offsets = np.sort(rng.integers(num_frames, size=num_segments))
    else:
        offsets = np.concatenate([
            np.arange(num_frames),
            np.full(num_segments - num_frames, num_frames - 1),
        ])
    return offsets + 1


def _center_indices(num_frames: int, num_segments: int) -> np.ndarray:
    """Center of each uniform segment (dataset.py:144-152)."""
    if num_frames > num_segments:
        tick = num_frames / float(num_segments)
        offsets = (tick / 2.0 + tick * np.arange(num_segments)).astype(np.int64)
    else:
        offsets = np.concatenate([
            np.arange(num_frames),
            np.full(num_segments - num_frames, num_frames - 1),
        ])
    return offsets + 1


def _dense_indices(
    num_frames: int,
    num_segments: int,
    rng: Optional[np.random.Generator],
    num_clips: int = 10,
) -> np.ndarray:
    """I3D-style dense sampling (dataset.py:121-126,155-161): 64-frame
    windows at stride 64//num_segments, wrapped modulo the video length.
    With an rng -> one random window (train/val); without -> ``num_clips``
    evenly spaced windows concatenated (test)."""
    sample_pos = max(1, 1 + num_frames - 64)
    t_stride = 64 // num_segments
    base = np.arange(num_segments) * t_stride
    if rng is not None:
        start = 0 if sample_pos == 1 else int(rng.integers(sample_pos - 1))
        return (base + start) % num_frames + 1
    starts = np.linspace(0, sample_pos - 1, num=num_clips, dtype=np.int64)
    return np.concatenate([(base + s) % num_frames for s in starts]) + 1


def sample_segment_indices(
    num_frames: int,
    num_segments: int,
    mode: str = "train",
    rng: Optional[np.random.Generator] = None,
    dense: bool = False,
    twice: bool = False,
) -> np.ndarray:
    """1-based frame indices for one video.

    mode: 'train' (random-in-segment), 'val' (centers), 'test' (centers, or
    twice = centers + starts, or dense = 10 clips).
    """
    if dense:
        return _dense_indices(
            num_frames, num_segments, rng if mode != "test" else None
        )
    if mode == "train":
        if rng is None:
            raise ValueError("train sampling needs an rng")
        return _train_indices(num_frames, num_segments, rng)
    if mode == "test" and twice:
        tick = num_frames / float(num_segments)
        centers = (tick / 2.0 + tick * np.arange(num_segments)).astype(np.int64)
        starts = (tick * np.arange(num_segments)).astype(np.int64)
        return np.concatenate([centers, starts]) + 1
    return _center_indices(num_frames, num_segments)


def sample_dual_rate(
    num_frames: int,
    num_segments_glancer: int,
    num_segments_focuser: int,
    mode: str = "train",
    rng: Optional[np.random.Generator] = None,
    dense: bool = False,
    twice: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two independent segment sets per video — the sth-sth dual-rate
    sampling (sthsth/ops/dataset.py:108-199, e.g. 8 glancer + 12 focuser
    frames)."""
    g = sample_segment_indices(num_frames, num_segments_glancer, mode, rng, dense, twice)
    f = sample_segment_indices(num_frames, num_segments_focuser, mode, rng, dense, twice)
    return g, f
