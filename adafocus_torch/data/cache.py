"""In-memory dataset caching: decode once, train from RAM or from the card
(counterpart of adafocus_tpu/data/cache.py).

* ``host`` mode keeps one (N, T, S, S, 3) uint8 array in host RAM: no
  decode in the steady state, one host-to-device copy a batch.
* ``device`` mode keeps that array on the GPU as one uint8 tensor, filled
  once; a batch is gathered on the card by advanced indexing, so after the
  fill frames never cross PCIe again (only the (B, T) indices do).

Sampling, shuffling, labels and batch order replicate ``VideoLoader``
exactly (the same seed derivations, the same ``.npy`` memo beside the
dataset), so cached and streamed runs give the same batches. Requires every
record to have the same stored frame count.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from adafocus_torch.data.pipeline import VideoLoader
from adafocus_torch.data.sampling import sample_dual_rate, sample_segment_indices
from adafocus_torch.data.transforms import to_device


class CachedVideoLoader:
    """Drop-in iterable wrapper over a ``VideoLoader`` (same batch dicts);
    with ``device`` (a CUDA device, or "cpu") the frames are tensors there,
    else numpy arrays."""

    def __init__(self, inner: VideoLoader, device: Optional[torch.device] = None):
        self.inner = inner
        self.cfg = inner.cfg
        self.records = inner.records
        self.device = None if device is None else torch.device(device)
        self._frames = None  # (N, T, S, S, 3) uint8, numpy or a tensor
        if not self.records:
            raise ValueError("cache: empty record list")
        counts = {r.num_frames for r in self.records}
        if len(counts) != 1:
            raise ValueError(
                "cache requires a uniform stored frame count per video; got "
                f"{sorted(counts)[:5]}... — use the streaming loader for "
                "variable-length datasets"
            )
        self._t_stored = self.records[0].num_frames

    # -- construction --------------------------------------------------------

    def fill(self) -> float:
        """Decode (or read the memo) and place the cache; returns the
        seconds it took (0 when already filled)."""
        if self._frames is not None:
            return 0.0
        t0 = time.perf_counter()
        frames = self._load_memoized()
        if frames is None and self.device is not None and not self._memo_path():
            # nothing to memoize: each video goes to the device as it is
            # decoded, with no host array of the whole cache
            self._frames = self._decode(self.device)
        else:
            if frames is None:
                frames = self._decode()
                self._save_memoized(frames)
            self._frames = frames if self.device is None else \
                torch.from_numpy(frames).to(self.device)
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def _decode(self, device: Optional[torch.device] = None):
        """Every record's stored frames, (N, T, S, S, 3) uint8: a numpy array,
        or with ``device`` a tensor there, each record's frames copied over
        as they are decoded."""
        src = self.inner.source
        all_idx = np.arange(1, self._t_stored + 1)
        canvas = self.cfg.canvas_size
        first = self._load_all(src, self.records[0], all_idx, canvas)
        frames = torch.empty((len(self.records),) + first.shape, dtype=torch.uint8,
                             device=device or "cpu")
        for i, rec in enumerate(self.records):
            video = first if i == 0 else self._load_all(src, rec, all_idx, canvas)
            frames[i] = torch.from_numpy(video)
        return frames.numpy() if device is None else frames

    @property
    def nbytes(self) -> int:
        """Bytes the filled cache holds (0 before the fill)."""
        if self._frames is None:
            return 0
        if isinstance(self._frames, np.ndarray):
            return self._frames.nbytes
        return self._frames.numel() * self._frames.element_size()

    # -- decoded-cache disk memoization --------------------------------------
    #
    # The decoded (N, T, S, S, 3) uint8 array round-trips through one .npy
    # beside the dataset, keyed by record count / frame count / canvas so
    # that layout changes invalidate it (the JAX package's file name, so the
    # two packages share a memo). As in the JAX package, the name does not
    # say which decoder (native or PIL) wrote it.

    def _memo_path(self) -> str:
        cfg = self.cfg
        root = getattr(self.inner.source, "root", "")
        name = (f".decoded_{cfg.mode}_{len(self.records)}x{self._t_stored}"
                f"_c{cfg.canvas_size}.npy")
        return os.path.join(root, name) if root and os.path.isdir(root) else ""

    def _load_memoized(self):
        path = self._memo_path()
        if not path or not os.path.exists(path):
            return None
        try:
            arr = np.load(path)
        except (OSError, ValueError):
            return None
        want = (len(self.records), self._t_stored)
        if arr.shape[:2] != want or arr.dtype != np.uint8:
            return None
        return arr

    def _save_memoized(self, frames: np.ndarray) -> None:
        path = self._memo_path()
        if not path:
            return
        try:
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, frames)
            os.replace(tmp, path)
        except OSError:
            pass  # read-only dataset dir / no space: stay un-memoized

    @staticmethod
    def _load_all(src, record, indices, canvas) -> np.ndarray:
        if hasattr(src, "load_frames"):
            return src.load_frames(record, indices, canvas)
        return np.stack(
            [src.load_frame(record, int(i), canvas) for i in indices]
        )

    # -- VideoLoader protocol ------------------------------------------------

    def __len__(self) -> int:
        return len(self.inner)

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def close(self) -> None:
        self.inner.close()
        self._frames = None

    def _gather(self, vid_idx: np.ndarray, frame_idx: np.ndarray):
        """(B,) video rows + (B, T) 0-based frame indices -> (B, T, S, S, 3),
        on the cache's device (only the indices are copied there)."""
        if self.device is not None:
            vids = to_device(vid_idx.astype(np.int64), self.device)
            frames = to_device(frame_idx.astype(np.int64), self.device)
            return self._frames[vids[:, None], frames]
        return self._frames[vid_idx[:, None], frame_idx]

    def __iter__(self) -> Iterator[dict]:
        self.fill()
        cfg = self.cfg
        inner = self.inner
        batches = inner._batch_order()
        # a hash of ints, stable across processes (as VideoLoader's)
        base_seed = hash((cfg.seed, inner._epoch, cfg.host_id)) & 0x7FFFFFFF
        mode = cfg.mode
        for bi, batch_indices in enumerate(batches):
            idx_g, idx_f, labels = [], [], []
            for k, j in enumerate(batch_indices):
                rec = self.records[j]
                rng = np.random.default_rng(
                    base_seed + bi * cfg.batch_size + k)
                if cfg.num_segments_focuser:
                    g, f = sample_dual_rate(
                        rec.num_frames, cfg.num_segments,
                        cfg.num_segments_focuser, mode, rng,
                        cfg.dense_sample, cfg.twice_sample,
                    )
                    idx_f.append(f - 1)
                else:
                    g = sample_segment_indices(
                        rec.num_frames, cfg.num_segments, mode, rng,
                        cfg.dense_sample, cfg.twice_sample,
                    )
                idx_g.append(g - 1)
                if cfg.multi_label:
                    labels.append(rec.sampled_labels(rng) if mode == "train"
                                  else np.asarray(rec.labels, np.int64))
                else:
                    labels.append(rec.primary_label)
            vid = np.asarray(batch_indices, np.int32)
            out = {
                "frames": self._gather(vid, np.asarray(idx_g, np.int32)),
                "labels": np.asarray(labels, np.int32),
                "record_index": vid,
            }
            if idx_f:
                out["frames_focuser"] = self._gather(
                    vid, np.asarray(idx_f, np.int32))
            yield out


def maybe_cache(loader: VideoLoader, mode: str, device: Optional[torch.device] = None):
    """'' -> unchanged; 'host' -> frames in host RAM; 'device' -> frames on
    ``device``."""
    if not mode:
        return loader
    if mode not in ("host", "device"):
        raise ValueError(f"loader.cache must be '', 'host', or 'device'; "
                         f"got {mode!r}")
    if mode == "device" and device is None:
        raise ValueError("loader.cache=device needs the device to hold the cache")
    return CachedVideoLoader(loader, device=device if mode == "device" else None)
