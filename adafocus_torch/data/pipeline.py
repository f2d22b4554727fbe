"""Host input pipeline: threaded JPEG decode -> fixed-shape uint8 batches.

A copy of adafocus_tpu/data/pipeline.py (the port imports nothing of the
JAX package); the same records, seeds and draws give the same batches.

Replaces the reference's DataLoader worker processes + DistributedSampler
(the reference, actnet/main_dist.py:194-239): a thread pool decodes frame
JPEGs into a fixed (canvas x canvas) uint8 layout, batches are prefetched
ahead of the training loop, and per-host sharding is index arithmetic
(host h of H takes records [h::H]) — the DistributedSampler equivalent for
a multi-host run. All augmentation happens on the device
(adafocus_torch/data/transforms.py), so the host does the minimum possible
work per frame: decode + one resize.

Fault tolerance mirrors the reference: a missing/corrupt frame file falls
back to frame 1 (dataset.py:82-87); a missing video folder resamples a
random other record, giving up after 3 tries (dataset.py:185-198).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
from typing import Iterator, List, Sequence

import numpy as np

from adafocus_torch.data.records import MAX_LABELS, VideoRecord
from adafocus_torch.data.sampling import sample_dual_rate, sample_segment_indices


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    num_segments: int = 16
    num_segments_focuser: int = 0   # >0 enables sth-sth dual-rate batches
    canvas_size: int = 256          # short side after host resize
    batch_size: int = 64
    mode: str = "train"             # 'train' | 'val' | 'test'
    dense_sample: bool = False
    twice_sample: bool = False
    num_workers: int = 8
    decode_procs: int = 0           # >0: decode in worker PROCESSES (the
                                    # reference's DataLoader workers,
                                    # main_dist.py:194-239) — for multi-core
                                    # hosts where one interpreter's Python-
                                    # side work caps the thread pool
    prefetch: int = 2
    cache: str = ""                 # '' stream | 'host' RAM | 'device' HBM
                                    # decode-once caching (data/cache.py)
    seed: int = 1007
    host_id: int = 0                # this host's index in the slice
    num_hosts: int = 1
    drop_last: bool = True
    multi_label: bool = False       # actnet: emit (B, 3) padded label lists

    @property
    def t_focuser(self) -> int:
        return self.num_segments_focuser or self.num_segments


class FrameFolderSource:
    """Reads JPEG frames from <root>/<record.path>/<tmpl % index>.

    Decoding prefers the native C++ core (libjpeg DCT-scaled decode +
    fixed-point bilinear, native/frame_loader.cc) and falls back to PIL
    when the native library is unavailable or a file is corrupt.
    """

    def __init__(self, root: str, image_tmpl: str = "image_{:06d}.jpg",
                 use_native: bool = True):
        self.root = root
        self.image_tmpl = image_tmpl
        self.use_native = use_native

    @property
    def _native(self):
        # resolved lazily (and per process) so the source stays picklable
        # for the decode_procs worker pool; native.available() caches the
        # loaded library module-globally.
        if not self.use_native:
            return None
        from adafocus_torch.data import native

        return native if native.available() else None

    def exists(self, record: VideoRecord) -> bool:
        return os.path.exists(
            os.path.join(self.root, record.path, self.image_tmpl.format(1))
        )

    def _frame_path(self, record: VideoRecord, index: int) -> str:
        return os.path.join(self.root, record.path, self.image_tmpl.format(index))

    def load_frames(
        self, record: VideoRecord, indices, canvas: int
    ) -> np.ndarray:
        """Decode several frames in one native batch call (the C++ worker
        pool decodes them concurrently); falls back to per-frame loading.
        Failed frames fall back to frame 1 (reference dataset.py:82-87)."""
        if self._native is not None:
            paths = [self._frame_path(record, int(i)) for i in indices]
            frames, status = self._native.decode_batch(paths, canvas)
            if frames is not None:
                if status.any():
                    fallback = self.load_frame(record, 1, canvas)
                    for i in np.nonzero(status)[0]:
                        frames[i] = fallback
                return frames
        return np.stack(
            [self.load_frame(record, int(i), canvas) for i in indices]
        )

    def load_frame(self, record: VideoRecord, index: int, canvas: int) -> np.ndarray:
        """Decode frame ``index`` (1-based) to (canvas, canvas, 3) uint8:
        resize short side to ``canvas`` then center-crop square (the host
        half of GroupScale; crops/flips happen on device). Missing/corrupt
        frame falls back to frame 1 (reference dataset.py:82-87)."""
        path = self._frame_path(record, index)
        if self._native is not None:
            out = self._native.decode_file(path, canvas)
            if out is None:
                out = self._native.decode_file(
                    self._frame_path(record, 1), canvas)
            if out is not None:
                return out
        from PIL import Image

        try:
            img = Image.open(path).convert("RGB")
        except Exception:
            img = Image.open(self._frame_path(record, 1)).convert("RGB")
        w, h = img.size
        scale = canvas / min(w, h)
        img = img.resize(
            (max(canvas, round(w * scale)), max(canvas, round(h * scale))),
            Image.BILINEAR,
        )
        w, h = img.size
        x0, y0 = (w - canvas) // 2, (h - canvas) // 2
        return np.asarray(img.crop((x0, y0, x0 + canvas, y0 + canvas)), np.uint8)


class SyntheticVideoSource:
    """Procedural frames — the test and bench stand-in for a dataset on
    disk."""

    def __init__(self, noise: bool = False):
        self.noise = noise

    def exists(self, record: VideoRecord) -> bool:
        return True

    def load_frame(self, record: VideoRecord, index: int, canvas: int) -> np.ndarray:
        # As the JAX package does (data/pipeline.py:153), the seed hashes the
        # path string, which Python salts per process: the frames are the
        # same within one process and differ between two. Mirrored for
        # parity, not fixed.
        seed = (hash(record.path) ^ index) & 0xFFFFFFFF
        return _uniform_bytes(seed, (canvas, canvas, 3))


def _uniform_bytes(seed: int, shape) -> np.ndarray:
    """``np.random.default_rng(seed).integers(0, 256, shape, np.uint8)``, the
    same values at about half the cost: numpy draws full-range uint8 as the
    bytes of successive 32-bit outputs, low byte first, and PCG64 (the
    default generator) makes two 32-bit outputs of each 64-bit one, low half
    first, so the values are the generator's raw 64-bit outputs read as
    little-endian bytes."""
    n = int(np.prod(shape))
    raw = np.random.default_rng(seed).bit_generator.random_raw(-(-n // 8))
    return raw.astype("<u8", copy=False).view(np.uint8)[:n].reshape(shape)


class VideoLoader:
    """Iterable over device-ready uint8 batches.

    Batch dict (all numpy, converted on device by the caller):
      frames:         (B, T, canvas, canvas, 3) uint8
      frames_focuser: (B, Tf, canvas, canvas, 3) uint8   [dual-rate only]
      labels:         (B,) int32, or (B, 3) padded when multi_label
    """

    def __init__(
        self,
        records: Sequence[VideoRecord],
        source,
        cfg: LoaderConfig,
    ):
        self.cfg = cfg
        self.source = source
        self.records = list(records)[cfg.host_id :: cfg.num_hosts]
        self._epoch = 0
        self._proc_pool = None

    def _decode_pool(self):
        """Lazy, epoch-persistent process pool (decode_procs > 0). Workers
        hold a replica of (records, source, cfg) via the initializer, so
        per-task pickles are just (index, seed)."""
        if self._proc_pool is None:
            import multiprocessing as mp

            self._proc_pool = concurrent.futures.ProcessPoolExecutor(
                self.cfg.decode_procs,
                mp_context=mp.get_context("forkserver"),
                initializer=_decode_worker_init,
                initargs=(self.records, self.source, self.cfg),
            )
        return self._proc_pool

    def close(self) -> None:
        if self._proc_pool is not None:
            self._proc_pool.shutdown()
            self._proc_pool = None

    def __len__(self) -> int:
        n = len(self.records) // self.cfg.batch_size
        if not self.cfg.drop_last and len(self.records) % self.cfg.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle seed per epoch (DistributedSampler.set_epoch parity,
        main_dist.py:255)."""
        self._epoch = epoch

    # -- per-video work (runs on pool threads) ------------------------------

    def _resolve(self, record: VideoRecord, rng: np.random.Generator) -> VideoRecord:
        tries = 0
        while not self.source.exists(record):
            tries += 1
            if tries > 3:
                raise FileNotFoundError(
                    f"video folder missing after 3 resamples: {record.path}"
                )
            record = self.records[int(rng.integers(len(self.records)))]
        return record

    def _load_video(self, record: VideoRecord, seed: int):
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        record = self._resolve(record, rng)
        mode = cfg.mode
        if cfg.num_segments_focuser:
            idx_g, idx_f = sample_dual_rate(
                record.num_frames, cfg.num_segments, cfg.num_segments_focuser,
                mode, rng, cfg.dense_sample, cfg.twice_sample,
            )
        else:
            idx_g = sample_segment_indices(
                record.num_frames, cfg.num_segments, mode, rng,
                cfg.dense_sample, cfg.twice_sample,
            )
            idx_f = None

        def frames_for(indices):
            if hasattr(self.source, "load_frames"):
                return self.source.load_frames(record, indices, cfg.canvas_size)
            return np.stack([
                self.source.load_frame(record, int(i), cfg.canvas_size)
                for i in indices
            ])

        if cfg.multi_label:
            label = (record.sampled_labels(rng) if mode == "train"
                     else np.asarray(record.labels, np.int64))
        else:
            label = record.primary_label
        out = {"frames": frames_for(idx_g), "labels": np.asarray(label, np.int32)}
        if idx_f is not None:
            out["frames_focuser"] = frames_for(idx_f)
        return out

    # -- epoch iteration ----------------------------------------------------

    def _batch_order(self) -> List[List[int]]:
        cfg = self.cfg
        order = np.arange(len(self.records))
        if cfg.mode == "train":
            np.random.default_rng((cfg.seed, self._epoch)).shuffle(order)
        batches = []
        for i in range(0, len(order), cfg.batch_size):
            chunk = order[i : i + cfg.batch_size]
            if len(chunk) < cfg.batch_size and cfg.drop_last:
                break
            batches.append([int(j) for j in chunk])
        return batches

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        batches = self._batch_order()
        base_seed = hash((cfg.seed, self._epoch, cfg.host_id)) & 0x7FFFFFFF
        use_procs = cfg.decode_procs > 0
        if use_procs:
            pool = self._decode_pool()

        def make_batch(bi: int, batch_indices, pool):
            futs = [
                pool.submit(_decode_worker_load, j,
                            base_seed + bi * cfg.batch_size + k)
                if use_procs else
                pool.submit(self._load_video, self.records[j],
                            base_seed + bi * cfg.batch_size + k)
                for k, j in enumerate(batch_indices)
            ]
            videos = [f.result() for f in futs]
            out = {
                k: np.stack([v[k] for v in videos]) for k in videos[0]
            }
            # positions in self.records — lets eval align per-video side
            # tables (e.g. oracle ground-truth actions) with batches
            out["record_index"] = np.asarray(batch_indices, np.int32)
            return out

        with concurrent.futures.ThreadPoolExecutor(cfg.num_workers) as tpool, \
                concurrent.futures.ThreadPoolExecutor(
                    max(cfg.prefetch, 1)) as batch_pool:
            if not use_procs:
                pool = tpool
            pending: "queue.Queue" = queue.Queue()
            it = iter(enumerate(batches))

            def submit_next():
                try:
                    bi, br = next(it)
                except StopIteration:
                    return False
                pending.put(batch_pool.submit(make_batch, bi, br, pool))
                return True

            for _ in range(cfg.prefetch + 1):
                if not submit_next():
                    break
            while not pending.empty():
                fut = pending.get()
                yield fut.result()
                submit_next()


# -- decode_procs worker-process state (one replica per worker) --------------

_WORKER_LOADER: "VideoLoader" = None


def _decode_worker_init(records, source, cfg: LoaderConfig) -> None:
    global _WORKER_LOADER
    # records arrive pre-sharded; neutralize host slicing in the replica
    cfg = dataclasses.replace(cfg, host_id=0, num_hosts=1, decode_procs=0)
    _WORKER_LOADER = VideoLoader(records, source, cfg)


def _decode_worker_load(index: int, seed: int):
    return _WORKER_LOADER._load_video(_WORKER_LOADER.records[index], seed)
