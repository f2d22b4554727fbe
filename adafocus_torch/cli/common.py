"""Shared CLI plumbing (counterpart of adafocus_tpu/cli/common.py): device
selection, seeding, logging, model and loader construction, and the batch
prep that turns a raw uint8 batch into the model's inputs on the device.

The batch prep is the device half of the input pipeline: augmentation,
normalization and the glance downsample (``data/transforms.py``). The JAX
package also pads the frames to its TPU kernel's lane layout
(``pad_for_extraction``); that is a Mosaic constraint, and the port's patch
kernel takes the unpadded (B, T, S, S, 3) frames, so the batch key is
``frames``, not ``frames_flat``.

Per-batch randomness comes from a ``torch.Generator`` on the device seeded
from (seed, stream, index) through ``np.random.SeedSequence``
(``batch_generator``), where the JAX package folds the index into its key:
a resumed run draws what an unbroken run would.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional

import numpy as np
import torch

from adafocus_torch import default_device
from adafocus_torch.config import ExperimentConfig
from adafocus_torch.data.pipeline import (
    FrameFolderSource,
    LoaderConfig,
    SyntheticVideoSource,
    VideoLoader,
)
from adafocus_torch.data.records import VideoRecord, parse_list_file, return_dataset
from adafocus_torch.data.transforms import (
    augment_eval,
    augment_eval_views,
    augment_train,
    glance_downsample,
    num_eval_views,
    to_device,
)
from adafocus_torch.parallel.mesh import Replicas, init_replicas

# the stream of the validation batches' generators (the JAX package folds
# 0x7FFFFFFF into its root key for them)
EVAL_STREAM = 0x7FFFFFFF


def select_device(run_cfg) -> torch.device:
    """``run.platform``: 'cpu' runs on the CPU; '' or 'cuda' on the GPU
    (``default_device``, which raises when none is visible); 'tpu' raises.
    ``run.host_devices=N`` asks for N local ranks, one GPU each
    (cli/train.py), so it raises when fewer GPUs are visible."""
    if run_cfg.platform == "tpu":
        raise NotImplementedError(
            "run.platform=tpu: the port runs on CUDA GPUs, or on the CPU with "
            "run.platform=cpu (the JAX package adafocus_tpu runs on TPUs)")
    if run_cfg.platform == "cpu":
        return torch.device("cpu")
    if run_cfg.platform not in ("", "cuda"):
        raise ValueError(f"unknown run.platform {run_cfg.platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; set run.platform=cpu to run on the CPU")
    if run_cfg.host_devices > torch.cuda.device_count():
        raise RuntimeError(f"run.host_devices={run_cfg.host_devices}: only "
                           f"{torch.cuda.device_count()} GPU(s) visible")
    return default_device(None)


def join_replicas(run_cfg) -> Replicas:
    """``run.multihost``: joins the replica group as this process's rank,
    from ``run.coordinator`` (``host:port`` or ``file://path``) with
    ``run.num_processes`` and ``run.process_id``, or else from torchrun's
    environment; on the GPU (NCCL) unless ``run.platform=cpu`` (gloo)."""
    device_type = select_device(run_cfg).type
    if not run_cfg.coordinator:
        try:
            return init_replicas(device_type=device_type)
        except ValueError as e:
            raise ValueError(f"run.multihost=true: {e} (run.coordinator, run.num_processes, "
                             "run.process_id)") from None
    if not 0 <= run_cfg.process_id < run_cfg.num_processes:
        raise ValueError(f"run.multihost=true with run.coordinator needs run.num_processes >= 1 "
                         f"and 0 <= run.process_id < it; got {run_cfg.num_processes} and "
                         f"{run_cfg.process_id}")
    return init_replicas(run_cfg.coordinator, run_cfg.num_processes, run_cfg.process_id,
                         device_type)


def set_all_seeds(seed: int) -> torch.Generator:
    """Python and numpy seeding; returns the CPU generator the model's
    weights are drawn from."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def batch_generator(seed: int, stream: int, index: int, device: torch.device
                    ) -> torch.Generator:
    """The generator of one batch (training: stream = epoch), on ``device``."""
    s = int(np.random.SeedSequence((seed, stream, index)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


class Logger:
    """stdout + append-to-file logging."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(msg + "\n")


def check_family(cfg: ExperimentConfig) -> None:
    """``run.family`` names a family of the port, and the model's head is
    that family's (the sth-sth family's is ``model.classifier=consensus``)."""
    if cfg.run.family not in ("actnet", "sthsth"):
        raise ValueError(f"unknown run.family {cfg.run.family!r}: 'actnet' or 'sthsth'")
    if (cfg.run.family == "sthsth") != cfg.model.sthsth:
        raise ValueError(f"run.family={cfg.run.family!r} with model.classifier="
                         f"{cfg.model.classifier!r}: the sth-sth family's head is 'consensus'")


def build_model(cfg: ExperimentConfig, device: torch.device):
    """The GFV of ``cfg.model`` on ``device``, weights from the run's seed:
    float32 parameters computing in ``cfg.model.dtype``, as a training run
    keeps them."""
    from adafocus_torch.models.gfv import GFV

    return GFV(cfg.model, device=device, generator=set_all_seeds(cfg.run.seed),
               param_dtype=torch.float32)


def synthetic_records(n: int, num_classes: int, frames: int = 64):
    return [
        VideoRecord(f"synthetic{i}", frames, (i % num_classes, -1, -1))
        for i in range(n)
    ]


def build_loader(cfg: ExperimentConfig, train: bool, device: torch.device,
                 shard: Optional[tuple] = None):
    """The train or validation loader; ``loader.cache=device`` holds the
    frames on ``device``. ``shard`` (rank, world) reads that record shard,
    unless ``loader.host_id`` / ``loader.num_hosts`` pin another (the JAX
    package's rule for its processes)."""
    run = cfg.run
    loader_cfg = cfg.loader
    if train:
        mode = "train"
    elif loader_cfg.dense_sample or loader_cfg.twice_sample:
        mode = "test"  # dense/twice multi-clip sampling (test-time)
    else:
        mode = "val"
    host_id, num_hosts = loader_cfg.host_id, loader_cfg.num_hosts
    if shard is not None:
        host_id = host_id or shard[0]
        num_hosts = num_hosts if num_hosts > 1 else shard[1]
    loader_cfg = LoaderConfig(
        **{**loader_cfg.__dict__, "mode": mode,
           "multi_label": run.dataset in ("actnet", "fcvid"),
           "drop_last": train, "host_id": host_id, "num_hosts": num_hosts})
    if run.synthetic_data:
        # synthetic labels must live in the model's class space
        records = synthetic_records(run.synthetic_videos, cfg.model.num_classes)
        source = SyntheticVideoSource()
    else:
        spec, frames_root, list_file = return_dataset(
            run.dataset, run.data_root, train=train
        )
        records = parse_list_file(list_file, dataset=run.dataset)
        source = FrameFolderSource(frames_root, spec.image_tmpl)
    loader = VideoLoader(records, source, loader_cfg)
    if loader_cfg.cache:
        from adafocus_torch.data.cache import maybe_cache

        loader = maybe_cache(loader, loader_cfg.cache, device)
    return loader


def make_batch_prep(cfg: ExperimentConfig, train: bool, device: torch.device) -> Callable:
    """raw uint8 batch -> ``{frames, frames_small, labels}`` on ``device``.

    Returns ``run(raw, generator=None, draws=None) -> (batch, labels as
    numpy, clips per video)``: ``generator`` (on ``device``) draws the
    training augmentation, ``draws`` (``AugmentDraws``) replaces it. The
    frames are in the model's dtype, unpadded; evaluation folds multi-clip
    sampling and test-time views into the batch. ``run.host_frame_bytes``
    counts the frame bytes copied from the host (0 while a device cache
    serves the batches).

    The ActivityNet family's one stream feeds both the glancer (downsampled)
    and the focuser. The sth-sth family's batches are dual-rate: the glancer
    sees ``raw["frames"]`` (Tg frames) downsampled, the focuser
    ``raw["frames_focuser"]`` (Tf frames), each stream augmented by its own
    draw, the focuser's after the glancer's (``draws`` is then the pair).
    """
    device = default_device(device)
    model_cfg = cfg.model
    aug = cfg.augment
    dual = cfg.run.family == "sthsth"
    n_views = 1 if train else num_eval_views(aug)

    def expand_views(frames):
        """(B, T, H, W, C) -> (B*V, T, S, S, C): test-time views,
        view-minor so that validate()'s per-video consensus groups them
        with the clips."""
        out = augment_eval_views(frames, aug)
        return out.reshape((-1,) + out.shape[2:])

    def split_clips(frames: torch.Tensor, t_model: int):
        """(B, k*T, ...) multi-clip test sampling -> (B*k, T, ...) clips."""
        b, t_total = frames.shape[:2]
        k = t_total // t_model
        if k <= 1:
            return frames, 1
        return frames.reshape((b * k, t_model) + frames.shape[2:]), k

    def on_device(frames) -> torch.Tensor:
        if isinstance(frames, np.ndarray):
            run.host_frame_bytes += frames.nbytes
            return to_device(frames, device)
        if frames.device != device:
            run.host_frame_bytes += frames.numel() * frames.element_size()
        return frames.to(device)

    def augment(frames, generator, draws):
        if train:
            return augment_train(frames, generator, aug, draws)
        if n_views > 1:
            return expand_views(frames)
        return augment_eval(frames, aug)

    def run(raw: dict, generator: Optional[torch.Generator] = None, draws=None):
        labels = np.asarray(raw["labels"])
        labels_train = labels[:, 0] if labels.ndim == 2 else labels
        frames = on_device(raw["frames"])
        focus_frames = on_device(raw["frames_focuser"]) if dual else frames
        draws_g, draws_f = draws if dual and draws is not None else (draws, None)
        k = 1
        if not train:
            frames, k = split_clips(frames, model_cfg.num_frames)
            if dual:
                focus_frames, kf = split_clips(focus_frames, model_cfg.t_focuser)
                if kf != k:
                    raise ValueError(f"clip counts differ between streams: {k} vs {kf}")
            k *= n_views  # crop views consensus-average like clips
            if k > 1:
                labels_train = np.repeat(labels_train, k)
        big = augment(frames, generator, draws_g)
        small = glance_downsample(big, model_cfg.glance_size)
        focus = augment(focus_frames, generator, draws_f) if dual else big
        batch = {
            "frames": focus.to(model_cfg.dtype),
            "frames_small": small.to(model_cfg.dtype),
            "labels": to_device(labels_train.astype(np.int64), device),
        }
        return batch, labels, k

    run.host_frame_bytes = 0
    return run


class ProgressMeter:
    """Per-epoch progress lines."""

    def __init__(self, num_batches: int, prefix: str = ""):
        self.num_batches = num_batches
        self.prefix = prefix
        self.t0 = time.time()

    def line(self, batch_idx: int, metrics: dict) -> str:
        elapsed = time.time() - self.t0
        body = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        return (f"{self.prefix}[{batch_idx + 1}/{self.num_batches}] "
                f"t={elapsed:.1f}s {body}")
