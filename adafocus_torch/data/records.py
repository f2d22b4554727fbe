"""A copy of adafocus_tpu/data/records.py: the port imports nothing of
the JAX package, whose ``data/__init__`` loads JAX.

Video list parsing + dataset registry.

Capability parity with the reference's record/registry layer
(the reference, actnet/ops/dataset.py:10-37,91-113 and
actnet/ops/dataset_config.py:33-48, sthsth/ops/dataset_config.py:39-57),
re-done as plain data: records are numpy-friendly tuples, multi-label
shuffling is an explicit rng-taking function (the reference hides it in a
``label`` property with global torch RNG), and the registry is a dict of
frozen specs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple

import numpy as np

MAX_LABELS = 3  # actnet videos carry up to 3 labels (dataset.py:12)


@dataclasses.dataclass(frozen=True)
class VideoRecord:
    """One video: frame-folder path, frame count, up to 3 class labels
    (-1 = empty slot, sorted unique like the reference dataset.py:13-16)."""

    path: str
    num_frames: int
    labels: Tuple[int, ...]  # length MAX_LABELS, padded with -1

    @property
    def primary_label(self) -> int:
        return self.labels[0]

    @property
    def num_labels(self) -> int:
        return sum(1 for l in self.labels if l >= 0)

    def sampled_labels(self, rng: np.random.Generator) -> np.ndarray:
        """Training-time label vector with the reference's shuffling quirk
        (dataset.py:26-36): 3 labels -> random permutation; 2 labels -> the
        pair order coin-flipped; 1 label -> as-is."""
        labels = np.asarray(self.labels, np.int64)
        n = self.num_labels
        if n == 3:
            return labels[rng.permutation(MAX_LABELS)]
        if n == 2 and rng.random() > 0.5:
            return labels[[1, 0, 2]]
        return labels


def _make_record(path: str, num_frames: int, raw_labels: Sequence[int]) -> VideoRecord:
    labels = sorted(set(int(x) for x in raw_labels))[:MAX_LABELS]
    labels = tuple(labels) + (-1,) * (MAX_LABELS - len(labels))
    return VideoRecord(path=path, num_frames=int(num_frames), labels=labels)


def parse_list_file(
    list_file: str,
    dataset: str = "actnet",
    min_frames: int = 3,
    half_frame_count: bool = False,
) -> List[VideoRecord]:
    """Parse a '<path><sep><num_frames><sep><label...>' list file.

    Separator follows the reference (dataset.py:91-94): ',' for
    actnet/fcvid, ';' for kinetics, whitespace otherwise; minik rows with a
    path containing the separator are re-joined (dataset.py:96-97). Rows
    with fewer than ``min_frames`` frames are dropped (dataset.py:104-105).
    """
    sep = {"actnet": ",", "fcvid": ",", "kinetics": ";",
           "miniact": ","}.get(dataset)
    records = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            items = line.split(sep) if sep else line.split()
            if dataset == "minik" and len(items) > 3:
                items = [sep.join(items[:-2]) if sep else " ".join(items[:-2]),
                         items[-2], items[-1]]
            path, n = items[0], int(items[1])
            if half_frame_count:
                n //= 2
            if n < min_frames:
                continue
            records.append(_make_record(path, n, [int(x) for x in items[2:]]))
    return records


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Registry entry (reference return_dataset,
    actnet/ops/dataset_config.py:33-48)."""

    name: str
    num_classes: int
    image_tmpl: str
    multi_label: bool
    train_list: str = "train_split.txt"
    val_list: str = "val_split.txt"
    frames_dir: str = "frames"


_REGISTRY = {
    "actnet": DatasetSpec("actnet", 200, "image_{:06d}.jpg", multi_label=True),
    "fcvid": DatasetSpec("fcvid", 239, "image_{:06d}.jpg", multi_label=True),
    "minik": DatasetSpec("minik", 200, "image_{:06d}.jpg", multi_label=False),
    "somethingv1": DatasetSpec("somethingv1", 174, "{:05d}.jpg", multi_label=False),
    "somethingv2": DatasetSpec("somethingv2", 174, "{:06d}.jpg", multi_label=False),
    # generated accuracy-parity proxy benchmark (data/miniact.py)
    "miniact": DatasetSpec("miniact", 50, "image_{:06d}.jpg", multi_label=False),
}


def dataset_registry() -> dict:
    return dict(_REGISTRY)


def return_dataset(
    name: str, root: str, train: bool = True
) -> Tuple[DatasetSpec, str, str]:
    """(spec, frames_root, list_file) for a registered dataset rooted at
    ``root``; mirrors the reference's path resolution."""
    spec = _REGISTRY[name]
    frames_root = os.path.join(root, spec.frames_dir)
    list_file = os.path.join(root, spec.train_list if train else spec.val_list)
    return spec, frames_root, list_file
