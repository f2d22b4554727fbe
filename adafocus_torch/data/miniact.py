"""A copy of adafocus_tpu/data/miniact.py (the port imports nothing of
the JAX package). ``render_video`` is numpy only; ``generate`` needs PIL.

mini-ActivityNet: a generated accuracy-parity proxy benchmark.

No real video dataset ships in this environment, so this module generates
one with the statistical structure AdaFocus exploits (reference README.md:28-30
in the reference: cheap global scan -> localize -> expensive local look):

* Each video contains ONE target tile — a class-specific texture motif —
  marked by a red border, drifting across the canvas over time, plus
  several unmarked distractor tiles carrying OTHER classes' motifs.
* All motifs share the same two-tone palette, so class identity lives in
  fine pattern GEOMETRY only: a 96^2 patch centered on the target makes
  classification easy for the focuser, while global average pooling over
  the full frame mixes 4+ textures and dilutes the signal — exactly the
  glance/focus asymmetry of the real datasets.
* The marker is class-independent: the policy's job is pure localization
  from the glance feature map (the 7x7-map spatial-policy path,
  reference actnet/models/ppo.py:32-47).
* In a random subset of frames the target is absent (distractors only) —
  temporal relevance structure for the AdaFocus+ frame-selection frontier.
* Motifs are horizontally symmetric so the horizontal-flip augmentation
  (reference transforms GroupRandomHorizontalFlip) preserves labels.

Output layout matches the frame-folder datasets the loader consumes
(reference actnet/ops/dataset.py:40-113): ``frames/<vid>/image_%06d.jpg``,
comma-separated ``train_split.txt``/``val_split.txt``, plus ``gt.npz``
(per-video per-frame target centers + presence — ground truth for oracle
policy evaluation) and ``meta.json``.

CLI: ``python -m adafocus_torch.data.miniact --root <dir>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MiniactConfig:
    num_classes: int = 50
    train_per_class: int = 24
    val_per_class: int = 8
    num_frames: int = 16
    canvas: int = 256
    tile: int = 72              # target/distractor tile side (px)
    cell: int = 8               # motif cell size (tile/cell motif grid)
    num_distractors: int = 3
    marker_px: int = 3          # red marker border width
    min_present: int = 10       # min informative frames per video
    max_drift: int = 50         # max per-video drift of any tile (px)
    jitter: int = 3             # per-frame tile-position jitter (px)
    jpeg_quality: int = 87
    seed: int = 2024

    @property
    def motif_cells(self) -> int:
        return self.tile // self.cell


# two-tone palette shared by EVERY class (color carries zero class signal)
_TONE0 = np.array([52, 62, 118], np.uint8)    # dark blue
_TONE1 = np.array([228, 200, 86], np.uint8)   # ochre
_MARKER = np.array([212, 38, 38], np.uint8)   # red (class-independent cue)


def class_motifs(cfg: MiniactConfig) -> np.ndarray:
    """(C, m, m) binary motifs, horizontally symmetric, pairwise distinct."""
    rng = np.random.default_rng(cfg.seed)
    m = cfg.motif_cells
    motifs, seen = [], set()
    while len(motifs) < cfg.num_classes:
        pat = rng.random((m, m)) < 0.5
        pat = pat | pat[:, ::-1]            # symmetrize (flip-invariant)
        key = pat.tobytes()
        if key in seen:
            continue
        seen.add(key)
        motifs.append(pat)
    return np.stack(motifs)


def render_tile(motif: np.ndarray, cfg: MiniactConfig) -> np.ndarray:
    """(m, m) binary motif -> (tile, tile, 3) uint8 two-tone texture."""
    cells = np.kron(motif, np.ones((cfg.cell, cfg.cell), bool))
    return np.where(cells[..., None], _TONE1, _TONE0).astype(np.uint8)


def _background(rng: np.random.Generator, cfg: MiniactConfig) -> np.ndarray:
    """Smooth low-contrast noise canvas (no class information)."""
    coarse = rng.integers(108, 148, (cfg.canvas // 16, cfg.canvas // 16, 3))
    big = np.kron(coarse, np.ones((16, 16, 1))).astype(np.float32)
    # cheap box smoothing to kill the block edges
    big = (big + np.roll(big, 8, 0) + np.roll(big, 8, 1)
           + np.roll(big, (8, 8), (0, 1))) / 4.0
    return big.astype(np.uint8)


def _tile_track(rng: np.random.Generator, cfg: MiniactConfig) -> np.ndarray:
    """(T, 2) top-left (y, x) positions: linear drift + per-frame jitter."""
    lim = cfg.canvas - cfg.tile - 4
    p0 = rng.integers(4, lim, 2).astype(np.float64)
    delta = rng.integers(-cfg.max_drift, cfg.max_drift + 1, 2)
    p1 = np.clip(p0 + delta, 4, lim)
    ts = np.linspace(0.0, 1.0, cfg.num_frames)[:, None]
    track = p0[None] * (1 - ts) + p1[None] * ts
    track += rng.integers(-cfg.jitter, cfg.jitter + 1, (cfg.num_frames, 2))
    return np.clip(np.round(track), 0, lim).astype(np.int64)


def _paste(frame: np.ndarray, tile_img: np.ndarray, y: int, x: int) -> None:
    frame[y : y + tile_img.shape[0], x : x + tile_img.shape[1]] = tile_img


def render_video(
    label: int, motifs: np.ndarray, rng: np.random.Generator, cfg: MiniactConfig
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (frames (T, S, S, 3) uint8, centers (T, 2) normalized target
    centers in canvas coords, presence (T,) bool)."""
    t_len, s = cfg.num_frames, cfg.canvas
    others = rng.choice(
        [c for c in range(cfg.num_classes) if c != label],
        size=cfg.num_distractors, replace=False,
    )
    target_img = render_tile(motifs[label], cfg)
    distractor_imgs = [render_tile(motifs[c], cfg) for c in others]
    target_track = _tile_track(rng, cfg)
    distractor_tracks = [_tile_track(rng, cfg) for _ in others]

    n_present = int(rng.integers(cfg.min_present, t_len + 1))
    presence = np.zeros(t_len, bool)
    presence[rng.permutation(t_len)[:n_present]] = True

    frames = np.empty((t_len, s, s, 3), np.uint8)
    for t in range(t_len):
        frame = _background(rng, cfg)
        for img, track in zip(distractor_imgs, distractor_tracks):
            _paste(frame, img, *track[t])
        if presence[t]:
            y, x = target_track[t]
            # marker first (border band), then the texture on top
            w = cfg.marker_px
            y0, x0 = max(y - w, 0), max(x - w, 0)
            frame[y0 : y + cfg.tile + w, x0 : x + cfg.tile + w] = _MARKER
            _paste(frame, target_img, y, x)
        frames[t] = frame
    centers = (target_track + cfg.tile / 2.0) / s
    return frames, centers.astype(np.float32), presence


def generate(root: str, cfg: MiniactConfig, log=print) -> None:
    """Write the full dataset (frames, split lists, gt.npz, meta.json)."""
    from PIL import Image

    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    motifs = class_motifs(cfg)
    rng = np.random.default_rng(cfg.seed + 1)

    splits = {"train": cfg.train_per_class, "val": cfg.val_per_class}
    lists = {k: [] for k in splits}
    gt_paths, gt_centers, gt_presence = [], [], []
    done = 0
    total = cfg.num_classes * sum(splits.values())
    for label in range(cfg.num_classes):
        for split, count in splits.items():
            for i in range(count):
                vid = f"{split}_c{label:03d}_{i:03d}"
                vdir = os.path.join(frames_dir, vid)
                os.makedirs(vdir, exist_ok=True)
                frames, centers, presence = render_video(
                    label, motifs, rng, cfg)
                for t in range(cfg.num_frames):
                    Image.fromarray(frames[t]).save(
                        os.path.join(vdir, f"image_{t + 1:06d}.jpg"),
                        quality=cfg.jpeg_quality,
                    )
                lists[split].append(f"{vid},{cfg.num_frames},{label}")
                gt_paths.append(vid)
                gt_centers.append(centers)
                gt_presence.append(presence)
                done += 1
                if done % 200 == 0:
                    log(f"miniact: {done}/{total} videos written")

    for split, lines in lists.items():
        with open(os.path.join(root, f"{split}_split.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    np.savez_compressed(
        os.path.join(root, "gt.npz"),
        paths=np.array(gt_paths),
        centers=np.stack(gt_centers),
        presence=np.stack(gt_presence),
    )
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    log(f"miniact: dataset complete at {root} "
        f"({total} videos x {cfg.num_frames} frames, "
        f"{cfg.num_classes} classes)")


def load_gt(root_or_file: str):
    """gt.npz (or the dataset root containing it) ->
    (paths list, centers (N, T, 2), presence (N, T))."""
    path = (root_or_file if root_or_file.endswith(".npz")
            else os.path.join(root_or_file, "gt.npz"))
    z = np.load(path)
    return list(z["paths"]), z["centers"], z["presence"]


def oracle_actions(
    centers: np.ndarray, presence: np.ndarray, canvas: int, input_size: int,
    patch_size: int,
) -> np.ndarray:
    """Ground-truth patch actions for oracle evaluation.

    centers: (..., 2) normalized target centers in CANVAS coords. Eval
    preprocessing center-crops canvas -> input_size, so the center shifts
    by (canvas - input_size)/2; the action a solving
    floor(a * (S - P)) + P/2 = center is a = (center - P/2) / (S - P)
    (patch coord math, ops/patch.py / reference models/utils.py:19-35).
    Absent frames fall back to the frame center (a = 0.5).
    """
    off = (canvas - input_size) / 2.0
    c = centers * canvas - off
    a = (c - patch_size / 2.0) / float(input_size - patch_size)
    a = np.clip(a, 0.0, 1.0).astype(np.float32)
    return np.where(presence[..., None], a, np.float32(0.5))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--classes", type=int, default=50)
    ap.add_argument("--train-per-class", type=int, default=24)
    ap.add_argument("--val-per-class", type=int, default=8)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--canvas", type=int, default=256)
    ap.add_argument("--tile", type=int, default=0,
                    help="0 = scale the default 72px (at canvas 256)")
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args(argv)
    tile = args.tile or max(16, round(args.canvas * 72 / 256 / 8) * 8)
    cfg = MiniactConfig(
        num_classes=args.classes, train_per_class=args.train_per_class,
        val_per_class=args.val_per_class, num_frames=args.frames,
        canvas=args.canvas, tile=tile,
        min_present=max(1, (args.frames * 10) // 16),
        max_drift=max(8, args.canvas * 50 // 256),
        seed=args.seed,
    )
    generate(args.root, cfg)


if __name__ == "__main__":
    main()
