"""A copy of adafocus_tpu/data/video_jpg.py (the port imports nothing of
the JAX package).

Offline video -> JPEG frame extraction (ffmpeg subprocess).

Capability parity with the reference extractor
(the reference, actnet/ops/video_jpg.py:25-79): walks a directory of
videos, shells out to ffmpeg per file to dump frames as
``<out>/<video_id>/image_%06d.jpg``, optionally in a process pool, and
writes the '<path>,<num_frames>,<labels...>' list file the loaders consume.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import subprocess
from typing import Optional, Sequence

VIDEO_EXTS = (".mp4", ".mkv", ".webm", ".avi", ".mov")


def extract_one(
    video_path: str, out_dir: str, fps: Optional[float] = None,
    short_side: int = 331, quality: int = 2,
) -> int:
    """Extract all frames of one video; returns the frame count."""
    os.makedirs(out_dir, exist_ok=True)
    vf = [f"scale=-2:'min({short_side},ih)'"]
    if fps:
        vf.append(f"fps={fps}")
    cmd = [
        "ffmpeg", "-nostdin", "-loglevel", "error", "-i", video_path,
        "-vf", ",".join(vf), "-q:v", str(quality),
        os.path.join(out_dir, "image_%06d.jpg"),
    ]
    subprocess.run(cmd, check=True)
    return sum(1 for f in os.listdir(out_dir) if f.endswith(".jpg"))


def _work(args):
    video_path, out_dir, fps, short_side = args
    vid = os.path.splitext(os.path.basename(video_path))[0]
    try:
        n = extract_one(video_path, os.path.join(out_dir, vid), fps, short_side)
        return vid, n
    except subprocess.CalledProcessError:
        return vid, 0


def extract_directory(
    video_dir: str, out_dir: str, fps: Optional[float] = None,
    short_side: int = 331, workers: int = 8,
) -> dict:
    """Extract every video under ``video_dir``; returns {video_id: frames}
    and writes ``<out_dir>/extracted_list.txt`` rows of '<id>,<frames>'
    (append class labels to turn it into a loader list file)."""
    if not os.path.isdir(video_dir):
        raise SystemExit(f"video_jpg: video directory not found: {video_dir}")
    jobs = [
        (os.path.join(video_dir, f), out_dir, fps, short_side)
        for f in sorted(os.listdir(video_dir))
        if f.lower().endswith(VIDEO_EXTS)
    ]
    if workers > 1:
        with multiprocessing.Pool(workers) as pool:
            results = pool.map(_work, jobs)
    else:
        results = [_work(j) for j in jobs]
    counts = dict(results)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "extracted_list.txt"), "w") as f:
        for vid, n in sorted(counts.items()):
            if n > 0:
                f.write(f"{vid},{n}\n")
    return counts


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("video_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--short-side", type=int, default=331)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    counts = extract_directory(
        args.video_dir, args.out_dir, args.fps, args.short_side, args.workers
    )
    ok = sum(1 for n in counts.values() if n > 0)
    print(f"extracted {ok}/{len(counts)} videos")


if __name__ == "__main__":
    main()
