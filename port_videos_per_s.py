#!/usr/bin/env python3
"""Videos/s of the port's bf16 flagship deployment forward for one checkout.

    python3 port_videos_per_s.py TREE [fused]

TREE is the root of a checkout of this repository (``.`` for this one);
``fused`` is the ``inference(fused=...)`` path, ``auto`` by default. Runs
B=64, T=16 (224^2 frames and glance, random weights and inputs from fixed
seeds) on one CUDA GPU: three warm-up forwards, then five timed runs of ten
forwards each, timed with CUDA events. Prints one line with the five
videos/s figures and the card's name, power limit, SM clock and
temperature.

To compare two checkouts, run both in one call on the same card, in turns:

    for t in parent . . parent; do python3 port_videos_per_s.py $t; done
"""

import os
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    fused = sys.argv[2] if len(sys.argv) > 2 else "auto"
    sys.path.insert(0, tree)
    import torch

    from adafocus_torch.models.gfv import GFV, flagship, inference

    if not torch.cuda.is_available():
        print("port_videos_per_s: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = True
    model = GFV(flagship(), device=dev, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(2)
    b, t = 64, 16
    frames = torch.randn((b, t, 224, 224, 3), generator=gen, device=dev,
                         dtype=torch.bfloat16)
    small = torch.randn((b, t, 224, 224, 3), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    kwargs = {} if fused == "auto" else {"fused": fused}

    def once():
        return inference(model, frames, small, device=dev, **kwargs)

    for _ in range(3):
        once()
    torch.cuda.synchronize()
    vps = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            once()
        end.record()
        torch.cuda.synchronize()
        vps.append(b / (start.elapsed_time(end) / 10 / 1e3))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"{sys.argv[1]} fused={fused}: videos/s {vps} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
