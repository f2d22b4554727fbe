"""Export a trained checkpoint as a serving artifact (counterpart of
adafocus_tpu/cli/export.py): load a checkpoint, with ``run.quantize=int8``
calibrate the int8 activation scales on validation batches, and write a
``torch.export`` artifact (``serving.py``) that serves with no model code.

    python -m adafocus_torch.cli.export --path model.pt2 --batch 64 \\
        [--config conf.yaml] run.resume=<ckpt_dir> [run.quantize=int8 ...] \\
        [section.key=value ...]

The checkpoint is ``run.resume``'s ``model_best.pt`` when there is one,
else its last. The artifact serves ``(frames, frames_small) -> per-step
logits`` at the fixed ``--batch`` (static shapes: export one artifact per
served batch size), in the model's compute dtype, or in int8 with
``run.quantize=int8`` (calibrated on ``run.quantize_batches`` validation
batches, ``cli.evaluate.calibrate_from_loader``; ``run.quantize_heads=true``
quantizes the policy and the classifier too).

The JAX package's ``--platforms`` lowers one StableHLO program for several
backends. A ``torch.export`` program holds its weights on one device, so
the port's artifact serves on the run's device: the GPU, or the CPU with
``run.platform=cpu`` (``cli.common.select_device``; with no GPU and no
such request it raises).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from adafocus_torch.cli.common import (
    Logger,
    build_loader,
    build_model,
    check_family,
    make_batch_prep,
    select_device,
)
from adafocus_torch.cli.evaluate import calibrate_from_loader
from adafocus_torch.config import echo, load_config
from adafocus_torch.serving import export_inference, save_exported
from adafocus_torch.train import checkpoint as ckpt


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Exports ``run.resume``'s checkpoint; returns the artifact's path."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--path", default="model.pt2", help="output artifact path")
    ap.add_argument("--batch", type=int, default=64,
                    help="served batch size (one artifact per batch size)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    check_family(cfg)
    if cfg.run.multihost:
        raise ValueError("run.multihost: export runs in one process on one device")
    device = select_device(cfg.run)
    log = Logger(os.path.join(cfg.run.ckpt_dir, "export.log"))
    log(echo(cfg))

    model = build_model(cfg, device)
    if cfg.run.resume:
        tree = ckpt.load_checkpoint(cfg.run.resume, best=True) \
            or ckpt.load_checkpoint(cfg.run.resume)
        if tree is None:
            raise SystemExit(f"no checkpoint under {cfg.run.resume}")
        ckpt.load_components(model, tree)
        log(f"loaded checkpoint from {cfg.run.resume}")
    else:
        log("WARNING: run.resume not set — exporting a fresh init")

    mode, scales = "bf16", None
    if cfg.run.quantize == "int8":
        loader = build_loader(cfg, train=False, device=device)
        if hasattr(loader, "fill"):
            loader.fill()
        prep = make_batch_prep(cfg, train=False, device=device)
        scales = calibrate_from_loader(model, loader, prep, cfg, cfg.run.quantize_batches)
        mode = "int8"
        log(f"int8 PTQ: calibrated on {cfg.run.quantize_batches} val batches")
    elif cfg.run.quantize:
        raise SystemExit(f"unknown run.quantize mode {cfg.run.quantize!r}")

    exported = export_inference(model, args.batch, mode=mode, scales=scales)
    save_exported(exported, args.path)
    size_mb = os.path.getsize(args.path) / 1e6
    log(f"exported {mode} artifact: {args.path} ({size_mb:.1f} MB, batch={args.batch}, "
        f"device={device})")
    return args.path


if __name__ == "__main__":
    main()
