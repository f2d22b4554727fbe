"""Evaluation entry point of the port (counterpart of
adafocus_tpu/cli/evaluate.py): load a checkpoint, run the deployment forward
(greedy policy) over the validation set, report top-1/5 and mAP.

    python -m adafocus_torch.cli.evaluate [--config conf.yaml] run.resume=<ckpt_dir> \\
        [section.key=value ...]

``run.eval_policy`` overrides the patch policy: 'random' (uniform patches
from each batch's generator), 'center', or 'oracle' (the ground-truth
target tracks of ``run.oracle_gt``, a miniact ``gt.npz``); these bracket the
learned policy's accuracy. ``run.family=sthsth`` evaluates the sth-sth
family (``inference_sthsth``; one action a video division, an oracle
division's the mean of its frames' targets where the target is present).
A frame-budget (AdaFocus+) model evaluates through ``inference_plus``; the
policy overrides are not defined for it and exit, as the JAX package's do.
The model keeps float32 parameters and computes in ``model.dtype``, as a
training run's does. On the GPU unless ``run.platform=cpu``; in one
process on one device, as the JAX package's evaluate (``run.host_devices``
is accepted, ``run.multihost`` refused).
``run.quantize=int8`` evaluates the int8 serving forward of the model's
family (models/quant_inference.py): it calibrates on
``run.quantize_batches`` validation batches (``calibrate_from_loader``),
prepares the int8 weights once (``prepare_q8``) and feeds the frames in the
int8 transport format; ``run.quantize_heads=true`` quantizes the policy and
the classifier too. The policy overrides do not combine with it.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from adafocus_torch.cli.common import (
    Logger,
    build_loader,
    build_model,
    check_family,
    make_batch_prep,
    select_device,
)
from adafocus_torch.cli.train import validate
from adafocus_torch.config import echo, load_config
from adafocus_torch.data.transforms import to_device
from adafocus_torch.models.gfv import GFV, glance_policy_actions, inference_with_actions
from adafocus_torch.models.gfv_sthsth import (
    actions_per_frame, glance_division_rollout, inference_sthsth_with_actions,
)
from adafocus_torch.models.quant_inference import (
    calibrate_gfv, calibration_batch, family_q8, prepare_q8,
)
from adafocus_torch.ops.metrics import topk_accuracy
from adafocus_torch.ops.patch import patch_offsets, random_patch_actions
from adafocus_torch.ops.quant import quantize_frames
from adafocus_torch.train import checkpoint as ckpt
from adafocus_torch.train.stages import _final, make_eval_step
from adafocus_torch.train.stages_plus import make_plus_eval_step
from adafocus_torch.train.stages_sthsth import make_sthsth_eval_step


def visualize_policy_patches(model, loader, prep, cfg, path, generator) -> None:
    """Render where the greedy policy looks on the first eval batch."""
    from adafocus_torch.utils.visualize import save_patch_grid

    raw = next(iter(loader))
    batch, _, _ = prep(raw, generator)
    mc = cfg.model
    with torch.no_grad(), model.autocast():
        if mc.sthsth:
            _, _, roll = glance_division_rollout(model, batch["frames_small"])
            actions = actions_per_frame(roll["actions"], batch["frames"].shape[1])
        else:
            actions = glance_policy_actions(model, batch["frames_small"])[2]["actions"]
    n = min(cfg.run.visualize_patches, actions.shape[0])
    offs = patch_offsets(actions[:n], mc.image_size, mc.patch_size).cpu().numpy()
    frames = batch["frames"][:n].float().cpu().numpy()
    save_patch_grid(path, frames, offs, mc.patch_size)


def calibrate_from_loader(model: GFV, loader, prep, cfg, n_batches: int) -> dict:
    """Per-unit int8 activation scales (``calibrate_gfv``) from the first
    ``n_batches`` validation batches: each runs the family's deployment
    phases in the compute dtype (``calibration_batch``) for its glance
    frames and the patches the greedy policy picks."""
    batches = []
    for i, raw in enumerate(loader):
        if i >= n_batches:
            break
        batch, _, _ = prep(raw)   # the eval prep draws nothing
        batches.append(calibration_batch(model, batch["frames"], batch["frames_small"]))
    if not batches:
        raise SystemExit("run.quantize: no validation batches to calibrate on")
    return calibrate_gfv(model, batches, heads=cfg.run.quantize_heads)


def make_eval_step_q8(model: GFV, scales: dict, qw: Optional[dict] = None):
    """The eval step on the int8 serving forward of the model's family
    (``family_q8``), ``qw`` the cache of ``prepare_q8``. The step's first
    act quantizes the frames to the int8 transport format, so the accuracy
    it measures is what the int8 path serves. ``step(batch, generator) ->
    (logits, {"top1", "top5"})``."""
    forward = family_q8(model.cfg)

    def step(batch, generator=None):
        logits = forward(model, scales, quantize_frames(batch["frames"]),
                         quantize_frames(batch["frames_small"]), device=model.device, qw=qw)
        top1, top5 = topk_accuracy(_final(logits).float(), batch["labels"])
        return logits, {"top1": top1, "top5": top5}

    return step


def make_eval_step_forced(model: GFV, mode: str):
    """Eval step with the patch policy overridden: 'random' or 'center'
    patches, or 'oracle' patches from the batch's ``actions`` (attached by
    the prep wrapper from the ground-truth tracks); one action a frame, or
    a video division in the sth-sth family. ``step(batch, generator) ->
    (logits, {"top1", "top5"})``."""
    if mode not in ("random", "center", "oracle"):
        raise ValueError(f"unknown forced policy {mode!r}")
    if model.cfg.frame_budget > 0:
        raise SystemExit("run.eval_policy overrides are not defined for AdaFocus+ "
                         "frame-budget models")
    sthsth = model.cfg.sthsth

    def step(batch, generator):
        small = batch["frames_small"]
        b = small.shape[0]
        n = model.cfg.video_div if sthsth else small.shape[1]
        if mode == "random":
            actions = random_patch_actions((b, n), generator, model.device)
        elif mode == "center":
            actions = torch.full((b, n, 2), 0.5, device=model.device)
        else:
            actions = batch["actions"]
        forward = inference_sthsth_with_actions if sthsth else inference_with_actions
        logits = forward(model, batch["frames"], small, actions, device=model.device)
        final = logits if sthsth else logits[:, -1]
        top1, top5 = topk_accuracy(final.float(), batch["labels"])
        return logits, {"top1": top1, "top5": top5}

    return step


def build_oracle_table(cfg, loader) -> np.ndarray:
    """(num_records, T, 2) ground-truth patch actions aligned with the val
    loader's record order, from the dataset's gt.npz (``run.oracle_gt``),
    at the focuser frames that val sampling (segment centers) picks. For a
    consensus-head model (num_records, video_div, 2): each division's the
    mean of its frames' targets where present, else the center."""
    from adafocus_torch.data.miniact import load_gt, oracle_actions
    from adafocus_torch.data.sampling import sample_segment_indices

    paths, centers, presence = load_gt(cfg.run.oracle_gt)
    row = {p: i for i, p in enumerate(paths)}
    lcfg = loader.cfg
    if lcfg.dense_sample or lcfg.twice_sample:
        raise SystemExit("eval_policy=oracle does not support multi-clip sampling")
    mc = cfg.model
    t = mc.t_focuser
    n = len(loader.records)
    out = np.empty((n, t, 2), np.float32)
    pres = np.empty((n, t), bool)
    for i, rec in enumerate(loader.records):
        r = row[rec.path]
        idx = sample_segment_indices(rec.num_frames, t, mode="val") - 1
        pres[i] = presence[r][idx]
        out[i] = oracle_actions(centers[r][idx], pres[i], lcfg.canvas_size,
                                mc.image_size, mc.patch_size)
    if mc.sthsth:
        d = mc.video_div
        pres = pres.reshape(n, d, t // d, 1)
        div = out.reshape(n, d, t // d, 2)
        w = np.maximum(pres.sum(axis=2), 1e-6)
        out = np.where(pres.any(axis=2), (div * pres).sum(axis=2) / w,
                       np.float32(0.5)).astype(np.float32)
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Evaluates ``run.resume``'s checkpoint (``model_best.pt`` when there
    is one); returns top1, top5 and mAP."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    check_family(cfg)
    policy_mode = cfg.run.eval_policy
    if policy_mode not in ("learned", "random", "center", "oracle"):
        raise SystemExit(f"unknown run.eval_policy {policy_mode!r}")
    if policy_mode != "learned" and cfg.run.quantize:
        raise SystemExit("run.eval_policy overrides cannot combine with run.quantize")
    if cfg.run.quantize not in ("", "int8"):
        raise SystemExit(f"unknown run.quantize mode {cfg.run.quantize!r}")
    if cfg.run.multihost:
        raise ValueError("run.multihost: evaluate runs in one process on one device")
    device = select_device(cfg.run)
    log = Logger(os.path.join(cfg.run.ckpt_dir, "evaluate.log"))
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
        log("WARNING: run.resume not set — evaluating a fresh init")

    loader = build_loader(cfg, train=False, device=device)
    if hasattr(loader, "fill"):
        seconds = loader.fill()
        log(f"val cache ({cfg.loader.cache}): {loader.nbytes} B filled in {seconds:.2f} s")
    prep = make_batch_prep(cfg, train=False, device=device)
    if policy_mode == "oracle":
        if not cfg.run.oracle_gt:
            raise SystemExit("eval_policy=oracle needs run.oracle_gt")
        table = to_device(build_oracle_table(cfg, loader), device)
        base_prep = prep

        def prep(raw, generator=None, _bp=base_prep, _tbl=table):
            batch, labels, k = _bp(raw, generator)
            if k != 1:
                raise SystemExit("oracle eval does not support multi-clip")
            batch["actions"] = _tbl[to_device(raw["record_index"].astype(np.int64), device)]
            return batch, labels, k

        log(f"oracle actions table built for {table.shape[0]} videos")
    if policy_mode != "learned":
        eval_step = make_eval_step_forced(model, policy_mode)
    elif cfg.run.quantize == "int8":
        scales = calibrate_from_loader(model, loader, prep, cfg, cfg.run.quantize_batches)
        log(f"int8 PTQ: calibrated {sum(len(s) for s in scales.values())} activation scales "
            f"on {cfg.run.quantize_batches} val batches")
        qw = prepare_q8(model, scales)
        log(f"int8 PTQ: prepared {sum(len(q) for q in qw.values())} quantized weight sets")
        eval_step = make_eval_step_q8(model, scales, qw)
    else:
        if cfg.run.family == "sthsth":
            learned = make_sthsth_eval_step(model)
        elif cfg.model.frame_budget > 0:
            learned = make_plus_eval_step(model)
        else:
            learned = make_eval_step(model)

        def eval_step(batch, generator):
            return learned(batch)
    multi_label = cfg.run.dataset in ("actnet", "fcvid")
    if cfg.run.visualize_patches > 0:
        path = os.path.join(cfg.run.ckpt_dir, "patches.png")
        visualize_policy_patches(model, loader, prep, cfg, path,
                                 torch.Generator(device=device).manual_seed(cfg.run.seed))
        log(f"policy patch grid saved to {path}")
    results = validate(eval_step, loader, prep, log, multi_label, cfg.run.seed, device,
                       anytime=cfg.run.anytime_eval)
    log("final: " + " ".join(f"{k}={v:.4f}" for k, v in results.items()))
    return results


if __name__ == "__main__":
    main()
