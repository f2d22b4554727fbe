"""Training entry point of the port (counterpart of adafocus_tpu/cli/train.py):
every stage of both families, one entry point.

    python -m adafocus_torch.cli.train [--config conf.yaml] [section.key=value ...]

Stage selection is ``run.stage`` (0..3), the family ``run.family``
('actnet', or 'sthsth' with ``model.classifier=consensus``: stages 1..3,
dual-rate batches; ``configs/sthsth_default.yaml``). ``model.frame_budget=K``
trains AdaFocus+ (stages 1 and 3 ``make_plus_train_step``; stage 2 the joint
PPO with ``model.plus_rl=true``, else the base stage 2 over all T frames;
its eval ``make_plus_eval_step``). The run is on the GPU unless
``run.platform=cpu``; without a GPU and without that flag it raises. Each
epoch streams the training loader through the batch prep on the device
(prefetched on a thread), trains, then evaluates and writes the
``checkpoint.pt`` / ``model_best.pt`` pair under ``run.ckpt_dir``;
``run.warm_start`` loads the previous stage's components
(``train/checkpoint.py STAGE_LOADS``), ``run.resume`` continues a run.

Data parallel (``parallel/mesh.py``), one process a replica:

- ``run.host_devices=N`` (N > 1) starts N local ranks, one GPU each over
  NCCL (or the CPU over gloo with ``run.platform=cpu``). As on the JAX
  package's single-host mesh, step i's global batch is the one a single
  process forms (``loader.batch_size`` videos, augmented from the batch's
  unfolded generator) and rank r trains on its rows (``shard_batch``); every
  rank validates the whole set, which the JAX package does not shard either.
- ``run.multihost=true`` makes this process one rank of a group: from
  ``run.coordinator`` (``host:port`` or ``file://path``),
  ``run.num_processes`` and ``run.process_id``, or from torchrun's
  environment. Each rank reads its record shard (``loader.batch_size`` a
  rank), and the validation scores are gathered before the mAP, as the JAX
  package's processes do.

Either way the steps average gradients, running statistics, returns'
moments and metrics over the ranks; each rank's step draws from its own
generator (``rank_generator``); rank 0 alone logs and writes checkpoints;
a preemption signal on any rank stops every rank at the same step.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

from adafocus_torch.cli.common import (
    EVAL_STREAM,
    Logger,
    ProgressMeter,
    batch_generator,
    build_loader,
    check_family,
    join_replicas,
    make_batch_prep,
    select_device,
    set_all_seeds,
)
from adafocus_torch.config import ExperimentConfig, echo, load_config
from adafocus_torch.ops.metrics import AverageMeter, mean_average_precision, multi_hot
from adafocus_torch.parallel.mesh import (
    Replicas, any_rank, barrier, gather_objects, rank_generator, replicate, shard_batch,
    shutdown, spawn,
)
from adafocus_torch.train import checkpoint as ckpt
from adafocus_torch.train.stages import (
    create_train_state,
    make_eval_step,
    make_stage2_step,
    make_stage_train_step,
)
from adafocus_torch.train.stages_plus import (
    make_plus_eval_step,
    make_plus_stage2_joint_step,
    make_plus_train_step,
)
from adafocus_torch.train.stages_sthsth import (
    make_sthsth_eval_step,
    make_sthsth_stage2_step,
    make_sthsth_train_step,
)


def build_steps(cfg: ExperimentConfig, state, replicas: Optional[Replicas] = None) -> tuple:
    """(train_step, eval_step) of the configured family and stage; both take
    ``(batch, generator)``. The train step averages over ``replicas``."""
    stage = cfg.run.stage
    model = state.model
    sgd = (state.optimizer, state.scheduler, replicas)
    if cfg.run.family == "sthsth":
        if stage == 2:
            train = make_sthsth_stage2_step(model, state.ppo, replicas)
        else:
            train = make_sthsth_train_step(model, stage, *sgd)
        eval_step = make_sthsth_eval_step(model)
        return train, lambda batch, generator: eval_step(batch)
    plus = cfg.model.frame_budget > 0
    if plus and stage in (1, 3):
        train = make_plus_train_step(model, stage, *sgd)
    elif plus and stage == 2 and cfg.model.plus_rl:
        train = make_plus_stage2_joint_step(model, state.ppo, replicas)
    elif stage == 2:
        train = make_stage2_step(model, state.ppo, replicas)
    else:
        train = make_stage_train_step(model, stage, *sgd)
    eval_step = make_plus_eval_step(model) if plus else make_eval_step(model)
    return train, lambda batch, generator: eval_step(batch)


def build_state(cfg: ExperimentConfig, steps_per_epoch: int, device: torch.device,
                log: Callable[[str], None] = print):
    """The stage's train state (weights from the run's seed), then the full
    resume of ``run.resume`` or the warm start of ``run.warm_start``.
    Returns (state, start_epoch, best_acc)."""
    stage = cfg.run.stage
    # the run's epochs and the loader's steps an epoch set the schedule
    # (the JAX package's make_tx; stage 2 trains by PPO's Adam instead)
    optim = dataclasses.replace(cfg.optim, epochs=cfg.run.epochs,
                                steps_per_epoch=max(steps_per_epoch, 1))
    state = create_train_state(cfg.model, stage, optim, device=device,
                               generator=set_all_seeds(cfg.run.seed), ppo=cfg.ppo)
    start_epoch, best_acc = 0, 0.0
    if cfg.run.resume:
        tree = ckpt.load_checkpoint(cfg.run.resume)
        if tree is None:
            raise SystemExit(f"no checkpoint under {cfg.run.resume}")
        ckpt.restore_train_state(state, tree)
        start_epoch = int(tree["meta"]["epoch"]) + 1
        best_acc = ckpt.best_acc_of(tree)
        log(f"resumed from {cfg.run.resume} at epoch {start_epoch}")
    elif cfg.run.warm_start:
        tree = ckpt.load_checkpoint(cfg.run.warm_start, best=True) \
            or ckpt.load_checkpoint(cfg.run.warm_start)
        if tree is None:
            raise SystemExit(f"no checkpoint under {cfg.run.warm_start}")
        ckpt.load_stage_components(state, tree, stage)
        log(f"stage-{stage} warm start from {cfg.run.warm_start} "
            f"(components: {ckpt.STAGE_LOADS[stage]})")
    return state, start_epoch, best_acc


def validate(eval_step, loader, prep, log, multi_label: bool, seed: int,
             device: torch.device, anytime: bool = False,
             gather: Optional[Replicas] = None) -> dict:
    """Eval epoch: top-1/5 and mAP over the whole set on the host. With
    multi-clip sampling or test-time views (k > 1 per video) the softmax is
    averaged over a video's k entries and top-1/5 recomputed from it. With
    ``anytime`` (a GRU head's per-step logits) it also logs the mAP after
    every step. With ``gather``, each rank's loader holds a shard of the
    set: the scores, labels and top-k counts of every rank are gathered, in
    rank order, before the metrics."""
    top1, top5 = AverageMeter("top1"), AverageMeter("top5")
    all_scores, all_labels, all_steps = [], [], []
    for i, raw in enumerate(loader):
        gen = batch_generator(seed, EVAL_STREAM, i, device)
        batch, full_labels, k = prep(raw, gen)
        logits, metrics = eval_step(batch, gen)
        b = batch["labels"].shape[0]
        probs = F.softmax(logits.float(), dim=-1).cpu().numpy()
        if k > 1:  # multi-clip eval: average the softmax over a video's clips
            probs = probs.reshape((b // k, k) + probs.shape[1:]).mean(axis=1)
        if probs.ndim == 3:
            scores = probs[:, -1]
            if anytime:
                all_steps.append(probs)
        else:
            scores = probs
        if k > 1:
            labels1 = full_labels.reshape(len(full_labels), -1)[:, 0]
            order = np.argsort(-scores, axis=1, kind="stable")
            top1.update(float((order[:, 0] == labels1).mean()), len(labels1))
            top5.update(float((order[:, :5] == labels1[:, None]).any(1).mean()),
                        len(labels1))
        else:
            top1.update(float(metrics["top1"]), b)
            top5.update(float(metrics["top5"]), b)
        all_scores.append(scores)
        all_labels.append(full_labels)
    if gather is not None:
        parts = gather_objects((all_scores, all_labels, all_steps, top1.sum, top1.count,
                                top5.sum, top5.count), gather)
        all_scores, all_labels, all_steps = ([a for p in parts for a in p[j]] for j in range(3))
        top1.sum, top1.count, top5.sum, top5.count = (sum(p[j] for p in parts)
                                                      for j in range(3, 7))
    out = {"top1": top1.avg, "top5": top5.avg}
    if all_scores:
        scores = np.concatenate(all_scores)
        labels = np.concatenate(all_labels)
        hot = multi_hot(labels, scores.shape[1]) if multi_label else \
            multi_hot(labels.reshape(len(labels), -1)[:, :1], scores.shape[1])
        out["mAP"] = mean_average_precision(scores, hot)
        if all_steps:
            steps = np.concatenate(all_steps)  # (N, T, C)
            per_t = [mean_average_precision(steps[:, t], hot)
                     for t in range(steps.shape[1])]
            log("  * anytime mAP per timestep: "
                + " ".join(f"{m:.4f}" for m in per_t))
    log("  * val: " + " ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the configured stage (``train``); returns ``best_acc``, each
    epoch's training seconds, steps, videos and videos/s (loader, batch prep
    and step, from the first batch asked of the loader to the last step
    done), the caches' fill seconds and bytes, and the final ``state``.
    With ``run.host_devices=N`` (N > 1) it runs N local ranks and returns
    rank 0's results, without the state (rank 0 wrote its checkpoints)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("overrides", nargs="*", help="section.key=value")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    check_family(cfg)
    run = cfg.run
    if run.host_devices > 1:
        if run.multihost:
            raise ValueError("run.multihost runs one rank a process: start one process a GPU "
                             "(torchrun --nproc-per-node) instead of setting run.host_devices")
        return spawn(_local_rank, run.host_devices, select_device(run).type, (cfg,))[0]
    replicas = join_replicas(run) if run.multihost else None
    try:
        return train(cfg, replicas, shard_records=True)
    finally:
        shutdown(replicas)


def _local_rank(replicas: Replicas, cfg: ExperimentConfig) -> dict:
    """One rank of ``run.host_devices``: its rows of every global batch."""
    out = train(cfg, replicas, shard_records=False)
    del out["state"]
    return out


def train(cfg: ExperimentConfig, replicas: Optional[Replicas] = None,
          shard_records: bool = True) -> dict:
    """The training run of one process: alone, or as one rank of
    ``replicas``, reading its record shard (``shard_records``) or its rows of
    the global batch; returns ``main``'s results."""
    rank0 = replicas is None or replicas.rank == 0
    device = select_device(cfg.run) if replicas is None else replicas.device
    log = Logger(os.path.join(cfg.run.ckpt_dir, cfg.run.log_file)) if rank0 \
        else (lambda msg: None)
    log(echo(cfg))
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    shard = None
    if replicas is not None:
        shard = (replicas.rank, replicas.world) if shard_records else None
        log(f"data-parallel over {replicas.world} ranks ({dist.get_backend(replicas.group)}), each "
            + ("reading its record shard" if shard_records else "training on its rows of the "
               "global batch"))

    train_loader = build_loader(cfg, train=True, device=device, shard=shard)
    val_loader = build_loader(cfg, train=False, device=device, shard=shard)
    # every rank takes as many steps an epoch as the smallest record shard gives
    steps_per_epoch = min(gather_objects(len(train_loader), replicas))
    log(f"train batches/epoch: {steps_per_epoch}, val batches: {len(val_loader)}")
    if not cfg.run.synthetic_data:
        from adafocus_torch.data import native

        log(f"frame decoder: {native.describe()}")
    caches = {}
    for name, loader in (("train", train_loader), ("val", val_loader)):
        if hasattr(loader, "fill"):
            seconds = loader.fill()
            caches[name] = {"fill_seconds": seconds, "bytes": loader.nbytes}
            log(f"{name} cache ({cfg.loader.cache}): {loader.nbytes} B filled in "
                f"{seconds:.2f} s")

    state, start_epoch, best_acc = build_state(cfg, steps_per_epoch, device, log)
    replicate(state, replicas)
    train_step, eval_step = build_steps(cfg, state, replicas)
    prep_train = make_batch_prep(cfg, train=True, device=device)
    prep_eval = make_batch_prep(cfg, train=False, device=device)
    multi_label = cfg.run.dataset in ("actnet", "fcvid")
    seed = cfg.run.seed
    world = 1 if replicas is None else replicas.world

    from adafocus_torch.data.prefetch import prefetch_to_device
    from adafocus_torch.train.preemption import PreemptionGuard

    guard = PreemptionGuard.install()

    def stopping() -> bool:
        return any_rank(guard.should_stop, replicas)

    def save_last():
        ckpt.save_checkpoint(cfg.run.ckpt_dir, state, epoch, best_acc, best_acc)

    epoch = start_epoch
    epochs = []
    stop = False
    try:
        for epoch in range(start_epoch, cfg.run.epochs):
            train_loader.set_epoch(epoch)
            meter = ProgressMeter(steps_per_epoch, prefix=f"epoch {epoch} ")

            def prep_one(raw, i, _epoch=epoch):
                # the augmentation draws from the batch's generator on every
                # rank, the step from the rank's (rank_generator)
                gen = batch_generator(seed, _epoch, i, device)
                batch, _, _ = prep_train(raw, gen)
                if not shard_records:
                    batch = shard_batch(batch, replicas)
                return batch, rank_generator(gen, replicas)

            _sync(device)
            t0 = time.perf_counter()
            n_steps = n_videos = 0
            for i, (batch, gen) in enumerate(
                    prefetch_to_device(train_loader, prep_one, device=device)):
                if i >= steps_per_epoch:
                    break
                stop = stopping()
                if stop:
                    break
                metrics = train_step(batch, gen)
                n_steps += 1
                n_videos += batch["labels"].shape[0] * world
                if rank0 and ((i + 1) % cfg.run.print_freq == 0 or i + 1 == steps_per_epoch):
                    log(meter.line(i, {k: float(v) for k, v in metrics.items()}))
            _sync(device)
            seconds = time.perf_counter() - t0
            epochs.append({"epoch": epoch, "steps": n_steps, "videos": n_videos,
                           "seconds": seconds, "videos_per_s": n_videos / seconds})
            log(f"epoch {epoch}: {n_steps} steps, {n_videos / seconds:.2f} videos/s "
                "(loader, batch prep and step)")
            stop = stop or stopping()
            if stop:
                log("preemption signal received — checkpointing and stopping")
                break

            if (epoch + 1) % cfg.run.eval_freq == 0 or epoch + 1 == cfg.run.epochs:
                results = validate(eval_step, val_loader, prep_eval, log, multi_label, seed,
                                   device, anytime=cfg.run.anytime_eval,
                                   gather=replicas if shard_records else None)
                acc = results.get("mAP", results["top1"]) if multi_label \
                    else results["top1"]
                is_best = acc > best_acc
                best_acc = max(best_acc, acc)
                if rank0:
                    ckpt.save_checkpoint(cfg.run.ckpt_dir, state, epoch, acc, best_acc, is_best)
                barrier(replicas)
                log(f"  * checkpoint saved (acc={acc:.4f}, best={best_acc:.4f})")
    finally:
        guard.uninstall()
    if replicas is None:
        guard.finalize(save_last)
    else:
        if stop and rank0:
            save_last()
        barrier(replicas)
        guard.finalize()
    log(f"done. best acc {best_acc:.4f}")
    return {"best_acc": best_acc, "epochs": epochs, "caches": caches, "state": state,
            "host_frame_bytes": prep_train.host_frame_bytes + prep_eval.host_frame_bytes}


if __name__ == "__main__":
    main()
