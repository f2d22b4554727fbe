"""Data-parallel dry run (counterpart of ``__graft_entry__.py
dryrun_multichip``).

    python -m adafocus_torch.parallel.dryrun --ranks N [--platform cpu]

Starts N local ranks (one GPU each over NCCL; with ``--platform cpu`` the
CPU over gloo) and runs, at the tiny configuration (``flagship(tiny=True)``),
one data-parallel step of each of the five step factories the JAX dry run
lifts onto its mesh: ActivityNet stage 1 and stage 2, the sth-sth stage 2,
AdaFocus+ stage 1 and its joint stage 2. Every rank starts from weights of
its own seed, which ``replicate`` overwrites with rank 0's; it trains on its
two videos of a global batch of 2N, drawing from its own generator. Each
loss must be finite and, after each step, every rank's parameters and
running statistics bit-identical to rank 0's. Without a GPU and without
``--platform cpu`` it raises; it never moves to the CPU by itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import time
from typing import Dict

import torch

from adafocus_torch.parallel.mesh import (
    Replicas, digest, gather_objects, rank_generator, replicate, shard_batch, spawn,
)

VIDEOS_A_RANK = 2
SEED = 0
TIMEOUT = datetime.timedelta(minutes=5)


def _configs() -> Dict[str, tuple]:
    """{name: (GFVConfig, stage)} of the five steps, the JAX dry run's."""
    from adafocus_torch.models.gfv import flagship

    tiny = flagship(tiny=True)
    sth = dataclasses.replace(tiny, classifier="consensus", tsm=True, video_div=2,
                              num_frames_focuser=4)
    plus = dataclasses.replace(tiny, frame_budget=1, selector_hidden=8)
    joint = dataclasses.replace(plus, frame_budget=2, plus_rl=True)
    return {"stage 1": (tiny, 1), "stage 2": (tiny, 2), "sth-sth stage 2": (sth, 2),
            "AdaFocus+ stage 1": (plus, 1), "AdaFocus+ joint stage 2": (joint, 2)}


def _global_batch(cfg, b: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The same random batch of ``b`` videos on every rank (drawn on the CPU)."""
    gen = torch.Generator().manual_seed(SEED + 1)
    s, g = cfg.image_size, cfg.glance_size
    batch = {"frames": torch.randn((b, cfg.t_focuser, s, s, 3), generator=gen),
             "frames_small": torch.randn((b, cfg.num_frames, g, g, 3), generator=gen),
             "labels": torch.randint(0, cfg.num_classes, (b,), generator=gen)}
    return {k: v.to(device) for k, v in batch.items()}


def _step(cfg, stage: int, state, replicas: Replicas):
    from adafocus_torch.train.stages import make_stage2_step, make_stage_train_step
    from adafocus_torch.train.stages_plus import (
        make_plus_stage2_joint_step, make_plus_train_step,
    )
    from adafocus_torch.train.stages_sthsth import make_sthsth_stage2_step

    model = state.model
    if stage == 2:
        if cfg.sthsth:
            return make_sthsth_stage2_step(model, state.ppo, replicas)
        if cfg.plus_rl:
            return make_plus_stage2_joint_step(model, state.ppo, replicas)
        return make_stage2_step(model, state.ppo, replicas)
    make = make_plus_train_step if cfg.frame_budget > 0 else make_stage_train_step
    return make(model, stage, state.optimizer, state.scheduler, replicas)


def run_rank(replicas: Replicas) -> Dict[str, float]:
    """One rank's five steps; returns each step's loss (averaged over the
    ranks) and the seconds the five took."""
    from adafocus_torch.train.optim import OptimConfig
    from adafocus_torch.train.stages import create_train_state

    start = time.perf_counter()
    losses = {}
    for name, (cfg, stage) in _configs().items():
        state = create_train_state(cfg, stage, OptimConfig(epochs=2, steps_per_epoch=2),
                                   device=replicas.device,
                                   generator=torch.Generator().manual_seed(SEED + replicas.rank))
        replicate(state, replicas)
        batch = shard_batch(_global_batch(cfg, VIDEOS_A_RANK * replicas.world,
                                          replicas.device), replicas)
        gen = rank_generator(torch.Generator(device=replicas.device).manual_seed(SEED + 2),
                             replicas)
        metrics = _step(cfg, stage, state, replicas)(batch, gen)
        loss = float(metrics["ppo/loss" if stage == 2 else "loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"dry run {name}: loss {loss} on rank {replicas.rank}")
        digests = gather_objects(digest(state.model), replicas)
        if len(set(digests)) != 1:
            raise AssertionError(f"dry run {name}: the replicas' weights differ after the step")
        losses[name] = loss
    return {"losses": losses, "seconds": time.perf_counter() - start}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2, help="local ranks (processes)")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="one GPU a rank over NCCL, or the CPU over gloo")
    args = ap.parse_args(argv)
    start = time.perf_counter()
    if args.platform == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise RuntimeError(f"{args.ranks} ranks need {args.ranks} GPUs; "
                               f"{torch.cuda.device_count()} visible (--platform cpu runs "
                               "on the CPU)")
        from adafocus_torch.ops import _kernels

        _kernels.build(["patch_extract"])
    out = spawn(run_rank, args.ranks, args.platform, timeout=TIMEOUT)[0]
    out["wall_seconds"] = time.perf_counter() - start
    print(f"dryrun --ranks {args.ranks} --platform {args.platform} ok: five data-parallel "
          f"steps, losses finite, replicas bit-identical after each; losses "
          f"{out['losses']}; steps {out['seconds']:.1f} s, wall {out['wall_seconds']:.1f} s",
          flush=True)
    return out


if __name__ == "__main__":
    main()
