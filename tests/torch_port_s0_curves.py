"""Stage 0's validation curves through both train CLIs, at a reduced profile,
on the CPU (minutes a run; not a test).

    python -m tests.torch_port_s0_curves --seed 1007 --out curves_1007.json
        [--epochs 15] [--data DIR] [--workdir DIR] [--threads N]

The JAX package's ``cli.train`` runs stage 0 at ``run.seed=SEED``, float32,
and the run's initial weights, each training batch's augmentation draws and
random patch actions (from the batch's key) and a glancer-dropout mask
(numpy, injected through ``flax.linen.intercept_methods``) are kept; then the
port's ``cli.train`` runs from the same weights with those draws, actions
and masks replayed, on the same batches in the same order (held). Both
validate every epoch. The output holds the profile and both packages'
validation rows, epoch by epoch, and each run's seconds. From the same
start the two runs part by float32 rounding within a few steps (stage 0 is
chaotic at small sizes, ``tests/test_torch_port_train_cli_s0.py``), so the
curves are two samples of one trajectory's neighbourhood, not one curve.

The profile: the flagship's widths (MobileNetV2, ResNet-50, 1024-wide GRUs,
49 anchors) at 10 classes, 4 frames, 96^2 frames and glance (3x3 last
maps), 48^2 patches (2x2), batches of 8, the miniact generator at 8
training and 4 validation videos a class on a 112^2 canvas: ten steps an
epoch. (At 20 classes, 8 frames, 112^2 and batches of 16, a JAX step took
19 s on 8 CPU cores, an hour a run.)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import flax.linen as fnn
import jax
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from adafocus_torch.cli import common as tcommon  # noqa: E402
from adafocus_torch.cli import train as ttrain  # noqa: E402
from adafocus_torch.models import gfv as tgfv  # noqa: E402
from adafocus_torch.train import optim as toptim  # noqa: E402
from adafocus_torch.train.stages import TrainState  # noqa: E402
from adafocus_torch.weights import gfv_state_dict_from_flax  # noqa: E402
from adafocus_tpu.cli import common as jcommon  # noqa: E402
from adafocus_tpu.cli import train as jtrain  # noqa: E402
from adafocus_tpu.ops.patch import random_patch_actions  # noqa: E402
from adafocus_tpu.train import stages as jstages  # noqa: E402
from tests.test_torch_port_data import jax_draws  # noqa: E402
from tests.test_torch_port_train import _dropout_interceptor  # noqa: E402

GEN = ["--classes", "10", "--train-per-class", "8", "--val-per-class", "4",
       "--frames", "4", "--canvas", "112"]
PROFILE = ["run.platform=cpu", "run.dataset=miniact", "model.num_classes=10",
           "model.num_frames=4", "model.image_size=96", "model.glance_size=96",
           "model.patch_size=48", "model.action_dim=49", "model.dtype=float32",
           "loader.batch_size=8", "loader.canvas_size=112", "loader.cache=host",
           "run.stage=0", "run.eval_freq=1", "run.print_freq=1000"]
GLANCE_DIM = 1280


class Replay:
    """Hooks of both CLIs: the JAX run's record, replayed into the port's."""

    def __init__(self):
        self.variables = None
        self.labels, self.draws, self.actions, self.keep = [], [], [], []
        self.rows = {"jax": [], "port": []}
        self.rs = np.random.RandomState(23)
        self.n_prep = self.n_step = 0
        self.state = None

    # -- JAX ---------------------------------------------------------------
    def jax_create_train_state(self, *args, **kwargs):
        state = jstages.create_train_state(*args, **kwargs)
        self.variables = jax.tree.map(np.asarray, (state.params, state.batch_stats))
        return state

    def jax_make_batch_prep(self, cfg, train):
        prep = jcommon.make_batch_prep(cfg, train)
        if not train:
            return prep

        def run(raw, key):
            batch, labels, k = prep(raw, key)
            b, t = batch["frames_small"].shape[:2]
            half = jax.random.split(key)[0]
            self.labels.append(np.array(raw["labels"]))
            self.draws.append(jax_draws(half, b, cfg.loader.canvas_size, cfg.augment))
            self.actions.append(np.array(random_patch_actions(half, (b, t))))
            self.keep.append(self.rs.uniform(0, 1, (b * t, GLANCE_DIM)) < 0.8)
            return dict(batch, keep=self.keep[-1]), labels, k

        return run

    def jax_build_steps(self, cfg, model, tx, axis_name=None):
        train, eval_step = JAX_BUILD_STEPS(cfg, model, tx, axis_name)

        def step(state, batch, rng):
            batch = dict(batch)
            keep = batch.pop("keep")
            with fnn.intercept_methods(_dropout_interceptor(keep)):
                return train(state, batch, rng)

        return step, eval_step

    def jax_validate(self, *args, **kwargs):
        row = JAX_VALIDATE(*args, **kwargs)
        self.rows["jax"].append(row)
        return row

    # -- the port ----------------------------------------------------------
    def port_create_train_state(self, cfg, stage, optim, device=None, generator=None, ppo=None):
        model = tgfv.GFV(cfg, device=device, param_dtype=torch.float32)
        model.load_state_dict(gfv_state_dict_from_flax(*self.variables))
        self.state = TrainState(model, *toptim.make_stage_optimizer(model, stage, optim))
        return self.state

    def port_make_batch_prep(self, cfg, train, device):
        prep = tcommon.make_batch_prep(cfg, train, device)
        if not train:
            return prep

        def run(raw, generator=None, draws=None):
            i = self.n_prep
            self.n_prep += 1
            np.testing.assert_array_equal(raw["labels"], self.labels[i])
            return prep(raw, generator, self.draws[i])

        run.host_frame_bytes = 0
        return run

    def port_build_steps(self, cfg, state, replicas=None):
        train, eval_step = PORT_BUILD_STEPS(cfg, state, replicas)

        def step(batch, generator):
            i = self.n_step
            self.n_step += 1
            return train(batch, generator, torch.from_numpy(self.actions[i]),
                         torch.from_numpy(self.keep[i]))

        return step, eval_step

    def port_validate(self, *args, **kwargs):
        row = PORT_VALIDATE(*args, **kwargs)
        self.rows["port"].append(row)
        return row


JAX_BUILD_STEPS, JAX_VALIDATE = jtrain.build_steps, jtrain.validate
PORT_BUILD_STEPS, PORT_VALIDATE = ttrain.build_steps, ttrain.validate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--out", required=True)
    ap.add_argument("--data", default=os.path.join(REPO, ".data", "s0_curves"))
    ap.add_argument("--workdir", default=os.path.join(REPO, ".data", "s0_curves_work"))
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    if not os.path.exists(os.path.join(args.data, "gt.npz")):
        subprocess.run([sys.executable, "-m", "adafocus_torch.data.miniact", "--root",
                        args.data] + GEN, cwd=REPO, check=True)
    replay = Replay()
    overrides = PROFILE + [f"run.data_root={args.data}", f"run.epochs={args.epochs}",
                           f"run.seed={args.seed}"]
    seconds = {}
    for pkg, module in (("jax", jtrain), ("port", ttrain)):
        for name in ("create_train_state", "make_batch_prep", "build_steps", "validate"):
            setattr(module, name, getattr(replay, f"{pkg}_{name}"))
        ck = os.path.join(args.workdir, f"{pkg}_{args.seed}")
        t0 = time.time()
        module.main(overrides + [f"run.ckpt_dir={ck}"])
        seconds[pkg] = round(time.time() - t0, 1)
    assert replay.n_step == len(replay.actions), (replay.n_step, len(replay.actions))
    out = {"seed": args.seed, "epochs": args.epochs, "profile": PROFILE, "dataset": GEN,
           "seconds": seconds, "threads": args.threads,
           "jax": replay.rows["jax"], "port": replay.rows["port"]}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for e, (j, p) in enumerate(zip(out["jax"], out["port"])):
        print(f"epoch {e}: JAX top1 {j['top1']:.4f} mAP {j['mAP']:.4f} | "
              f"port top1 {p['top1']:.4f} mAP {p['mAP']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
