"""The port's train CLI against the JAX package's for the sth-sth family, on
the CPU in float64.

One stage-1 epoch of the tiny miniact set (a batch of all 24 videos: one
step) with
the family's overrides (``run.family=sthsth``: TSM backbones, 4 glance and
6 focuser frames a clip, two video divisions, the consensus head, the TSN
optimizer groups) through each package's ``cli.train.main``, in-process, as
tests/test_torch_port_train_cli.py runs the ActivityNet family's. The port
starts from the JAX run's initial weights
(``tests/torch_port_common.abstract_state``) and replays JAX's draws of each batch's
key: both streams' augmentation (the glancer's from the key's first half,
the focuser's from its second), the step's random patch actions, and the
head's dropout mask (drawn on both sides from the key, folded with a
constant, and intercepted in JAX's step). What the CLIs glue together is
held:

- the loader gives the same raw batches, both streams, in the same order;
- the dual-rate batch prep gives the same frames within 1e-4 (the step is
  then fed JAX's prepared frames);
- the same number of steps, the schedule's update count and every group's
  learning rate at the end (rtol 1e-6);
- the saved weights: every tensor JAX leaves as it was bit-identical, and
  each trained component's update, parameters and running statistics
  apart, ||port - JAX|| / ||JAX|| within 1e-4, the bound of the ActivityNet
  CLI's test (measured 5.2e-8, the focuser's parameters).

One step, where the ActivityNet CLI's test takes two: with TSM and 16^2
patches a second step amplifies the first's float64 rounding to 6.3e-4 of
the focuser's update (batches of 12), the trajectories parting as
tests/test_torch_port_train.py's three-step stage-1 case shows.
"""

import dataclasses
import os
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch import config as tconfig
from adafocus_torch.cli import common as tcommon
from adafocus_torch.cli import train as ttrain
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.train import checkpoint as tckpt
from adafocus_torch.train import optim as toptim
from adafocus_torch.train.stages import TrainState, optimizer_stage
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu import config as jconfig
from adafocus_tpu.cli import common as jcommon
from adafocus_tpu.cli import train as jtrain
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.train import checkpoint as jckpt
from adafocus_tpu.train.optim import lr_schedule
from tests.test_torch_port_cli import tiny_miniact
from tests.test_torch_port_data import ATOL, jax_draws, make_miniact
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_port_train import _dropout_interceptor
from tests.torch_port_common import abstract_state, no_init
from tests.torch_port_common import scratch_path  # noqa: F401 (a fixture)

BATCH = 24
UPDATE_TOL = 1e-4
# the sth-sth family at the tiny profile's sizes
STHSTH = ["run.family=sthsth", "model.classifier=consensus", "model.tsm=true",
          "model.num_frames_focuser=6", "model.video_div=2", "model.policy_bn=true",
          "model.policy_channels=8", "model.continuous_policy=true",
          "optim.tsn_policies=true"]
# the fold of a batch key that draws the head's dropout mask
KEEP_FOLD = 7


@pytest.fixture(scope="module")
def miniact_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("miniact"))
    make_miniact(root)
    return root


def sthsth_args(root: str) -> list:
    return tiny_miniact(root) + STHSTH


def _keep_of(key, b: int, tf: int, rate: float):
    return jax.random.uniform(jax.random.fold_in(key, KEEP_FOLD), (b, tf, 2048)) < 1.0 - rate


class _JaxRun:
    """Wraps the JAX CLI's ``create_train_state`` (float64 parameters from
    ``abstract_state``, nothing compiled but the optimizer's init; the
    initial variables kept as numpy), its training batch prep (each batch's
    raw streams, prepared frames, and the draws of its key, kept in order)
    and its steps (the train step's dropout mask from the key)."""

    def __init__(self, build_steps):
        self._build_steps = build_steps
        self.variables = None
        self.raw, self.frames, self.small, self.draws, self.actions, self.keep = (
            [], [], [], [], [], [])

    def create_train_state(self, model, rng, tx=None, ppo_cfg=None):
        state = abstract_state(model, rng, tx, ppo_cfg)
        self.variables = jax.tree.map(np.asarray, (state.params, state.batch_stats))
        return state

    def make_batch_prep(self, cfg, train):
        prep = jcommon.make_batch_prep(cfg, train)
        if not train:
            return prep

        def run(raw, key):
            batch, labels, k = prep(raw, key)
            self.raw.append({name: np.array(raw[name])
                             for name in ("frames", "frames_focuser", "labels")})
            b, tf = batch["frames_flat"].shape[:2]
            k1, k2 = jax.random.split(key)
            canvas = cfg.loader.canvas_size
            self.draws.append((jax_draws(k1, b, canvas, cfg.augment),
                               jax_draws(k2, b, canvas, cfg.augment)))
            a_key = jax.random.split(key)[0]
            self.actions.append(np.array(random_patch_actions(jax.random.split(a_key)[0],
                                                              (b, tf))))
            self.keep.append(np.array(_keep_of(key, b, tf, cfg.model.dropout)))
            self.frames.append(np.array(batch["frames_flat"]))
            self.small.append(np.array(batch["frames_small"]))
            return batch, labels, k

        return run

    def build_steps(self, cfg, model, tx, axis_name=None):
        train, eval_step = self._build_steps(cfg, model, tx, axis_name)

        def step(state, batch, rng):
            b, tf = batch["frames_flat"].shape[:2]
            keep = _keep_of(rng, b, tf, cfg.model.dropout)
            with fnn.intercept_methods(_dropout_interceptor(keep)):
                return train(state, batch, rng)

        return step, eval_step


@pytest.fixture(scope="module")
def runs(miniact_root):
    """Both CLIs' sth-sth stage-1 epoch. Returns (what the JAX run used,
    JAX's checkpoint tree, the port's, the port's hook counts); the
    checkpoints' directories are removed at once."""
    base = sthsth_args(miniact_root) + [f"loader.batch_size={BATCH}", "run.stage=1",
                                        "run.epochs=1"]
    args = base + ["model.dtype=float64"]
    jcfg = jconfig.load_config(None, base)
    s = jcfg.model.image_size
    seen = _JaxRun(jtrain.build_steps)
    counts = {"prep": 0, "step": 0}
    build_steps = ttrain.build_steps

    def create_train_state(cfg, stage, optim, device=None, generator=None, ppo=None):
        with no_init():
            model = tgfv.GFV(cfg, device=device, param_dtype=torch.float64)
        model.load_state_dict(gfv_state_dict_from_flax(*seen.variables, dtype=torch.float64))
        return TrainState(model, *toptim.make_stage_optimizer(
            model, optimizer_stage(cfg, stage), optim, partial_bn=cfg.partial_bn))

    def make_batch_prep(cfg, train, device):
        prep = tcommon.make_batch_prep(cfg, train, device)
        if not train:
            return prep

        def run(raw, generator=None, draws=None):
            i = counts["prep"]
            counts["prep"] += 1
            for name in ("frames", "frames_focuser", "labels"):
                np.testing.assert_array_equal(raw[name], seen.raw[i][name])
            batch, labels, k = prep(raw, generator, seen.draws[i])
            frames = seen.frames[i][..., : s * 3].reshape(seen.frames[i].shape[:3] + (s, 3))
            np.testing.assert_allclose(batch["frames"].numpy(), frames, rtol=0, atol=ATOL)
            np.testing.assert_allclose(batch["frames_small"].numpy(), seen.small[i],
                                       rtol=0, atol=ATOL)
            batch["frames"] = torch.from_numpy(np.ascontiguousarray(frames))
            batch["frames_small"] = torch.from_numpy(seen.small[i])
            return batch, labels, k

        run.host_frame_bytes = 0
        return run

    def build_replayed_steps(cfg, state, replicas=None):
        train, eval_step = build_steps(cfg, state, replicas)

        def step(batch, generator):
            i = counts["step"]
            counts["step"] += 1
            return train(batch, generator, torch.from_numpy(seen.actions[i]),
                         torch.from_numpy(seen.keep[i]))

        return step, eval_step

    with tempfile.TemporaryDirectory() as out, pytest.MonkeyPatch.context() as mp:
        jdir, tdir = os.path.join(out, "jax"), os.path.join(out, "port")
        mp.setattr(jax, "device_count", lambda *a: 1)
        mp.setitem(jconfig._DTYPES, "float64", jnp.float64)
        mp.setitem(tconfig._DTYPES, "float64", torch.float64)
        mp.setattr(jtrain, "create_train_state", seen.create_train_state)
        mp.setattr(jtrain, "make_batch_prep", seen.make_batch_prep)
        mp.setattr(jtrain, "build_steps", seen.build_steps)
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            jtrain.main(args + [f"run.ckpt_dir={jdir}"])
            jtree = jax.tree.map(np.asarray, jckpt.load_checkpoint(jdir))
        finally:
            jax.config.update("jax_enable_x64", x64)
        mp.setattr(ttrain, "create_train_state", create_train_state)
        mp.setattr(ttrain, "make_batch_prep", make_batch_prep)
        mp.setattr(ttrain, "build_steps", build_replayed_steps)
        ttrain.main(args + [f"run.ckpt_dir={tdir}"])
        ttree = tckpt.load_checkpoint(tdir)
    return seen, jtree, ttree, counts, jcfg


def test_sthsth_train_clis_take_the_same_steps(runs):
    """The same batches (checked in the hooks), as many steps as JAX, and
    the same schedule count and group learning rates at the end."""
    seen, jtree, ttree, counts, jcfg = runs
    n = len(seen.raw)
    assert n == counts["prep"] == counts["step"] == int(jtree["step"]) == 24 // BATCH
    assert ttree["scheduler"]["last_epoch"] == n
    optim = dataclasses.replace(jcfg.optim, epochs=1, steps_per_epoch=n)
    mults = {"fc": (optim.fc_lr, 1.0), "tsn_first_conv_weight": (optim.backbone_lr, 1.0),
             "tsn_normal_weight": (optim.backbone_lr, 1.0),
             "tsn_normal_bias": (optim.backbone_lr, 2.0), "tsn_bn": (optim.backbone_lr, 1.0)}
    names = [g["name"] for g in ttree["optimizer"]["param_groups"]]
    assert names == list(mults)
    want = [float(lr_schedule(base * m, optim)(n)) for base, m in mults.values()]
    np.testing.assert_allclose(ttree["scheduler"]["_last_lr"], want, rtol=1e-6)


def test_sthsth_train_clis_save_the_same_weights(runs):
    seen, jtree, ttree, _, _ = runs
    init = gfv_state_dict_from_flax(*seen.variables, dtype=torch.float64)
    want = gfv_state_dict_from_flax(jtree["params"], jtree["batch_stats"], dtype=torch.float64)
    got = {f"{comp}.{key}": value for comp in tckpt.COMPONENTS
           for key, value in ttree["components"][comp].items()}
    keys = [k for k in init if not k.endswith("num_batches_tracked")]
    moved = {k for k in keys if not torch.equal(want[k], init[k])}
    assert {k.split(".")[0] for k in moved} == {"focuser", "classifier"}
    for k in keys:
        if k not in moved:
            assert torch.equal(got[k], init[k]), f"{k} moved; JAX leaves it"
    for comp in ("focuser", "classifier"):
        for stats in (False, True):
            group = [k for k in moved if k.startswith(comp + ".")
                     and k.endswith(("running_mean", "running_var")) == stats]
            if group:
                upd = torch.cat([(got[k] - init[k]).flatten() for k in group])
                ref = torch.cat([(want[k] - init[k]).flatten() for k in group])
                err = float((upd - ref).norm() / ref.norm())
                assert err <= UPDATE_TOL, (comp, "running statistics" if stats else
                                           "parameters", err)


def test_port_cli_trains_sthsth_stages_and_evaluates(miniact_root, scratch_path):
    """The port's CLIs alone at the tiny sizes, float32: stage 1, stage 2
    warm-started from it with the continuous and with the discrete policy,
    stage 3 from the continuous stage 2, then evaluate with every policy.
    Each stage 2 leaves the components it does not train as stage 1 saved
    them; stage 0 of the family raises, as JAX's does."""
    import shutil

    from adafocus_torch.cli import evaluate as tevaluate

    base = sthsth_args(miniact_root) + ["run.epochs=1"]
    ck = scratch_path
    res = ttrain.main(base + ["run.stage=1", f"run.ckpt_dir={ck}/s1"])
    assert np.isfinite(res["best_acc"])
    stage1 = tckpt.load_checkpoint(f"{ck}/s1", best=True)["components"]
    for policy_args, out in ((["model.continuous_policy=false"], "s2d"), ([], "s2")):
        res = ttrain.main(base + policy_args + ["run.stage=2", f"run.ckpt_dir={ck}/{out}",
                                                f"run.warm_start={ck}/s1"])
        model = res["state"].model
        for comp in ("glancer", "focuser", "classifier"):
            for key, value in getattr(model, comp).state_dict().items():
                assert torch.equal(value, stage1[comp][key]), (out, comp, key)
        assert model.policy.actor.out_features == (4 if policy_args else 2)
    shutil.rmtree(f"{ck}/s1")
    shutil.rmtree(f"{ck}/s2d")
    res = ttrain.main(base + ["run.stage=3", f"run.ckpt_dir={ck}/s3", f"run.warm_start={ck}/s2"])
    assert np.isfinite(res["best_acc"])
    shutil.rmtree(f"{ck}/s2")
    for policy in ("learned", "random", "center", "oracle"):
        out = tevaluate.main(base + [f"run.resume={ck}/s3", f"run.ckpt_dir={ck}/ev",
                                     f"run.eval_policy={policy}",
                                     f"run.oracle_gt={miniact_root}/gt.npz"])
        assert all(0.0 <= v <= 1.0 for v in out.values()), (policy, out)
    with pytest.raises(ValueError, match="no stage 0"):
        ttrain.main(base + ["run.stage=0", f"run.ckpt_dir={ck}/s0"])
