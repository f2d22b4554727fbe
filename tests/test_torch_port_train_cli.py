"""The port's train CLI against the JAX package's, on the CPU in float64.

One stage-1 epoch of the tiny miniact set (``benchmarks/miniact_harness.py``'s
tiny profile, batches of 12: two steps) through each package's
``cli.train.main``, in-process. The port's run starts from the JAX run's
initial weights (``tests/torch_port_common.abstract_state``: the package's
structure, values from a seed) and replays JAX's augmentation draws and random patch actions from
each batch's key (JAX's batch prep and step both draw from the key's first
half). What the CLIs glue together is held:

- the loader gives the same raw batches in the same order;
- the batch prep gives the same frames within 1e-4 (the step is then fed
  JAX's prepared frames, so that the weights compare the CLI and the step,
  not the resampler's rounding);
- the same number of steps, the schedule's update count, and the learning
  rates it ends on (rtol 1e-6);
- the saved weights: every tensor that JAX leaves as it was (the frozen
  glancer and policy) bit-identical, and each trained component's update,
  parameters and running statistics apart, ||port - JAX|| / ||JAX|| within
  1e-4 (measured: 3.3e-6 at most, the classifier's parameters).

Float64, as tests/test_torch_port_train.py holds the steps, whose bounds
this follows (1e-5 of an update after one step, 2e-2 after three): the
two backbones at batch 12 amplify the packages' rounding from step to step,
and in float32 the two runs' focuser updates part by more than half their
size within this epoch. Both configurations take ``model.dtype=float64`` here only,
through their ``_DTYPES`` tables.
"""

import dataclasses
import os
import tempfile

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
from adafocus_torch.train.stages import TrainState
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
from tests.torch_port_common import abstract_state, no_init

BATCH = 12
UPDATE_TOL = 1e-4


@pytest.fixture(scope="module")
def miniact_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("miniact"))
    make_miniact(root)
    return root


def _args(root: str) -> list:
    return tiny_miniact(root) + [f"loader.batch_size={BATCH}", "run.stage=1", "run.epochs=1"]


class _JaxRun:
    """Wraps the JAX CLI's ``create_train_state`` (float64 parameters from
    ``abstract_state``, nothing compiled but the optimizer's init; the
    initial variables kept as numpy) and its training batch prep: each
    batch's raw frames and labels, prepared frames, and the augmentation
    draws and patch actions of its key, kept in order. (The draws are taken
    here, while JAX runs with 64-bit types: ``randint`` and ``uniform``
    draw other values without them.)"""

    def __init__(self):
        self.variables = None
        self.raw, self.frames, self.small, self.draws, self.actions = [], [], [], [], []

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
            self.raw.append({name: np.array(raw[name]) for name in ("frames", "labels")})
            b, t = batch["frames_small"].shape[:2]
            half = jax.random.split(key)[0]
            self.draws.append(jax_draws(half, b, cfg.loader.canvas_size, cfg.augment))
            self.actions.append(np.array(random_patch_actions(half, (b, t))))
            self.frames.append(np.array(batch["frames_flat"]))
            self.small.append(np.array(batch["frames_small"]))
            return batch, labels, k

        return run


@pytest.fixture(scope="module")
def runs(miniact_root):
    """Both CLIs' stage-1 epoch. Returns (what the JAX run used, JAX's
    checkpoint tree, the port's, the port's hook counts); the checkpoints'
    directories are removed at once (about 380 MB each in float64)."""
    args = _args(miniact_root) + ["model.dtype=float64"]
    jcfg = jconfig.load_config(None, _args(miniact_root))
    s = jcfg.model.image_size
    seen = _JaxRun()
    counts = {"prep": 0, "step": 0}
    build_steps = ttrain.build_steps

    def create_train_state(cfg, stage, optim, device=None, generator=None, ppo=None):
        with no_init():
            model = tgfv.GFV(cfg, device=device, param_dtype=torch.float64)
        model.load_state_dict(gfv_state_dict_from_flax(*seen.variables, dtype=torch.float64))
        return TrainState(model, *toptim.make_stage_optimizer(model, stage, optim))

    def make_batch_prep(cfg, train, device):
        prep = tcommon.make_batch_prep(cfg, train, device)
        if not train:
            return prep

        def run(raw, generator=None, draws=None):
            i = counts["prep"]
            counts["prep"] += 1
            np.testing.assert_array_equal(raw["frames"], seen.raw[i]["frames"])
            np.testing.assert_array_equal(raw["labels"], seen.raw[i]["labels"])
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
            return train(batch, generator, torch.from_numpy(seen.actions[i]))

        return step, eval_step

    with tempfile.TemporaryDirectory() as out, pytest.MonkeyPatch.context() as mp:
        jdir, tdir = os.path.join(out, "jax"), os.path.join(out, "port")
        # the tests' JAX runs on 8 virtual CPU devices (tests/conftest.py);
        # the CLI is shown one, as a process of its own on a CPU sees
        mp.setattr(jax, "device_count", lambda *a: 1)
        mp.setitem(jconfig._DTYPES, "float64", jnp.float64)
        mp.setitem(tconfig._DTYPES, "float64", torch.float64)
        mp.setattr(jtrain, "create_train_state", seen.create_train_state)
        mp.setattr(jtrain, "make_batch_prep", seen.make_batch_prep)
        # the switch is global, not a context: the CLI preps each batch on
        # a thread of its own, which a context's (thread-local) setting
        # would not reach
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
    return seen, jtree, ttree, counts


def test_train_clis_take_the_same_steps(runs, miniact_root):
    """The same batches (checked in the hooks), as many steps as JAX, and
    the same schedule count and learning rates at the end."""
    seen, jtree, ttree, counts = runs
    n = len(seen.raw)
    assert n == counts["prep"] == counts["step"] == int(jtree["step"]) == 24 // BATCH
    assert ttree["scheduler"]["last_epoch"] == n
    optim = jconfig.load_config(None, _args(miniact_root)).optim
    optim = dataclasses.replace(optim, epochs=1, steps_per_epoch=n)
    want = [float(lr_schedule(lr, optim)(n)) for lr in (optim.backbone_lr, optim.fc_lr)]
    np.testing.assert_allclose(ttree["scheduler"]["_last_lr"], want, rtol=1e-6)


def test_train_clis_save_the_same_weights(runs):
    seen, jtree, ttree, _ = runs
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
