"""Stage 0 through both train CLIs across epochs, on the CPU in float64.

Four stage-0 epochs of a small miniact set (the tiny profile's model and
4 classes, 2 training and 3 validation videos a class; batches of 8: one
step an epoch) through each package's ``cli.train.main``, in-process,
validating after every epoch (``run.eval_freq=1``). Each run is killed as
its fourth epoch asks for its first batch, after the third epoch's
checkpoint, and resumed from it (``run.resume``) for the fourth. The port's
run starts from the JAX run's initial weights (random from a seed, in the
structure of JAX's ``create_train_state``, BatchNorms fresh) and replays,
from each batch's key, JAX's augmentation draws and random patch actions;
the glancer head's
dropout mask of each step is drawn with numpy and injected into both (into
JAX through ``flax.linen.intercept_methods``, as tests/test_torch_port_train.py
does). The validation batches, like the training ones, reach the port as
JAX prepared them (checked within 1e-4 first). What the loop adds to the
steps is held:

- the raw batches and their order in every epoch, the resumed one included
  (``train_loader.set_epoch``);
- each step's learning rates, and the count and rates each epoch ends on,
  against JAX's schedule (rtol 1e-6: it runs in float32);
- each epoch's validation row: top-1 and top-5 equal, every score within
  ``SCORE_TOL``, the mAP within ``MAP_TOL`` (ties in float32 scores) and
  equal on scores rounded to ``SCORE_TOL``;
- ``best_acc`` of both runs, and the epoch whose weights ``model_best`` holds;
- after the resume: the schedule's count, and each trained component's
  momentum, ||port - JAX|| / ||JAX|| within ``MOMENTUM_TOL``;
- the weights saved after the third epoch and after the fourth: each
  trained component's update from the initial weights, parameters and
  running statistics apart, ||port - JAX|| / ||JAX|| within ``UPDATE_TOL``.

Measured bounds are beside each constant below.

Float64, through both configurations' ``_DTYPES`` tables, as
tests/test_torch_port_train_cli.py runs stage 1; and float64 throughout:
the test takes the cross-entropy without its float32 cast in both packages
and JAX's cosine schedule in float64. At the tiny profile's sizes stage 0
is chaotic (measured at batches of 12): a relative difference of 1e-12 in
the port's own initial weights grows to 1e-2 of an update within five
steps, and the two float32 roundings (the
loss's, ~6e-8, and JAX's learning rate, 2.2e-8 at 0.01) would swamp every
bound by the third step (PERF.md, §6). Each rounding is held where it
is made: the float32 loss by the step tests (tests/test_torch_port_train.py),
the schedule here, at rtol 1e-6.

``test_resume_with_more_epochs_takes_the_schedule_at_the_count`` holds the
port's resume of a run asked for more epochs than it was saved under: the
first update takes the new schedule at the restored count, as optax
evaluates its schedule, not the rate the optimizer was saved with.
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
from adafocus_torch.data import miniact as tminiact
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.ops.metrics import mean_average_precision
from adafocus_torch.train import checkpoint as tckpt
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.train.stages import TrainState
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu import config as jconfig
from adafocus_tpu.cli import common as jcommon
from adafocus_tpu.cli import train as jtrain
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.train import checkpoint as jckpt
from adafocus_tpu.train import optim as joptim
from adafocus_tpu.train import stages as jstages
from adafocus_tpu.train.optim import lr_schedule
from tests.test_torch_port_cli import tiny_miniact
from tests.test_torch_port_data import ATOL, MINIACT_GEN, jax_draws
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_port_train import _dropout_interceptor
from tests.torch_port_common import abstract_variables, fresh_bn, no_init, removed_after
from tests.torch_port_common import scratch_path  # noqa: F401 (a fixture)

BATCH = 8
EPOCHS = 4               # the run is killed before the last, then resumed
KILLED_AT = EPOCHS - 1   # the epoch whose first batch the first run asks for last
STEPS = 1                # 8 training videos: one step an epoch
VAL_BATCHES = 2          # 12 validation videos
TRAINED = ("glancer", "focuser", "classifier")
SCORE_TOL = 1e-3         # measured 2.3e-4 (epoch 2), 3e-8 at the other epochs
# the tiny model gives several validation videos the same float32 score, and
# each package's rounding orders such ties its own way: measured 0.0556
# (epoch 0), equal at the other epochs
MAP_TOL = 0.06
MOMENTUM_TOL = 1e-4      # measured 1.1e-5 (the classifier's)
UPDATE_TOL = 1e-5        # measured 5.2e-8 after the third epoch, 9.8e-7 after the fourth
GLANCE_DIM = jstages.GFVConfig().glance_dim
JAX_BUILD_STEPS, JAX_VALIDATE = jtrain.build_steps, jtrain.validate
JAX_RESTORE = jckpt.restore_train_state


def _recording_map(module, record):
    """``module.mean_average_precision``, keeping each validation's scores
    in ``record.scores``."""
    fn = module.mean_average_precision

    def run(scores, hot):
        record.scores.append((np.array(scores, np.float64), np.array(hot)))
        return fn(scores, hot)

    return run


def _jax_lr_schedule64(base_lr, cfg):
    """The JAX package's cosine schedule (``train/optim.py lr_schedule``)
    evaluated in float64: the package's runs in float32."""
    assert cfg.lr_type == "cos"
    spe = max(cfg.steps_per_epoch, 1)
    return lambda step: 0.5 * base_lr * (1.0 + jnp.cos(
        jnp.pi * (jnp.asarray(step, jnp.float64) / spe) / cfg.epochs))


def _jax_ce64(logits, labels):
    """``adafocus_tpu.train.stages._ce_per_step`` without its float32 cast."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None, None].astype(jnp.int32), axis=-1))


def _port_ce64(logits, labels):
    """``adafocus_torch.train.stages._ce_per_step`` without its float32 cast."""
    logp = torch.log_softmax(logits, dim=-1)
    b, t = logp.shape[:2]
    return -logp.gather(-1, labels.long().reshape(b, 1, 1).expand(b, t, 1)).mean()


def _as_structure(target, saved):
    """``saved`` (orbax's restored tree: dicts and lists) in the structure of
    ``target`` (optax's state: named tuples, tuples, dicts, arrays)."""
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(**{f: _as_structure(getattr(target, f), saved[f])
                               for f in target._fields})
    if isinstance(target, (tuple, list)):
        return type(target)(_as_structure(t, s) for t, s in zip(target, saved))
    if isinstance(target, dict):
        return {k: _as_structure(v, saved[k]) for k, v in target.items()}
    if target is None:
        return None
    return jnp.asarray(saved, target.dtype)


@pytest.fixture(scope="module")
def miniact_root(tmp_path_factory):
    with removed_after(tmp_path_factory.mktemp("miniact_s0")) as root:
        g = MINIACT_GEN
        tminiact.generate(str(root), tminiact.MiniactConfig(
            num_classes=g["classes"], train_per_class=2, val_per_class=3,
            num_frames=g["frames"], canvas=g["canvas"], tile=16, min_present=2, max_drift=12),
            log=lambda msg: None)
        yield str(root)


def _args(root: str) -> list:
    return tiny_miniact(root) + [f"loader.batch_size={BATCH}", "run.stage=0",
                                 f"run.epochs={EPOCHS}", "run.eval_freq=1",
                                 "model.dtype=float64"]


class _Killed(Exception):
    """The first run's end, as its last epoch asks for a batch."""


class _JaxRun:
    """Wraps the JAX CLI: ``create_train_state`` (float64 parameters; the
    first run's initial variables kept as numpy), the batch prep (each
    training batch's raw frames and labels, prepared frames, augmentation
    draws, patch actions and a dropout mask, and each validation batch's
    prepared frames, in order; it ends the first run as its last epoch
    asks for a batch), ``build_steps`` (the batch's dropout mask injected;
    the resumed run, whose configuration is the same, gets the same
    functions, so that ``jax.jit`` compiles them once), the resume and
    ``validate`` (each row, with the update count)."""

    def __init__(self):
        self.variables = self.state = self.steps = None
        self.preps = {}
        self.raw, self.frames, self.small, self.draws, self.actions, self.keep = \
            [], [], [], [], [], []
        self.eval_frames, self.eval_small, self.rows, self.counts = [], [], [], []
        self.scores = []
        self.rs = np.random.RandomState(17)
        self.kill = True

    def create_train_state(self, model, rng, tx=None, ppo_cfg=None):
        """``create_train_state``'s structure, float64 values from a seed
        (``abstract_variables``: nothing compiled, where the package's jitted
        init takes ~27 s); the resumed run, of the same configuration, gets
        the same fresh state to restore into."""
        if self.state is None:
            _, variables = abstract_variables(model.cfg, seed=5)
            variables = {k: fresh_bn(v) for k, v in variables.items()}
            self.variables = (variables["params"], variables["batch_stats"])
            self.state = jstages.TrainState(
                params=variables["params"], batch_stats=variables["batch_stats"],
                opt_state=jax.jit(tx.init)(variables["params"]), step=jnp.zeros((), jnp.int32))
        return self.state

    def make_batch_prep(self, cfg, train):
        """The package's prep, made once a kind (jitted once)."""
        if train not in self.preps:
            self.preps[train] = self._logged_prep(cfg, train)
        return self.preps[train]

    def _logged_prep(self, cfg, train):
        prep = jcommon.make_batch_prep(cfg, train)

        def run(raw, key):
            if train and self.kill and len(self.raw) == KILLED_AT * STEPS:
                self.kill = False
                raise _Killed
            batch, labels, k = prep(raw, key)
            if not train:
                self.eval_frames.append(np.array(batch["frames_flat"]))
                self.eval_small.append(np.array(batch["frames_small"]))
                return batch, labels, k
            self.raw.append({name: np.array(raw[name]) for name in ("frames", "labels")})
            b, t = batch["frames_small"].shape[:2]
            half = jax.random.split(key)[0]
            self.draws.append(jax_draws(half, b, cfg.loader.canvas_size, cfg.augment))
            self.actions.append(np.array(random_patch_actions(half, (b, t))))
            self.frames.append(np.array(batch["frames_flat"]))
            self.small.append(np.array(batch["frames_small"]))
            self.keep.append(self.rs.uniform(0, 1, (b * t, GLANCE_DIM)) < 0.8)
            return dict(batch, keep=jnp.asarray(self.keep[-1])), labels, k

        return run

    def build_steps(self, cfg, model, tx, axis_name=None):
        if self.steps is None:
            train, eval_step = JAX_BUILD_STEPS(cfg, model, tx, axis_name)

            def step(state, batch, rng):
                batch = dict(batch)
                keep = batch.pop("keep")
                with fnn.intercept_methods(_dropout_interceptor(keep)):
                    return train(state, batch, rng)

            self.steps = (step, eval_step)
        return self.steps

    @staticmethod
    def restore_train_state(state, tree):
        """The JAX package's ``restore_train_state``, with the optimizer
        state put back into optax's structure. The package's own hands optax
        orbax's restored tree, in which optax's named tuples are dicts and
        its tuples lists, and the first update after a resume then fails
        (``'dict' object has no attribute 'inner_states'``); the saved leaves
        are kept as they are."""
        restored = JAX_RESTORE(state, tree)
        return restored.replace(opt_state=_as_structure(state.opt_state, tree["opt_state"]))

    def validate(self, state, *args, **kwargs):
        row = JAX_VALIDATE(state, *args, **kwargs)
        self.rows.append(row)
        self.counts.append(int(state.step))
        return row


class _PortRun:
    """The port's CLI hooked to replay ``seen``: JAX's initial weights, its
    prepared training and validation frames (after checking the port's own
    within ``ATOL``), its draws, actions and dropout masks; the first run
    ends where JAX's did; each step's learning rates and each validation row
    are kept, the row with the update count and the rates."""

    def __init__(self, seen: _JaxRun):
        self.seen = seen
        self.n_prep = self.n_step = self.n_eval = 0
        self.state = None
        self.kill = True
        self.rows, self.counts, self.lrs, self.step_lrs, self.scores = [], [], [], [], []

    def create_train_state(self, cfg, stage, optim, device=None, generator=None, ppo=None):
        with no_init():
            model = tgfv.GFV(cfg, device=device, param_dtype=torch.float64)
        model.load_state_dict(gfv_state_dict_from_flax(*self.seen.variables,
                                                       dtype=torch.float64))
        self.state = TrainState(model, *toptim.make_stage_optimizer(model, stage, optim))
        return self.state

    def make_batch_prep(self, cfg, train, device):
        prep = tcommon.make_batch_prep(cfg, train, device)
        s = cfg.model.image_size
        seen = self.seen

        def as_port(flat):
            return torch.from_numpy(np.ascontiguousarray(
                flat[..., : s * 3].reshape(flat.shape[:3] + (s, 3))))

        def run(raw, generator=None, draws=None):
            if train:
                if self.kill and self.n_prep == KILLED_AT * STEPS:
                    self.kill = False
                    raise _Killed
                i = self.n_prep
                self.n_prep += 1
                np.testing.assert_array_equal(raw["frames"], seen.raw[i]["frames"])
                np.testing.assert_array_equal(raw["labels"], seen.raw[i]["labels"])
                batch, labels, k = prep(raw, generator, seen.draws[i])
                frames, small = as_port(seen.frames[i]), seen.small[i]
            else:
                i = self.n_eval
                self.n_eval += 1
                batch, labels, k = prep(raw, generator)
                frames, small = as_port(seen.eval_frames[i]), seen.eval_small[i]
            np.testing.assert_allclose(batch["frames"].numpy(), frames.numpy(), rtol=0, atol=ATOL)
            np.testing.assert_allclose(batch["frames_small"].numpy(), small, rtol=0, atol=ATOL)
            batch["frames"], batch["frames_small"] = frames, torch.from_numpy(small)
            return batch, labels, k

        run.host_frame_bytes = 0
        return run

    def build_steps(self, cfg, state, replicas=None):
        train, eval_step = PORT_BUILD_STEPS(cfg, state, replicas)

        def step(batch, generator):
            i = self.n_step
            self.n_step += 1
            self.step_lrs.append([g["lr"] for g in self.state.optimizer.param_groups])
            return train(batch, generator, torch.from_numpy(self.seen.actions[i]),
                         torch.from_numpy(self.seen.keep[i]))

        return step, eval_step

    def validate(self, *args, **kwargs):
        row = PORT_VALIDATE(*args, **kwargs)
        self.rows.append(row)
        self.counts.append(self.state.scheduler.last_epoch)
        self.lrs.append([g["lr"] for g in self.state.optimizer.param_groups])
        return row


PORT_BUILD_STEPS, PORT_VALIDATE = ttrain.build_steps, ttrain.validate


def _momentum(optimizer_state, names):
    """{port parameter name: momentum buffer} of a port optimizer state dict
    (``names``: the parameter names in the optimizer's order)."""
    state = optimizer_state["state"]
    order = [i for g in optimizer_state["param_groups"] for i in g["params"]]
    return {names[j]: state[i]["momentum_buffer"] for j, i in enumerate(order)}


def _jax_traces(opt_state):
    """{port parameter name: momentum trace} of JAX's saved multi_transform
    state: each label's ``sgd`` trace, its masked-out leaves dropped."""
    found = {}

    def walk(node):
        if isinstance(node, dict):
            if isinstance(node.get("trace"), dict):
                found.update(gfv_state_dict_from_flax(_unmask(node["trace"]), {},
                                                      torch.float64))
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    return found


def _unmask(tree):
    """A label's trace without the leaves of other labels (optax's
    ``MaskedNode``, saved empty)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _unmask(v)
            if sub:
                out[k] = sub
        elif v is not None and np.asarray(v).size:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs(miniact_root):
    """Both CLIs' stage 0, killed before the last epoch and resumed. Returns
    (the JAX run's record, the port's, {package: ``main``'s results of the
    resumed run, the checkpoints after the third epoch and after the
    fourth, ``model_best``})."""
    seen = _JaxRun()
    port = _PortRun(seen)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
        # the tests' JAX runs on 8 virtual CPU devices (tests/conftest.py);
        # the CLI is shown one, as a process of its own on a CPU sees
        mp.setattr(jax, "device_count", lambda *a: 1)
        mp.setitem(jconfig._DTYPES, "float64", jnp.float64)
        mp.setitem(tconfig._DTYPES, "float64", torch.float64)
        for name in ("create_train_state", "make_batch_prep", "build_steps", "validate"):
            mp.setattr(jtrain, name, getattr(seen, name))
            mp.setattr(ttrain, name, getattr(port, name))
        mp.setattr(jckpt, "restore_train_state", seen.restore_train_state)
        for mod, record in ((jtrain, seen), (ttrain, port)):
            mp.setattr(mod, "mean_average_precision", _recording_map(mod, record))
        # float64 throughout: the loss (both packages cast it to float32)
        # and JAX's schedule (float32)
        mp.setattr(joptim, "lr_schedule", _jax_lr_schedule64)
        mp.setattr(jstages, "_ce_per_step", _jax_ce64)
        mp.setattr(tstages, "_ce_per_step", _port_ce64)
        for pkg, main, load in (("jax", jtrain.main, jckpt.load_checkpoint),
                                ("port", ttrain.main, tckpt.load_checkpoint)):
            ck = os.path.join(tmp, pkg)
            args = _args(miniact_root) + [f"run.ckpt_dir={ck}"]
            # the switch is global, not a context: the CLI preps each batch
            # on a thread of its own, which a context's setting would not reach
            x64 = jax.config.jax_enable_x64
            jax.config.update("jax_enable_x64", pkg == "jax" or x64)
            try:
                with pytest.raises(_Killed):
                    main(args)
                after_three = load(ck)
                results = main(args + [f"run.resume={ck}"])
                final, best = load(ck), load(ck, best=True)
            finally:
                jax.config.update("jax_enable_x64", x64)
            if pkg == "jax":
                after_three, final, best = (jax.tree.map(np.asarray, t)
                                            for t in (after_three, final, best))
            out[pkg] = {"results": results, "after_three": after_three, "final": final,
                        "best": best}
        names = {id(p): n for n, p in port.state.model.named_parameters()}
        out["port"]["names"] = [names[id(p)] for g in port.state.optimizer.param_groups
                                for p in g["params"]]
    return seen, port, out


def _jax_rates(count: int):
    """JAX's learning rates (backbone, fc) at update ``count`` of this run."""
    optim = dataclasses.replace(jconfig.load_config(None, []).optim, epochs=EPOCHS,
                                steps_per_epoch=STEPS)
    return [float(lr_schedule(lr, optim)(count)) for lr in (optim.backbone_lr, optim.fc_lr)]


def test_s0_clis_take_the_same_batches_and_steps(runs):
    """Every raw batch in order, the resumed epoch's too (checked in the
    hooks as each comes), and as many steps and validations as JAX."""
    seen, port, _ = runs
    n = EPOCHS * STEPS
    assert len(seen.raw) == port.n_prep == port.n_step == n
    assert len(seen.rows) == len(port.rows) == EPOCHS
    assert port.n_eval == len(seen.eval_frames) == EPOCHS * VAL_BATCHES
    # set_epoch reshuffles: the epochs' batches come in other orders
    orders = {tuple(r["labels"].tolist()) for r in seen.raw}
    assert len(orders) > 1


def test_s0_every_step_takes_the_schedule_at_its_count(runs):
    """Each step's learning rates, the resumed run's first step included."""
    _, port, _ = runs
    assert len(port.step_lrs) == EPOCHS * STEPS
    for count, lrs in enumerate(port.step_lrs):
        np.testing.assert_allclose(lrs, _jax_rates(count), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {count}")


def test_s0_clis_end_each_epoch_on_the_same_schedule(runs):
    seen, port, _ = runs
    assert seen.counts == port.counts == [STEPS * (e + 1) for e in range(EPOCHS)]
    for e, (count, lrs) in enumerate(zip(port.counts, port.lrs)):
        np.testing.assert_allclose(lrs, _jax_rates(count), rtol=1e-6, atol=1e-12,
                                   err_msg=f"epoch {e}")


@pytest.mark.parametrize("epoch", range(EPOCHS))
def test_s0_clis_validate_alike(runs, epoch):
    """The epoch's row: top-1 and top-5 equal; every validation score (the
    float32 softmax the mAP ranks) within ``SCORE_TOL``; the mAP within
    ``MAP_TOL``, and equal once the scores are rounded to ``SCORE_TOL``, where
    each package's float32 rounding no longer breaks ties its own way."""
    seen, port, _ = runs
    want, got = seen.rows[epoch], port.rows[epoch]
    (js, hot), (ts, port_hot) = seen.scores[epoch], port.scores[epoch]
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"], (got, want)
    np.testing.assert_array_equal(port_hot, hot)
    err = np.abs(ts - js).max()
    print(f"epoch {epoch}: port {got}, JAX {want}, max|score difference| {err:.3g}")
    assert err <= SCORE_TOL
    assert abs(got["mAP"] - want["mAP"]) <= MAP_TOL, (got, want)
    decimals = -int(np.log10(SCORE_TOL))
    assert mean_average_precision(np.round(ts, decimals), hot) == \
        mean_average_precision(np.round(js, decimals), hot)


def test_s0_clis_keep_the_same_best(runs):
    _, _, out = runs
    assert out["port"]["results"]["best_acc"] == out["jax"]["results"]["best_acc"]
    assert int(out["port"]["best"]["meta"]["epoch"]) == int(out["jax"]["best"]["meta"]["epoch"])
    assert float(out["port"]["best"]["meta"]["best_acc"]) == \
        float(out["jax"]["best"]["meta"]["best_acc"])


def _rel(got, want):
    got = torch.cat([g.flatten() for g in got])
    want = torch.cat([w.flatten() for w in want])
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("comp", TRAINED)
def test_s0_resume_restores_momentum_and_count(runs, comp):
    """After the resumed epoch: the schedule's count, and the momentum of
    every trained parameter of ``comp`` against JAX's trace."""
    _, _, out = runs
    ttree, jtree = out["port"]["final"], out["jax"]["final"]
    assert ttree["scheduler"]["last_epoch"] == int(jtree["step"]) == EPOCHS * STEPS
    got = _momentum(ttree["optimizer"], out["port"]["names"])
    want = _jax_traces(jtree["opt_state"])
    keys = sorted(k for k in got if k.startswith(comp + "."))
    assert keys and set(keys) <= set(want)
    err = _rel([got[k] for k in keys], [want[k] for k in keys])
    print(f"momentum {comp}: {err:.3g}")
    assert err <= MOMENTUM_TOL, (comp, err)


@pytest.mark.parametrize("when", ["after_three", "final"])
@pytest.mark.parametrize("comp", TRAINED)
def test_s0_clis_save_the_same_weights(runs, comp, when):
    """The weights saved after the third epoch and after the resumed one."""
    seen, _, out = runs
    init = gfv_state_dict_from_flax(*seen.variables, dtype=torch.float64)
    jtree, ttree = out["jax"][when], out["port"][when]
    want = gfv_state_dict_from_flax(jtree["params"], jtree["batch_stats"], dtype=torch.float64)
    got = {f"{c}.{key}": value for c in tckpt.COMPONENTS
           for key, value in ttree["components"][c].items()}
    for stats in (False, True):
        group = [k for k in init if k.startswith(comp + ".") and
                 not k.endswith("num_batches_tracked") and
                 k.endswith(("running_mean", "running_var")) == stats]
        if group:
            err = _rel([got[k] - init[k] for k in group], [want[k] - init[k] for k in group])
            print(f"{when} {comp} {'stats' if stats else 'params'}: {err:.3g}")
            assert err <= UPDATE_TOL, (comp, "running statistics" if stats else "parameters", err)


def test_resume_with_more_epochs_takes_the_schedule_at_the_count(scratch_path):
    """A stage-0 run saved after 6 updates of a 3-epoch cosine (2 steps an
    epoch), whose rates there are 0, resumed as a 4-epoch run: the restored
    optimizer's rates are the 4-epoch schedule's at count 6, JAX's
    ``lr_schedule``, and the next update takes them."""
    cfg = tgfv.flagship(tiny=True)
    old = toptim.OptimConfig(epochs=3, steps_per_epoch=2)
    state = tstages.create_train_state(cfg, 0, old, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    for _ in range(6):      # no gradients: the updates move nothing
        state.optimizer.step()
        state.scheduler.step()
    assert [g["lr"] for g in state.optimizer.param_groups] == [0.0, 0.0]
    tckpt.save_checkpoint(str(scratch_path), state, 2, 0.5, 0.5)
    new = dataclasses.replace(old, epochs=4)
    fresh = tstages.create_train_state(cfg, 0, new, device="cpu",
                                       generator=torch.Generator().manual_seed(1))
    tckpt.restore_train_state(fresh, tckpt.load_checkpoint(str(scratch_path)))
    assert fresh.scheduler.last_epoch == 6
    jnew = joptim.OptimConfig(epochs=4, steps_per_epoch=2)
    want = [float(lr_schedule(lr, jnew)(6)) for lr in (jnew.backbone_lr, jnew.fc_lr)]
    got = [g["lr"] for g in fresh.optimizer.param_groups]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert fresh.scheduler.get_last_lr() == got
