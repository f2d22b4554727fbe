"""Port parity for training: train-mode BatchNorm, the patch VJP, the
schedules, the metrics, the stage 0, 1 and 3 train steps and the eval step,
each against the JAX package on the CPU in float32.

Weights are bridged from a JAX GFV with randomised BatchNorm
(tests/torch_port_common.py) at the tiny configuration; the inputs are the
same numpy arrays on both sides. The random patch actions of stages 0 and 1
come from the JAX step's own key split and are injected into the port; the
stage-0 dropout mask is drawn with numpy and injected into both, into JAX
through ``flax.linen.intercept_methods``.

Tolerances, float32 (two backbones and two GRUs summed in another order):

- BatchNorm at n=4 values a channel: output and running statistics atol
  1e-5, rtol 1e-5;
- the patch VJP: exact;
- learning rates: rtol 1e-6 (the JAX schedule runs in float32);
- top-k and mAP: exact;
- a train step: loss rtol 1e-4; top-1/top-5 equal; each parameter's
  update (new - old), max|port - JAX| <= 2e-3 of max|JAX update| of that
  tensor; running statistics atol 1e-4, rtol 1e-4; a tensor that JAX leaves
  unchanged (every frozen component) bit-identical;
- the eval step and ``forward_random``: logits atol = rtol = 1e-3, as the
  deployment forward.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models.layers import ConvBNAct
from adafocus_torch.ops import metrics as tmetrics
from adafocus_torch.ops import patch as tpatch
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models import layers as jlayers
from adafocus_tpu.models.gfv import forward_random
from adafocus_tpu.ops import metrics as jmetrics
from adafocus_tpu.ops.patch import extract_patches, patch_offsets
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.train import optim as joptim
from adafocus_tpu.train.stages import TrainState, make_eval_step, make_stage_train_step
from tests.torch_port_common import (
    TRAIN_B, float64_train_setup, port_model64, snapshot, state_dict_from_jax,
)

OPT = dict(epochs=2, steps_per_epoch=4)
STEPS = 3
SEED = 1


# ---------------------------------------------------------------------------
# BatchNorm, patch VJP, schedules, metrics
# ---------------------------------------------------------------------------


def test_train_mode_batchnorm_matches_flax():
    # n = 1 * 2 * 2 = 4 values a channel: torch's unbiased running variance
    # would be 4/3 of flax's
    rs = np.random.RandomState(0)
    x = rs.randn(1, 2, 2, 5).astype(np.float32)
    flax_unit = jlayers.ConvBNAct(8, kernel_size=3)
    variables = flax_unit.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = {"bn": {"mean": rs.uniform(-0.5, 0.5, 8).astype(np.float32),
                    "var": rs.uniform(0.5, 1.5, 8).astype(np.float32)}}
    params["bn"] = {"scale": rs.uniform(0.5, 1.5, 8).astype(np.float32),
                    "bias": rs.uniform(-0.5, 0.5, 8).astype(np.float32)}
    want, upd = flax_unit.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                True, mutable=["batch_stats"])

    unit = ConvBNAct(5, 8, kernel_size=3)
    sd = gfv_state_dict_from_flax({"u": params}, {"u": stats})
    unit.load_state_dict({k[2:]: v for k, v in sd.items()})
    unit.train()
    got = unit(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(unit.bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]), **tol)
    np.testing.assert_allclose(unit.bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]), **tol)
    # eval mode normalises with the running statistics, as flax does
    unit.eval()
    want_eval = flax_unit.apply({"params": params, "batch_stats": upd["batch_stats"]},
                                jnp.asarray(x), False)
    got_eval = unit(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), **tol)


@pytest.mark.parametrize("from_actions", [False, True], ids=["offsets", "actions"])
def test_patch_vjp_matches_jax(from_actions):
    # N=6 frames 20x23, P=7; offsets include a negative start (wraps) and
    # starts past the edge (clamp); from actions, patch_offsets' range
    rs = np.random.RandomState(1)
    n, h, w, c, p = 6, 20, 23, 3, 7
    frames = rs.randn(n, h, w, c).astype(np.float32)
    cot = rs.randn(n, p, p, c).astype(np.float32)
    if from_actions:
        actions = rs.uniform(0, 1, (2, 3, 2)).astype(np.float32)
        actions[0, 0] = (1.0, 0.0)
        offs = np.asarray(patch_offsets(jnp.asarray(actions.reshape(n, 2)), h, p))
    else:
        offs = np.array([[0, 0], [-3, 5], [h - p, w - p], [h, w + 9], [5, -1], [2, 11]],
                        np.int32)
    _, vjp = jax.vjp(lambda im: extract_patches(im, jnp.asarray(offs), p, "slice"),
                     jnp.asarray(frames))
    (want,) = vjp(jnp.asarray(cot))

    packed = []
    src = torch.from_numpy(frames).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(tuple(t.shape)) or t, lambda t: t):
        if from_actions:
            out = tpatch.extract_patches_at(src.reshape(2, 3, h, w, c),
                                            torch.from_numpy(actions), h, p)
        else:
            out = tpatch.extract_patches(src, torch.from_numpy(offs), p)
    # only the offsets (or the actions) are kept for the backward, never frames
    assert packed == [(n, 2)] if not from_actions else packed == [(2, 3, 2)]
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(src.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("lr_type", ["cos", "step"])
def test_lr_schedule_matches_optax(lr_type):
    kw = dict(OPT, lr_type=lr_type, lr_steps=(1,))
    jcfg, tcfg = joptim.OptimConfig(**kw), toptim.OptimConfig(**kw)
    end = jcfg.epochs * jcfg.steps_per_epoch
    jsched = joptim.lr_schedule(0.01, jcfg)
    tsched = toptim.lr_schedule(0.01, tcfg)
    for step in (0, 1, end // 2, end):
        np.testing.assert_allclose(tsched(step), float(jsched(jnp.int32(step))), rtol=1e-6)
    # the optimizer's rates follow the update count, from 0
    model = tgfv.GFV(tgfv.flagship(tiny=True), device="cpu")
    opt, sched = toptim.make_stage_optimizer(model, 1, tcfg)
    for step in range(end + 1):
        assert [g["lr"] for g in opt.param_groups] == pytest.approx(
            [tsched(step), toptim.lr_schedule(tcfg.fc_lr, tcfg)(step)], rel=1e-12)
        opt.step()
        sched.step()


def test_stage_freeze_matrix():
    model = tgfv.GFV(tgfv.flagship(tiny=True), device="cpu")
    for stage, trained in ((0, {"glancer", "focuser", "classifier"}),
                           (1, {"focuser", "classifier"}), (3, {"classifier"})):
        opt, _ = toptim.make_stage_optimizer(model, stage, toptim.OptimConfig())
        in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
        for name, module in model.named_children():
            for prm in module.parameters():
                assert prm.requires_grad == (name in trained), (stage, name)
                assert (id(prm) in in_opt) == (name in trained), (stage, name)
        assert toptim.stage_trainable(stage) == joptim.stage_trainable(stage)
    with pytest.raises(ValueError, match="PPO"):
        toptim.make_stage_optimizer(model, 2, toptim.OptimConfig())
    # the TSN groups (the sth-sth recipe) split the focuser alone
    opt, _ = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig(tsn_policies=True))
    assert [g["name"] for g in opt.param_groups] == [
        "fc", "tsn_first_conv_weight", "tsn_normal_weight", "tsn_normal_bias", "tsn_bn"]
    assert {id(p) for g in opt.param_groups[1:] for p in g["params"]} == \
        {id(p) for p in model.focuser.parameters()}


def test_metrics_match_jax():
    rs = np.random.RandomState(2)
    # integer logits with many ties: the lower class index ranks first
    logits = rs.randint(0, 4, (64, 7)).astype(np.float32)
    labels = rs.randint(0, 7, 64)
    want = jmetrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), ks=(1, 3, 5, 9))
    got = tmetrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 ks=(1, 3, 5, 9))
    assert [float(v) for v in got] == [float(v) for v in want]
    scores = rs.randn(40, 6).astype(np.float32)
    label_lists = np.stack([rs.randint(-1, 5, 40), rs.randint(-1, 5, 40)], 1)
    hot = tmetrics.multi_hot(label_lists, 6)
    np.testing.assert_array_equal(hot, jmetrics.multi_hot(label_lists, 6))
    assert hot[:, 5].sum() == 0     # an empty class
    for skip in (False, True):
        assert tmetrics.mean_average_precision(scores, hot, skip) == \
            jmetrics.mean_average_precision(scores, hot, skip)
    meter = tmetrics.AverageMeter("loss")
    meter.update(2.0, 3)
    meter.update(1.0)
    assert meter.avg == 1.75


# ---------------------------------------------------------------------------
# Train steps and eval
# ---------------------------------------------------------------------------


def _dropout_interceptor(keep):
    """Replaces flax's train-mode Dropout by ``where(keep, x / keep_prob, 0)``."""

    def intercept(next_fun, args, kwargs, context):
        module = context.module
        if isinstance(module, fnn.Dropout) and context.method_name == "__call__":
            deterministic = kwargs.get("deterministic", module.deterministic)
            if not deterministic:
                return jnp.where(keep, args[0] / (1.0 - module.rate), 0.0)
        return next_fun(*args, **kwargs)

    return intercept


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers a
    machine, and each worker's torch would otherwise start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train_setup():
    """The float64 JAX GFV at TRAIN_CFG, its (randomised) variables and the
    batch, shared by the three stages."""
    return float64_train_setup(SEED)


@pytest.fixture(scope="module", params=[0, 1, 3], ids=["stage0", "stage1", "stage3"])
def trained(request, train_setup):
    """STEPS steps of one stage on both sides, in float64, from the same
    weights and batch. Returns the stage, the state dicts after 0..STEPS
    steps and the metrics of each step, JAX's and the port's."""
    stage = request.param
    cfg, jmodel, variables, jbatch, tbatch = train_setup
    b, t = TRAIN_B, cfg.num_frames
    with jax.enable_x64(True):
        tx = joptim.make_stage_optimizer(stage, joptim.OptimConfig(**OPT))
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        jstep = make_stage_train_step(jmodel, stage, tx)

        @jax.jit
        def jax_step(state, batch, rng, keep):
            with fnn.intercept_methods(_dropout_interceptor(keep)):
                return jstep(state, batch, rng)

        model = port_model64(cfg, variables)
        opt, sched = toptim.make_stage_optimizer(model, stage, toptim.OptimConfig(**OPT))
        step = tstages.make_stage_train_step(model, stage, opt, sched)

        rs = np.random.RandomState(SEED + 2)
        jax_sd, port_sd = [state_dict_from_jax(variables, torch.float64)], [snapshot(model)]
        jax_m, port_m = [], []
        for k in range(STEPS):
            rng = jax.random.key(100 + k)
            a_key, _ = jax.random.split(rng)
            actions = np.array(random_patch_actions(a_key, (b, t)))
            keep = rs.uniform(0, 1, (b * t, cfg.glance_dim)) < 0.8
            state, m = jax_step(state, jbatch, rng, jnp.asarray(keep))
            jax_sd.append(state_dict_from_jax({"params": state.params,
                                               "batch_stats": state.batch_stats},
                                              torch.float64))
            jax_m.append({k: float(v) for k, v in m.items()})
            # stage 3 takes the port's own greedy actions
            got = step(tbatch, torch.Generator(),
                       None if stage == 3 else torch.from_numpy(actions), torch.from_numpy(keep))
            port_sd.append(snapshot(model))
            port_m.append({k: float(v) for k, v in got.items()})
    return stage, jax_sd, port_sd, jax_m, port_m


_FROZEN = {0: ("policy",), 1: ("glancer", "policy"), 3: ("glancer", "focuser", "policy")}
_COMPONENTS = ("glancer", "focuser", "classifier", "policy")


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("n_steps", [1, STEPS], ids=["one_step", "three_steps"])
def test_stage_step_matches_jax(trained, n_steps):
    """After one step every tensor's update (new - old) is within 1e-5 of
    max|JAX update| of that tensor, every running statistic within 1e-9
    relative. Over three steps the trajectories of the stages that train a
    backbone part by rounding: what agrees to 6e-8 after one step, in float64,
    reaches 5e-3 after three on some components. So after three steps each
    component's update is compared as a whole, ||port - JAX|| / ||JAX|| <=
    2e-2 for parameters and 1e-3 for running statistics. Losses rtol 1e-4
    (1e-6 at the first step), top-1/top-5 equal, and a tensor that JAX leaves
    unchanged, every frozen component's among them, bit-identical."""
    stage, jax_sd, port_sd, jax_m, port_m = trained
    for k in range(n_steps):
        np.testing.assert_allclose(port_m[k]["loss"], jax_m[k]["loss"],
                                   rtol=1e-6 if k == 0 else 1e-4)
        assert (port_m[k]["top1"], port_m[k]["top5"]) == (jax_m[k]["top1"], jax_m[k]["top5"])
    j0, j1, p0, p1 = jax_sd[0], jax_sd[n_steps], port_sd[0], port_sd[n_steps]
    keys = [k for k in j0 if not k.endswith("num_batches_tracked")]
    moved = {key for key in keys if (j1[key] - j0[key]).abs().max() > 0}
    for key in keys:
        assert torch.equal(p0[key], j0[key]), key
        if key not in moved:
            assert torch.equal(p1[key], p0[key]), f"{key} moved; JAX leaves it"
        elif n_steps == 1 and key.endswith(("running_mean", "running_var")):
            assert _rel(p1[key], j1[key]) <= 1e-9, key
        elif n_steps == 1:
            want = j1[key] - j0[key]
            err = ((p1[key] - p0[key]) - want).abs().max() / want.abs().max()
            assert err <= 1e-5, (key, float(err))
    if n_steps > 1:
        for comp in _COMPONENTS:
            for stats, tol in ((False, 2e-2), (True, 1e-3)):
                group = [k for k in moved if k.startswith(comp + ".")
                         and k.endswith(("running_mean", "running_var")) == stats]
                if group:
                    got = torch.cat([(p1[k] - p0[k]).flatten() for k in group])
                    want = torch.cat([(j1[k] - j0[k]).flatten() for k in group])
                    assert _rel(got, want) <= tol, (comp, stats, _rel(got, want))
    assert {key.split(".")[0] for key in moved} == set(_COMPONENTS) - set(_FROZEN[stage])


def test_forward_random_matches_jax(train_setup):
    # float64, both backbones in train mode: logits and every running
    # statistic within 1e-9 relative
    cfg, jmodel, variables, jbatch, tbatch = train_setup
    b, t = TRAIN_B, cfg.num_frames
    rng = jax.random.key(5)
    with jax.enable_x64(True):
        want, upd = jax.jit(lambda v, ff, fs, r: forward_random(
            jmodel, v, ff, fs, r, train=True, mutable=["batch_stats"]))(
            variables, jbatch["frames_flat"], jbatch["frames_small"], rng)
        a_key, _ = jax.random.split(rng)
        actions = np.array(random_patch_actions(a_key, (b, t)))
        want_sd = state_dict_from_jax({"params": variables["params"],
                               "batch_stats": upd["batch_stats"]}, torch.float64)
    model = port_model64(cfg, variables)
    got = tgfv.forward_random(model, tbatch["frames"], tbatch["frames_small"],
                              torch.Generator(), actions=torch.from_numpy(actions))
    assert _rel(got.detach(), torch.from_numpy(np.array(want))) <= 1e-9
    for key, value in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert _rel(value, want_sd[key]) <= 1e-9, key
    # without ``actions`` the draw comes from the generator, on its device
    gen = torch.Generator().manual_seed(0)
    tgfv.forward_random(model, tbatch["frames"], tbatch["frames_small"], gen, train=False)


def test_eval_step_matches_jax(train_setup):
    # float64: logits within 1e-9 relative, top-1/top-5 equal
    cfg, jmodel, variables, jbatch, tbatch = train_setup
    with jax.enable_x64(True):
        jstate = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=None, step=jnp.zeros((), jnp.int32))
        want, want_m = jax.jit(make_eval_step(jmodel))(jstate, jbatch, jax.random.key(0))
    model = port_model64(cfg, variables)
    got, got_m = tstages.make_eval_step(model)(tbatch)
    assert _rel(got, torch.from_numpy(np.array(want))) <= 1e-9
    assert {k: float(v) for k, v in got_m.items()} == {k: float(v) for k, v in want_m.items()}
    # after a stage-1 step, which leaves the focuser in train mode, the eval
    # step runs both backbones in eval mode
    opt, sched = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig(**OPT))
    tstages.make_stage_train_step(model, 1, opt, sched)(tbatch, torch.Generator())
    assert model.focuser.training
    logits, _ = tstages.make_eval_step(model)(tbatch)
    assert not model.focuser.training and not model.glancer.training
    assert torch.isfinite(logits).all()


def test_train_step_refuses_low_precision_parameters():
    cfg = dataclasses.replace(tgfv.flagship(tiny=True), dtype=torch.bfloat16)
    model = tgfv.GFV(cfg, device="cpu")
    opt, sched = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig())
    with pytest.raises(ValueError, match="float32 parameters"):
        tstages.make_stage_train_step(model, 1, opt, sched)
    with pytest.raises(ValueError, match="stage 2"):
        tstages.make_stage_train_step(tgfv.GFV(tgfv.flagship(tiny=True), device="cpu"), 2,
                                      opt, sched)
    state = tstages.create_train_state(cfg, 1, device="cpu")
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
