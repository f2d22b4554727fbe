"""Port parity for AdaFocus+'s steps (train/stages_plus.py) against the JAX
package on the CPU in float64.

Weights come from ``abstract_variables`` (flax's tree structure, values from
a seeded generator, nothing compiled) at tests/test_plus.py's tiny
configuration (T=6, K=3, selector width 8), batch 4, in float64 under
``jax.enable_x64``. JAX's draws are injected into the port: the Gumbel
uniforms or random frames' noise and the random patch actions of stages 1
and 3; the selector's sampled picks, the patch policy's sampled anchors and
the baseline's frames and patch actions of the joint stage 2, each from the
key JAX's step gives it.

Tolerances:

- stages 1 and 3 (ST selector; stage 1 with ``plus_rl``) and the linear
  head's stage 1: loss rtol 1e-6; each tensor's update within 1e-5 of
  max|JAX update| of that tensor; running statistics within 1e-9 relative;
  a tensor JAX leaves unchanged bit-identical;
- the joint stage 2, rewards 'random', 'conf' and 'prev': the mean reward
  and confidence within 1e-6, the loss terms rtol 1e-5, ``ratio_mean`` 1;
  the gradient of the policy and of ``selector_ac``, each as a whole,
  ||port - JAX|| / ||JAX|| <= 1e-6 and max|port - JAX| <= 1e-6 of its
  max|JAX gradient| (measured about 2e-7: both packages compute the
  selector's and the policy's logprobs, values and entropies in float32,
  and the rewards from float32 confidences; so the attention projections,
  whose gradients are about 1e-3 of the module's largest, differ by a few
  1e-4 of their own); the Adam update as a whole within 1e-4 (measured
  5e-6) over the elements whose JAX gradient exceeds 1e-6 of its module's
  largest (Adam's first step is lr * g / (|g| + 1e-8), about lr * sign(g):
  where float32 rounding is of the gradient's size, as on the score head's
  bias, whose true gradient is 0, the sign is noise in both packages); the
  other components bit-identical. The JAX step's gradient is read by running it
  with ``optax.identity`` in place of its Adam, and its Adam update is
  optax's on that gradient;
- the batched per-slot classifier against the slot loop of the JAX step's
  scan (out-of-place ``index_put``, a later write winning): within 1e-7
  (float32 confidences of float64 logits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.ppo import core as tppo
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.train import stages_plus as tsplus
from adafocus_torch.weights import ppo_state_from_flax
from adafocus_tpu.models.gfv import GFV, GFVConfig
from adafocus_tpu.models.gfv_plus import SelectorActorCritic, gather_frames
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.ppo import core as jppo
from adafocus_tpu.train import optim as joptim
from adafocus_tpu.train import stages_plus as jsplus
from adafocus_tpu.train.stages import TrainState, _rollout_time_major, make_stage_train_step
from tests.torch_port_common import (
    abstract_variables, port_config, port_model, port_model64, snapshot, state_dict_from_jax,
    train_batch,
)

SEED = 6
B = 4
OPT = dict(epochs=2, steps_per_epoch=4)
TINY_PLUS = GFVConfig(
    num_classes=5, num_frames=6, image_size=24, glance_size=16, patch_size=16,
    action_dim=4, hidden_dim=16, policy_hidden=16, frame_budget=3, selector_hidden=8,
    dtype=jnp.float64,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(cfg: GFVConfig, seed: int):
    """(flax GFV, float64 numpy variables, JAX batch, port batch)."""
    jmodel, variables = abstract_variables(cfg, seed)
    return (jmodel, variables) + train_batch(cfg, B, seed + 1, np.float64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def _check_update(j0, j1, p0, p1):
    """Every tensor's update within 1e-5 of max|JAX update| of that tensor,
    running statistics within 1e-9 relative, an unmoved tensor unmoved.
    Returns the components that moved."""
    keys = [k for k in j0 if not k.endswith("num_batches_tracked")]
    moved = {key for key in keys if (j1[key] - j0[key]).abs().max() > 0}
    for key in keys:
        assert torch.equal(p0[key], j0[key]), key
        if key not in moved:
            assert torch.equal(p1[key], p0[key]), f"{key} moved; JAX leaves it"
        elif key.endswith(("running_mean", "running_var")):
            assert _rel(p1[key], j1[key]) <= 1e-9, key
        else:
            want = j1[key] - j0[key]
            err = ((p1[key] - p0[key]) - want).abs().max() / want.abs().max()
            assert err <= 1e-5, (key, float(err))
    return {key.split(".")[0] for key in moved}


# ---------------------------------------------------------------------------
# stages 1 and 3, and the linear head's stage 1
# ---------------------------------------------------------------------------

# case: (plus_rl, stage, components JAX moves)
_STEPS = {"st-stage1": (False, 1, {"focuser", "classifier", "selector"}),
          "st-stage3": (False, 3, {"focuser", "classifier", "selector"}),
          "rl-stage1": (True, 1, {"focuser", "classifier"})}


@pytest.mark.parametrize("case", sorted(_STEPS))
def test_plus_train_step_matches_jax(case):
    """One step of ``make_plus_train_step``. In stage 3 the focuser's
    parameters are frozen but, in train mode as in the JAX package, its
    running statistics move; the port takes its own greedy patch actions
    there."""
    rl, stage, comps = _STEPS[case]
    cfg = dataclasses.replace(TINY_PLUS, plus_rl=rl)
    b, t, k = B, cfg.num_frames, cfg.frame_budget
    with jax.enable_x64(True):
        jmodel, variables, jbatch, tbatch = _setup(cfg, SEED + stage)
        tx = joptim.make_stage_optimizer(stage, joptim.OptimConfig(**OPT))
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        rng = jax.random.key(40 + stage)
        a_key, _ = jax.random.split(rng)
        sel_key, patch_key, _ = jax.random.split(a_key, 3)
        if rl:
            uniforms = jax.random.uniform(sel_key, (b, t))
        else:
            uniforms = jax.random.uniform(sel_key, (b, t), minval=1e-20, maxval=1.0)
        actions = random_patch_actions(patch_key, (b, k))
        new, m = jax.jit(jsplus.make_plus_train_step(jmodel, stage, tx))(state, jbatch, rng)
        j0 = state_dict_from_jax(variables, torch.float64)
        j1 = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats},
                                 torch.float64)
    model = port_model64(cfg, variables)
    opt, sched = toptim.make_stage_optimizer(model, stage, toptim.OptimConfig(**OPT))
    step = tsplus.make_plus_train_step(model, stage, opt, sched)
    p0 = snapshot(model)
    got = step(tbatch, None, uniforms=_t(uniforms),
               actions=_t(actions) if stage == 1 else None)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-6)
    assert (float(got["top1"]), float(got["top5"])) == (float(m["top1"]), float(m["top5"]))
    assert _check_update(j0, j1, p0, snapshot(model)) == comps


def test_linear_head_stage1_step_matches_jax():
    """The linear head (``classifier='linear'``) through the base stage-1
    step, the consensus log-probabilities' NLL."""
    cfg = GFVConfig(num_classes=5, num_frames=3, image_size=24, glance_size=16,
                    patch_size=16, action_dim=4, hidden_dim=16, policy_hidden=16,
                    classifier="linear", dtype=jnp.float64)
    with jax.enable_x64(True):
        jmodel, variables, jbatch, tbatch = _setup(cfg, SEED)
        tx = joptim.make_stage_optimizer(1, joptim.OptimConfig(**OPT))
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        rng = jax.random.key(50)
        a_key, _ = jax.random.split(rng)
        actions = random_patch_actions(a_key, (B, cfg.num_frames))
        new, m = jax.jit(make_stage_train_step(jmodel, 1, tx))(state, jbatch, rng)
        j0 = state_dict_from_jax(variables, torch.float64)
        j1 = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats},
                                 torch.float64)
    model = port_model64(cfg, variables)
    opt, sched = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig(**OPT))
    p0 = snapshot(model)
    got = tstages.make_stage_train_step(model, 1, opt, sched)(tbatch, None, _t(actions))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-6)
    assert (float(got["top1"]), float(got["top5"])) == (float(m["top1"]), float(m["top5"]))
    assert _check_update(j0, j1, p0, snapshot(model)) == {"focuser", "classifier"}


# ---------------------------------------------------------------------------
# the joint stage 2
# ---------------------------------------------------------------------------


def _slot_loop(model, pooled, local_sel, idx, labels, rand_idx, rand_local):
    """The JAX step's K-step scan, one classifier call a sequence."""
    b, t = pooled.shape[:2]
    rows = torch.arange(b)

    def conf_final(local):
        logits = model.classify_seq(torch.cat([pooled, local], -1))
        return tstages._target_confidence(logits, labels)[:, -1]

    carry = torch.zeros((b, t, local_sel.shape[-1]), dtype=local_sel.dtype)
    conf, base = [], []
    for j in range(idx.shape[1]):
        new = carry.index_put((rows, idx[:, j]), local_sel[:, j])
        conf.append(conf_final(new))
        base.append(conf_final(carry.index_put((rows, rand_idx[:, j]), rand_local[:, j])))
        carry = new
    return torch.stack(conf, 1), torch.stack(base, 1)


def test_slot_confidences_match_the_slot_loop():
    """float64, K=4 of T=6, B=3; one row picks a frame twice (the later
    slot's features win) and the baseline's random frames hit picked ones."""
    cfg = tgfv.GFVConfig(num_classes=5, num_frames=6, image_size=24, glance_size=16,
                         patch_size=16, action_dim=4, hidden_dim=16, policy_hidden=16,
                         frame_budget=4, selector_hidden=8, plus_rl=True,
                         dtype=torch.float64)
    model = tgfv.GFV(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    pooled = torch.randn((3, 6, 1280), generator=gen, dtype=torch.float64)
    local_sel = torch.randn((3, 4, 2048), generator=gen, dtype=torch.float64)
    rand_local = torch.randn((3, 4, 2048), generator=gen, dtype=torch.float64)
    idx = torch.tensor([[0, 2, 5, 1], [3, 1, 3, 4], [5, 4, 3, 2]])
    rand_idx = torch.tensor([[2, 2, 0, 3], [1, 0, 4, 4], [5, 5, 5, 5]])
    labels = torch.tensor([1, 4, 0])
    with torch.no_grad():
        got = tsplus.slot_confidences(model, pooled, local_sel, idx, labels, rand_idx,
                                      rand_local)
        want = _slot_loop(model, pooled, local_sel, idx, labels, rand_idx, rand_local)
        alone, none = tsplus.slot_confidences(model, pooled, local_sel, idx, labels)
    assert none is None and got[0].shape == (3, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-7, rtol=0)
    assert torch.equal(alone, got[0])


@pytest.fixture(scope="module")
def joint_setup():
    cfg = dataclasses.replace(TINY_PLUS, plus_rl=True)
    with jax.enable_x64(True):
        return (cfg,) + _setup(cfg, SEED + 10)


def _joint_draws(cfg, jmodel, variables, small, rng):
    """The JAX joint step's draws from its key: the selector's sampled picks
    (B, K), the policy's sampled anchors (K, B), the baseline's frames and
    patch actions."""
    b, t, k = B, cfg.num_frames, cfg.frame_budget

    @jax.jit     # one program, where eagerly each op compiles at each shape
    def draws(variables, small, rng):
        sel_key, spat_key, base_f_key, base_a_key = jax.random.split(rng, 4)
        params = variables["params"]
        fmap, pooled = jmodel.apply(variables, small, False, method=GFV.glance)
        selector = SelectorActorCritic(hidden_dim=cfg.selector_hidden, in_dim=cfg.glance_dim,
                                       dtype=cfg.dtype)
        idx = selector.apply({"params": params["selector_ac"]}, pooled, k, sel_key, "sample",
                             method=SelectorActorCritic.rollout)["idx"]
        fmaps_tb = jnp.swapaxes(gather_frames(fmap, idx), 0, 1)
        policy_vars = {"params": params["policy"]}
        if "policy" in variables["batch_stats"]:
            # a BatchNorm encoder: the behavior rollout normalizes with the
            # batch's statistics, as the JAX step gives it the policy's stats
            policy_vars["batch_stats"] = variables["batch_stats"]["policy"]
        spatial = _rollout_time_major(jppo.make_policy(cfg), policy_vars, fmaps_tb, spat_key,
                                      cfg)["store"]
        return (idx, spatial, jax.random.randint(base_f_key, (b, k), 0, t),
                random_patch_actions(base_a_key, (b, k)))

    idx, spatial, base_idx, base_actions = draws(variables, small, rng)
    return {"select": _t(idx).long(), "spatial": _t(spatial).long(),
            "base_idx": _t(base_idx).long(), "base_actions": _t(base_actions)}


@pytest.mark.parametrize("mode", ["random", "conf", "prev"])
def test_joint_stage2_step_matches_jax(joint_setup, mode, monkeypatch):
    cfg, jmodel, variables, jbatch, tbatch = joint_setup
    jcfg = jppo.PPOConfig(reward_mode=mode)
    with jax.enable_x64(True):
        params = variables["params"]
        learner = {"policy": params["policy"], "selector_ac": params["selector_ac"]}
        state = TrainState(params=params, batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.zeros((), jnp.int32),
                           ppo=jppo.ppo_init(learner, jcfg))
        # optax.identity in place of the step's Adam: its update is the gradient
        monkeypatch.setattr(jsplus, "make_optimizer", lambda c: optax.identity())
        jstep = jsplus.make_plus_stage2_joint_step(jmodel, jcfg)
        rng = jax.random.key(60)
        new, m = jax.jit(jstep)(state, jbatch, rng)
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.ppo.params,
                             learner)
        tx = optax.adam(jcfg.lr, b1=jcfg.betas[0], b2=jcfg.betas[1])
        adam, _ = tx.update(grads, tx.init(learner))
        want_grad = state_dict_from_jax({"params": grads, "batch_stats": {}}, torch.float64)
        want_upd = state_dict_from_jax({"params": jax.tree.map(np.asarray, adam),
                                        "batch_stats": {}}, torch.float64)
        draws = _joint_draws(cfg, jmodel, variables, jbatch["frames_small"], rng)
    model = port_model64(cfg, variables)
    toptim.freeze_for_stage(model, 2)
    ppo = tppo.ppo_init(tstages.joint_learner(model), tppo.PPOConfig(reward_mode=mode))
    before = snapshot(model)
    got = tsplus.make_plus_stage2_joint_step(model, ppo)(tbatch, None, draws)
    after = snapshot(model)
    assert got.keys() == {k: v for k, v in m.items()}.keys()
    for key in ("reward_mean", "confidence"):
        np.testing.assert_allclose(float(got[key]), float(m[key]), atol=1e-6, rtol=0,
                                   err_msg=key)
    for key in ("ppo/loss", "ppo/policy_loss", "ppo/value_loss", "ppo/entropy"):
        np.testing.assert_allclose(float(got[key]), float(m[key]), rtol=1e-5, err_msg=key)
    assert abs(float(got["ppo/ratio_mean"]) - 1.0) <= 1e-6
    trained = dict(tstages.joint_learner(model).named_parameters())
    assert trained.keys() == want_grad.keys()
    mx = {}
    for module in ("policy", "selector_ac"):
        keys = [k for k in trained if k.startswith(module + ".")]
        got_g = torch.cat([trained[k].grad.flatten() for k in keys])
        want_g = torch.cat([want_grad[k].flatten() for k in keys])
        mx[module] = want_g.abs().max()
        assert _rel(got_g, want_g) <= 1e-6, module
        assert float((got_g - want_g).abs().max() / want_g.abs().max()) <= 1e-6, module
    upd = torch.cat([(after[k] - before[k]).flatten() for k in trained])
    want = torch.cat([want_upd[k].flatten() for k in trained])
    scale = torch.cat([torch.full((want_grad[k].numel(),), float(mx[k.split(".")[0]]))
                       for k in trained])
    g = torch.cat([want_grad[k].flatten() for k in trained])
    resolved = g.abs() > 1e-6 * scale
    assert _rel(upd[resolved], want[resolved]) <= 1e-4
    for key in before:
        if key not in trained:
            assert torch.equal(after[key], before[key]), f"{key} moved"


@pytest.fixture(scope="module")
def joint_bn_setup():
    cfg = dataclasses.replace(TINY_PLUS, plus_rl=True, policy_bn=True)
    with jax.enable_x64(True):
        return (cfg,) + _setup(cfg, SEED + 10)


@pytest.mark.parametrize("mode", ["random", "conf", "prev"])
def test_joint_stage2_bn_encoder_step_matches_jax(joint_bn_setup, mode, monkeypatch):
    """The joint stage 2 with a BatchNorm policy encoder
    (``model.policy_bn=true``): the train-mode behavior rollout, whose
    statistics update is discarded, and ``joint_loss``'s evaluate pass
    under ``stats_frozen``. JAX's behavior rollout is given the policy's
    ``batch_stats``, as its step gives them.

    The weights, batch and key are ``test_joint_stage2_step_matches_jax``'s
    with ``policy_bn=True``; the bars are the gaps measured on them in
    float64 over the three rewards, not that test's: the BatchNorm's batch
    statistics over B*K = 12 maps amplify the float32 rounding of the
    logprobs, values and confidences that both packages compute in
    float32. The mean reward and the confidence were within 2.3e-6
    relative; the total loss, value loss and entropy within 1.3e-7
    relative (two float32 ulps); ``ratio_mean`` exactly 1; each module's
    gradient within 2.7e-6 as a whole; the Adam update within 2.1e-5 over
    the elements whose gradient is resolved (as in that test). The policy
    loss is a near-cancelling mean (about 2.6e-3 over terms of order 1), so
    it is held by its absolute error, 1.3e-7 (5e-5 relative)."""
    cfg, jmodel, variables, jbatch, tbatch = joint_bn_setup
    jcfg = jppo.PPOConfig(reward_mode=mode)
    with jax.enable_x64(True):
        params = variables["params"]
        learner = {"policy": params["policy"], "selector_ac": params["selector_ac"]}
        state = TrainState(params=params, batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.zeros((), jnp.int32),
                           ppo=jppo.ppo_init(learner, jcfg))
        monkeypatch.setattr(jsplus, "make_optimizer", lambda c: optax.identity())
        jstep = jsplus.make_plus_stage2_joint_step(jmodel, jcfg)
        rng = jax.random.key(60)
        new, m = jax.jit(jstep)(state, jbatch, rng)
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.ppo.params,
                             learner)
        tx = optax.adam(jcfg.lr, b1=jcfg.betas[0], b2=jcfg.betas[1])
        adam, _ = tx.update(grads, tx.init(learner))
        want_grad = state_dict_from_jax({"params": grads, "batch_stats": {}}, torch.float64)
        want_upd = state_dict_from_jax({"params": jax.tree.map(np.asarray, adam),
                                        "batch_stats": {}}, torch.float64)
        draws = _joint_draws(cfg, jmodel, variables, jbatch["frames_small"], rng)
    model = port_model64(cfg, variables)
    assert model.policy.encoder.bn is not None
    toptim.freeze_for_stage(model, 2)
    ppo = tppo.ppo_init(tstages.joint_learner(model), tppo.PPOConfig(reward_mode=mode))
    before = snapshot(model)
    got = tsplus.make_plus_stage2_joint_step(model, ppo)(tbatch, None, draws)
    after = snapshot(model)
    assert got.keys() == m.keys()
    for key in ("reward_mean", "confidence"):
        np.testing.assert_allclose(float(got[key]), float(m[key]), rtol=2.3e-6, err_msg=key)
    for key in ("ppo/loss", "ppo/value_loss", "ppo/entropy"):
        np.testing.assert_allclose(float(got[key]), float(m[key]), rtol=1.3e-7, err_msg=key)
    np.testing.assert_allclose(float(got["ppo/policy_loss"]), float(m["ppo/policy_loss"]),
                               atol=1.3e-7, rtol=0)
    assert float(got["ppo/ratio_mean"]) == 1.0
    trained = dict(tstages.joint_learner(model).named_parameters())
    assert trained.keys() == want_grad.keys()
    mx = {}
    for module in ("policy", "selector_ac"):
        keys = [k for k in trained if k.startswith(module + ".")]
        got_g = torch.cat([trained[k].grad.flatten() for k in keys])
        want_g = torch.cat([want_grad[k].flatten() for k in keys])
        mx[module] = want_g.abs().max()
        assert _rel(got_g, want_g) <= 2.7e-6, module
    upd = torch.cat([(after[k] - before[k]).flatten() for k in trained])
    want = torch.cat([want_upd[k].flatten() for k in trained])
    scale = torch.cat([torch.full((want_grad[k].numel(),), float(mx[k.split(".")[0]]))
                       for k in trained])
    g = torch.cat([want_grad[k].flatten() for k in trained])
    resolved = g.abs() > 1e-6 * scale
    assert _rel(upd[resolved], want[resolved]) <= 2.1e-5
    for key in before:
        if key not in trained:
            assert torch.equal(after[key], before[key]), f"{key} moved"


def test_joint_learner_state_and_bridge():
    """``create_train_state(cfg, 2)`` with ``plus_rl``: one Adam over the
    policy and the selector actor-critic, everything else frozen; the Adam
    moments of a JAX joint learner (``{"policy", "selector_ac"}``, moments
    from a seeded generator) cross through ``ppo_state_from_flax``."""
    cfg = dataclasses.replace(TINY_PLUS, plus_rl=True, dtype=jnp.float32)
    state = tstages.create_train_state(port_config(cfg), 2, device="cpu")
    model = state.model
    in_adam = {id(p) for g in state.ppo.optimizer.param_groups for p in g["params"]}
    for name, module in model.named_children():
        trained = name in ("policy", "selector_ac")
        for p in module.parameters():
            assert p.requires_grad == trained and (id(p) in in_adam) == trained, name
    with pytest.raises(ValueError, match="joint"):
        tsplus.make_plus_stage2_joint_step(model, tppo.ppo_init(model.policy))
    with pytest.raises(ValueError, match="policy"):
        tstages.make_stage2_step(model, state.ppo)
    _, variables = abstract_variables(cfg, SEED)
    model = port_model(cfg, variables)
    learner = tppo.ppo_init(tstages.joint_learner(model))
    rs = np.random.RandomState(0)
    params = {"policy": variables["params"]["policy"],
              "selector_ac": variables["params"]["selector_ac"]}
    mu = jax.tree.map(lambda a: rs.rand(*a.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda a: 2 * a, mu)
    flax_ppo = jppo.PPOState(params=params, params_old=params, step=np.int32(3),
                             opt_state=(optax.ScaleByAdamState(count=np.int32(3), mu=mu, nu=nu),
                                        optax.EmptyState()))
    ppo_state_from_flax(flax_ppo, learner)
    want = state_dict_from_jax({"params": mu, "batch_stats": {}})
    named = dict(learner.policy.named_parameters())
    assert learner.step == 3 and named.keys() == want.keys()
    for key, p in named.items():
        s = learner.optimizer.state[p]
        assert float(s["step"]) == 3 and torch.equal(s["exp_avg"], want[key]), key
        assert torch.equal(s["exp_avg_sq"], 2 * want[key]), key
