"""Port parity for stage 2 (PPO on the patch policy) against the JAX
package on the CPU: the rewards and returns, the sampler, the policy's
evaluate pass, the classifier's lookahead, the PPO update, the whole
stage-2 step and the Adam-state bridge.

The inputs are numpy arrays from seeds, the weights flax's, bridged
(tests/torch_port_common.py). The stage-2 step is compared in float64 at
TRAIN_CFG with JAX's own draws injected into the port: the behavior indices
from JAX's ``_rollout_time_major`` on the step's ``roll_key``, the baseline
actions from ``random_patch_actions`` on its ``base_key``.

Tolerances:

- ``compute_rewards``: exact; ``discounted_returns``: atol 1e-6 in float32;
- ``sample_discrete``: the logprob exactly ``log_softmax`` at the drawn
  index, the same draws from the same seed, and over 200 000 draws every
  class frequency within 5 sigma of its softmax probability;
- ``evaluate_episode`` and the lookahead: atol 1e-5 in float32;
- ``ppo_update`` on the same memory, float64, one and two epochs: each
  policy tensor's update within 1e-6 of max|JAX update| of that tensor
  (measured 1.0e-10); with one epoch ``ratio_mean`` 1 within 1e-12; the
  loss terms rtol 2.5e-7, not 1e-8: both packages compute the loss in
  float32 whatever the parameters' dtype (JAX's ``evaluate_episode``
  returns float32), and a float32 mean over the T*B values summed in
  another order differs by an ulp, at most 1.2e-7 of the value (measured:
  ``ppo/policy_loss`` 1.13e-7, one ulp; the others equal);
- the stage-2 step and the bridged Adam state, float64: see
  ``test_stage2_step_matches_jax``.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.models import classifiers as tclassifiers
from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import policy as tpolicy
from adafocus_torch.ppo import core as tppo
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.weights import gfv_state_dict_from_flax, ppo_state_from_flax
from adafocus_tpu.models.classifiers import RecurrentClassifier
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.models.policy import ActorCritic
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.ppo import core as jppo
from adafocus_tpu.train.stages import TrainState, _rollout_time_major, make_stage2_step
from tests.torch_port_common import (
    FLAGSHIP_WIDTH, TINY, TRAIN_B, abstract_variables, float64_train_setup, jax_variables,
    port_model, port_model64, snapshot, state_dict_from_jax,
)

SEED = 3
STEPS = 3
# two float32 ulps of a loss term (see the module docstring)
LOSS_RTOL = 2.5e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the suite runs several workers a
    machine, and each worker's torch would otherwise start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Rewards, returns, sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["conf", "prev", "random"])
def test_compute_rewards_matches_jax(mode):
    rs = np.random.RandomState(0)
    conf, base = rs.uniform(0, 1, (2, 4, 5)).astype(np.float32)
    want = jppo.compute_rewards(jnp.asarray(conf), jnp.asarray(base), mode)
    got = tppo.compute_rewards(torch.from_numpy(conf), torch.from_numpy(base), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode == "random":
        with pytest.raises(ValueError, match="baseline"):
            tppo.compute_rewards(torch.from_numpy(conf), None, mode)


def test_discounted_returns_matches_jax():
    # (T, B) = (4, 2): the population std is sqrt(7/8) of the unbiased one,
    # so that correction=1 would miss atol 1e-6 by far
    rewards = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    want = np.asarray(jppo.discounted_returns(jnp.asarray(rewards), 0.7))
    got = tppo.discounted_returns(torch.from_numpy(rewards), 0.7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # normalised by the unbiased std the values would shrink by sqrt(7/8)
    assert np.abs(want * np.sqrt(7 / 8) - want).max() > 1e-2


def test_sample_discrete():
    rs = np.random.RandomState(2)
    logits = torch.from_numpy(rs.randn(3, 5, 49).astype(np.float32) * 2)
    idx, logp = tpolicy.sample_discrete(logits, torch.Generator().manual_seed(7))
    assert idx.shape == logp.shape == (3, 5) and logp.dtype == torch.float32
    want = torch.log_softmax(logits, -1).gather(-1, idx[..., None])[..., 0]
    assert torch.equal(logp, want)
    again, _ = tpolicy.sample_discrete(logits, torch.Generator().manual_seed(7))
    assert torch.equal(idx, again)
    # frequencies of 200 000 draws from one row of logits
    n, row = 200_000, logits[0, 0]
    draws, _ = tpolicy.sample_discrete(row.expand(n, 49), torch.Generator().manual_seed(8))
    freq = torch.bincount(draws, minlength=49).double() / n
    p = torch.softmax(row.double(), -1)
    sigma = (p * (1 - p) / n).sqrt()
    assert ((freq - p).abs() <= 5 * sigma).all(), ((freq - p).abs() / sigma).max()
    # greedy mode and the refusals
    actions, greedy, zero = tpolicy.sample_rollout(logits, "greedy", 49)
    assert torch.equal(greedy, logits.argmax(-1)) and not zero.any()
    assert torch.equal(actions, tpolicy.discrete_to_coords(greedy, 49))
    with pytest.raises(ValueError, match="generator"):
        tpolicy.sample_rollout(logits, "sample", 49)


def test_stage2_state_trains_only_the_policy():
    cfg = tgfv.flagship(tiny=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstages.create_train_state(cfg, 2)     # no GPU here, and none asked for
    state = tstages.create_train_state(cfg, 2, device="cpu",
                                       ppo=tppo.PPOConfig(reward_mode="conf"))
    model = state.model
    assert state.optimizer is None and state.scheduler is None
    assert state.ppo.policy is model.policy and state.ppo.cfg.reward_mode == "conf"
    in_adam = {id(p) for g in state.ppo.optimizer.param_groups for p in g["params"]}
    for name, module in model.named_children():
        for prm in module.parameters():
            assert prm.requires_grad == (name == "policy"), name
            assert (id(prm) in in_adam) == (name == "policy"), name
    group = state.ppo.optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (3e-4, (0.9, 0.999), 1e-8)
    assert toptim.stage_trainable(2)["policy"] == "ppo"
    assert {v for k, v in toptim.stage_trainable(2).items() if k != "policy"} == {"frozen"}
    with pytest.raises(ValueError, match="ppo_init"):
        toptim.make_stage_optimizer(model, 2, toptim.OptimConfig())
    other = tstages.create_train_state(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="this model's policy"):
        tstages.make_stage2_step(model, other.ppo)
    serving = tgfv.GFV(dataclasses.replace(cfg, dtype=torch.bfloat16), device="cpu")
    with pytest.raises(ValueError, match="float32 parameters"):
        tstages.make_stage2_step(serving, tppo.ppo_init(serving.policy))


# ---------------------------------------------------------------------------
# Evaluate pass and lookahead, float32
# ---------------------------------------------------------------------------


def _jax_policy(cfg, t, b, seed):
    """A flax ActorCritic of ``cfg`` with its params as numpy, the port's
    ActorCritic with the same weights, and (T, B) glance maps of a 64^2
    glance (2x2 maps)."""
    policy = jppo.make_policy(cfg)
    rs = np.random.RandomState(seed)
    fmaps = rs.rand(t, b, 2, 2, 1280).astype(np.float32)
    params = jax.jit(partial(policy.init, method=ActorCritic.rollout_states))(
        jax.random.key(seed), jnp.asarray(fmaps))["params"]
    params = jax.tree.map(np.asarray, params)
    port = tpolicy.ActorCritic(1280, (2, 2), action_dim=cfg.action_dim,
                               hidden_dim=cfg.policy_hidden,
                               encoder_channels=cfg.policy_channels)
    sd = gfv_state_dict_from_flax({"policy": params}, {})
    port.load_state_dict({k.removeprefix("policy."): v for k, v in sd.items()})
    return policy, params, port, fmaps


def test_evaluate_episode_matches_jax():
    t, b = 4, 3
    policy, params, port, fmaps = _jax_policy(FLAGSHIP_WIDTH, t, b, SEED)
    actions = np.random.RandomState(SEED).randint(0, 49, (t, b)).astype(np.int32)
    want = jax.jit(partial(jppo.evaluate_episode, policy))(
        {"params": params}, jnp.asarray(fmaps), jnp.asarray(actions))
    with torch.no_grad():
        got = tppo.evaluate_episode(port, torch.from_numpy(fmaps),
                                    torch.from_numpy(actions).long())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_lookahead_matches_jax():
    # the flagship classifier's widths (3328 -> 1024 -> 200), N = 6
    rs = np.random.RandomState(4)
    hidden = rs.randn(6, 1024).astype(np.float32)
    feature = rs.randn(6, 3328).astype(np.float32)
    head = RecurrentClassifier(num_classes=200, hidden_dim=1024, in_dim=3328,
                               dtype=jnp.float32)
    params = head.init(jax.random.key(4), jnp.asarray(hidden), jnp.asarray(feature),
                       method=RecurrentClassifier.lookahead)["params"]
    want = head.apply({"params": params}, jnp.asarray(hidden), jnp.asarray(feature),
                      method=RecurrentClassifier.lookahead)
    port = tclassifiers.RecurrentClassifier(3328, 200, 1024)
    sd = gfv_state_dict_from_flax({"c": jax.tree.map(np.asarray, params)}, {})
    port.load_state_dict({k.removeprefix("c."): v for k, v in sd.items()})
    with torch.no_grad():
        got = port.lookahead(torch.from_numpy(hidden), torch.from_numpy(feature))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def tiny_models():
    jmodel, variables = abstract_variables(TINY, seed=SEED)
    return jmodel, variables, port_model(TINY, variables)


def test_gfv_classifier_methods_match_jax(tiny_models):
    # classifier_step, classify_seq_with_hiddens and classifier_lookahead on
    # the bridged TINY GFV, atol 1e-5
    jmodel, variables, model = tiny_models
    rs = np.random.RandomState(5)
    b, t, d, h = 3, 4, TINY.fused_dim, TINY.hidden_dim
    fused = rs.randn(b, t, d).astype(np.float32)
    h0 = rs.randn(b, h).astype(np.float32)
    cases = [("classify_seq_with_hiddens", (fused,)), ("classifier_step", (h0, fused[:, 0])),
             ("classifier_lookahead", (h0, fused[:, 1]))]
    for name, args in cases:
        want = jmodel.apply(variables, *map(jnp.asarray, args), method=getattr(GFV, name))
        with torch.no_grad():
            got = getattr(model, name)(*map(torch.from_numpy, args))
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                       err_msg=name)


def test_policy_rollout_sample_mode(tiny_models):
    # GFV.policy_rollout(mode='sample') and the stage-2 behavior rollout draw
    # the same actions from the same seed, with log_softmax's logprob at them
    _, _, model = tiny_models
    fmap = torch.from_numpy(np.random.RandomState(7).rand(3, TINY.num_frames, 1, 1, 1280)
                            .astype(np.float32))
    with torch.no_grad():
        roll = model.policy_rollout(fmap, "sample", torch.Generator().manual_seed(9))
        behavior = tstages._rollout_time_major(model.policy, fmap.transpose(0, 1),
                                               torch.Generator().manual_seed(9),
                                               TINY.action_dim)
        logits = model.policy.rollout_states(fmap.transpose(0, 1))[1]
    assert torch.equal(roll["action_idx"], behavior["store"].transpose(0, 1))
    assert torch.equal(roll["actions"], behavior["coords"].transpose(0, 1))
    want = torch.log_softmax(logits, -1).gather(-1, behavior["store"][..., None])[..., 0]
    assert torch.equal(roll["logprob"], want.transpose(0, 1))
    with pytest.raises(ValueError, match="generator"):
        model.policy_rollout(fmap, "sample")


def test_batched_lookahead_matches_sequential(tiny_models):
    # the stage-2 baseline: one batched lookahead over B*T from the shifted
    # hiddens h_{t-1} equals the MDP loop that peeks one step with the
    # random features at each t without advancing the hidden
    _, _, model = tiny_models
    rs = np.random.RandomState(6)
    b, t, d = 2, 5, TINY.fused_dim
    fused_policy = torch.from_numpy(rs.randn(b, t, d).astype(np.float32))
    fused_rand = torch.from_numpy(rs.randn(b, t, d).astype(np.float32))
    with torch.no_grad():
        _, hiddens = model.classify_seq_with_hiddens(fused_policy)
        h_prev = torch.cat([torch.zeros_like(hiddens[:, :1]), hiddens[:, :-1]], 1)
        batched = model.classifier_lookahead(h_prev.reshape(b * t, -1),
                                             fused_rand.reshape(b * t, -1)).reshape(b, t, -1)
        h, seq = torch.zeros(b, TINY.hidden_dim), []
        for i in range(t):
            seq.append(model.classifier_lookahead(h, fused_rand[:, i]))
            h, _ = model.classifier_step(h, fused_policy[:, i])
    torch.testing.assert_close(batched, torch.stack(seq, 1), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# PPO update, float64
# ---------------------------------------------------------------------------


def _rel_update(got_new, got_old, want_new, want_old):
    """max|port update - JAX update| / max|JAX update| of one tensor."""
    want = want_new - want_old
    return float(((got_new - got_old) - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("k_epochs", [1, 2])
def test_ppo_update_matches_jax(k_epochs):
    # with two epochs the second re-evaluates the episode under the first's
    # update (ratios away from 1) and takes a second Adam step
    t, b = 4, 3
    cfg64 = dataclasses.replace(FLAGSHIP_WIDTH, dtype=jnp.float64)
    with jax.enable_x64(True):
        policy, params, _, fmaps = _jax_policy(cfg64, t, b, SEED + 1)
        params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        fmaps = fmaps.astype(np.float64)
        rs = np.random.RandomState(SEED + 1)
        actions = rs.randint(0, 49, (t, b)).astype(np.int32)
        old_logprob, _, _ = jax.jit(partial(jppo.evaluate_episode, policy))(
            {"params": params}, jnp.asarray(fmaps), jnp.asarray(actions))
        returns = np.asarray(jppo.discounted_returns(
            jnp.asarray(rs.randn(t, b).astype(np.float32)), 0.7))
        memory = {"fmaps": fmaps, "actions": actions, "old_logprob": np.asarray(old_logprob),
                  "returns": returns}
        cfg = jppo.PPOConfig(k_epochs=k_epochs)
        state, want_m, _ = jax.jit(lambda s, m: jppo.ppo_update(policy, s, None, m, cfg))(
            jppo.ppo_init(params, cfg), jax.tree.map(jnp.asarray, memory))
        want_sd = gfv_state_dict_from_flax({"policy": jax.tree.map(np.asarray, state.params)},
                                           {}, torch.float64)

    port = tpolicy.ActorCritic(1280, (2, 2), action_dim=49, hidden_dim=1024).double()
    sd = gfv_state_dict_from_flax({"policy": params}, {}, torch.float64)
    port.load_state_dict({k.removeprefix("policy."): v for k, v in sd.items()})
    learner = tppo.ppo_init(port, tppo.PPOConfig(k_epochs=k_epochs))
    tmem = {k: torch.tensor(v) for k, v in memory.items()}
    tmem["actions"] = tmem["actions"].long()
    got_m = tppo.ppo_update(learner, tmem)
    assert learner.step == 1
    for key, p in port.state_dict().items():
        err = _rel_update(p, sd["policy." + key], want_sd["policy." + key], sd["policy." + key])
        assert err <= 1e-6, (key, err)
    for key, want in want_m.items():
        np.testing.assert_allclose(float(got_m[key]), float(want), rtol=LOSS_RTOL, err_msg=key)
    if k_epochs == 1:
        assert abs(float(got_m["ppo/ratio_mean"]) - 1.0) <= 1e-12
    else:
        assert abs(float(got_m["ppo/ratio_mean"]) - 1.0) > 1e-6


# ---------------------------------------------------------------------------
# The stage-2 step, float64, against JAX's with its draws injected
# ---------------------------------------------------------------------------


_FROZEN = ("glancer.", "focuser.", "classifier.")
# (reward mode, steps) of the trajectories compared
_RUNS = {"random": STEPS, "conf": 1, "prev": 1}
# one step's per-tensor tolerance (test_stage2_step_matches_jax)
_TENSOR_TOL = {"random": 1e-4, "conf": 1e-6, "prev": 1e-6}


def _same_tree(a, b):
    return all(jax.tree.leaves(jax.tree.map(lambda x, y: bool(np.array_equal(x, y)), a, b)))


@pytest.fixture(scope="module")
def stage2_runs():
    """For each reward mode, _RUNS[mode] stage-2 steps on both sides from the
    same float64 weights and batch, with JAX's draws injected into the port.
    Returns {mode: (JAX state dicts, port state dicts, JAX metrics, port
    metrics, the draws, JAX's state after its first step)}."""
    # flax's init: on abstract_variables' weights four of these bounds fail
    # (ROADMAP item 26)
    cfg, jmodel, variables, jbatch, tbatch = float64_train_setup(SEED, jax_variables)
    b, t = TRAIN_B, cfg.num_frames
    runs = {}
    with jax.enable_x64(True):
        fmap, _ = jax.jit(lambda v, x: jmodel.apply(v, x, False, method=GFV.glance))(
            variables, jbatch["frames_small"])
        fmaps_tb = jnp.swapaxes(fmap, 0, 1)
        policy = jppo.make_policy(cfg)
        behavior = jax.jit(lambda p, key: _rollout_time_major(
            policy, {"params": p}, fmaps_tb, key, cfg)["store"])
        for mode, n_steps in _RUNS.items():
            jcfg = jppo.PPOConfig(reward_mode=mode)
            state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                               opt_state=None, step=jnp.zeros((), jnp.int32),
                               ppo=jppo.ppo_init(variables["params"]["policy"], jcfg))
            jstep = jax.jit(make_stage2_step(jmodel, jcfg))
            model = port_model64(cfg, variables)
            toptim.freeze_for_stage(model, 2)
            step = tstages.make_stage2_step(model, tppo.ppo_init(model.policy,
                                                                 tppo.PPOConfig(reward_mode=mode)))
            jax_sd = [state_dict_from_jax(variables, torch.float64)]
            port_sd = [snapshot(model)]
            jax_m, port_m, draws, first = [], [], [], None
            for k in range(n_steps):
                rng = jax.random.key(200 + k)
                roll_key, base_key = jax.random.split(rng)
                idx = np.array(behavior(state.ppo.params_old, roll_key))
                base = np.array(random_patch_actions(base_key, (b, t)))
                draws.append((idx, base))
                state, m = jstep(state, jbatch, rng)
                # the invariant the port's behavior policy rests on: the
                # behavior copy equals the trained parameters after a step
                assert _same_tree(state.ppo.params_old, state.ppo.params)
                assert _same_tree(state.ppo.params, state.params["policy"])
                if k == 0:
                    first = jax.tree.map(np.asarray, state)
                jax_sd.append(state_dict_from_jax({"params": state.params,
                                                   "batch_stats": state.batch_stats},
                                                  torch.float64))
                jax_m.append({key: float(v) for key, v in m.items()})
                got = step(tbatch, None, torch.from_numpy(idx).long(), torch.from_numpy(base))
                port_sd.append(snapshot(model))
                port_m.append({key: float(v) for key, v in got.items()})
            runs[mode] = (jax_sd, port_sd, jax_m, port_m, draws, first)
    return cfg, tbatch, runs


def _check_step(jax_sd, port_sd, jax_m, port_m, n_steps, tensor_tol):
    for k in range(n_steps):
        assert port_m[k].keys() == jax_m[k].keys()
        for key, want in jax_m[k].items():
            tol = dict(rtol=0, atol=1e-8) if key == "reward_mean" else dict(rtol=1e-6)
            np.testing.assert_allclose(port_m[k][key], want, err_msg=(k, key), **tol)
    j0, j1, p0, p1 = jax_sd[0], jax_sd[n_steps], port_sd[0], port_sd[n_steps]
    for key in j0:
        assert torch.equal(p0[key], j0[key]), key
        if key.startswith(_FROZEN):
            # JAX leaves the frozen components and every running statistic
            assert torch.equal(j1[key], j0[key]), key
            assert torch.equal(p1[key], p0[key]), f"{key} moved"
        elif n_steps == 1:
            assert _rel_update(p1[key], p0[key], j1[key], j0[key]) <= tensor_tol, key
    keys = [k for k in j0 if k.startswith("policy.")]
    got = torch.cat([(p1[k] - p0[k]).flatten() for k in keys])
    want = torch.cat([(j1[k] - j0[k]).flatten() for k in keys])
    assert float((got - want).norm() / want.norm()) <= (1e-6 if n_steps == 1 else 1e-4)


@pytest.mark.parametrize("mode,n_steps", [("random", 1), ("random", STEPS), ("conf", 1),
                                          ("prev", 1)],
                         ids=["random-one_step", "random-three_steps", "conf-one_step",
                              "prev-one_step"])
def test_stage2_step_matches_jax(stage2_runs, mode, n_steps):
    """float64, JAX's draws injected. Glancer, focuser, classifier and every
    running statistic stay bit-identical, as JAX leaves them. The metrics
    agree within rtol 1e-6 (measured: at most 6.0e-7, the loss), except
    ``reward_mean``, held at atol 1e-8 (measured 2.3e-9; 1.6e-6 relative):
    the reward is a difference of two float32 confidences near 0.1 and its
    float32 mean, summed in another order, differs by a fraction of an ulp
    of the confidences (7.5e-9), not of the mean reward (about 1e-3).

    The policy's update: after three steps, as a whole, ||port - JAX|| /
    ||JAX|| <= 1e-4 (measured 2.4e-7); after one step as a whole <= 1e-6
    (measured 1.4e-7), and each tensor's max|port - JAX| within
    ``_TENSOR_TOL`` of its max|JAX update|. That is 1e-6 for rewards 'conf'
    and 'prev' (measured 3.2e-12), 1e-4 for 'random' (measured 2.4e-5 on
    ``policy.gru.weight_ih``, 4.1e-6 on ``policy.encoder.fc.weight``, the
    rest under 1e-7): there the float32 means of the rewards and of the
    returns' normalisation differ by an ulp between the packages, the
    returns by about 1e-7 relative, and Adam's first step, lr * g / (|g| +
    1e-8), turns that into 1e-5 of lr on the few elements whose gradient is
    within a few 1e-8 of zero."""
    _, _, runs = stage2_runs
    jax_sd, port_sd, jax_m, port_m, _, _ = runs[mode]
    _check_step(jax_sd, port_sd, jax_m, port_m, n_steps, _TENSOR_TOL[mode])


def test_ppo_state_from_flax_continues_jax_run(stage2_runs):
    # JAX's state after its first step (reward 'random') crosses to a fresh
    # port model and learner; the port's second step then agrees with JAX's
    # to the one-step tolerances of reward 'random' (measured: 1.5e-5 of a
    # tensor's max|update|, 4.1e-7 for the policy's as a whole)
    cfg, tbatch, runs = stage2_runs
    jax_sd, _, jax_m, _, draws, first = runs["random"]
    model = port_model64(cfg, {"params": first.params, "batch_stats": first.batch_stats})
    toptim.freeze_for_stage(model, 2)
    learner = tppo.ppo_init(model.policy, tppo.PPOConfig())
    ppo_state_from_flax(first.ppo, learner)
    assert learner.step == 1
    assert all(float(s["step"]) == 1 for s in learner.optimizer.state.values())
    before = snapshot(model)
    idx, base = draws[1]
    got = tstages.make_stage2_step(model, learner)(
        tbatch, None, torch.from_numpy(idx).long(), torch.from_numpy(base))
    _check_step([jax_sd[1], jax_sd[2]], [before, snapshot(model)], [jax_m[1]],
                [{k: float(v) for k, v in got.items()}], 1, _TENSOR_TOL["random"])
