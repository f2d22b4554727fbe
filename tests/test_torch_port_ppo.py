"""Port parity for stage 2 (PPO on the patch policy) against the JAX
package on the CPU: the rewards and returns, the sampler, the policy's
evaluate pass, the classifier's lookahead, the PPO update, the whole
stage-2 step and the Adam-state bridge.

The inputs are numpy arrays from seeds; the weights are bridged
(tests/torch_port_common.py), flax's init for the policy-only tests and
``abstract_variables`` for the GFV. The stage-2 step is compared in float64
at TRAIN_CFG with JAX's own draws injected into the port: the behavior
indices from JAX's ``_rollout_time_major`` on the step's ``roll_key``, the
baseline actions from ``random_patch_actions`` on its ``base_key``.

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
- the stage-2 step, the bridged Adam state and an update whose ratios start
  off 1, float64: bounds derived from float32's rounding, not fixed ones
  (``test_stage2_step_matches_jax``): each policy tensor's gradient within
  64 float32 ulps of its largest |g|, each update within what Adam makes of
  that gradient bound, each loss metric within 2 * T*B float32 ulps of the
  mean of |term| of its own terms.
"""

import collections
import contextlib
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
    FLAGSHIP_WIDTH, TINY, TRAIN_B, abstract_variables, float64_train_setup,
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
# both packages' PPO defaults (rate, betas, coefficients, clip) and Adam's
# eps (optax.adam's default, JAX's make_optimizer)
_REF = jppo.PPOConfig()
_ADAM_EPS = 1e-8
_EPS64 = float(np.finfo(np.float64).eps)
# the bounds of the stage-2 checks (test_stage2_step_matches_jax)
GRAD_ULPS = 64        # a policy tensor's gradient: float32 ulps of its largest |g|
SAFETY = 2            # on each bound derived from the rounding
REWARD_ATOL = 1e-8


def _ulp32(x: float) -> float:
    """float32's unit in the last place at |x|."""
    return float(np.spacing(np.float32(abs(x))))


def _same_tree(a, b):
    return all(jax.tree.leaves(jax.tree.map(lambda x, y: bool(np.array_equal(x, y)), a, b)))


@dataclasses.dataclass
class _Run:
    """Both sides of a run of stage-2 steps (or PPO updates): the state
    dicts before and after each step; each step's metrics, Adam moments after
    it ({"m", "v"}, each by state-dict key) and the port's loss terms
    (``_recorded_terms``); the moments and Adam's count before the first
    step, the same on both sides."""

    jax_sd: list
    port_sd: list
    adam0: dict
    count0: int = 0
    jax_m: list = dataclasses.field(default_factory=list)
    port_m: list = dataclasses.field(default_factory=list)
    jax_adam: list = dataclasses.field(default_factory=list)
    port_adam: list = dataclasses.field(default_factory=list)
    terms: list = dataclasses.field(default_factory=list)


@contextlib.contextmanager
def _recorded_terms():
    """Yields a list that gets, for each call of the port's
    ``clipped_objective``, its float32 inputs (logprobs, values, entropies,
    behavior logprobs, returns) as float64 numpy arrays."""
    calls, objective = [], tppo.clipped_objective

    def record(*args):
        calls.append([a.detach().double().numpy() for a in args[:5]])
        return objective(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tppo, "clipped_objective", record)
        yield calls


def _port_moments(model, learner) -> dict:
    names = {p: "policy." + n for n, p in model.policy.named_parameters()}
    return {m: {names[p]: s[key].clone() for p, s in learner.optimizer.state.items()}
            for m, key in (("m", "exp_avg"), ("v", "exp_avg_sq"))}


def _jax_moments(ppo_state) -> dict:
    adam = ppo_state.opt_state[0]
    return {m: state_dict_from_jax({"params": {"policy": tree}, "batch_stats": {}}, torch.float64)
            for m, tree in (("m", adam.mu), ("v", adam.nu))}


def _zero_moments(model) -> dict:
    zeros = {"policy." + n: torch.zeros_like(p) for n, p in model.policy.named_parameters()}
    return {"m": zeros, "v": zeros}


def _train_setup():
    """The float64 TRAIN_CFG set-up of ``float64_train_setup`` (weights from
    ``abstract_variables``) and JAX's glance maps of its batch, time-major,
    as numpy."""
    cfg, jmodel, variables, jbatch, tbatch = float64_train_setup(SEED)
    with jax.enable_x64(True):
        fmap, _ = jax.jit(lambda v, x: jmodel.apply(v, x, False, method=GFV.glance))(
            variables, jbatch["frames_small"])
        fmaps_tb = np.asarray(jnp.swapaxes(fmap, 0, 1))
    return cfg, jmodel, variables, jbatch, tbatch, fmaps_tb


def _stage2_runs(setup) -> dict:
    """For each reward mode, _RUNS[mode] stage-2 steps on both sides from the
    set-up's weights and batch, with JAX's draws injected into the port.
    Returns {mode: (the _Run, the draws, JAX's state after its first step)}."""
    cfg, jmodel, variables, jbatch, tbatch, fmaps_tb = setup
    b, t = TRAIN_B, cfg.num_frames
    runs = {}
    with jax.enable_x64(True), _recorded_terms() as terms:
        policy = jppo.make_policy(cfg)
        behavior = jax.jit(lambda p, key: _rollout_time_major(
            policy, {"params": p}, jnp.asarray(fmaps_tb), key, cfg)["store"])
        for mode, n_steps in _RUNS.items():
            jcfg = jppo.PPOConfig(reward_mode=mode)
            state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                               opt_state=None, step=jnp.zeros((), jnp.int32),
                               ppo=jppo.ppo_init(variables["params"]["policy"], jcfg))
            jstep = jax.jit(make_stage2_step(jmodel, jcfg))
            model = port_model64(cfg, variables)
            toptim.freeze_for_stage(model, 2)
            learner = tppo.ppo_init(model.policy, tppo.PPOConfig(reward_mode=mode))
            step = tstages.make_stage2_step(model, learner)
            run = _Run([state_dict_from_jax(variables, torch.float64)], [snapshot(model)],
                       _zero_moments(model))
            draws, first = [], None
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
                run.jax_sd.append(state_dict_from_jax({"params": state.params,
                                                       "batch_stats": state.batch_stats},
                                                      torch.float64))
                run.jax_m.append({key: float(v) for key, v in m.items()})
                run.jax_adam.append(_jax_moments(state.ppo))
                got = step(tbatch, None, torch.from_numpy(idx).long(), torch.from_numpy(base))
                assert len(terms) == 1     # one epoch
                run.terms.append(terms.pop())
                run.port_sd.append(snapshot(model))
                run.port_m.append({key: float(v) for key, v in got.items()})
                run.port_adam.append(_port_moments(model, learner))
            runs[mode] = (run, draws, first)
    return runs


def _off_policy_run(setup) -> _Run:
    """One PPO update (``ppo_update``, one epoch) on both sides from the
    set-up's policy on an episode of its glance maps, seeded actions and
    returns, whose behavior logprobs are JAX's own shifted by seeded offsets
    in +-0.4: the ratios start in [0.67, 1.49], where the clip acts (in the
    stage-2 step they start at exactly 1)."""
    cfg, _, variables, _, _, fmaps_tb = setup
    t, b = fmaps_tb.shape[:2]
    rs = np.random.RandomState(SEED + 7)
    actions = rs.randint(0, cfg.action_dim, (t, b)).astype(np.int32)
    offsets = rs.uniform(-0.4, 0.4, (t, b)).astype(np.float32)
    rewards = rs.randn(t, b).astype(np.float32)
    params = variables["params"]["policy"]
    with jax.enable_x64(True):
        policy = jppo.make_policy(cfg)
        logp, _, _ = jax.jit(partial(jppo.evaluate_episode, policy))(
            {"params": params}, jnp.asarray(fmaps_tb), jnp.asarray(actions))
        memory = {"fmaps": fmaps_tb, "actions": actions,
                  "old_logprob": np.asarray(logp) + offsets,
                  "returns": np.asarray(jppo.discounted_returns(jnp.asarray(rewards),
                                                                _REF.gamma))}
        state, want, _ = jax.jit(lambda s, m: jppo.ppo_update(policy, s, None, m, _REF))(
            jppo.ppo_init(params, _REF), jax.tree.map(jnp.asarray, memory))
        run = _Run([state_dict_from_jax({"params": {"policy": params}, "batch_stats": {}},
                                        torch.float64)], [], {})
        run.jax_sd.append(state_dict_from_jax({"params": {"policy": state.params},
                                               "batch_stats": {}}, torch.float64))
        run.jax_m.append({key: float(v) for key, v in want.items()})
        run.jax_adam.append(_jax_moments(state))
    model = port_model64(cfg, variables)
    learner = tppo.ppo_init(model.policy, tppo.PPOConfig())
    run.adam0 = _zero_moments(model)
    policy_sd = lambda: {"policy." + k: v.detach().clone()  # noqa: E731
                         for k, v in model.policy.state_dict().items()}
    run.port_sd.append(policy_sd())
    tmem = {k: torch.tensor(v) for k, v in memory.items()}
    tmem["actions"] = tmem["actions"].long()
    with _recorded_terms() as terms:
        got = tppo.ppo_update(learner, tmem, model.autocast)
    run.terms.append(terms.pop())
    run.port_sd.append(policy_sd())
    run.port_m.append({key: float(v) for key, v in got.items()})
    run.port_adam.append(_port_moments(model, learner))
    return run


@pytest.fixture(scope="module")
def train_setup():
    return _train_setup()


@pytest.fixture(scope="module")
def stage2_runs(train_setup):
    cfg, _, _, _, tbatch, _ = train_setup
    return cfg, tbatch, _stage2_runs(train_setup)


def _metric_errors(jax_m: dict, port_m: dict, terms: list) -> dict:
    """{metric: (|port - JAX|, its bound)} of one step. A metric that is a
    float32 mean of N terms: SAFETY * N float32 ulps of the mean of |term|
    (of the step's own terms; the confidence's are positive, their mean the
    metric); ``reward_mean``: REWARD_ATOL."""
    assert port_m.keys() == jax_m.keys()
    logp, values, entropy, old, returns = terms
    ratio = np.exp(logp - old)
    adv = returns - values
    surr = np.minimum(ratio * adv, np.clip(ratio, 1 - _REF.eps_clip, 1 + _REF.eps_clip) * adv)
    value = (values - returns) ** 2
    mean_abs = {"ppo/policy_loss": np.abs(surr).mean(), "ppo/value_loss": value.mean(),
                "ppo/entropy": np.abs(entropy).mean(), "ppo/ratio_mean": ratio.mean(),
                "ppo/loss": (np.abs(surr) + _REF.value_coef * value
                             + _REF.entropy_coef * np.abs(entropy)).mean(),
                "confidence": abs(jax_m.get("confidence", 0.0))}
    return {key: (abs(port_m[key] - want), REWARD_ATOL if key == "reward_mean"
                  else SAFETY * logp.size * _ulp32(mean_abs[key]))
            for key, want in jax_m.items()}


def _adam_update(m, v, count: int):
    """Adam's update (its magnitude, before the sign) from the moments after
    ``count`` steps, as optax and torch compute it."""
    b1, b2 = _REF.betas
    return _REF.lr * (m / (1 - b1 ** count)) / ((v / (1 - b2 ** count)).sqrt() + _ADAM_EPS)


def _update_spread(g, delta: float, m, v, dm, dv, count: int):
    """The most Adam's update can move, element by element, when each
    gradient so far may be off by its bound: at the first step (moments
    from zero) the update lr * g / (|g| + eps) is monotone in g, so the ends
    of g +- delta bound it; later, with moments off by dm and dv, the
    update is monotone in each moment, so the box's corners bound it."""
    b1, b2 = _REF.betas
    if count == 1:
        ends = [_adam_update((1 - b1) * x, (1 - b2) * x * x, 1) for x in (g - delta, g + delta)]
        mid = _adam_update(m, v, 1)
    else:
        mid = _adam_update(m, v, count)
        ends = [_adam_update(m + sm * dm, (v + sv * dv).clamp(min=0), count)
                for sm in (-1, 1) for sv in (-1, 1)]
    return torch.stack([(e - mid).abs() for e in ends]).amax(0)


def _check_run(run: _Run, n_steps: int) -> dict:
    """Holds the first ``n_steps`` steps of ``run`` to their bounds: the
    frozen components and running statistics bit-identical, then each step's
    metrics (``_metric_errors``), each policy tensor's gradient (Adam's new
    first moment less beta1 times its last, over 1 - beta1) within
    GRAD_ULPS float32 ulps of JAX's largest |g| of the tensor, and each
    element's update within SAFETY times ``_update_spread`` at JAX's
    moments, plus float64's rounding of Adam's arithmetic and of each side's
    parameter add. Returns each check's largest share of its bound."""
    b1, b2 = _REF.betas
    keys = sorted(run.adam0["m"])
    j, p = run.jax_sd, run.port_sd
    for key in j[0]:
        assert torch.equal(p[0][key], j[0][key]), key
        if key.startswith(_FROZEN):
            # JAX leaves the frozen components and every running statistic
            assert torch.equal(j[n_steps][key], j[0][key]), key
            assert torch.equal(p[n_steps][key], p[0][key]), f"{key} moved"
        else:
            assert key in run.adam0["m"], f"{key} is neither frozen nor trained"
    shares = collections.defaultdict(float)
    jm0 = pm0 = run.adam0["m"]
    dm, dv = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0.0)
    for k in range(n_steps):
        for key, (err, bound) in _metric_errors(run.jax_m[k], run.port_m[k],
                                                run.terms[k]).items():
            assert err <= bound, (k, key, run.port_m[k][key], run.jax_m[k][key], bound)
            shares[key] = max(shares[key], err / bound)
        count = run.count0 + k + 1
        jm, jv, pm = run.jax_adam[k]["m"], run.jax_adam[k]["v"], run.port_adam[k]["m"]
        for key in keys:
            g = (jm[key] - b1 * jm0[key]) / (1 - b1)
            delta = GRAD_ULPS * _ulp32(float(g.abs().max()))
            dg = float(((pm[key] - b1 * pm0[key]) / (1 - b1) - g).abs().max())
            assert dg <= delta, (k, key, "gradient", dg / _ulp32(float(g.abs().max())))
            dm[key] = b1 * dm[key] + (1 - b1) * delta
            dv[key] = b2 * dv[key] + (1 - b2) * (2 * g.abs() * delta + delta ** 2)
            spread = _update_spread(g, delta, jm[key], jv[key], dm[key], dv[key], count)
            bound = SAFETY * spread + 4 * _EPS64 * (j[k + 1][key].abs() + _REF.lr)
            err = ((p[k + 1][key] - p[k][key]) - (j[k + 1][key] - j[k][key])).abs()
            assert (err <= bound).all(), (k, key, "update", float((err / bound).max()))
            shares["gradient"] = max(shares["gradient"], dg / delta if delta else 0.0)
            shares["update"] = max(shares["update"], float((err / bound).max()))
        jm0, pm0 = jm, pm
    return dict(shares)


@pytest.mark.parametrize("mode,n_steps", [("random", 1), ("random", STEPS), ("conf", 1),
                                          ("prev", 1)],
                         ids=["random-one_step", "random-three_steps", "conf-one_step",
                              "prev-one_step"])
def test_stage2_step_matches_jax(stage2_runs, mode, n_steps):
    """float64, JAX's draws injected; every bound follows from float32's
    rounding (``_check_run``). Glancer, focuser, classifier and every
    running statistic stay bit-identical, as JAX leaves them.

    Both packages compute the PPO loss in float32 whatever the parameters'
    dtype, so the policy's float64 gradient carries the loss terms' float32
    rounding. The gradient, Adam's first moment, is held element by element
    within GRAD_ULPS (64) float32 ulps of the tensor's largest |g|. The
    terms differ by ulps between the packages: the rewards are float32
    confidences (a difference of two for 'random', 'prev'), and the returns'
    normalisation divides that rounding by the returns' spread. Summed over
    the episode's N = T*B terms of both signs the difference can reach tens
    of ulps of max|g|. Measured, worst tensor and step (flax's init /
    ``abstract_variables``): 'random' 8.7 / 35 ulps (one step 1.2 / 28),
    'conf' 0.0 / 3.1, 'prev' 0.0 / 1.05 (on flax's init weights the two
    gradients of 'conf' and 'prev' agree to float64's rounding).

    Each update is held to what Adam does with that gradient bound: at the
    first step the update is lr * g / (|g| + eps), eps = 1e-8, monotone in
    g, so its change is at most its value's range over g +- 64 ulps (to
    first order lr * eps / (|g| + eps)^2 * delta); at later steps the
    moments carry every earlier step's bound, (1 - beta1) delta and
    (1 - beta2) (2|g| delta + delta^2) a step, and the update's range is
    taken at the corners of that box. Times SAFETY (2), plus float64's
    rounding of Adam and of the parameter's add. This replaces fixed bounds
    (1e-4 and 1e-6 of a tensor's largest update, per tensor and for the
    policy as a whole) that measured how well a set of weights is
    conditioned, not the port: on ``abstract_variables`` a gradient within
    1e-8 of zero moves ``policy.encoder.fc.weight``'s update by 6.7e-4 of
    its largest (reward 'prev'). Such an element's update may be anything in
    +-lr, and its bound reads so: up to 4 lr, 3.98 times the largest update
    of ``policy.encoder.proj.weight`` on flax's init weights; the gradient
    check is what holds it. Measured, the largest share of its bound an
    update took: 0.21 (``abstract_variables``, 'random'), 0.08 (flax's init).

    The loss metrics are float32 means of N terms: SAFETY * N ulps of the
    mean of |term| of that step (one ulp a term for its own rounding and its
    share of a sum in another order; measured at most 3 ulps, 'conf'
    ``ppo/value_loss`` on ``abstract_variables``). On flax's init weights
    each reads wider than the rtol 1e-6 it replaces: from 1.2e-6 of the
    value (``confidence``) to 2.8e-5 (``ppo/loss``, reward 'prev': 0.068,
    where its terms average 1.3). ``reward_mean`` keeps atol 1e-8 (measured
    3.7e-9: a difference of two float32 confidences near 0.05-0.1 averaged,
    a fraction of their ulp)."""
    _, _, runs = stage2_runs
    run, _, _ = runs[mode]
    _check_run(run, n_steps)


def test_ppo_state_from_flax_continues_jax_run(stage2_runs):
    # JAX's state after its first step (reward 'random') crosses to a fresh
    # port model and learner, its Adam moments exactly; the port's second
    # step then agrees with JAX's to the bounds of
    # test_stage2_step_matches_jax from those moments (Adam's count 1 before)
    cfg, tbatch, runs = stage2_runs
    run, draws, first = runs["random"]
    model = port_model64(cfg, {"params": first.params, "batch_stats": first.batch_stats})
    toptim.freeze_for_stage(model, 2)
    learner = tppo.ppo_init(model.policy, tppo.PPOConfig())
    ppo_state_from_flax(first.ppo, learner)
    assert learner.step == 1
    assert all(float(s["step"]) == 1 for s in learner.optimizer.state.values())
    moments = _port_moments(model, learner)
    for m, by_key in moments.items():
        for key, value in by_key.items():
            assert torch.equal(value, run.jax_adam[0][m][key]), (m, key)
    cont = _Run([run.jax_sd[1], run.jax_sd[2]], [snapshot(model)], moments, count0=1,
                jax_m=[run.jax_m[1]], jax_adam=[run.jax_adam[1]])
    idx, base = draws[1]
    with _recorded_terms() as terms:
        got = tstages.make_stage2_step(model, learner)(
            tbatch, None, torch.from_numpy(idx).long(), torch.from_numpy(base))
    cont.terms.append(terms.pop())
    cont.port_sd.append(snapshot(model))
    cont.port_m.append({k: float(v) for k, v in got.items()})
    cont.port_adam.append(_port_moments(model, learner))
    _check_run(cont, 1)


def test_stage2_update_off_policy_matches_jax(train_setup):
    # the stage-2 step's ratios start at exactly 1, where the clip does
    # nothing; this update's start in [0.67, 1.49] (_off_policy_run), and it
    # is held to the same bounds
    run = _off_policy_run(train_setup)
    logp, _, _, old, _ = run.terms[0]
    ratio = np.exp(logp - old)
    assert (ratio < 1 - _REF.eps_clip).any() and (ratio > 1 + _REF.eps_clip).any()
    _check_run(run, 1)
