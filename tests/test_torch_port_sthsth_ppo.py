"""Port parity for the sth-sth family's stage-2 step (per-division PPO) in
float64 on the CPU: the continuous and the discrete policy, each with the
BatchNorm state encoder, one step from the same weights and batch as the
JAX package's step, reward 'random'. JAX's draws are injected into the
port: the behavior noise (continuous) or indices (discrete, from JAX's
``_rollout_time_major``) from the step's roll key, the baseline actions
from its base key. Set-up: tests/test_torch_port_sthsth_steps.py.

Tolerances:

- the policy's gradient within 1e-6 of JAX's as a whole (measured 6.7e-7
  continuous, 2.9e-7 discrete): both packages compute the PPO loss in
  float32 whatever the parameters' dtype, and the rewards, differences of
  float32 confidences, agree to about 1e-6 relative;
- the policy's update within 1e-4 of JAX's as a whole (measured 6.3e-6
  continuous, 3.6e-5 discrete), not 1e-6: Adam's first step, lr * g /
  (|g| + 1e-8), turns the float32 rounding of a gradient element near 1e-8
  into a sizeable fraction of lr;
- the encoder's running statistics atol 1e-6 (measured 3e-16), every
  other tensor bit-identical, ``ppo/ratio_mean`` 1 within 1e-12 on both
  sides, the other metrics rtol 1e-6 (atol 1e-8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch.ppo import core as tppo
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages_sthsth as tss
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.ppo import core as jppo
from adafocus_tpu.train import stages_sthsth as jss
from adafocus_tpu.train.stages import TrainState, _rollout_time_major
from tests.test_torch_port_sthsth_steps import one_torch_thread, setup64  # noqa: F401 (fixtures)
from tests.test_torch_port_sthsth_train import B, SEED, _policy_pair
from tests.torch_port_common import port_model64, snapshot, state_dict_from_jax


@pytest.mark.parametrize("continuous", [True, False], ids=["continuous", "discrete"])
def test_sthsth_stage2_step_matches_jax(setup64, continuous):  # noqa: F811
    """One float64 stage-2 step, reward 'random', BatchNorm encoder, JAX's
    draws injected; see the module's tolerances."""
    cfg, variables, jbatch, tbatch = setup64
    if not continuous:
        cfg = dataclasses.replace(cfg, continuous_policy=False)
        with jax.enable_x64(True):
            _, pv, _ = _policy_pair(cfg, SEED + 1, np.float64)
        variables = {k: {**variables[k], "policy": pv[k]} for k in ("params", "batch_stats")}
    d = cfg.video_div
    rng = jax.random.key(400)
    roll_key, base_key = jax.random.split(rng)
    jmodel = GFV(cfg)
    with jax.enable_x64(True):
        pcfg = jppo.PPOConfig()
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None, step=jnp.zeros((), jnp.int32),
                           ppo=jppo.ppo_init(variables["params"]["policy"], pcfg))
        new, want_m = jax.jit(jss.make_sthsth_stage2_step(jmodel, pcfg))(state, jbatch, rng)
        j1 = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats},
                                 torch.float64)
        if continuous:
            behavior = np.stack([np.asarray(jax.random.normal(k, (B, 2)))
                                 for k in jax.random.split(roll_key, d)])
        else:
            @jax.jit
            def behavior_of(variables, small):
                fmap, _ = jmodel.apply(variables, small, False, method=GFV.glance_logits)
                tg, gh, gw, c = fmap.shape[1:]
                stacked = jnp.moveaxis(fmap.reshape(B, d, tg // d, gh, gw, c), 2, 4).reshape(
                    B, d, gh, gw, (tg // d) * c)
                return _rollout_time_major(
                    jppo.make_policy(cfg), {k: variables[k]["policy"] for k in variables},
                    jnp.swapaxes(stacked, 0, 1), roll_key, cfg)["store"]

            behavior = np.array(behavior_of(variables, jbatch["frames_small"]))
        base = np.array(random_patch_actions(base_key, (B, d)))
    assert abs(float(want_m["ppo/ratio_mean"]) - 1.0) <= 1e-12
    j0 = state_dict_from_jax(variables, torch.float64)
    model = port_model64(cfg, variables)
    toptim.freeze_for_stage(model, 2)
    step = tss.make_sthsth_stage2_step(model, tppo.ppo_init(model.policy, tppo.PPOConfig()))
    got_m = step(tbatch, None, torch.from_numpy(behavior), torch.from_numpy(base))
    p1 = snapshot(model)
    assert abs(float(got_m["ppo/ratio_mean"]) - 1.0) <= 1e-12
    assert got_m.keys() == want_m.keys()
    for key, want in want_m.items():
        np.testing.assert_allclose(float(got_m[key]), float(want), rtol=1e-6, atol=1e-8,
                                   err_msg=key)
    keys = [k for k in j0 if k.startswith("policy.") and not k.endswith("num_batches_tracked")]
    params = [k for k in keys if not k.endswith(("running_mean", "running_var"))]
    # the gradient, from Adam's first moment (1 - beta1) * g
    mu = gfv_state_dict_from_flax(
        {"policy": jax.tree.map(lambda a: np.asarray(a) / (1 - pcfg.betas[0]),
                                new.ppo.opt_state[0].mu)}, {}, torch.float64)
    grads = {"policy." + n: p.grad for n, p in model.policy.named_parameters()}
    got = torch.cat([grads[k].flatten() for k in params])
    want = torch.cat([mu[k].flatten() for k in params])
    assert float((got - want).norm() / want.norm()) <= 1e-6
    got = torch.cat([(p1[k] - j0[k]).flatten() for k in params])
    want = torch.cat([(j1[k] - j0[k]).flatten() for k in params])
    assert float((got - want).norm() / want.norm()) <= 1e-4
    for k in keys:
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(j1[k], j0[k]), k
            np.testing.assert_allclose(p1[k].numpy(), j1[k].numpy(), atol=1e-6, rtol=0)
    for k in j0:
        if not k.startswith("policy.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(p1[k], j0[k]) and torch.equal(j1[k], j0[k]), k
