"""Port parity for the sth-sth family's train steps in float64 on the CPU:
stage 1 with the TSN optimizer groups and partial BatchNorm on and off,
one step from the same weights and batch as the JAX package's step. Stage 3
(tests/test_torch_port_sthsth_stage3.py) and stage 2
(tests/test_torch_port_sthsth_ppo.py) use this module's set-up; each is a
file of its own so that no file of the suite takes much over two minutes
on one process.

The configuration, weights and inputs are those of
tests/test_torch_port_sthsth_train.py, in float64 (as
tests/test_torch_port_train.py compares the ActivityNet steps: in float32
the two packages' train-mode BatchNorm backwards part by more than
rounding). JAX's draws are injected into the port: stage 1's random actions
from the step's key; the dropout mask is drawn with numpy and injected into
both.

JAX's supervised step is run once for each (stage, partial_bn) with an
optimizer that keeps the gradient as its state and updates nothing; each
optimizer of the case (TSN groups on or off) is then applied to that
gradient, ``tx.update`` and ``optax.apply_updates`` as the step applies
them. So four compiles of the step serve eight cases.

Tolerances (tests/test_torch_port_train.py's): each tensor's update within
1e-5 of its largest, running statistics 1e-9 relative, a tensor JAX leaves
unchanged bit-identical (the frozen glancer and policy, partial BatchNorm's
block affines and statistics); loss rtol 1e-6, top-1/top-5 equal.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.train import stages_sthsth as tss
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.train import optim as joptim
from adafocus_tpu.train import stages_sthsth as jss
from adafocus_tpu.train.stages import TrainState
from tests.test_torch_port_sthsth import STH
from tests.test_torch_port_sthsth_train import B, OPT, SEED, _batch, _keep, _rel_update
from tests.test_torch_port_train import _dropout_interceptor
from tests.test_torch_port_train import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import abstract_variables, port_model64, snapshot, state_dict_from_jax

# an optimizer that updates nothing and keeps the gradient as its state
_CAPTURE = optax.GradientTransformation(
    lambda params: jax.tree.map(jnp.zeros_like, params),
    lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def setup64():
    """STH in float64: JAX's variables (BatchNorm random) and a batch."""
    with jax.enable_x64(True):
        cfg = dataclasses.replace(STH, dtype=jnp.float64)
        _, variables = abstract_variables(cfg, seed=SEED)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        jbatch, tbatch = _batch(cfg, B, SEED + 7, np.float64)
    return cfg, variables, jbatch, tbatch


def jax_gradient_of(stage, partial_bn, setup):
    """JAX's step of (stage, partial_bn) on ``setup`` (``setup64``): its
    gradient (the optimizer's state), new running statistics and metrics,
    the random actions of its key and the dropout mask."""
    cfg, variables, jbatch, _ = setup
    cfg = dataclasses.replace(cfg, partial_bn=partial_bn)
    keep = _keep(cfg, B, SEED + 8)
    rng = jax.random.key(300 + stage)
    with jax.enable_x64(True):
        jstep = jss.make_sthsth_train_step(GFV(cfg), stage, _CAPTURE)

        @jax.jit
        def jax_step(state, batch, rng, keep):
            with fnn.intercept_methods(_dropout_interceptor(keep)):
                return jstep(state, batch, rng)

        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=_CAPTURE.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        new, metrics = jax_step(state, jbatch, rng, jnp.asarray(keep))
        a_key = jax.random.split(rng)[0]
        actions = np.array(random_patch_actions(jax.random.split(a_key)[0], (B, cfg.t_focuser)))
    return stage, cfg, new, metrics, actions, keep


@pytest.fixture(scope="module", params=[False, True], ids=["stage1", "stage1-pbn"])
def jax_gradient(request, setup64):
    return jax_gradient_of(1, request.param, setup64)


@pytest.mark.parametrize("tsn", [False, True], ids=["sgd", "tsn"])
def test_sthsth_stage1_step_matches_jax(jax_gradient, setup64, tsn):
    """One float64 stage-1 step (partial BatchNorm on or off) under the flat
    SGD groups or the TSN groups; see the module's tolerances."""
    check_train_step(jax_gradient, setup64, tsn)


def check_train_step(jax_gradient, setup64, tsn):
    """The port's step against JAX's gradient under the optimizer of
    ``tsn``, to the module's tolerances."""
    stage, cfg, new, want_m, actions, keep = jax_gradient
    _, variables, _, tbatch = setup64
    partial_bn = cfg.partial_bn
    with jax.enable_x64(True):
        # the sth-sth recipe's optimizer: stage 1's freeze matrix for stage 3
        tx = joptim.make_stage_optimizer(1, joptim.OptimConfig(tsn_policies=tsn, **OPT),
                                         partial_bn=partial_bn)
        params = variables["params"]
        updates, _ = tx.update(new.opt_state, tx.init(params), params)
        params = optax.apply_updates(params, updates)
        j1 = state_dict_from_jax({"params": params, "batch_stats": new.batch_stats},
                                 torch.float64)
    j0 = state_dict_from_jax(variables, torch.float64)
    model = port_model64(cfg, variables)
    opt, sched = toptim.make_stage_optimizer(
        model, tstages.optimizer_stage(model.cfg, stage),
        toptim.OptimConfig(tsn_policies=tsn, **OPT), partial_bn=partial_bn)
    step = tss.make_sthsth_train_step(model, stage, opt, sched)
    # stage 3 takes the port's own greedy actions
    got_m = step(tbatch, None, torch.from_numpy(actions) if stage == 1 else None,
                 torch.from_numpy(keep))
    p1 = snapshot(model)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-6)
    assert (float(got_m["top1"]), float(got_m["top5"])) == \
        (float(want_m["top1"]), float(want_m["top5"]))
    moved = set()
    for key in j0:
        if key.endswith("num_batches_tracked"):
            continue
        if torch.equal(j1[key], j0[key]):
            assert torch.equal(p1[key], j0[key]), f"{key} moved; JAX leaves it"
            continue
        moved.add(key)
        if key.endswith(("running_mean", "running_var")):
            assert float((p1[key] - j1[key]).norm() / j1[key].norm()) <= 1e-9, key
        else:
            assert _rel_update(p1[key], j0[key], j1[key], j0[key]) <= 1e-5, key
    assert {k.split(".")[0] for k in moved} == {"focuser", "classifier"}
    block_bn = {k for k in moved if k.startswith("focuser.layer") and ".bn." in k}
    assert bool(block_bn) != partial_bn
    assert any(k.startswith("focuser.stem.bn.") for k in moved)
