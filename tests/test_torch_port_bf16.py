"""bf16 training against float32 in each package, on the CPU.

One stage-1 step at TRAIN_CFG in bf16 compute over float32 parameters and
one in float32, in the JAX package and in the port, from the same bridged
weights, batch and random-patch actions. Each package's focuser and
classifier gradients in bf16 are held against its own float32 ones (cosine
and norm ratio). At random initialisation the train-mode BatchNorm backward
decorrelates a bf16 focuser gradient from the float32 one; the test shows
whether the port does so more than JAX does: each of the port's cosines may
be lower than JAX's by at most 0.1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.ops.patch import random_patch_actions
from adafocus_tpu.train.stages import TrainState, make_stage_train_step
from tests.torch_port_common import (
    TRAIN_B, TRAIN_CFG, abstract_variables, port_config, state_dict_from_jax, train_batch,
)

SEED = 5
COMPONENTS = ("focuser", "classifier")
MAX_COS_DEFICIT = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gradient_tx():
    """An optax transformation whose update is zero and whose state is the
    last gradients: the JAX step then returns its gradients."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree.map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _flat(leaves):
    return torch.cat([torch.as_tensor(np.asarray(g, np.float64)).flatten() for g in leaves])


@pytest.fixture(scope="module")
def gradients():
    """{package: {dtype: {component: flat float64 gradient}}} of one
    stage-1 step."""
    _, variables = abstract_variables(TRAIN_CFG, seed=SEED)
    jbatch, tbatch = train_batch(TRAIN_CFG, TRAIN_B, SEED + 1)
    rng = jax.random.key(SEED)
    a_key, _ = jax.random.split(rng)
    actions = torch.from_numpy(np.array(random_patch_actions(
        a_key, (TRAIN_B, TRAIN_CFG.num_frames))))
    out = {"jax": {}, "port": {}}
    for name, jdtype, tdtype in (("float32", jnp.float32, torch.float32),
                                 ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        jmodel = GFV(dataclasses.replace(TRAIN_CFG, dtype=jdtype))
        tx = _gradient_tx()
        state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))
        state, _ = jax.jit(make_stage_train_step(jmodel, 1, tx))(state, jbatch, rng)
        out["jax"][name] = {c: _flat(jax.tree.leaves(state.opt_state[c])) for c in COMPONENTS}

        model = tgfv.GFV(dataclasses.replace(port_config(TRAIN_CFG), dtype=tdtype),
                         device="cpu", param_dtype=torch.float32)
        model.load_state_dict(state_dict_from_jax(variables))
        opt, sched = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig())
        tstages.make_stage_train_step(model, 1, opt, sched)(tbatch, None, actions)
        out["port"][name] = {c: _flat(p.grad for p in getattr(model, c).parameters())
                             for c in COMPONENTS}
    return out


def _against_float32(grads):
    g16, g32 = grads["bfloat16"], grads["float32"]
    return {c: (float(torch.nn.functional.cosine_similarity(g16[c], g32[c], dim=0)),
                float(g16[c].norm() / g32[c].norm())) for c in COMPONENTS}


@pytest.mark.parametrize("component", COMPONENTS)
def test_bf16_gradient_direction_no_worse_than_jax(gradients, component):
    port, ref = _against_float32(gradients["port"]), _against_float32(gradients["jax"])
    print(f"\n{component}: bf16 vs float32 gradient (cosine, norm ratio): port "
          f"{port[component]}, JAX {ref[component]}")
    assert port[component][0] >= ref[component][0] - MAX_COS_DEFICIT
    assert np.isfinite(port[component][1])
