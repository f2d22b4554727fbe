"""The dtypes of the bf16 stage-0 train step, the port's against the JAX
package's, on the CPU.

Both packages train float32 parameters and compute in bfloat16, by two
means: the JAX package casts module by module (``dtype=cfg.dtype``), the
port runs the step under ``torch.autocast`` (``GFV.autocast``). A place
where one computes in float32 and the other in bfloat16 would change the
rounding of every step, which no float32 or float64 parity test sees. So
this test holds, point by point, the dtype of what the stage-0 step computes
(``tests/torch_port_dtypes.py``: every conv-BatchNorm unit and block of both
backbones, the glance map and pooled features, the
patches and focuser features, the fused input, every GRU hidden state, the
three heads' logits and log-probabilities, the three losses) and the dtype
of every parameter's gradient, equal to JAX's.

Dtypes, not values: torch's CPU bf16 conv weight gradient is wrong at a
stride-2 conv on a 1x1 map (ROADMAP, "Not the port's"). JAX's side is traced
with ``jax.eval_shape`` (nothing is compiled or run) from weights of its
``create_train_state``'s structure (``abstract_variables``), its points read by
``flax.linen.intercept_methods`` and by wrapping ``extract_for_frames``,
``_ce_per_step`` and ``jax.nn.log_softmax``. The configuration is the train
tests' TRAIN_CFG (``tests/torch_port_common.py``) at batch 4.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.weights import gfv_state_dict_from_flax
from adafocus_tpu.models.gfv import GFV
from adafocus_tpu.train import stages as jstages
from adafocus_tpu.train.stages import TrainState, make_stage_train_step
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.torch_port_common import (
    TRAIN_B, TRAIN_CFG, abstract_variables, port_config, state_dict_from_jax, train_batch,
)
from tests.torch_port_dtypes import DtypeLog, dtype_name, grad_dtypes, stage0_dtypes

SEED = 7
TRAINED = ("glancer", "focuser", "classifier")   # stage 0's trained components


def _gradient_tx():
    """An optax transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree.map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_dtypes(variables, jbatch):
    """JAX's stage-0 step in bfloat16 over float32 parameters, traced: (the
    dtype map, {port parameter name: its gradient's dtype})."""
    model = GFV(dataclasses.replace(TRAIN_CFG, dtype=jnp.bfloat16))
    tx = _gradient_tx()
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(params=params, batch_stats=variables["batch_stats"],
                       opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    log, losses = DtypeLog(), []

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        kind, method = type(context.module).__name__, context.method_name
        if method == "__call__" and kind in ("ConvBNAct", "InvertedResidual", "Bottleneck"):
            backbone = context.module.path[0]
            log.add(f"{backbone}.{'units' if kind == 'ConvBNAct' else 'blocks'}", out)
        elif kind == "GFV" and method == "glance":
            log.add("glance.fmap", out[0])
            log.add("glance.pooled", out[1])
        elif kind == "GFV" and method == "focus":
            log.add("focus.local", out)
        elif kind == "GFV" and method == "classify_seq":
            log.add("fused", args[0])
        elif kind == "RecurrentClassifier" and method == "initial_hidden":
            log.add("gru.h0", out)
        elif kind == "GRUCell" and method == "step_from_proj":
            log.add("gru.hidden", out)
        return out

    extract, ce, log_softmax = jstages.extract_for_frames, jstages._ce_per_step, jax.nn.log_softmax

    def extract_logged(*args, **kwargs):
        out = extract(*args, **kwargs)
        log.add("patches", out)
        return out

    def ce_logged(logits, labels):
        log.add(("logits", "glance_logits", "focus_logits")[len(losses)], logits)
        out = ce(logits, labels)
        losses.append(dtype_name(out.dtype))
        return out

    def log_softmax_logged(*args, **kwargs):
        out = log_softmax(*args, **kwargs)
        log.add("log_softmax", out)
        return out

    with pytest.MonkeyPatch.context() as mp, fnn.intercept_methods(intercept):
        mp.setattr(jstages, "extract_for_frames", extract_logged)
        mp.setattr(jstages, "_ce_per_step", ce_logged)
        mp.setattr(jax.nn, "log_softmax", log_softmax_logged)
        new_state, _ = jax.eval_shape(make_stage_train_step(model, 0, tx), state, jbatch,
                                      jax.random.key(SEED))
    points = log.as_dict()
    points["loss"] = losses
    # each gradient leaf filled with its dtype's width crosses the weight
    # bridge, which moves and transposes values but keeps them
    codes = jax.tree.map(lambda s: np.full(s.shape, np.dtype(s.dtype).itemsize * 8, np.int64),
                         new_state.opt_state)
    sd = gfv_state_dict_from_flax(codes, {}, dtype=torch.int64)
    widths = {16: "bfloat16", 32: "float32", 64: "float64"}
    grads = {}
    for name, value in sd.items():
        if name.split(".")[0] in TRAINED and not name.endswith("num_batches_tracked"):
            (width,) = set(value.flatten().tolist())
            grads[name] = widths[width]
    return points, grads


@pytest.fixture(scope="module")
def dtype_maps():
    """{package: (dtype map, gradient dtypes)} of one bf16 stage-0 step from
    the same weights and batch."""
    _, variables = abstract_variables(TRAIN_CFG, seed=SEED)
    jbatch, tbatch = train_batch(TRAIN_CFG, TRAIN_B, SEED + 1)
    # both CLIs' batch prep hands the step its frames in the compute dtype
    jbatch = {k: v.astype(jnp.bfloat16) if k != "labels" else v for k, v in jbatch.items()}
    tbatch = {k: v.to(torch.bfloat16) if k != "labels" else v for k, v in tbatch.items()}
    out = {"jax": _jax_dtypes(variables, jbatch)}
    model = tgfv.GFV(dataclasses.replace(port_config(TRAIN_CFG), dtype=torch.bfloat16),
                     device="cpu", param_dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables))
    keep = torch.from_numpy(np.random.RandomState(SEED).uniform(
        0, 1, (TRAIN_B * TRAIN_CFG.num_frames, TRAIN_CFG.glance_dim)) < 0.8)
    points = stage0_dtypes(model, tbatch, keep, SEED)
    out["port"] = (points, grad_dtypes(model))
    return out


POINTS = ("glancer.units", "glancer.blocks", "focuser.units", "focuser.blocks", "glance.fmap", "glance.pooled", "patches", "focus.local", "fused", "gru.h0",
          "gru.hidden", "logits", "glance_logits", "focus_logits", "log_softmax", "loss")


@pytest.mark.parametrize("point", POINTS)
def test_bf16_step_dtype_matches_jax(dtype_maps, point):
    want, got = dtype_maps["jax"][0], dtype_maps["port"][0]
    assert point in want, f"JAX's step never reached {point}"
    assert got.get(point) == want[point], (point, got.get(point), want[point])


def test_bf16_step_computes_in_bfloat16(dtype_maps):
    """What the map says: the two backbones, the fused input, the GRU and the
    heads compute in bfloat16; the log-probabilities and losses are float32."""
    want = dtype_maps["jax"][0]
    for point in POINTS[:-2]:
        assert want[point] == ["bfloat16"], (point, want[point])
    assert want["log_softmax"] == ["float32"]
    assert want["loss"] == ["float32"] * 3


def test_bf16_step_gradient_dtypes_match_jax(dtype_maps):
    """Every trained parameter gets a gradient, in JAX's dtype (float32: the
    parameters' own)."""
    want, got = dtype_maps["jax"][1], dtype_maps["port"][1]
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}
    assert set(want.values()) == {"float32"}

