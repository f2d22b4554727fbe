"""The plain reference against the program at tiny sizes on the CPU, as a
test of the reference (on the card the reference judges the program, not
the other way round): the same tensors by name and shape, the same served
forward of both families, the same first stage-1 step in float64; and the
control's fp8 rounding."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from perfbench import common, inputs, judge, port, serve, train  # noqa: E402
from perfbench.reference import nets, precision  # noqa: E402

CPU = torch.device("cpu")
# small widths of the same structure; a 64^2 glance gives a 2x2 map, so
# the policy's flatten order is tested
TINY = dict(num_classes=10, num_frames=2, num_frames_focuser=0, image_size=24, glance_size=64,
            patch_size=16, action_dim=4, hidden_dim=16, policy_hidden=16, dtype="float32")
TINY_STHSTH = dict(TINY, num_frames=4, num_frames_focuser=6, video_div=2)
# the int8 path's per-tensor scales over the tiniest maps read several
# times its full-size error; at these sizes it reads 0.024-0.027
# (logit_err), under the cell's limits, and its int4 control 0.61-0.69
TINY_INT8 = dict(TINY, image_size=96, patch_size=48, glance_size=96, hidden_dim=128,
                 policy_hidden=128, num_classes=50, num_frames=4)


def tiny_cell(name: str, dtype: str = "float32", load=common.cell) -> dict:
    cell = load(name)
    cfg = cell["config"]
    tiny = TINY_INT8 if cell["traffic"].get("mode") == "int8" else \
        TINY_STHSTH if cfg["family"] == "gfv_sthsth" else TINY
    cfg.update(tiny, dtype=dtype)
    cell["traffic"].update(batch=3, pool=4, warmup=1, check_requests=3, readings_requests=4)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("config", ["actnet-flagship", "sthsth-matched-144"])
def test_specs_are_the_programs_tensors(config):
    from adafocus_torch.models.gfv import GFV

    cfg = common.load_json(os.path.join(common.HERE, "configs", config + ".json"))
    with torch.device("meta"):
        model = GFV(port.gfv_config(cfg), device="meta")
    theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ours = {name: tuple(shape) for name, shape, _ in nets.param_specs(cfg)}
    assert ours == theirs


@pytest.mark.parametrize("name", ["actnet-serve-b64", "sthsth-serve-b64"])
def test_serve_reference_matches_the_program(name):
    cell = tiny_cell(name)
    cfg = cell["config"]
    weights = inputs.weights(cfg, 7, CPU, torch.float32)
    server = serve.Server(cell, weights, CPU, False, 7)
    pool = inputs.input_pool(cfg, 3, 2, 7, CPU, torch.float32)
    loop = serve.closed_loop(server, pool, 2, requests=2)
    for i in range(2):
        got = judge.serve_request(cfg, weights, pool[i], loop["outputs"][i], server.actions[i])
        assert got["logit_err"] < 1e-5
        assert got.get("anchor_gap", 0.0) == 0.0 and got.get("action_err", 0.0) < 1e-6


def test_stage1_reference_matches_the_program_in_float64():
    cell = tiny_cell("actnet-train-s1-b64", "float64")
    cfg, traffic = cell["config"], cell["traffic"]
    weights = inputs.weights(cfg, 11, CPU, torch.float64)
    pool = train.batches(cfg, traffic, 11, CPU)
    model, optimizer, step = train.build(cell, weights, CPU)
    names = {id(p): k for k, p in model.named_parameters()}
    loss = float(step(pool[0], torch.Generator(), actions=pool[0]["actions"])["loss"])
    buf = {names[id(p)]: s["momentum_buffer"] for p, s in optimizer.state.items()}
    ref = judge.reference(cfg).stage1_steps(weights, cfg, traffic["optim"], pool[:1])
    # the program takes the loss's log-softmax in float32
    assert loss == pytest.approx(float(ref["losses"][0]), rel=1e-6)
    assert set(buf) == set(ref["first_buf"]), set(buf) ^ set(ref["first_buf"])
    for k, b in buf.items():
        r = ref["first_buf"][k]
        assert float((b - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-12), k
    after = model.state_dict()
    for k, w in ref["weights"].items():
        assert float((after[k].double() - w.double()).abs().max()) <= \
            1e-5 * max(float(w.double().abs().max()), 1.0), k


def test_fp8_rounds_below_bfloat16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    x.requires_grad_(True)
    y = precision.fp8(x)
    rel = float(((y.detach() - x.detach()).abs() / x.detach().abs().clamp_min(1e-3)).median())
    x0 = x.detach()
    bf16 = float(((x0.bfloat16().double() - x0).abs() / x0.abs().clamp_min(1e-3)).median())
    assert 4 * bf16 < rel < 0.07
    y.backward(x.detach())
    assert float((x.grad - x.detach()).abs().max()) > 0          # e5m2 on the way back
    assert torch.equal(precision.fp8(y.detach()), y.detach())     # idempotent
