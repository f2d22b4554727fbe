"""``correct`` comes out false when the timed path is broken underneath, and
for each cell's control; true for a sound run. Each case drives a whole
run past the look for a card (``run.measure`` on the CPU) at a tiny size of
the cell's configuration, against the cell's own limits: the served
answers (a logit, an action) altered where they are produced, half of a
batch left out of the focuser or of the loss, a training step that leaves
the state unchanged, a stage 1 that leaves the classifier untrained. The
controls (``readings.py``): the program's int8 serving path for the serving
cells, the reference in fp8 for training."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from perfbench import common, judge, readings, run  # noqa: E402
from test_perfbench_reference import few_threads, tiny_cell  # noqa: E402, F401

CPU = torch.device("cpu")
SERVE = ["actnet-serve-b64", "sthsth-serve-b64", "actnet-serve-int8-b64"]
TRAIN = "actnet-train-s1-b64"


def measure(monkeypatch, name, dtype="float32"):
    monkeypatch.setattr(common, "cell", lambda n, bench=None: tiny_cell(n, dtype))
    return run.measure(name, 2**31 + 77, 0.5, False, CPU)


def _serve_faults():
    from adafocus_torch.models import gfv, gfv_sthsth, policy, quant_inference

    def altered_logit(mp):
        for module in (gfv, quant_inference):
            mp.setattr(module, "fuse_and_classify", _plus_one(gfv.fuse_and_classify))
        mp.setattr(gfv_sthsth, "sum_consensus", _plus_one(gfv_sthsth.sum_consensus))

    def altered_action(mp):
        mp.setattr(gfv, "sample_rollout", readings.moved_rollout(policy.sample_rollout))

    def half_batch(mp):
        # the first half of the videos' patches, whole clips, stand for all
        def half(focus, first):
            def run(*a, **k):
                a = list(a)
                patches, cfg = a[first], a[0].cfg
                clip = cfg.t_focuser if cfg.tsm else 1
                n = patches.shape[0] // clip // 2 * clip
                if n == 0:
                    return focus(*a, **k)
                a[first] = patches[:n]
                out = focus(*a, **k)
                return out.repeat(-(-patches.shape[0] // n), 1)[: patches.shape[0]]
            return run
        mp.setattr(gfv.GFV, "focus", half(gfv.GFV.focus, 1))
        mp.setattr(quant_inference, "q8_focus", half(quant_inference.q8_focus, 2))

    return {"altered_logit": altered_logit, "altered_action": altered_action,
            "half_batch": half_batch}


def _plus_one(fn):
    def altered(*a, **k):
        out = fn(*a, **k)
        flat = out.reshape(-1).clone()
        flat[0] += 1.0 + flat.abs().max()
        return flat.reshape(out.shape)
    return altered


@pytest.mark.parametrize("name", SERVE)
def test_sound_serving_run_is_correct(monkeypatch, name):
    result = measure(monkeypatch, name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["altered_logit", "altered_action", "half_batch"])
@pytest.mark.parametrize("name", SERVE)
def test_broken_serving_run_is_not_correct(monkeypatch, name, fault):
    _serve_faults()[fault](monkeypatch)
    result = measure(monkeypatch, name)
    assert not result["correct"], result["checks"]


def test_sound_training_run_is_correct(monkeypatch):
    result = measure(monkeypatch, TRAIN, "float64")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "classifier_frozen"])
def test_broken_training_run_is_not_correct(monkeypatch, fault):
    from adafocus_torch.train import stages

    if fault == "state_unchanged":
        monkeypatch.setattr(stages, "_sgd_step", lambda *a, **k: None)
        result = measure(monkeypatch, TRAIN, "float64")
    else:
        with readings.planted(fault):
            result = measure(monkeypatch, TRAIN, "float64")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_serving_control_is_not_correct(name):
    cell = tiny_cell(name)
    rows = dict(readings.serve_readings(cell, 2**31 + 5, True, CPU))
    assert judge.passed(judge.checks(name, rows["program"]))
    assert not judge.passed(judge.checks(name, rows["control"])), rows["control"]


def test_training_control_is_not_correct():
    cell = tiny_cell(TRAIN)
    (side, values), = readings.train_readings(cell, 2**31 + 5, True, "", CPU)
    assert side == "control"
    assert not judge.passed(judge.checks(TRAIN, values)), values
