"""The port's own phase spans (adafocus_torch/utils/profiling.py ``span``,
``recording``) on the CPU, the port against itself on its own seeded
weights at tiny sizes:

- the recorder's arithmetic on nested spans: parents, the unit id an
  outermost span gives the spans under it, host and device self times
  (the device's from stand-in CUDA events);
- off (no profiler, no recorder) a span is one shared null context that
  makes no profiler or CUDA call;
- ``inference`` (both backbone paths), ``inference_with_actions``,
  ``inference_sthsth`` (both paths), ``inference_q8`` (with and without
  int8 heads) and the stage-1 step give exactly their span trees, with
  outputs bit-identical with recording on and off, and the step's
  ``mark(phase)`` calls as before;
- under a CPU ``torch.profiler`` capture the spans are ``adafocus.*``
  ``user_annotation`` events of its trace.
"""

import json

import pytest
import torch

from adafocus_torch.models import gfv as tgfv
from adafocus_torch.models import gfv_sthsth as tsth
from adafocus_torch.models import quant_inference as qi
from adafocus_torch.ops.quant import quantize_frames
from adafocus_torch.train.stages import create_train_state, make_stage_train_step
from adafocus_torch.utils import profiling as tprof
from tests.test_torch_port_data import one_torch_thread  # noqa: F401 (an autouse fixture)

CPU = "cpu"
SERVE_TREE = [("serve", None), ("glance", "serve"), ("policy", "serve"), ("focus", "serve"),
              ("classify", "serve")]
TRAIN_TREE = [("train_step", None), ("optimizer", "train_step")]
STH = tgfv.GFVConfig(
    num_classes=5, num_frames=4, num_frames_focuser=6, image_size=24, glance_size=16,
    patch_size=16, action_dim=4, hidden_dim=16, policy_hidden=16, classifier="consensus",
    tsm=True, video_div=2, continuous_policy=True, policy_bn=True, policy_channels=64,
    dtype=torch.float32)


def _frames(cfg, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    s, gs = cfg.image_size, cfg.glance_size
    return (torch.randn(b, cfg.t_focuser, s, s, 3, generator=g),
            torch.randn(b, cfg.num_frames, gs, gs, 3, generator=g))


def tree(rec):
    """(name, parent's name) of each recorded span, in the order opened."""
    return [(s.name, None if s.parent is None else rec.spans[s.parent].name)
            for s in rec.spans]


def recorded(fn):
    """``fn()`` with recording off, then on: (both results, the recorder)."""
    off = fn()
    with tprof.recording() as rec:
        on = fn()
    return off, on, rec


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class _Event:
    """Stands in for a timing CUDA event: reads the fake device clock."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = _Event.clock[0]

    def elapsed_time(self, other):
        return other.t - self.t


def test_recorder_arithmetic_on_nested_spans(monkeypatch):
    host = iter(range(0, 10**9, 10**6))            # the host's clock: 1 ms a reading
    monkeypatch.setattr(tprof.time, "perf_counter_ns", lambda: next(host))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    span = tprof.span

    def device(ms):
        _Event.clock[0] += ms

    with tprof.recording() as rec:
        rec._cuda = True
        for _ in range(2):
            with span("serve"):              # host 0 .. 7 ms
                device(1.0)
                with span("glance"):         # host 1 .. 4
                    device(4.0)
                    with span("inner"):      # host 2 .. 3
                        device(2.0)
                with span("policy"):         # host 5 .. 6
                    device(0.5)
            device(100.0)                    # outside every span
    assert tree(rec)[:4] == [("serve", None), ("glance", "serve"), ("inner", "glance"),
                             ("policy", "serve")]
    assert [s.unit for s in rec.spans] == [0, 0, 0, 0, 4, 4, 4, 4]
    got = rec.summary()
    assert got["serve"] == {"count": 2, "host_ms": 14.0, "host_self_ms": 14.0 - 2 * (3 + 1),
                            "device_ms": 15.0, "device_self_ms": 2 * 1.0}
    assert got["glance"] == {"count": 2, "host_ms": 6.0, "host_self_ms": 4.0,
                             "device_ms": 12.0, "device_self_ms": 8.0}
    assert got["inner"]["host_self_ms"] == got["inner"]["host_ms"] == 2.0
    assert got["policy"]["device_ms"] == got["policy"]["device_self_ms"] == 1.0


def test_recorder_on_the_cpu_reads_no_device_and_skips_open_spans():
    with tprof.recording() as rec:
        with tprof.span("outer"):
            with tprof.span("done"):
                pass
            got = rec.summary()
        with pytest.raises(RuntimeError):
            with tprof.recording():
                pass
    assert set(got) == {"done"}
    assert got["done"]["count"] == 1 and got["done"]["device_ms"] is None
    assert got["done"]["device_self_ms"] is None and got["done"]["host_ms"] >= 0
    assert set(rec.summary()) == {"outer", "done"}
    assert all(s.start is None and s.end is None for s in rec.spans)


def test_spans_off_make_no_profiler_or_cuda_call(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    assert tprof.span("serve") is tprof.span("glance")
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device=CPU)
    assert tgfv.inference(model, *_frames(cfg), device=CPU).shape == (2, 2, 10)
    state = create_train_state(cfg, 1, device=CPU)
    step = make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
    step(_batch(cfg), torch.Generator().manual_seed(1))


# ---------------------------------------------------------------------------
# the entries' span trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_inference_span_tree(fused):
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device=CPU)
    frames, small = _frames(cfg)
    off, on, rec = recorded(lambda: tgfv.inference(model, frames, small, CPU, fused))
    assert torch.equal(off, on)
    assert tree(rec) == SERVE_TREE
    assert {s.unit for s in rec.spans} == {0}
    actions = torch.rand(2, cfg.num_frames, 2, generator=torch.Generator().manual_seed(3))
    off, on, rec = recorded(lambda: tgfv.inference_with_actions(model, frames, small, actions,
                                                                CPU))
    assert torch.equal(off, on)
    assert tree(rec) == [("serve", None), ("glance", "serve"), ("focus", "serve"),
                         ("classify", "serve")]


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_inference_sthsth_span_tree(fused):
    model = tgfv.GFV(STH, device=CPU)
    frames, small = _frames(STH)
    off, on, rec = recorded(lambda: tsth.inference_sthsth(model, frames, small, CPU, fused))
    assert torch.equal(off, on)
    assert tree(rec) == SERVE_TREE
    # two requests: a unit each
    with tprof.recording() as rec:
        for _ in range(2):
            tsth.inference_sthsth(model, frames, small, CPU, fused)
    assert [s.unit for s in rec.spans] == [0] * 5 + [5] * 5
    assert rec.summary()["policy"]["count"] == 2


@pytest.mark.parametrize("heads", [False, True])
def test_inference_q8_span_tree(heads):
    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device=CPU)
    frames, small = _frames(cfg)
    scales = qi.calibrate_gfv(model, [qi.calibration_batch(model, frames, small)], heads=heads)
    qw = qi.prepare_q8(model, scales)
    qf, qs = quantize_frames(frames), quantize_frames(small)
    off, on, rec = recorded(lambda: qi.inference_q8(model, scales, qf, qs, device=CPU, qw=qw))
    assert torch.equal(off, on)
    assert tree(rec) == SERVE_TREE


def _batch(cfg, seed=2):
    frames, small = _frames(cfg, 2, seed)
    return {"frames": frames, "frames_small": small, "labels": torch.tensor([1, 7])}


def test_stage1_step_span_tree():
    cfg = tgfv.flagship(tiny=True)
    batch = _batch(cfg)
    actions = torch.rand(2, cfg.num_frames, 2, generator=torch.Generator().manual_seed(4))
    states = [create_train_state(cfg, 1, device=CPU, generator=torch.Generator().manual_seed(5))
              for _ in range(2)]
    marks = [[], []]
    outs = []
    for i, state in enumerate(states):
        step = make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
        run = lambda: step(batch, torch.Generator().manual_seed(6), actions=actions,  # noqa: E731
                           mark=marks[i].append)
        if i == 0:
            outs.append(run())
        else:
            with tprof.recording() as rec:
                outs.append(run())
    assert tree(rec) == TRAIN_TREE
    assert marks[0] == marks[1] == ["glance", "extract", "focus", "classify", "backward",
                                    "optimizer"]
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    after = [s.model.state_dict() for s in states]
    assert all(torch.equal(after[0][k], after[1][k]) for k in after[0])


def test_spans_are_annotations_of_a_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg = tgfv.flagship(tiny=True)
    model = tgfv.GFV(cfg, device=CPU)
    frames, small = _frames(cfg)
    state = create_train_state(cfg, 1, device=CPU)
    step = make_stage_train_step(state.model, 1, state.optimizer, state.scheduler)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        want = tgfv.inference(model, frames, small, CPU)
        step(_batch(cfg), torch.Generator().manual_seed(1))
    assert torch.equal(want, tgfv.inference(model, frames, small, CPU))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        found = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    assert {tprof.SPAN_PREFIX + n for n, _ in SERVE_TREE + TRAIN_TREE} <= found
