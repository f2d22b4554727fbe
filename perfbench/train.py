"""Training traffic: the program's stage-1 step, driven back to back.

Set-up builds one step (model, optimizer and schedule) from the seed's
weights and drives it through its first ``reference_steps`` steps on
distinct pool batches, each with its own labels and patch actions drawn
from the seed; those steps are the warm-up, and the same object then
trains through the window over the cycled pool, at most ``in_flight``
steps enqueued ahead of the device. ``train_videos_per_s`` is the videos of
every step of the window over the window, which ends when the device has
finished the last.

The reference (``reference/<family>.py stage1_steps``) follows the first
steps from the same weights, batches and actions, in float32 with TF32
off, once the window has closed. Compared (``judgement``):

- ``loss_err``: the widest relative gap of a step's loss;
- ``grad_gap``: over the trained tensors, the widest gap between the
  program's and the reference's norm of the first gradient as the
  optimizer holds it after one step (its momentum buffer: the gradient plus
  the weight decay), over the larger of the reference's norm of that tensor
  and of the median tensor;
- ``change_gap``: the same of each trained tensor's change over the steps;
- ``part_grad_gap``, ``part_change_gap``: the same gaps taken within each
  trained component (the focuser, the classifier), each tensor's over the
  larger of its norm and the component's median tensor's; the largest,
  over the components, of the component's median gap. A component that
  trains wrong shows however few of the tensors are its own;
- ``stats_gap``: the same of each running statistic's change;
- ``frozen_change``: the largest change of a tensor the stage freezes.

Tensors whose first raw gradient in the reference is under a thousandth of
the median tensor's (the focuser's unused classifier, which moves by weight
decay alone) are left out of the gradient and change gaps.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from perfbench import inputs, judge, port
from perfbench.reference.precision import QUANTIZERS

PHASES = ("glance", "extract", "focus", "classify", "backward", "optimizer")
RANGES = ("step",) + PHASES
# a tensor whose reference gradient is under this share of the median's is
# not compared: it moves by weight decay and round-off alone
RESOLVED = 1e-3


class _Marks:
    """The step's ``mark(phase)`` as ``record_function`` ranges, each phase
    from the previous mark to its own."""

    def __init__(self):
        self.open = None

    def start(self):
        self._enter(PHASES[0])

    def _enter(self, name):
        self.open = (name, torch.profiler.record_function(name))
        self.open[1].__enter__()

    def __call__(self, phase: str):
        name, ctx = self.open
        ctx.__exit__(None, None, None)
        nxt = PHASES.index(phase) + 1
        self.open = None
        if nxt < len(PHASES):
            self._enter(PHASES[nxt])


def _event(device):
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return None


def build(cell: dict, weights, device):
    """The program's stage-1 step over a float32-parameter model of the
    configuration: ``(model, optimizer, step)``."""
    from adafocus_torch.train.optim import OptimConfig, make_stage_optimizer

    cfg, traffic = cell["config"], cell["traffic"]
    model = port.model(cfg, weights, device,
                       param_dtype=torch.promote_types(port.DTYPES[cfg["dtype"]], torch.float32))
    optimizer, scheduler = make_stage_optimizer(model, traffic["stage"],
                                                OptimConfig(**traffic["optim"]))
    step = port.entry(cfg["train_entry"])(model, traffic["stage"], optimizer, scheduler)
    return model, optimizer, step


def batches(cfg: dict, traffic: dict, seed: int, device) -> List[dict]:
    dtype = port.DTYPES[cfg["dtype"]]
    b, pool = traffic["batch"], traffic["pool"]
    out = inputs.input_pool(cfg, b, pool, seed, device, dtype)
    labels = inputs.labels(cfg, b * pool, seed, device).split(b)
    actions = inputs.uniform_actions((pool, b, cfg["num_frames"]), seed, device)
    for item, lab, act in zip(out, labels, actions):
        item.update(labels=lab, actions=act)
    return out


def first_steps(model, optimizer, one, count: int) -> dict:
    """Steps ``one(0)`` ... ``one(count - 1)``: each step's loss, every
    momentum buffer after the first (the first gradient as the optimizer
    holds it), and the model's state after the last."""
    names = {id(p): k for k, p in model.named_parameters()}
    losses = []
    for i in range(count):
        losses.append(one(i)["loss"].detach().clone())
        if i == 0:
            first_buf = {names[id(p)]: s["momentum_buffer"].clone()
                         for p, s in optimizer.state.items()}
    return {"losses": [float(x) for x in losses], "first_buf": first_buf,
            "after": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def run(cell: dict, seed: int, seconds: float, traced: bool, device, clock) -> dict:
    from perfbench import tracing

    cfg, traffic = cell["config"], cell["traffic"]
    phases = {"start": clock()}
    weights = inputs.weights(cfg, seed, device,
                             torch.promote_types(port.DTYPES[cfg["dtype"]], torch.float32))
    phases["weights"] = clock()
    model, optimizer, step = build(cell, weights, device)
    phases["model"] = clock()
    pool = batches(cfg, traffic, seed, device)
    phases["pool"] = clock()
    gen = torch.Generator(device=device).manual_seed(0)   # the actions are given: unused

    def one(i, mark=None):
        b = pool[i % len(pool)]
        return step(b, gen, actions=b["actions"], mark=mark)

    program = first_steps(model, optimizer, one, traffic["reference_steps"])
    record = {}
    if traced:
        record["flops_per_video"] = judge.train_flops(cfg, traffic, weights)
    first = traffic["reference_steps"]
    in_flight = traffic["in_flight"]

    def window(count=None, spans=False):
        """Steps ``first``, ``first + 1``, ...: ``count`` of them, or as many
        as start within ``seconds``; with ``spans``, each step and its marks
        in ``record_function`` ranges. Returns (steps, seconds)."""
        events, i = [], first
        t0 = time.perf_counter()
        while (count is None and time.perf_counter() - t0 < seconds) or \
                (count is not None and i - first < count):
            if len(events) >= in_flight:
                ev = events.pop(0)
                if ev is not None:
                    ev.synchronize()
            if spans:
                marks = _Marks()
                with torch.profiler.record_function("step"):
                    marks.start()
                    one(i, marks)
            else:
                one(i)
            events.append(_event(device))
            i += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
        return i - first, time.perf_counter() - t0

    first += window(traffic["warmup"], traced)[0]
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = clock()
    if traced:
        # the program's pace, untraced, over as many steps as are traced
        record["pace_us"], (record["pace_units"], _) = tracing.paced(
            lambda: window(traffic["trace_steps"]), device)
        first += record["pace_units"]
        with tracing.capture(record):
            steps, window_s = window(traffic["trace_steps"], spans=True)
    else:
        steps, window_s = window()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    videos = steps * traffic["batch"]
    result = {"attempted": steps, "failed": 0, "memory_peak_bytes": peak, "setup": phases,
              "metrics": {"train_videos_per_s": videos / window_s, "setup_s": setup_s}}
    if traced:
        rec = tracing.record(record.pop("events"), RANGES, "step")
        record.update(rec, steps=steps, videos=videos, batch=traffic["batch"],
                      precision=cfg["dtype"])
        result["record"] = record
    del model, optimizer, step
    start = time.perf_counter()
    result["values"] = judgement(cfg, traffic, weights, pool, program)
    result["check_s"] = time.perf_counter() - start
    return result


def judgement(cfg: dict, traffic: dict, weights, pool, program: dict,
              precision: str = "float32") -> Dict[str, float]:
    """The numbers of the module's docstring, ``program`` holding the
    program's (or the control's) losses, first momentum buffers and state
    after the steps, the reference run in float32 against it."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = judge.reference(cfg).stage1_steps(weights, cfg, traffic["optim"],
                                            pool[:traffic["reference_steps"]],
                                            QUANTIZERS[precision])
    return compare(weights, program, ref)


def _gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
          keys: List[str]) -> torch.Tensor:
    """Each tensor's |norm(program) - norm(reference)| over the larger of the
    reference's norm of the tensor and of the median tensor."""
    p = torch.stack([program[k].double().norm() if k in program else
                     torch.zeros((), dtype=torch.float64, device=reference[k].device)
                     for k in keys])
    r = torch.stack([reference[k].double().norm() for k in keys])
    return (p - r).abs() / torch.maximum(r, r.median())


def compare(weights, program: dict, ref: dict) -> Dict[str, float]:
    w0 = {k: v.double() for k, v in weights.items()}
    trained = sorted(ref["first_buf"])
    raw = torch.stack([ref["first_grad"][k].double().norm() for k in trained])
    kept = [k for k, n in zip(trained, raw) if n >= RESOLVED * raw.median()]
    losses = torch.tensor(program["losses"], dtype=torch.float64)
    ref_losses = torch.tensor([float(x) for x in ref["losses"]], dtype=torch.float64)
    after, ref_after = program["after"], ref["weights"]
    change = {k: after[k].double() - w0[k] for k in kept}
    ref_change = {k: ref_after[k].double() - w0[k] for k in kept}
    stats = [k for k in ref_after if k.startswith("focuser.") and "running_" in k]
    stat_change = {k: after[k].double() - w0[k] for k in stats}
    ref_stat_change = {k: ref_after[k].double() - w0[k] for k in stats}
    frozen = [k for k in after if k.startswith(("glancer.", "policy."))]
    grad = _gaps(program["first_buf"], ref["first_buf"], kept)
    moved = _gaps(change, ref_change, kept)
    parts: Dict[str, List[str]] = {}
    for k in kept:
        parts.setdefault(k.split(".", 1)[0], []).append(k)
    grad_parts = {p: float(_gaps(program["first_buf"], ref["first_buf"], ks).median())
                  for p, ks in parts.items()}
    moved_parts = {p: float(_gaps(change, ref_change, ks).median()) for p, ks in parts.items()}
    return {
        "grad_gap": float(grad.median()),
        "change_gap": float(moved.median()),
        "part_grad_gap": max(grad_parts.values()),
        "part_change_gap": max(moved_parts.values()),
        "frozen_change": max(float((after[k].double() - weights[k].double()).abs().max())
                             for k in frozen),
        # read and printed, not compared (PERF.md: no upper reading)
        "loss_err": float(((losses - ref_losses).abs() / ref_losses.abs()).max()),
        "stats_gap": float(_gaps(stat_change, ref_stat_change, stats).max()),
        "grad_gap_worst": float(grad.max()),
        "change_gap_worst": float(moved.max()),
        "worst": [kept[int(grad.argmax())], kept[int(moved.argmax())]],
        "parts": {p: [grad_parts[p], moved_parts[p], len(ks)] for p, ks in parts.items()},
    }
