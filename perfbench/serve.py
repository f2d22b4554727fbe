"""Serving traffic: a closed loop of batch requests.

``in_flight`` requests are outstanding at once: the next is enqueued as soon
as the oldest has delivered its logits to the host, so the device always
has the next request queued behind the one it runs and never waits for the
host to read a result. A request's latency runs from its enqueue to its
logits in host memory. The window starts at the first enqueue after the
warm-up and ends when the last request of the window has delivered; no
request is enqueued after ``--seconds``.

The traffic file: ``batch`` videos a request, ``in_flight``, ``pool``
distinct input batches made at set-up and cycled, ``warmup`` requests,
``check_requests`` requests that the reference judges once the window has
closed (drawn from the seed), ``trace_requests`` requests in the traced
run's window, ``fused`` (the entry's backbone path), ``mode`` (``bf16``:
the configuration's entry; ``int8``: the program's int8 serving path,
calibrated and prepared at set-up), and ``control`` (what ``readings.py
--control`` puts in the program's place). The traced run first times as
many requests untraced (the program's pace, ``tracing.paced``).
"""

from __future__ import annotations

import collections
import gc
import random
import time
from typing import Dict, List

import torch

from perfbench import inputs, judge, port

# the per-layer spans the traced run opens around calls into the program
RANGES = ("request", "glance", "focus")


class _HostEvent:
    """Stands in for a CUDA event on the CPU (tests)."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


def _event(device):
    return torch.cuda.Event() if device.type == "cuda" else _HostEvent()


def _wrap(obj, attr: str, around):
    """Replaces the bound method ``obj.attr`` by ``around(original, *a, **k)``."""
    original = getattr(obj, attr)
    setattr(obj, attr, lambda *a, **k: around(original, *a, **k))


def _spanned(name: str):
    def around(original, *a, **k):
        with torch.profiler.record_function(name):
            return original(*a, **k)
    return around


class Server:
    """The program's model behind one entry, with the served actions of
    every request kept (a pass-through wrapper on the model's policy
    rollout records the actions it returns)."""

    def __init__(self, cell: dict, weights: Dict[str, torch.Tensor], device, traced: bool,
                 seed: int):
        cfg, traffic = cell["config"], cell["traffic"]
        self.model = port.model(cfg, weights, device)
        # forward(model, frames, frames_small, device=, fused=) -> logits
        self.forward = port.entry(cfg["serve_entry"])
        self.fused = traffic["fused"]
        self.device = device
        self.actions: List[torch.Tensor] = []
        _wrap(self.model, "policy_rollout", self.keep_actions)
        if traced:
            _wrap(self.model.glancer, "features", _spanned("glance"))
            _wrap(self.model.focuser, "features", _spanned("focus"))
        if traffic["mode"] == "int8":
            self.forward = int8_forward(self.model, cfg, seed, device)

    def keep_actions(self, original, *a, **k):
        out = original(*a, **k)
        self.actions.append(out["actions"])
        return out

    def __call__(self, batch: dict) -> torch.Tensor:
        return self.forward(self.model, batch["frames"], batch["frames_small"],
                            device=self.device, fused=self.fused)


def int8_forward(model, cfg: dict, seed: int, device, heads: bool = False):
    """The program's int8 serving forward on ``model`` (``heads``: the policy
    and the classifier int8 too): activation scales calibrated on two
    videos drawn from the seed, weights prepared once, as a server does."""
    from adafocus_torch.models import quant_inference as qi

    calib = inputs.input_pool(cfg, 2, 1, seed, device, port.DTYPES[cfg["dtype"]],
                              "calibration")[0]
    scales = qi.calibrate_gfv(model, [qi.calibration_batch(model, calib["frames"],
                                                           calib["frames_small"])],
                              heads=heads)
    qw = qi.prepare_q8(model, scales)
    family = qi.family_q8(model.cfg)
    return lambda m, frames, small, device=None, fused=None: family(
        m, scales, frames, small, device=device, qw=qw)


def closed_loop(server: Server, pool: List[dict], in_flight: int, seconds: float = None,
                requests: int = None, first: int = 0) -> dict:
    """Runs requests ``first``, ``first + 1``, ... over the cycled ``pool``
    with ``in_flight`` outstanding, until ``seconds`` have passed since the
    first enqueue or ``requests`` have been enqueued. Returns each
    request's latency (s), its logits as delivered to the host, and the
    window (s)."""
    slots, pending = None, collections.deque()
    latencies, outputs = [], []
    device = server.device
    n = first

    def enqueue():
        nonlocal slots, n
        batch = pool[n % len(pool)]
        start = time.perf_counter()
        with torch.profiler.record_function("request"):
            logits = server(batch)
            if slots is None:
                slots = [torch.empty(logits.shape, dtype=logits.dtype,
                                     pin_memory=device.type == "cuda")
                         for _ in range(in_flight)]
            slot = slots[n % in_flight]
            slot.copy_(logits, non_blocking=True)
            done = _event(device)
            done.record()
        pending.append((start, done, slot))
        n += 1

    t0 = time.perf_counter()
    for _ in range(in_flight):
        enqueue()
    end = t0
    while pending:
        start, done, slot = pending.popleft()
        done.synchronize()
        end = time.perf_counter()
        latencies.append(end - start)
        outputs.append(slot.clone())
        more = (seconds is None or end - t0 < seconds) and \
            (requests is None or n - first < requests)
        if more:
            enqueue()
    return {"latencies": latencies, "outputs": outputs, "window_s": end - t0}


def p95(values: List[float]) -> float:
    """The 95th percentile, by linear interpolation between order statistics."""
    xs = sorted(values)
    k = 0.95 * (len(xs) - 1)
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def run(cell: dict, seed: int, seconds: float, traced: bool, device, clock) -> dict:
    """One run of a serving cell. ``clock()`` gives the seconds since the
    process started."""
    from perfbench import tracing

    cfg, traffic = cell["config"], cell["traffic"]
    dtype = port.DTYPES[cfg["dtype"]]
    phases = {"start": clock()}
    weights = inputs.weights(cfg, seed, device, dtype)
    phases["weights"] = clock()
    server = Server(cell, weights, device, traced, seed)
    phases["model"] = clock()
    pool = inputs.input_pool(cfg, traffic["batch"], traffic["pool"], seed, device, dtype)
    phases["pool"] = clock()
    closed_loop(server, pool, traffic["in_flight"], requests=traffic["warmup"])
    record = {}
    if traced:
        record["flops_per_video"] = judge.serve_flops(cfg, traffic, weights)
    if device.type == "cuda":
        torch.cuda.synchronize()
    server.actions.clear()
    setup_s = clock()
    if traced:
        # the program's pace, untraced, over as many requests as are traced
        record["pace_us"], paced = tracing.paced(
            lambda: closed_loop(server, pool, traffic["in_flight"],
                                requests=traffic["trace_requests"]), device)
        record["pace_units"] = len(paced["outputs"])
        server.actions.clear()
        with tracing.capture(record):
            loop = closed_loop(server, pool, traffic["in_flight"],
                               requests=traffic["trace_requests"])
    else:
        loop = closed_loop(server, pool, traffic["in_flight"], seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n = len(loop["outputs"])
    if len(server.actions) != n:
        raise RuntimeError(f"{len(server.actions)} policy rollouts for {n} requests")
    videos = n * traffic["batch"]
    result = {"attempted": n, "failed": 0, "memory_peak_bytes": peak, "setup": phases,
              "metrics": {"serve_videos_per_s": videos / loop["window_s"],
                          "serve_p95_ms": p95(loop["latencies"]) * 1e3,
                          "setup_s": setup_s}}
    if traced:
        rec = tracing.record(record.pop("events"), RANGES, "request")
        record.update(rec, requests=n, videos=videos, batch=traffic["batch"],
                      precision="int8" if traffic["mode"] == "int8" else cfg["dtype"],
                      patch=judge.patch_bytes(cfg, traffic["batch"]))
        if traffic["mode"] == "int8":
            record["int8_bound_us"] = judge.int8_bound_us(cfg, traffic["batch"])
        result["record"] = record
    served = {"outputs": loop["outputs"], "actions": server.actions}
    del server
    gc.collect()
    start = time.perf_counter()
    result["values"] = judgement(cell, seed, weights, pool, served)
    result["check_s"] = time.perf_counter() - start
    return result


def judgement(cell: dict, seed: int, weights, pool, served) -> Dict[str, float]:
    """The reference's judgement of ``check_requests`` served requests drawn
    from the seed (every one where fewer were served): each number of
    ``judge.serve_request``, its worst over the requests."""
    cfg, traffic = cell["config"], cell["traffic"]
    n = len(served["outputs"])
    k = min(traffic["check_requests"], n)
    picks = sorted(random.Random(f"{seed}/check").sample(range(n), k))
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wf = {name: t.float() for name, t in weights.items()}
    readings = [judge.serve_request(cfg, wf, pool[i % len(pool)], served["outputs"][i],
                                    served["actions"][i])
                for i in picks]
    return judge.worst(readings)
