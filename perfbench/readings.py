"""The readings that a cell's limits of ``correct`` are set from (see
README.md): the numbers that the benchmark compares, over many seeds, for
the program and for its control, in one process so that the set-up is paid
once a seed and the devices' build once.

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 [--control] \
        [--fault half_batch] [--out <file.jsonl>]

Serving: per seed, the set-up of a run, a closed-loop window of
``readings_requests`` requests at the cell's load and the reference's
judgement of the requests a run judges; with ``--control``, the same
requests through the traffic's ``control``: ``int8_heads``, the program's
int8 serving path with the policy and the classifier int8 too (its own
calibration on two videos the harness draws, then its prepared weights);
``reference_int4``, the reference in int4 with its own greedy actions;
judged alike; ``--fault altered_action`` plants an altered action in the
program (each anchor one on, each mean 0.25 on).
Training: per seed, the program's first steps and their judgement; with
``--control``, the reference's own steps in fp8 (``reference/precision.py``)
judged against its float32 steps; ``--fault half_batch`` plants a loss
over half of each batch's rows in the program, ``--fault
classifier_frozen`` a stage 1 that leaves the classifier untrained.

Each reading is one JSON line: the cell, the seed, which side, the numbers.
Not run by the benchmark's runs; on the chip only where the cell's device
is.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import common, inputs, judge, port, serve, train  # noqa: E402
from perfbench.reference.nets import anchor_grid  # noqa: E402
from perfbench.reference.precision import fp8, int4  # noqa: E402


def serve_readings(cell: dict, seed: int, control: bool, device, fault: str = "") -> list:
    cfg, traffic = cell["config"], cell["traffic"]
    dtype = port.DTYPES[cfg["dtype"]]
    weights = inputs.weights(cfg, seed, device, dtype)
    server = serve.Server(cell, weights, device, False, seed)
    pool = inputs.input_pool(cfg, traffic["batch"], traffic["pool"], seed, device, dtype)
    with planted(fault):
        sides = {fault or "program": _served(server, pool, traffic)}
    if control and traffic["control"] == "int8_heads":
        with int8_heads(server, cfg, seed, device):
            sides["control"] = _served(server, pool, traffic)
    del server
    if control and traffic["control"] == "reference_int4":
        sides["control"] = reference_served(cfg, weights, pool, traffic, int4)
    return [(side, serve.judgement(cell, seed, weights, pool, served))
            for side, served in sides.items()]


def _served(server, pool, traffic: dict) -> dict:
    """A warm-up, then ``readings_requests`` requests in the closed loop."""
    serve.closed_loop(server, pool, traffic["in_flight"], requests=traffic["warmup"])
    server.actions.clear()
    loop = serve.closed_loop(server, pool, traffic["in_flight"],
                             requests=traffic["readings_requests"])
    return {"outputs": loop["outputs"], "actions": list(server.actions)}


@contextlib.contextmanager
def int8_heads(server, cfg: dict, seed: int, device):
    """The program's int8 serving path with the policy and the classifier
    int8 too (mode int8+heads) in place of the server's forward; the int8
    policy's actions kept as the bf16 one's are."""
    from adafocus_torch.models import quant_inference as qi

    forward = serve.int8_forward(server.model, cfg, seed, device, heads=True)
    rollout, serving = qi.q8_policy_rollout, server.forward

    def kept(*a, **k):
        out = rollout(*a, **k)
        server.actions.append(out[0]["actions"])
        return out

    qi.q8_policy_rollout, server.forward = kept, forward
    try:
        yield
    finally:
        qi.q8_policy_rollout, server.forward = rollout, serving


def reference_served(cfg: dict, weights, pool, traffic: dict, q) -> dict:
    """The reference in the program's place, its products rounded by ``q``:
    its own greedy actions (the best anchor, or the mean) and its logits at
    them, for ``readings_requests`` requests over the cycled pool."""
    ref = judge.reference(cfg)
    wf = {k: v.float() for k, v in weights.items()}
    by_batch = []
    for b in pool:
        shape = (b["frames"].shape[0], cfg["video_div"] if cfg["continuous_policy"]
                 else cfg["num_frames"], 2)
        policy = ref.serve(wf, cfg, b["frames"], b["frames_small"],
                           torch.zeros(shape, device=b["frames"].device), q)["policy"]
        actions = policy if cfg["continuous_policy"] else \
            anchor_grid(cfg["action_dim"], policy.device)[policy.argmax(-1)]
        by_batch.append((ref.serve(wf, cfg, b["frames"], b["frames_small"], actions, q)["logits"],
                         actions))
    n = traffic["readings_requests"]
    return {"outputs": [by_batch[i % len(pool)][0] for i in range(n)],
            "actions": [by_batch[i % len(pool)][1] for i in range(n)]}


def train_readings(cell: dict, seed: int, control: bool, fault: str, device) -> list:
    cfg, traffic = cell["config"], cell["traffic"]
    weights = inputs.weights(cfg, seed, device,
                             torch.promote_types(port.DTYPES[cfg["dtype"]], torch.float32))
    pool = train.batches(cfg, traffic, seed, device)
    out = []
    if not control:
        with planted(fault):
            program = program_steps(cell, weights, pool, device)
        out.append((fault or "program", train.judgement(cfg, traffic, weights, pool, program)))
    else:
        ref = judge.reference(cfg).stage1_steps(weights, cfg, traffic["optim"],
                                                pool[:traffic["reference_steps"]], fp8)
        program = {"losses": [float(x) for x in ref["losses"]], "first_buf": ref["first_buf"],
                   "after": ref["weights"]}
        out.append(("control", train.judgement(cfg, traffic, weights, pool, program)))
    return out


def program_steps(cell: dict, weights, pool, device) -> dict:
    model, optimizer, step = train.build(cell, weights, device)
    gen = torch.Generator(device=device).manual_seed(0)
    return train.first_steps(model, optimizer,
                             lambda i: step(pool[i], gen, actions=pool[i]["actions"]),
                             cell["traffic"]["reference_steps"])


def moved_rollout(rollout):
    """``sample_rollout`` with each served action altered where it is
    produced: a discrete policy's anchor one on (modulo the anchors), a
    continuous policy's mean 0.25 on (held in [0, 1])."""
    from adafocus_torch.models.policy import discrete_to_coords

    def moved(*a, **k):
        actions, idx, logprob = rollout(*a, **k)
        if k.get("continuous", a[4] if len(a) > 4 else False):
            return (actions + 0.25).clamp(0.0, 1.0), idx, logprob
        anchors = k.get("action_dim", a[2] if len(a) > 2 else None)
        idx = (idx + 1) % anchors
        return discrete_to_coords(idx, anchors), idx, logprob
    return moved


# fault -> (module, attribute, the attribute's replacement made from it)
FAULTS = {
    # the per-step loss over the first half of the batch's rows, the mean
    # taken over them alone
    "half_batch": ("adafocus_torch.train.stages", "_ce_per_step",
                   lambda ce: lambda logits, labels: ce(logits[: logits.shape[0] // 2],
                                                        labels[: labels.shape[0] // 2])),
    # stage 1 leaves the classifier out of training
    "classifier_frozen": ("adafocus_torch.train.optim", "_STAGE_LABELS",
                          lambda labels: {**labels, 1: {**labels[1], "classifier": "frozen"}}),
    # every served action altered where the policy produces it
    "altered_action": ("adafocus_torch.models.gfv", "sample_rollout", moved_rollout),
}


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` (one of ``FAULTS``, or none) planted
    underneath while the block runs."""
    if not fault:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    name, attr, make = FAULTS[fault]
    module = importlib.import_module(name)
    original = getattr(module, attr)
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device is visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = common.cell(args.workload)
    torch.backends.cudnn.benchmark = common.CUDNN_BENCHMARK
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell["traffic"]["driver"] == "serve":
            rows = serve_readings(cell, seed, args.control, device, args.fault)
        else:
            rows = train_readings(cell, seed, args.control, args.fault, device)
        for side, values in rows:
            line = json.dumps({"workload": args.workload, "seed": seed, "side": side,
                               "values": values})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
