"""Worker processes of the port's data-parallel tests
(tests/test_torch_port_parallel.py, tests/test_torch_port_parallel_cli.py).

They import no JAX: the parent test computes JAX's references and passes
the weights, batches and JAX's draws in through ``torch.save`` files. Every
rank runs on one torch thread (the suite runs several test workers a
machine).

    python -m tests.torch_port_parallel_workers steps DIR
        DIR/cases.pt's step cases, the returns and the PPO update, over two
        gloo ranks; each rank's results to DIR/<case>.rank<r>.pt
    python -m tests.torch_port_parallel_workers cli64 OUT RANKS ARG...
        the train CLI in float64 (ARG: section.key=value) on RANKS local
        ranks (1: one process), as ``run.host_devices`` runs them;
        OUT/result.pt: the validation results, the classifier before and
        after
    python -m tests.torch_port_parallel_workers multihost OUT ARG...
        one process of a ``run.multihost`` group through ``cli.train.main``;
        OUT: its train shard's record paths and its final weights' digest
"""

import json
import os
import sys

import torch

from adafocus_torch import config as tconfig
from adafocus_torch.cli import train as ttrain
from adafocus_torch.models.gfv import GFV
from adafocus_torch.parallel import mesh
from adafocus_torch.ppo import core as tppo
from adafocus_torch.train import optim as toptim
from adafocus_torch.train import stages as tstages
from adafocus_torch.train import stages_plus as tsplus
from adafocus_torch.train import stages_sthsth as tss

RANKS = 2


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_case(spec: dict, weights: dict, replicas: mesh.Replicas) -> dict:
    """One step of ``spec['factory']`` from ``weights`` on this rank's shard
    of the batch, with this rank's draws; returns the metrics, the tensors
    that moved (the others are as they were), the learner's gradients
    (PPO) and the weights' digest."""
    cfg = spec["cfg"]
    model = GFV(cfg, device="cpu", param_dtype=torch.float64)
    model.load_state_dict(weights)
    batch = mesh.shard_batch(spec["batch"], replicas)
    draws = spec["draws"][replicas.rank]
    factory = spec["factory"]
    if factory in ("stage1", "sthsth1", "plus1"):
        opt, sched = toptim.make_stage_optimizer(model, 1, toptim.OptimConfig(**spec["optim"]))
        make = {"stage1": tstages.make_stage_train_step, "sthsth1": tss.make_sthsth_train_step,
                "plus1": tsplus.make_plus_train_step}[factory]
        metrics = make(model, 1, opt, sched, replicas)(batch, None, **draws)
        learner = None
    else:
        toptim.freeze_for_stage(model, 2)
        joint = factory == "joint2"
        learner = tstages.joint_learner(model) if joint else model.policy
        ppo = tppo.ppo_init(learner, tppo.PPOConfig(**spec["ppo"]))
        make = {"stage2": tstages.make_stage2_step, "sthsth2": tss.make_sthsth_stage2_step,
                "joint2": tsplus.make_plus_stage2_joint_step}[factory]
        metrics = make(model, ppo, replicas)(batch, None, **draws)
    prefix = "" if learner is None or factory == "joint2" else "policy."
    grads = None if learner is None else {
        prefix + n: p.grad.clone() for n, p in learner.named_parameters()}
    moved = {k: v for k, v in _snapshot(model).items() if not torch.equal(v, weights[k])}
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "moved": moved,
            "grads": grads, "digest": mesh.digest(model)}


def _steps_rank(replicas: mesh.Replicas, path: str) -> None:
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(path, "cases.pt"), weights_only=False)
    r = replicas.rank
    for name, spec in inputs["cases"].items():
        out = run_case(spec, inputs["weights"][spec["weights"]], replicas)
        if r:
            out = {"digest": out["digest"], "metrics": out["metrics"]}
        torch.save(out, os.path.join(path, f"{name}.rank{r}.pt"))
    # the rewards and the episode are time-major: this rank's videos are columns
    ret = inputs["returns"]
    n = ret["rewards"].shape[1] // replicas.world
    returns = tppo.discounted_returns(ret["rewards"][:, r * n:(r + 1) * n], ret["gamma"],
                                      replicas)
    upd = inputs["ppo_update"]
    policy = _policy(upd)
    n = upd["memory"]["returns"].shape[1] // replicas.world
    memory = {k: v[:, r * n:(r + 1) * n] for k, v in upd["memory"].items()}
    state = tppo.ppo_init(policy, tppo.PPOConfig(**upd["ppo"]))
    tppo.ppo_update(state, memory, replicas=replicas)
    torch.save({"returns": returns, "policy": _snapshot(policy), "digest": mesh.digest(policy)},
               os.path.join(path, f"shared.rank{r}.pt"))


def _policy(upd: dict):
    """The PPO update case's policy: a GFV's, with the given weights."""
    model = GFV(upd["cfg"], device="cpu", param_dtype=torch.float64)
    model.policy.load_state_dict(upd["policy"])
    return model.policy


def one_rank_ppo_update(upd: dict) -> dict:
    """The PPO update case on one process over the whole episode (the
    reference of the two ranks'); returns the policy's weights after."""
    policy = _policy(upd)
    state = tppo.ppo_init(policy, tppo.PPOConfig(**upd["ppo"]))
    tppo.ppo_update(state, dict(upd["memory"]))
    return _snapshot(policy)


def _float64_state(cfg, stage, optim, device=None, generator=None, ppo=None):
    """``create_train_state`` with float64 parameters (stages 1 and 3)."""
    model = GFV(cfg, device=device, generator=generator, param_dtype=torch.float64)
    return tstages.TrainState(model, *toptim.make_stage_optimizer(
        model, tstages.optimizer_stage(cfg, stage), optim))


def _cli64_rank(replicas, cfg, out_dir: str):
    """One rank (or, with ``replicas`` None, the one process) of the
    float64 train CLI; rank 0 writes OUT/result.pt."""
    torch.set_num_threads(1)
    ttrain.create_train_state = _float64_state
    results = []
    validate = ttrain.validate

    def keep_results(*a, **k):
        results.append(validate(*a, **k))
        return results[-1]

    ttrain.validate = keep_results
    initial = {}
    build_state = ttrain.build_state

    def keep_initial(*a, **k):
        state, *rest = build_state(*a, **k)
        initial.update(_snapshot(state.model.classifier))
        return (state, *rest)

    ttrain.build_state = keep_initial
    if replicas is None:
        out = ttrain.train(cfg)
    else:
        out = ttrain.train(cfg, replicas, shard_records=False)
    if replicas is None or replicas.rank == 0:
        final = _snapshot(out["state"].model.classifier)
        torch.save({"val": results, "initial": initial, "final": final,
                    "epochs": out["epochs"]}, os.path.join(out_dir, "result.pt"))
    return None


def _multihost(out_dir: str, args: list) -> None:
    torch.set_num_threads(1)
    shards = {}
    build_loader = ttrain.build_loader

    def spy(cfg, train, device, shard=None):
        loader = build_loader(cfg, train, device, shard)
        shards["train" if train else "val"] = [r.path for r in loader.records]
        return loader

    ttrain.build_loader = spy
    out = ttrain.main(args)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({"shards": shards, "digest": mesh.digest(out["state"].model),
                   "best_acc": out["best_acc"]}, f)


def main(argv):
    mode = argv[0]
    if mode == "steps":
        mesh.spawn(_steps_rank, RANKS, "cpu", (argv[1],))
    elif mode == "cli64":
        out_dir, ranks, args = argv[1], int(argv[2]), argv[3:]
        tconfig._DTYPES["float64"] = torch.float64
        cfg = tconfig.load_config(None, args)
        if ranks == 1:
            _cli64_rank(None, cfg, out_dir)
        else:
            mesh.spawn(_cli64_rank, ranks, "cpu", (cfg, out_dir))
    elif mode == "multihost":
        _multihost(argv[1], argv[2:])
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
