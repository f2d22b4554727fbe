"""Data parallelism over processes (counterpart of adafocus_tpu/parallel/mesh.py).

The JAX package lifts ``step(state, batch, rng)`` onto a 1-D ``data`` mesh
with ``shard_map``: the state and the rng replicated, the batch split on its
leading axis, each replica folding its axis index into the rng; inside the
step, ``axis_name`` makes ``pmean`` average what the replicas must agree on.
Here, in PyTorch's idiom, one process runs each replica (a rank: one GPU
over NCCL, or the CPU over gloo), and the steps (``train/stages*.py``,
``ppo/core.py``) take a ``Replicas`` where the JAX steps take
``axis_name``. They average, with explicit collectives on the same tensors
in the same order on every rank, what ``pmean`` averages:

  * the gradients, after the backward and before the optimizer step (every
    epoch of a PPO update);
  * the BatchNorm running statistics, once after the step. Each replica's
    forward normalises with its own batch statistics, as the JAX models
    (built without ``axis_name``) do: this is not SyncBatchNorm, and not
    DDP's ``broadcast_buffers``, which would copy rank 0's;
  * the moments of the discounted returns (``ppo.core.discounted_returns``);
  * the metrics.

There is no DDP wrapper: the steps are closures that run the backward and
the optimizer themselves. An average is a SUM all-reduce divided by the
world size, which is ``pmean`` exactly for equal shards; over one rank it is
the identity, bit for bit. Tensors go through in buckets of one dtype,
flattened in the order given; reduced precision is refused, since the
gradients and statistics are float32.

A second, gloo group carries what lives on the host (a stop flag, the
validation scores), so that no host value waits on the GPU's stream.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

BUCKET_BYTES = 32 * 2**20
# how long a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_REDUCED = (torch.float16, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Replicas:
    """One rank of the replica group: its index, the group's size, the
    process group of the tensors' collectives (NCCL or gloo), the gloo group
    of host values and the rank's device."""

    rank: int
    world: int
    group: Any
    host_group: Any
    device: torch.device


def _rendezvous(init_method: Optional[str], world: Optional[int], rank: Optional[int]):
    """(init_method, world, rank): ``file://path`` or ``tcp://host:port``
    (``host:port`` is taken as tcp) with the world size and rank given, or
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    if init_method:
        if world is None or rank is None:
            raise ValueError(f"rendezvous {init_method!r} needs the world size and the rank")
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
        return init_method, world, rank
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    raise ValueError(
        "no rendezvous: give a coordinator (file://path or host:port) with the number of "
        "processes and this process's rank, or start under torchrun (RANK, WORLD_SIZE, "
        "MASTER_ADDR, MASTER_PORT)")


def init_replicas(init_method: Optional[str] = None, world: Optional[int] = None,
                  rank: Optional[int] = None, device_type: str = "cuda",
                  local_rank: Optional[int] = None, backend: Optional[str] = None,
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Replicas:
    """Joins the replica group (``_rendezvous``) and returns this rank's
    ``Replicas``. ``device_type`` 'cuda' takes the GPU ``local_rank``
    (``LOCAL_RANK`` under torchrun, else rank modulo the visible GPUs), makes
    it the current device and defaults to NCCL; it raises when no GPU is
    visible. 'cpu' defaults to gloo. ``backend`` overrides the default (gloo
    takes CUDA tensors too)."""
    init_method, world, rank = _rendezvous(init_method, world, rank)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible for this rank; ask for the CPU "
                               "(device_type='cpu', run.platform=cpu) to run there")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank}: only {torch.cuda.device_count()} "
                               "GPU(s) visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unknown device type {device_type!r}: 'cuda' or 'cpu'")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    group = dist.group.WORLD
    host_group = group if backend == "gloo" else dist.new_group(backend="gloo",
                                                                timeout=timeout)
    return Replicas(rank, world, group, host_group, device)


def shutdown(replicas: Optional[Replicas]) -> None:
    """Leaves the group (every rank calls it once it is done)."""
    if replicas is not None and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, device_type: str, args: tuple = (),
          timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> List[Any]:
    """Runs ``fn(replicas, *args)`` on ``world`` local ranks, each a fresh
    process (rank r on GPU r, or on the CPU with an equal share of this
    process's threads), joined by a ``file://`` rendezvous in a temporary
    directory. Returns each rank's return value (``torch.save``-able), in
    rank order. A rank that raises stops every rank and raises here."""
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, world, tmp, device_type, threads, timeout, args),
            nprocs=world, start_method="spawn", join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _spawned(rank: int, fn, world: int, tmp: str, device_type: str, threads: int,
             timeout: datetime.timedelta, args: tuple) -> None:
    if device_type == "cpu":
        torch.set_num_threads(threads)
    replicas = init_replicas(f"file://{tmp}/rendezvous", world, rank, device_type,
                             local_rank=rank, timeout=timeout)
    try:
        out = fn(replicas, *args)
    finally:
        shutdown(replicas)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def shard_batch(batch: Dict[str, Any], replicas: Optional[Replicas]) -> Dict[str, Any]:
    """Rank r's rows ``[r*B/w, (r+1)*B/w)`` of every entry of a batch whose
    entries lead with the batch axis B; raises unless w divides B, as
    ``shard_map`` does."""
    if replicas is None:
        return batch
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch entries lead with different sizes {sorted(sizes)}")
    b = sizes.pop()
    if b % replicas.world:
        raise ValueError(f"a batch of {b} does not split over {replicas.world} replicas")
    n = b // replicas.world
    return {k: v[replicas.rank * n:(replicas.rank + 1) * n] for k, v in batch.items()}


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Runs of consecutive tensors of one dtype and device, each at most
    ``BUCKET_BYTES`` (or one tensor, where it alone is larger)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def _reduce_(tensors: List[torch.Tensor], replicas: Replicas, average: bool) -> None:
    for bucket in _buckets(tensors):
        if bucket[0].dtype in _REDUCED:
            raise TypeError(f"no {bucket[0].dtype} bucket: average float32 or float64 tensors")
        flat = torch.cat([t.reshape(-1) for t in bucket])
        if average:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=replicas.group)
            flat.div_(replicas.world)
        else:
            dist.broadcast(flat, src=0, group=replicas.group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_(tensors: Iterable[torch.Tensor], replicas: Optional[Replicas]) -> None:
    """Replaces each tensor by its mean over the replicas, in place (the
    JAX steps' ``pmean``). Every rank must pass the same list: same order,
    shapes and dtypes."""
    if replicas is not None:
        _reduce_(list(tensors), replicas, average=True)


def average_grads_(optimizer: torch.optim.Optimizer, replicas: Optional[Replicas]) -> None:
    """Averages the gradient of every parameter of ``optimizer``, in its
    param groups' order. A parameter the loss did not reach gets a zero
    gradient first, as optax's zero for an unreached leaf, so that every
    rank reduces the same list."""
    if replicas is None:
        return
    grads = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    average_(grads, replicas)


def average_bn_stats_(module: nn.Module, replicas: Optional[Replicas]) -> None:
    """Averages the running means and variances of ``module``'s BatchNorms,
    in ``named_buffers`` order (the JAX steps' ``pmean(new_stats)``; never
    ``num_batches_tracked``); a module without BatchNorm has nothing to
    average."""
    average_([b for name, b in module.named_buffers()
              if name.endswith(("running_mean", "running_var"))], replicas)


def average_metrics(metrics: Dict[str, torch.Tensor], replicas: Optional[Replicas]
                    ) -> Dict[str, torch.Tensor]:
    """The metrics (0-d tensors) averaged over the replicas, in key order."""
    if replicas is not None:
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        average_([metrics[k] for k in sorted(metrics)], replicas)
    return metrics


def replicate(obj: Any, replicas: Optional[Replicas]) -> None:
    """Broadcasts rank 0's values to every rank, in place: a module's
    parameters and buffers, or a train state's (``model``) and the tensors
    of its optimizers' state (``optimizer``, ``ppo.optimizer``). For the
    start of a run, where every rank must begin from the same weights."""
    if replicas is None:
        return
    tensors = list(_state_tensors(obj))
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        _reduce_(by_dtype[dtype], replicas, average=False)


def _state_tensors(obj: Any) -> Iterable[torch.Tensor]:
    if isinstance(obj, nn.Module):
        yield from obj.state_dict(keep_vars=True).values()
        return
    yield from _state_tensors(obj.model)
    optimizers = [getattr(obj, "optimizer", None)]
    if getattr(obj, "ppo", None) is not None:
        optimizers.append(obj.ppo.optimizer)
    for opt in optimizers:
        if opt is None:
            continue
        for group in opt.param_groups:
            for p in group["params"]:
                for v in opt.state.get(p, {}).values():
                    if torch.is_tensor(v) and v.dim() > 0:
                        yield v


def rank_generator(generator: Optional[torch.Generator], replicas: Optional[Replicas]
                   ) -> Optional[torch.Generator]:
    """The generator of this replica's draws in a step: ``generator`` itself
    for one replica (a single-GPU run's stream does not move), else a fresh
    generator on its device seeded from its initial seed and the rank, the
    counterpart of ``fold_in(rng, axis_index)``."""
    if generator is None or replicas is None or replicas.world == 1:
        return generator
    seed = np.random.SeedSequence((generator.initial_seed(), replicas.rank))
    return torch.Generator(device=generator.device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def any_rank(flag: bool, replicas: Optional[Replicas]) -> bool:
    """True on every rank when ``flag`` is true on any (a host all-reduce)."""
    if replicas is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=replicas.host_group)
    return bool(t.item())


def gather_objects(obj: Any, replicas: Optional[Replicas]) -> List[Any]:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if replicas is None:
        return [obj]
    out = [None] * replicas.world
    dist.all_gather_object(out, obj, group=replicas.host_group)
    return out


def barrier(replicas: Optional[Replicas]) -> None:
    """Waits on the host until every rank has reached it."""
    if replicas is not None:
        dist.barrier(group=replicas.host_group)


def digest(module: nn.Module) -> str:
    """A hash of every parameter and buffer of ``module``, bit for bit:
    two replicas agree exactly where their digests are equal."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
