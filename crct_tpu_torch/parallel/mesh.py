"""Process group and reductions (the port of crct_tpu/parallel/mesh.py).

The JAX package runs one process per host over a 1-D ``data`` mesh of the
host's chips; here one process (a *rank*) drives one card, and N ranks on
one machine (``torchrun --nproc_per_node N``) stand for one JAX host with N
chips. The global batch is the same: ``batch_size`` rows a card. Where jit
inserted the collectives from sharding annotations, the port calls them:

* :func:`broadcast_module` - rank 0's parameters and buffers to every rank
  at start (``replicate``);
* :func:`allreduce_gradients` - the mean of the gradients over the world,
  after ``backward()`` and before the optimizer (the gradient all-reduce
  that jit inserted for the sharded batch);
* :func:`allreduce_sum` / :func:`global_sum` - a device or host
  accumulator summed over the world (the metric psum, ``global_sum``);
* :func:`any_rank` - a host flag that is true on some rank, so that every
  rank takes the same branch at a step boundary (SIGTERM).

Without a process group every one of them is the identity: one process is
the whole world. The card's collectives run over nccl; a gloo group of the
same ranks carries the host's (flags, accumulators), so that they never wait
on the card. On the CPU both are gloo.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from crct_tpu_torch.utils.device import resolve_device

# the gloo group of the host's reductions (the world itself when the
# world's backend is gloo)
_HOST_GROUP = None
# elements of one bucket of the gradient all-reduce
BUCKET = 1 << 24
# rank r's random streams start from seed + RANK_SEED_STRIDE * r
RANK_SEED_STRIDE = 1_000_003


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def rank_seed(seed: int) -> int:
    """This rank's seed of a random stream that each rank draws on its own
    (dropout, the detector's sampling noise): ``seed`` on rank 0."""
    return int(seed) + RANK_SEED_STRIDE * rank()


def init_distributed(world: int, rank_id: int, *, init_method: str = "env://",
                     device="cuda", backend: Optional[str] = None) -> None:
    """Join the process group of ``world`` ranks as ``rank_id``: over nccl
    when ``device`` is a card, else gloo, unless ``backend`` says otherwise
    (gloo ranks may share one card, which nccl refuses). A group that does
    not form raises."""
    global _HOST_GROUP
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_id)
    _HOST_GROUP = (dist.new_group(backend="gloo") if backend != "gloo"
                   else dist.group.WORLD)


def maybe_initialize_distributed(params: Optional[Dict[str, Any]] = None
                                 ) -> bool:
    """Join the process group that the flags or torchrun's environment
    describe; True if this call formed it.

    The rules of the JAX package's: the rendezvous is ``-dist_url
    tcp://host:port`` (a ``file://`` url is the reference's NCCL rendezvous
    and the source of the seed quirk in ``config.py``, not an address), else
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``; the world size is
    ``-world_size`` when above 1, else ``WORLD_SIZE``; the rank ``-rank``
    when nonzero, else ``RANK``. One process, or no rendezvous, is a no-op,
    and so is a second call, except that ``-ddp`` with no rendezvous on a
    machine with several cards raises: it needs a process a card. On the
    card the rank runs on ``cuda:LOCAL_RANK`` (``LOCAL_RANK``, else the rank): ``params``'
    ``cuda_num`` is set to it, and a rank without its card raises. After the
    group forms, every rank takes rank 0's ``seed`` and ``save_path``: each
    process draws its own seed with ``-ddp`` and no ``-dist_url``, and its
    own save path without ``-save_name`` (``config.py``), while the
    loader's shuffle, the model's initialization and the per-rank result
    files must agree."""
    p = params if params is not None else {}
    device = torch.device(p.get("device") or "cuda")
    if device.type == "cuda":
        resolve_device(device)          # no card: raise, never the CPU
    url = str(p.get("dist_url") or "")
    if url.startswith("file://"):
        url = ""
    if url and "://" not in url:
        url = "tcp://" + url
    if not url and os.environ.get("MASTER_ADDR"):
        url = "env://"
    world = p.get("world_size")
    if not world or int(world) <= 1:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    rank_id = p.get("rank")
    if not rank_id and "RANK" in os.environ:
        rank_id = int(os.environ["RANK"])
    rank_id = int(rank_id or 0)
    if not url or int(world) <= 1 or is_initialized():
        n = torch.cuda.device_count() if device.type == "cuda" else 0
        if p.get("ddp") and not is_initialized() and n > 1:
            # the JAX -ddp spans every local chip; one process here would
            # drive one card at a global batch of batch_size
            raise RuntimeError(
                f"-ddp with {n} visible cards runs one process a card: "
                f"start it as `torchrun --nproc_per_node {n} -m "
                f"crct_tpu_torch.cli.train -ddp ...` (or give -dist_url, "
                f"-world_size and -rank to each process)")
        return False
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank_id))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank_id} wants card {local} but only "
                f"{torch.cuda.device_count()} are visible: start at most "
                f"one process per card")
        device = torch.device("cuda", local)
        p["cuda_num"] = local
    init_distributed(int(world), rank_id, init_method=url, device=device)
    keys = [k for k in ("seed", "save_path") if k in p]
    if keys:
        values = [p[k] for k in keys]
        dist.broadcast_object_list(values, src=0, group=_HOST_GROUP)
        p.update(zip(keys, values))
    return True


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src)


def _buckets(tensors: Iterable[torch.Tensor]):
    """Runs of tensors of one dtype and device, at most BUCKET elements each
    (a tensor larger than that is a run of its own)."""
    run, n = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or n + t.numel() > BUCKET):
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def allreduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the world. A parameter with
    no gradient takes a zero one first: a stopped gradient is zero, and
    every rank must reduce the same tensors."""
    W = world_size()
    if W == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for run in _buckets([p.grad for p in params]):
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat)
        flat.div_(W)
        offset = 0
        for g in run:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the world, in place (the identity on one rank)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def global_sum(arr: np.ndarray) -> np.ndarray:
    """A host accumulator summed over the world, in its dtype, through the
    host's group (the JAX ``global_sum``; the identity on one rank)."""
    if world_size() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)).clone()
    dist.all_reduce(t, group=_HOST_GROUP)
    return t.numpy().astype(arr.dtype)


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on some rank."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def shard(n: int) -> slice:
    """This rank's slice of ``n`` rows split evenly over the world; the
    world size must divide ``n``."""
    W, r = world_size(), rank()
    if n % W:
        raise ValueError(f"the world size {W} does not divide {n} rows")
    return slice(r * (n // W), (r + 1) * (n // W))


def destroy() -> None:
    """Leave the process group, if any (a no-op without one)."""
    global _HOST_GROUP
    if is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
