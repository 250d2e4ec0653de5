"""Data parallelism over a ``torch.distributed`` process group (counterpart
of ``coarse_fine_networks_tpu/parallel/mesh.py``).

The JAX package shards the batch over a device mesh and lets XLA insert the
collectives.  Here each rank is a process that holds its contiguous rows of
every global batch (the loader's ``shard=(rank, world)``), and the places
that need the global batch reduce across the group themselves: batch-norm
statistics (:class:`..models.layers.SubBatchNorm`, the training composite
:mod:`..ops.dw_mm_bn_train`), the loss's normalisers
(:mod:`..train.losses`) and, after the backward, the gradients
(:func:`all_reduce_grads`).  N ranks then compute what one process computes
on the whole batch.

Starting the ranks: :func:`run_data_parallel` with ``mesh_devices = N > 1``
spawns N processes (:func:`spawn`) unless the process already belongs to a
group of N, or joins the group ``torchrun`` describes (``RANK`` and
``WORLD_SIZE`` set).  Rank ``r`` uses ``cuda:(r % device_count)``.  The
backend (:func:`choose_backend`) is NCCL where every rank has a card of
its own and gloo where ranks share a card or run on the CPU: NCCL refuses
two ranks on one card, and gloo reduces CUDA tensors through host copies.
Outside a group every function here is the one-process identity.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import shutil
import socket
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("cfn_torch")

# how long a collective may wait: rank 0 validates alone while the others
# wait at a barrier
TIMEOUT = datetime.timedelta(hours=2)

def world() -> int:
    """The process group's size; 1 outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_shard(rank_: Optional[int] = None,
                  world_: Optional[int] = None) -> tuple[int, int]:
    """``(rank, world)`` of this process for the loader's ``shard=``:
    ``(0, 1)`` outside a group."""
    return (rank() if rank_ is None else rank_,
            world() if world_ is None else world_)


def backend() -> Optional[str]:
    """The group's backend (``"nccl"`` or ``"gloo"``), None outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def choose_backend(world_: int, device_type: str) -> str:
    """NCCL where every one of ``world_`` ranks has a card of its own;
    gloo where ranks share a card or run on the CPU."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_:
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank_: int, device_type: str) -> torch.device:
    """Rank ``rank_``'s device: ``cuda:(rank % device_count)``, or the
    CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank_ % torch.cuda.device_count())
    return torch.device("cpu")


def _rank_main(rank_: int, world_: int, port: int, backend_: str,
               device_type: str, threads: int, out_dir: str,
               fn: Callable, args: tuple) -> None:
    """The body of one spawned rank: its device, the group, ``fn(*args)``;
    its return value goes to ``out_dir``."""
    torch.set_num_threads(threads)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(rank_, device_type))
    dist.init_process_group(backend_, init_method=f"tcp://localhost:{port}",
                            world_size=world_, rank=rank_, timeout=TIMEOUT)
    try:
        log.info("rank %d of %d on %s over %s", rank_, world_,
                 rank_device(rank_, device_type), backend_)
        out = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank_}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_: int, *args, device: str = "cuda",
          backend_: Optional[str] = None) -> list:
    """Run ``fn(*args)`` in ``world_`` new processes joined in one group
    (``tcp://localhost:<free port>``, rank ``r`` on :func:`rank_device`,
    the backend of :func:`choose_backend` unless given, this process's
    thread count) and return each rank's result, by rank.  ``fn`` and
    ``args`` must pickle (a module-level function).  A rank that raises
    stops the others and the error propagates here."""
    device_type = torch.device(device).type
    backend_ = backend_ or choose_backend(world_, device_type)
    out_dir = tempfile.mkdtemp(prefix="cfn_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world_, join=True,
            args=(world_, free_port(), backend_, device_type,
                  torch.get_num_threads(), out_dir, fn, args))
        outs = []
        for r in range(world_):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return outs


def run_data_parallel(fn: Callable, cfg) -> Any:
    """``fn(cfg)`` on ``cfg.mesh_devices`` ranks; returns rank 0's result.

    One rank (``mesh_devices`` None or 1, outside a group): ``fn(cfg)``
    here.  N > 1 outside a group: N ranks spawned (:func:`spawn`), each
    running ``fn(cfg)`` in the group.  Under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set, no group yet) this process joins that group
    (``env://``, its device set first), whose size must be N.  In a group
    whose size differs from N, raises."""
    n = cfg.mesh_devices or 1
    device_type = torch.device(cfg.device).type
    if n > 1 and not dist.is_initialized():
        if "RANK" not in os.environ:
            return spawn(fn, n, cfg, device=cfg.device)[0]
        w, r = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if w != n:
            raise ValueError(f"mesh_devices {n} != WORLD_SIZE {w}")
        if device_type == "cuda":
            torch.cuda.set_device(rank_device(r, device_type))
        dist.init_process_group(choose_backend(w, device_type),
                                init_method="env://", world_size=w, rank=r,
                                timeout=TIMEOUT)
    if world() != n:
        raise ValueError(f"mesh_devices {n} in a group of {world()} ranks")
    if n > 1:
        log.info("data-parallel: rank %d of %d over %s", rank(), n,
                 backend())
    return fn(cfg)


# ---- collectives (identities outside a group) --------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over the
    ranks too (each rank's loss is its share of the global loss)."""

    @staticmethod
    def forward(ctx, t):
        out = t.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, with a backward (the statistics'
    gradient reduced too); ``t`` itself outside a group."""
    if world() == 1:
        return t
    return _AllReduceSum.apply(t)


def all_reduce_grads(params) -> None:
    """Sum every parameter's ``.grad`` over the ranks in place, in one
    bucket per dtype (every rank's ``.grad`` must be set)."""
    if world() == 1:
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (the JAX package's ``replicate``)."""
    if world() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0)
    return module


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def all_gather_objects(obj: Any) -> list:
    """Every rank's ``obj``, by rank (pickled; ``[obj]`` outside a
    group)."""
    if world() == 1:
        return [obj]
    out: list = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def _rows(n: int, rank_: int, world_: int) -> slice:
    if n % world_:
        raise ValueError(f"batch {n} not divisible by {world_} ranks")
    local = n // world_
    return slice(rank_ * local, (rank_ + 1) * local)


def shard_batch(batch: Any, leading_accum: bool = False,
                rank_: Optional[int] = None,
                world_: Optional[int] = None) -> Any:
    """This rank's contiguous rows of a global batch (a tensor, array or
    nested dict), the rows the loader's ``shard=(rank, world)`` gives it:
    axis 0, or axis 1 with ``leading_accum`` (micro-steps stacked in
    front)."""
    r, w = process_shard(rank_, world_)
    if isinstance(batch, dict):
        return {k: shard_batch(v, leading_accum, r, w)
                for k, v in batch.items()}
    if leading_accum:
        return batch[:, _rows(batch.shape[1], r, w)]
    return batch[_rows(batch.shape[0], r, w)]


def gather_rows(x: Any, axis: int = 0) -> Any:
    """Every rank's rows of ``x`` (a tensor, array or nested dict of them)
    concatenated in rank order on ``axis`` — the global batch's rows — on
    rank 0; None on the others; ``x`` itself outside a group.  Ranks' row
    counts and other axes may differ only on ``axis``."""
    if world() == 1:
        return x
    local = _to_host(x)
    parts = all_gather_objects(local)
    if rank() != 0:
        return None
    return _concat(parts, axis)


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return np.asarray(x)


def _concat(parts, axis):
    if isinstance(parts[0], dict):
        return {k: _concat([p[k] for p in parts], axis) for k in parts[0]}
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)
