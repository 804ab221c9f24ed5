"""Data parallelism over torch.distributed: N ranks, one global batch.

Counterpart of acfm_video_3d_reconstruction_tpu/parallel/mesh.py. There,
one SPMD program runs over a 1-D ('data',) mesh: batch leaves shard on
their leading axis, parameters replicate and XLA inserts the gradient
all-reduce, so a run over many devices equals a run over one device on the
whole batch. Here each rank runs the same step on its contiguous block of
the global batch (`shard_batch`), and the steps reduce explicitly what the
global program computes over the whole batch:
  * BatchNorm batch statistics in train mode (models/nn_blocks.py, through
    `all_reduce_autograd`, so that the backward sees them too);
  * the gradients: one flat, bucketed all-reduce over every trainable
    tensor in one fixed order, averaged (`all_reduce_grads`). Every batch
    term of both training losses is a mean over the leading axis, and the
    priors do not depend on the batch, so the average of the ranks'
    gradients is the gradient of the whole-batch loss;
  * the multiplex write-backs: every rank brings all ranks' rows together
    in rank order before it writes (`gather_rows`), so "last occurrence in
    (B, T) order" holds over the global batch;
  * the logged metrics: global means (`reduce_metrics`).
The multiplex tables replicate on every rank (the JAX module's frame-row
sharding has no counterpart); their gradients join the all-reduce, so the
Adam moments stay equal across ranks. Only all_reduce and broadcast are
used: gloo carries CUDA tensors for these two only.

Without a process group every function here leaves its input as it is,
and the steps take their one-process path.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Iterable

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BUCKET_ELEMS = 1 << 22  # elements per gradient all-reduce (16 MiB of f32)
TIMEOUT_S = 600.0       # default timeout of every collective of a group


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """Rank 0 (or no group): the rank that logs, saves and draws."""
    return rank() == 0


def init(backend: str, init_method: str, world: int, rank_: int,
         device: torch.device | None = None, timeout_s: float = TIMEOUT_S) -> None:
    """Initialise the default process group: `backend` "nccl" (give the
    rank's CUDA `device`) or "gloo", `init_method` e.g. "env://",
    "file:///path" or "tcp://localhost:PORT"; every collective times out
    after `timeout_s` seconds."""
    kw = {"device_id": device} if backend == "nccl" and device is not None else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank_, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def init_from_env(device: str | torch.device = "cuda") -> torch.device:
    """Join the group that a launcher such as `torchrun` describes in the
    environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    NCCL on cuda:LOCAL_RANK for a CUDA `device`, gloo for the CPU. Without
    WORLD_SIZE nothing is initialised and `device` is returned as given;
    with a group already initialised it is joined as it is. Returns this
    rank's device (the counterpart of the JAX driver's make_mesh() over
    every visible device)."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ and not active():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not active():
        init("nccl" if device.type == "cuda" else "gloo", "env://",
             int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device)
    return device


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (an all_reduce of one element on the group's
    device); nothing without a group."""
    if not active():
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    dist.all_reduce(torch.zeros(1, device=dev))


def _warn_replicated(what: str, shape, n: int) -> None:
    """The JAX module's loud fallback: a leading axis that the world size
    does not divide loses the data-parallel split."""
    logger.warning(
        "shard fallback: %s with shape %s replicates on a %d-rank group "
        "(leading axis not divisible by %d) — data parallelism lost for this "
        "batch", what, tuple(shape), n, n,
    )


def shard_batch(batch: dict, world: int | None = None, rank_: int | None = None) -> dict:
    """This rank's contiguous block of every array leaf's leading axis.

    The (B, T, ...) leaves and the flattened (B*T, ...) ones (edt, bdt,
    boundaries) are cut into the same W blocks, so both keep the same clips.
    When W does not divide some leaf's leading axis, every rank keeps the
    whole batch, with a `shard fallback` warning: the result stays equal to
    one process on the whole batch, only the split is lost. Scalars and
    non-array entries pass through. `world` / `rank_` default to the group's.
    """
    W = world_size() if world is None else world
    r = rank() if rank_ is None else rank_
    if W == 1:
        return batch
    leaves = {k: v for k, v in batch.items() if hasattr(v, "shape") and len(v.shape) > 0}
    bad = {k: v.shape for k, v in leaves.items() if v.shape[0] % W}
    if bad:
        for k, shape in bad.items():
            _warn_replicated(f"batch leaf {k!r}", shape, W)
        return batch
    out = dict(batch)
    for k, v in leaves.items():
        n = v.shape[0] // W
        out[k] = v[r * n:(r + 1) * n]
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_autograd(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: its backward sums the
    ranks' gradients, as the global program's backward does."""
    return _AllReduceSum.apply(x)


def _buckets(tensors: list, limit: int):
    """Consecutive runs of `tensors` of one dtype and device, at most
    `limit` elements each (a larger tensor alone)."""
    run, n = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or n + t.numel() > limit):
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Average the parameters' .grad over the ranks, in place: flat buckets
    of BUCKET_ELEMS elements in the order of `params`, one all_reduce each.
    Parameters without a gradient are skipped; every rank runs the same
    graph, so every rank reduces the same list."""
    grads = [p.grad for p in params if p.grad is not None]
    W = world_size()
    for bucket in _buckets(grads, BUCKET_ELEMS):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(W)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


@torch.no_grad()
def reduce_metrics(metrics: dict) -> dict:
    """The metrics' means over the ranks (each rank's value is a mean over
    its block, or a prior equal on every rank), in one all_reduce."""
    if not active():
        return metrics
    names = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float().reshape(()) for k in names])
    dist.all_reduce(vals)
    vals.div_(world_size())
    return dict(zip(names, vals.unbind(0)))


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's (n, ...) block stacked in rank order -> (W*n, ...): each
    rank writes its block into a zero buffer of the global size and the
    buffers are summed (exact: one nonzero term per element). Every rank
    must pass the same shape."""
    if not active():
        return x
    n, r = x.shape[0], rank()
    buf = x.new_zeros((world_size() * n,) + tuple(x.shape[1:]))
    buf[r * n:(r + 1) * n] = x
    dist.all_reduce(buf)
    return buf
