"""Data parallelism across GPUs with ``torch.distributed`` (counterpart of
``lightning_pose_tpu/parallel/mesh.py``; the module keeps the JAX name).

The JAX package puts one 1-D ``Mesh`` over its chips and lets GSPMD shard
the batch: gradient all-reduce, metric averaging and cross-replica
BatchNorm fall out of XLA's partitioner. Here each GPU is one process, one
rank of a process group (NCCL between CUDA devices, gloo between CPU ranks),
and the collectives are explicit:

- every rank builds the same global batch from the same seed and keeps its
  rows (:func:`shard_rows`);
- after the backward, :func:`all_reduce_gradients` averages the gradients
  in one flattened bucket;
- what needs the whole batch after the model (the losses over a window
  whose temporal term crosses the split) takes every rank's rows through
  :func:`gather_rows`;
- ``models/backbones/resnet.BatchNorm2d`` all-reduces its statistics.

A group comes up in one of two ways. ``train()`` with ``training.num_gpus``
above 1 spawns one process a device on this host over a loopback store and
calls :func:`initialize_distributed` with explicit arguments
(``one_host=True``). Otherwise each process joins a group it is given:
``LP_TPU_COORDINATOR`` (``host:port``), ``LP_TPU_NUM_PROCESSES`` and
``LP_TPU_PROCESS_ID``, as in the JAX package, or torchrun's ``env://``
variables, the counterpart of ``jax.distributed``'s auto-detection.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist
from torch import nn

logger = logging.getLogger(__name__)

__all__ = [
    "all_reduce_gradients",
    "devices",
    "gather_rows",
    "initialize_distributed",
    "local_device",
    "make_mesh",
    "rank",
    "replicate",
    "shard_rows",
    "stream_shard",
    "sync_collectives",
    "world_size",
]

# whether every rank of the group runs on this host (the spawned launch):
# the unlabeled stream is then one stream split by frames, not one a rank
_one_host = True


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    one_host: bool = False,
) -> None:
    """Join the process group, unless one is up already.

    Explicit arguments win; otherwise ``LP_TPU_COORDINATOR``,
    ``LP_TPU_NUM_PROCESSES`` and ``LP_TPU_PROCESS_ID``; otherwise torchrun's
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    A coordinator is ``host:port`` or a URL (``tcp://host:port``).
    ``backend``: ``nccl`` or ``gloo`` (default NCCL where CUDA is available,
    gloo otherwise). ``one_host``: every rank runs on this host, and the
    ranks share one unlabeled stream (:func:`stream_shard`).
    """
    global _one_host
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("LP_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("LP_TPU_NUM_PROCESSES"):
        num_processes = int(os.environ["LP_TPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("LP_TPU_PROCESS_ID"):
        process_id = int(os.environ["LP_TPU_PROCESS_ID"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError(
                "a coordinator address needs the number of processes and this process's id "
                "(LP_TPU_NUM_PROCESSES, LP_TPU_PROCESS_ID)"
            )
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")
    _one_host = bool(one_host)
    logger.info(f"torch.distributed up ({backend}): rank {rank()} of {world_size()}")
    # meet once while the processes are still in step: the first collective
    # of training comes after each rank's data loading and model set-up
    sync_collectives()


def stream_shard() -> tuple[int, int]:
    """``(shard_id, num_shards)`` of the unlabeled stream: ``(0, 1)`` when
    every rank runs on this host (one stream, split by frames), else one
    shard a rank (each decodes its own, as each host does in the JAX
    package)."""
    if _one_host or world_size() == 1:
        return 0, 1
    return rank(), world_size()


def local_device(device_type: str) -> torch.device:
    """This rank's device: the CPU, or the GPU of its local rank
    (``LOCAL_RANK``, else the rank modulo the visible GPUs)."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank() % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def devices(num_devices: int | None = None) -> list[torch.device]:
    """The GPUs this process sees, the first ``num_devices`` of them (all by
    default); the CPU when there is none. Data-parallel prediction makes one
    replica a device of this list (the tests replace it)."""
    found = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] or [torch.device("cpu")]
    return found if num_devices is None else found[:num_devices]


def make_mesh(num_devices: int | None = None) -> list[torch.device]:
    """The first ``num_devices`` devices of :func:`devices`; raises if fewer
    are visible, as the JAX package's ``make_mesh`` does."""
    found = devices()
    if num_devices is not None and num_devices > len(found):
        raise ValueError(f"requested {num_devices} devices but only {len(found)} available")
    return found if num_devices is None else found[:num_devices]


def shard_rows(x, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch ``x`` (a tensor or an array):
    the ``rank``-th of ``world`` equal slices of axis 0. Raises when the
    batch does not divide, as the JAX package's sharding does."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not divide over {world} ranks")
    m = n // world
    return x[rank * m:(rank + 1) * m]


class _GatherRows(torch.autograd.Function):
    """All-gather of equal row blocks along axis 0; the backward keeps this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.rank, ctx.rows = dist.get_rank(), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order (``x`` itself
    with one rank).

    Differentiable for a loss that every rank computes alike on the gathered
    batch: each rank's gradient is then its own block of the gathered
    gradient, with no communication. Each rank's parameter gradients are its
    rows' share of the whole; :func:`all_reduce_gradients` averages them, so
    such a loss is multiplied by the world size before the backward."""
    if world_size() == 1:
        return x
    return _GatherRows.apply(x)


def all_reduce_gradients(params) -> None:
    """Average the gradients of ``params`` over the ranks, in one flattened
    bucket (float32, or float64 for float64 parameters). A parameter with no gradient on some rank enters as
    zeros there, so that every rank steps the same set of parameters; one
    with no gradient on any rank keeps none."""
    world = world_size()
    if world == 1:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    device = params[0].device
    dtype = torch.float64 if any(p.dtype == torch.float64 for p in params) else torch.float32
    has = torch.tensor([p.grad is not None for p in params], dtype=dtype, device=device)
    bucket = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).to(dtype) for p in params] + [has]
    )
    dist.all_reduce(bucket)
    offset = 0
    flags = bucket[-len(params):].tolist()
    for p, flag in zip(params, flags):
        n = p.numel()
        if flag > 0:
            p.grad = bucket[offset:offset + n].view_as(p).div_(world).to(p.dtype)
        offset += n


def replicate(module: nn.Module) -> None:
    """Broadcast ``module``'s parameters and buffers from rank 0, so that
    every rank starts from rank 0's state."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for tensor in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(tensor.data, src=0)


def sync_collectives() -> None:
    """A barrier over the group (none without one)."""
    if world_size() > 1:
        dist.barrier()
