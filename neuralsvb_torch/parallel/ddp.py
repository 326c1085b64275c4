"""Data-parallel training over ``torch.distributed``; counterpart of
``neuralsvb_tpu/parallel/mesh.py``.

One process per card, started by ``torchrun --nproc_per_node N``; NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU. The JAX package trains under plain
``jit`` over a ``NamedSharding`` of the batch on a ``data`` axis, so a
``data:N`` step computes what a one-device step computes on the same global
batch: BatchNorm statistics, every masked mean and loss denominator and the
discriminator's ``x_len.max()`` run over the GLOBAL batch. The port keeps
that contract:

- every rank collates the same global batch (identically seeded loaders) and
  keeps its contiguous row block (``process_local_rows``), so padding,
  ``T``, rel-pos and the discriminator's windows agree across ranks;
- inside ``sharded()`` (a training step) the reductions of the models and
  losses go through ``all_sum`` (a differentiable all-reduce whose backward
  is the all-reduce of the gradient) and ``global_max``, so every rank
  computes the global value of every loss;
- random draws with a batch dimension draw the global batch's rows from the
  step's generator and keep this rank's (``draw_rows``);
- ``average_gradients`` all-reduces each optimizer's gradients and divides
  by the world: every rank's backward of the global loss carries the
  world's share of the gradient through the all-reduces, so the mean is the
  global batch's gradient, and clipping then steps every rank identically.

Outside ``sharded()`` (validation, inference, a world of 1) none of this
applies and nothing communicates.

``mesh_shape``: ``data:N`` must equal the launched world; ``''`` means the
launched world (1 without ``torchrun``). A ``model`` axis over more than one
device is GSPMD tensor parallelism, which the port does not do.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_SHARD: Optional[tuple] = None  # (world, rank) inside ``sharded()``


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def launched() -> bool:
    """True under ``torchrun`` (its environment names a world)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1)) if launched() else 1


def rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0)) if launched() else 0


def is_main() -> bool:
    return rank() == 0


def parse_mesh(mesh_shape) -> dict:
    """``'data:4,model:2'`` -> {'data': 4, 'model': 2}; ``''`` -> {}."""
    axes = {}
    for part in str(mesh_shape or "").split(","):
        if part.strip():
            name, _, n = part.partition(":")
            axes[name.strip()] = int(n)
    return axes


def data_parallel_size(mesh_shape) -> int:
    """The data-parallel degree of ``mesh_shape`` in the launched world.
    A ``model`` axis over more than one device, an axis the port does not
    know, or a ``data`` size other than the world raise."""
    axes = parse_mesh(mesh_shape)
    world = world_size()
    if axes.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh_shape {mesh_shape!r}: a model axis is GSPMD tensor parallelism "
            "(neuralsvb_tpu/parallel/mesh.py param_sharding), which the PyTorch port "
            "does not do (ROADMAP.md); use data:N")
    unknown = set(axes) - {"data", "model"}
    if unknown:
        raise ValueError(f"mesh_shape {mesh_shape!r}: unknown axes {sorted(unknown)}")
    n = axes.get("data", world)
    if n != world:
        raise ValueError(
            f"mesh_shape {mesh_shape!r} asks for {n} data-parallel devices but the "
            f"launched world has {world} process(es); start N processes with "
            "torchrun --nproc_per_node N, or set mesh_shape='' for the launched world")
    return n


def init_process_group(device, backend: Optional[str] = None,
                       init_method: Optional[str] = None, world: Optional[int] = None,
                       rank_: Optional[int] = None, timeout_s: float = 600.0):
    """Join the world: the launched one (torchrun's ``env://``), or
    ``world``/``rank_`` at ``init_method``. ``device`` is the one every
    rank was given: ``cuda`` without an index is the rank's own card,
    ``cuda:LOCAL_RANK``, and the backend NCCL; ``cuda:i`` puts every rank
    of the host on card i, where NCCL refuses two ranks, so the backend is
    gloo (it takes CUDA tensors through host memory) unless the host has
    one rank; the CPU takes gloo. ``backend`` overrides the choice.
    Returns the rank's device, or None when there is no world to join."""
    if dist.is_initialized() or (world is None and not launched()):
        return None
    dev = torch.device(device)
    if backend is None:
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        backend = ("nccl" if dev.type == "cuda" and (dev.index is None or ranks_here == 1)
                   else "gloo")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if world is None else dict(world_size=world, rank=rank_)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=timedelta(seconds=timeout_s), **kw)
    return dev


def destroy_process_group() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def process_local_rows(x, world: int, rank_: int, axis: int = 0):
    """Rank ``rank_``'s contiguous row block of a GLOBAL batch array over
    ``world`` ranks (JAX: ``process_local_rows``, mesh.py:84-106)."""
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"global batch dim {n} does not divide over {world} ranks; "
                         "the loader trims batches to a multiple of the world")
    rows = n // world
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(rank_ * rows, (rank_ + 1) * rows)
    return x[tuple(sl)]


def local_batch(batch: dict) -> dict:
    """A collated global batch -> inside ``sharded()``, this rank's rows of
    every array with a batch dimension (``nsamples`` follows; other entries
    pass through); else the batch itself."""
    if _SHARD is None:
        return batch
    world, r = _SHARD
    n = batch["nsamples"]
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = process_local_rows(v, world, r)
        elif isinstance(v, list) and len(v) == n:
            out[k] = list(process_local_rows(np.asarray(v, dtype=object), world, r))
        else:
            out[k] = v
    out["nsamples"] = n // world
    return out


def trim_batch_to_multiple(batch_idxs: list, n: int) -> list:
    """Trim an index batch to a multiple of the data-parallel degree."""
    return batch_idxs[: (len(batch_idxs) // n) * n]


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sharded(world: Optional[int] = None):
    """A training step over this rank's rows of the global batch: the
    reductions below run over the world. A no-op at a world of 1."""
    global _SHARD
    world = world_size() if world is None else world
    saved = _SHARD
    _SHARD = (world, rank()) if world > 1 else None
    try:
        yield
    finally:
        _SHARD = saved


def active() -> bool:
    return _SHARD is not None


def shard_world() -> int:
    return _SHARD[0] if _SHARD else 1


class _AllSum(torch.autograd.Function):
    """The world's sum; its backward is the world's sum of the gradient
    (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllSum.apply(g)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The world's sum of ``x`` inside ``sharded()`` (differentiable), else
    ``x``."""
    return x if _SHARD is None else _AllSum.apply(x)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The world's max of ``x`` inside ``sharded()`` (no gradient), else
    ``x``."""
    if _SHARD is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` over the global batch (every rank holds as many
    elements)."""
    if _SHARD is None:
        return x.mean()
    return all_sum(x.sum()) / (x.numel() * _SHARD[0])


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)`` of a tensor whose dim 0 is the batch: inside
    ``sharded()`` the global batch's draw, this rank's rows of it, so the
    ranks together draw what one process draws for the global batch."""
    if _SHARD is None or len(shape) == 0:
        return draw(shape)
    world, r = _SHARD
    b = shape[0]
    full = draw((b * world,) + tuple(shape[1:]))
    return full[r * b:(r + 1) * b]


def average_gradients(params: List[torch.Tensor]) -> None:
    """All-reduce the gradients of ``params`` and divide by the world, in
    one flat buffer per dtype (see the module docstring)."""
    if _SHARD is None:
        return
    world = _SHARD[0]
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(world)
        torch._foreach_copy_(grads, [t.view_as(g) for t, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])
