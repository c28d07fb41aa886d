"""The port's collectives and the sharded context the layer functions read.

The JAX package declares shardings and lets GSPMD insert the collectives;
the port shards explicitly (Megatron style): every rank holds its own
contiguous slice of the weights and of the KV, and the layer functions issue
the collectives themselves through the functions below.

``ShardContext`` names the process groups of a sharded run, one ``Axis``
per mesh dimension that splits something: ``dp`` (batch rows), ``tp``
(heads, MLP features, vocab), ``ep`` (MoE experts) and ``sp`` (the KV
cache's sequence dim). An axis of size 1 is left out (None), so it costs
nothing; ``sharded(ctx)`` makes a context current for the code it wraps
(the engine enters it around every call), and ``axis(name)`` reads it.

Every collective goes through this module. A gloo group takes tensors in
host memory only for some operations, so a CUDA tensor on a gloo group is
staged through host memory here, in ``_host_stage``, and nowhere else; an
NCCL group takes the device tensor as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

# calls of each collective, by name: a host counter, read by callers that
# report that a run went through its collectives (chip_smoke.py phase 12)
CALLS = {"all_reduce": 0, "all_gather": 0, "broadcast_object": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh dimension as this rank sees it: the process group of the
    ranks that differ only along it, its size and this rank's index."""

    group: Any
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class ShardContext:
    dp: Optional[Axis] = None
    tp: Optional[Axis] = None
    ep: Optional[Axis] = None
    sp: Optional[Axis] = None


_CTX: contextvars.ContextVar = contextvars.ContextVar("layerskip_torch_shard",
                                                      default=None)


@contextlib.contextmanager
def sharded(ctx: Optional[ShardContext]):
    """Make ``ctx`` (None: one device) the current context."""
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


def current() -> Optional[ShardContext]:
    return _CTX.get()


def axis(name: str) -> Optional[Axis]:
    """The current context's axis ``name``, or None (not split)."""
    ctx = _CTX.get()
    return None if ctx is None else getattr(ctx, name)


def size(ax: Optional[Axis]) -> int:
    return 1 if ax is None else ax.size


def _host_stage(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, ax: Optional[Axis], op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``sum`` or ``max``) over ``ax``; a new tensor, every
    rank's bit for bit the same. ``x`` itself when ``ax`` is None."""
    if ax is None:
        return x
    CALLS["all_reduce"] += 1
    staged = _host_stage(x, ax.group)
    y = x.to("cpu", copy=True) if staged else x.contiguous().clone()
    dist.all_reduce(y, op=_OPS[op], group=ax.group)
    return y.to(x.device) if staged else y


def all_gather(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``ax``, concatenated along ``dim`` in rank
    order. ``x`` itself when ``ax`` is None."""
    if ax is None:
        return x
    CALLS["all_gather"] += 1
    staged = _host_stage(x, ax.group)
    src = x.to("cpu") if staged else x
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable object) on every rank; ``obj`` itself
    when no process group is up."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    CALLS["broadcast_object"] += 1
    box = [obj]
    dev = None
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.broadcast_object_list(box, src=0, device=dev)
    return box[0]


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0
