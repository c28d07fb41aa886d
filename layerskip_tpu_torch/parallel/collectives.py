"""The port's collectives and the sharded context the layer functions read.

The JAX package declares shardings and lets GSPMD insert the collectives;
the port shards explicitly (Megatron style): every rank holds its own
contiguous slice of the weights and of the KV, and the layer functions issue
the collectives themselves through the functions below.

``ShardContext`` names the process groups of a sharded run, one ``Axis``
per mesh dimension that splits something: ``dp`` (batch rows), ``fsdp``
(training: the stacked layers and the sequence), ``tp`` (heads, MLP
features, vocab), ``ep`` (MoE experts) and ``sp`` (the KV cache's
sequence dim). An axis of size 1 is left out (None), so it costs nothing;
``sharded(ctx)`` makes a context current for the code it wraps (the
engine enters it around every call, the train step around each step), and
``axis(name)`` reads it.

The collectives are ``torch.autograd.Function``s with Megatron's rules
(inference runs them under no_grad and computes what their plain forms
did): ``all_reduce`` (gradient unchanged: g), ``copy_to_group``
(identity, gradient summed: f), ``all_gather`` (gradient sliced on a
replicated axis, reduce-scattered on a summed one, by argument),
``reduce_scatter``, ``split``, ``ring_shift`` and ``broadcast_from``
(gradient summed onto the owner). Over tp each rank computes the same
loss; over dp and fsdp each computes a part of a summed one.

Every collective goes through this module. A gloo group takes tensors in
host memory only for some operations, so a CUDA tensor on a gloo group is
staged through host memory here (``_wire``, ``_host_stage``) and nowhere
else; an NCCL group takes the device tensor as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

# calls of each collective, by name: a host counter, read by callers that
# report that a run went through its collectives (chip_smoke.py phase 12)
CALLS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0, "ring_shift": 0,
         "broadcast_from": 0, "reduce_to": 0, "broadcast_object": 0}

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
    fsdp: Optional[Axis] = None
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


def _wire(dev: torch.device, group) -> torch.device:
    """Where a collective over ``group`` takes a tensor of ``dev``: a gloo
    group takes CUDA tensors through host memory, everything else as it
    is. The one place the port stages collectives through the host."""
    return torch.device("cpu") if dev.type == "cuda" and dist.get_backend(group) == "gloo" \
        else dev


def _host_stage(x: torch.Tensor, group, copy: bool) -> torch.Tensor:
    """The tensor to hand a collective for ``x``: on the wire's device
    (``_wire``), contiguous, and a copy of ``x`` when ``copy`` (the
    collective writes into it). ``_unstage`` brings a result back to
    ``x``'s device."""
    wire = _wire(x.device, group)
    if wire != x.device:
        return torch.empty(x.shape, dtype=x.dtype, device=wire).copy_(x)
    return x.contiguous().clone() if copy else x.contiguous()


def _unstage(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y if y.device == like.device else y.to(like.device)


def _global(ax: Axis, rank: int) -> int:
    """The global rank of ``ax``'s rank ``rank``."""
    return dist.get_global_rank(ax.group, rank)


# ---------------------------------------------------------------- the wire
# Each of these issues one collective (counted in CALLS) and records no
# gradient; the autograd Functions below are built from them.


def _reduce(x: torch.Tensor, ax: Axis, op: str) -> torch.Tensor:
    CALLS["all_reduce"] += 1
    y = _host_stage(x, ax.group, copy=True)
    dist.all_reduce(y, op=_OPS[op], group=ax.group)
    return _unstage(y, x)


def _gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    CALLS["all_gather"] += 1
    src = _host_stage(x, ax.group, copy=False)
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return _unstage(torch.cat(parts, dim=dim), x)


def _own(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (a contiguous copy)."""
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"dim {dim} of size {n} does not divide by {ax.size}")
    step = n // ax.size
    return x.narrow(dim, ax.rank * step, step).contiguous()


def _reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The sum over ``ax``, this rank's chunk along ``dim``: an all-reduce
    and a slice (gloo has no reduce-scatter; the same path on every
    backend)."""
    CALLS["reduce_scatter"] += 1
    return _own(_reduce(x, ax, "sum"), ax, dim)


def _shift(x: torch.Tensor, ax: Axis, step: int) -> torch.Tensor:
    """``x`` of the rank ``step`` places back along ``ax`` (this rank's
    goes ``step`` places on, cyclically)."""
    CALLS["ring_shift"] += 1
    send = _host_stage(x, ax.group, copy=False)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _global(ax, (ax.rank + step) % ax.size), ax.group),
           dist.P2POp(dist.irecv, recv, _global(ax, (ax.rank - step) % ax.size), ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _unstage(recv, x)


def _layout(tensors) -> Tuple[dict, list]:
    """(numel of each dtype's buffer, the (dtype, offset) of each tensor):
    ``tensors`` laid end to end, one flat buffer per dtype."""
    sizes, where = {}, []
    for t in tensors:
        off = sizes.get(t.dtype, 0)
        where.append((t.dtype, off))
        sizes[t.dtype] = off + t.numel()
    return sizes, where


def _flat(tensors) -> dict:
    bufs = {}
    for t in tensors:
        bufs.setdefault(t.dtype, []).append(t.reshape(-1))
    return {dt: torch.cat(parts) for dt, parts in bufs.items()}


def _unflat(bufs: dict, where: list, like) -> list:
    return [bufs[dt][off:off + t.numel()].view(t.shape) for (dt, off), t in zip(where, like)]


def _broadcast(tensors, ax: Axis, owner: int) -> list:
    """The owner's ``tensors`` on every rank of ``ax`` (one broadcast per
    dtype); other ranks' ``tensors`` give only shapes and dtypes."""
    CALLS["broadcast_from"] += 1
    sizes, where = _layout(tensors)
    dev = tensors[0].device
    if ax.rank == owner:
        bufs = {dt: _host_stage(b, ax.group, copy=False) for dt, b in _flat(tensors).items()}
    else:  # received straight into a buffer on the wire's device
        wire = _wire(dev, ax.group)
        bufs = {dt: torch.empty(n, dtype=dt, device=wire) for dt, n in sizes.items()}
    for buf in bufs.values():
        dist.broadcast(buf, src=_global(ax, owner), group=ax.group)
    return _unflat({dt: b.to(dev) for dt, b in bufs.items()}, where, tensors)


def _reduce_to(tensors, ax: Axis, owner: int) -> Optional[list]:
    """The sum over ``ax`` of ``tensors`` on the owner (one reduce per
    dtype); None on the other ranks."""
    CALLS["reduce_to"] += 1
    _, where = _layout(tensors)
    bufs = _flat(tensors)
    for dt, buf in bufs.items():
        staged = _host_stage(buf, ax.group, copy=False)
        dist.reduce(staged, dst=_global(ax, owner), op=dist.ReduceOp.SUM, group=ax.group)
        bufs[dt] = _unstage(staged, buf)
    return _unflat(bufs, where, tensors) if ax.rank == owner else None


# ------------------------------------------------------- differentiable
# Megatron's rules. Over tp, activations and the loss are the same on every
# rank (replicated); over dp and fsdp, each rank holds a part of the batch
# and the loss is the sum of the ranks' parts. ``all_reduce`` is Megatron's
# g (its gradient passes through), ``copy_to_group`` its f (the identity
# whose gradient is summed: put it in front of a product whose output
# features are split), and ``all_gather`` names its axis's kind.


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, op):
        ctx.op = op
        return _reduce(x, ax, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op != "sum":
            raise RuntimeError(f"no gradient through a {ctx.op} all-reduce")
        return g, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.ax, "sum"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, grad):
        ctx.ax, ctx.dim, ctx.grad = ax, dim, grad
        return _gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "slice":
            return _own(g, ctx.ax, ctx.dim), None, None, None
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_scatter(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.ax, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _own(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.ax, ctx.dim), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _shift(x, ax, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.ax, -1), None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, owner, *tensors):
        ctx.ax, ctx.owner = ax, owner
        ctx.meta = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(_broadcast(tensors, ax, owner))

    @staticmethod
    def backward(ctx, *grads):
        # an output no loss reached has no gradient: it sends zeros, so
        # every rank's buffers have the same layout
        grads = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
                 for g, (shape, dt, dev) in zip(grads, ctx.meta)]
        summed = _reduce_to(grads, ctx.ax, ctx.owner)
        if summed is None:
            return (None, None) + (None,) * len(grads)
        return (None, None, *summed)


def all_reduce(x: torch.Tensor, ax: Optional[Axis], op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``sum`` or ``max``) over ``ax``; a new tensor, every
    rank's bit for bit the same. ``x`` itself when ``ax`` is None. Its
    gradient is the output's, unchanged (Megatron's g: after a product
    whose input features are split over tp, and for a statistic every rank
    adds to its own part of a summed loss); a ``max`` has none."""
    if ax is None:
        return x
    return _AllReduce.apply(x, ax, op)


def all_reduce_(tensors, ax: Optional[Axis]) -> None:
    """Sum each of ``tensors`` over ``ax`` in place (one buffer per dtype,
    no gradient recorded): gradients of weights every rank of ``ax``
    holds."""
    if ax is None or not tensors:
        return
    _, where = _layout(tensors)
    bufs = {dt: _reduce(b, ax, "sum") for dt, b in _flat([t.detach() for t in tensors]).items()}
    with torch.no_grad():
        for t, got in zip(tensors, _unflat(bufs, where, tensors)):
            t.copy_(got)


def copy_to_group(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``ax`` (Megatron's f, in
    front of a product whose output features are split over tp: each rank's
    gradient of the replicated input is a partial sum)."""
    if ax is None:
        return x
    return _CopyToGroup.apply(x, ax)


def all_gather(x: torch.Tensor, ax: Optional[Axis], dim: int,
               grad: str = "slice") -> torch.Tensor:
    """Every rank's ``x`` along ``ax``, concatenated along ``dim`` in rank
    order. ``x`` itself when ``ax`` is None. ``grad`` names the axis's
    kind for the backward: ``slice`` where every rank computes the same
    loss from the gathered tensor (tp: this rank's chunk of the gradient),
    ``sum`` where each rank's loss is a part of a summed one (dp, fsdp:
    the chunks summed over the ranks, a reduce-scatter)."""
    if ax is None:
        return x
    if grad not in ("slice", "sum"):
        raise ValueError(f"grad must be 'slice' or 'sum', not {grad!r}")
    return _AllGather.apply(x, ax, dim, grad)


def reduce_scatter(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``ax``, this rank's chunk along ``dim``; its
    gradient is the output's gathered over ``ax``."""
    if ax is None:
        return x
    return _ReduceScatter.apply(x, ax, dim)


def split(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` (the same on every rank of ``ax``) along
    ``dim``; its gradient is the output's gathered over ``ax``, so every
    rank holds the whole gradient of the replicated ``x``."""
    if ax is None:
        return x
    return _Split.apply(x, ax, dim)


def ring_shift(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The previous rank's ``x`` on ``ax``'s ring: this rank's ``x`` goes
    to the next rank. The gradient travels the other way."""
    if ax is None:
        return x
    return _RingShift.apply(x, ax)


def broadcast_from(tensors, ax: Optional[Axis], owner: int) -> list:
    """The ``owner``'s ``tensors`` (a list; one dtype's tensors travel as
    one buffer) on every rank of ``ax``; the others pass tensors of the
    same shapes and dtypes, which only give the shapes. The gradient is
    summed over ``ax`` onto the owner's tensors (fsdp: a layer's weights
    live on one rank, every rank uses them, and each rank's loss is a part
    of the sum); the other ranks' tensors get none from this call."""
    if ax is None:
        return list(tensors)
    return list(_BroadcastFrom.apply(ax, owner, *tensors))


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
