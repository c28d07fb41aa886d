"""Mixture-of-experts MLP (port of ``layerskip_tpu/ops/moe.py``): the
Mixtral-family ``block_sparse_moe`` and the Qwen3-MoE MLP.

Routing is HF ``MixtralSparseMoeBlock``'s: router logits in the model
dtype, fp32 softmax over all experts, top-k, and (``norm_topk``) the
selected weights renormalized to sum 1. Three exact execution paths, none
of which drops a token:

  * ``few``: each (token, slot) assignment gathers its expert's weights
    (``index_select`` with the device's expert ids, no host read) and
    multiplies them: only the routed experts' weights are read. Decode and
    draft steps, where ``n * k < E``;
  * ``dense``: every expert's MLP for every token, combined with the
    (mostly zero) routing weights. Verify windows and short prompts;
  * ``grouped``: assignments sorted by expert, one product per expert's
    contiguous segment (k/E of the dense path's products). Prefills of
    2048 tokens and more.

The JAX package computes these products with XLA, not with a Pallas
kernel, so plain torch products are their port. A quantized expert stack
goes through ``_qdot`` (the K4-K7 wrappers) in the ``few`` path, as the
JAX package's ``_expert_mm`` does; the other two paths dequantize it to
bf16 first, as the JAX package does.

Under expert parallelism (an ``ep`` axis in the sharded context,
parallel/collectives.py) a rank holds the experts ``[e0, e0 + E/ep)`` of
the stack: routing runs on every rank over all E, each path computes the
share of the resident experts (an assignment to another rank's expert adds
0) and one all-reduce over ep sums the shares. Under tp the experts' F is
split as well, and the caller's all-reduce over tp completes the product;
in training the experts' input and the routing weights (both replicated,
both multiplying a tp-partial product) pass ``copy_to_group``, so their
gradients are summed over tp, while the router's own (replicated) path is
not. With the tokens split over ranks (training's dp and fsdp), the
load-balancing term is the global one: the per-expert sums and the token
count are all-reduced before the product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from layerskip_tpu_torch.ops.linear import QuantTensor, _qdot
from layerskip_tpu_torch.parallel.collectives import all_reduce, axis, copy_to_group

# the JAX package's switch from the dense to the grouped path (measured there)
_GROUPED_MIN_TOKENS = 2048

# calls of ``moe_mlp`` by path taken; a host counter, read by callers that
# report which path a run took (chip_smoke.py phase 10)
PATH_CALLS = {"few": 0, "dense": 0, "grouped": 0}


def reset_path_calls() -> None:
    for key in PATH_CALLS:
        PATH_CALLS[key] = 0


def _dense(w, dtype: torch.dtype) -> torch.Tensor:
    """Expert weights in ``dtype``: a QuantTensor is dequantized to bf16
    (the JAX package's default) and then cast."""
    if isinstance(w, QuantTensor):
        return w.dequantize().to(dtype)
    return w


def route(x2: torch.Tensor, w_router: torch.Tensor, k: int,
          norm_topk: bool = True,
          aux_axes: tuple = ()) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of ``x2`` [N, D] over ``w_router`` [D, E]: (weights
    [N, k] fp32, expert ids [N, k], the load-balancing term ``E * sum_e
    f_e * P_e`` of this layer as a 0-d fp32 tensor). ``aux_axes`` are the
    axes the tokens are split over: f and P are then means over every
    rank's tokens (one all-reduce of the sums and the count per axis)."""
    e = w_router.shape[-1]
    logits = x2 @ w_router  # model dtype, like HF's nn.Linear gate
    probs = torch.softmax(logits.float(), dim=-1)  # [N, E]
    topv, topi = torch.topk(probs, k, dim=-1)
    if norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    assign = F.one_hot(topi, e).float().sum(dim=1)  # [N, E]
    if aux_axes:
        stats = torch.cat([assign.sum(dim=0), probs.sum(dim=0),
                           probs.new_full((1,), float(x2.shape[0]))])
        for ax in aux_axes:
            stats = all_reduce(stats, ax)
        f, p = stats[:e] / stats[-1], stats[e:2 * e] / stats[-1]
    else:
        f = assign.mean(dim=0)  # [E], sums to k
        p = probs.mean(dim=0)
    aux = float(e) * (f / k * p).sum()
    return topv, topi, aux


def _expert_mm(xs: torch.Tensor, w, experts: torch.Tensor) -> torch.Tensor:
    """Row ``j`` of ``xs`` [M, K] times expert ``experts[j]`` of the stacked
    ``w`` [E, K, N] (dense or quantized): [M, N] in xs's dtype. The experts
    are gathered on the device (``index_select``), so nothing waits on the
    host; a quantized weight goes through ``_qdot`` one assignment at a
    time (M < E of them)."""
    if isinstance(w, QuantTensor):
        q = w.q.index_select(0, experts)
        s = w.scale.index_select(0, experts)
        return torch.cat([
            _qdot(xs[j:j + 1], QuantTensor(q=q[j], scale=s[j], k_last=w.k_last,
                                           group=w.group))
            for j in range(xs.shape[0])])
    return torch.bmm(xs[:, None, :], w.index_select(0, experts))[:, 0]


def _moe_few(x2, topv, topi, w_gate, w_up, w_down, k: int,
             e0: Optional[int] = None) -> torch.Tensor:
    """Per-assignment expert gather: reads only the routed experts. The
    slots of a token add up in slot order, as the JAX package's unrolled
    loop does. With ``e0`` the stacks hold experts ``[e0, e0 + E_local)``
    only, and an assignment to another expert weighs 0."""
    n = x2.shape[0]
    flat_e = topi.reshape(n * k)
    flat_w = topv.reshape(n * k).to(x2.dtype)
    if e0 is not None:
        n_local = w_gate.shape[0]
        flat_e = flat_e - e0
        resident = (flat_e >= 0) & (flat_e < n_local)
        flat_w = torch.where(resident, flat_w, torch.zeros_like(flat_w))
        flat_e = flat_e.clamp(0, n_local - 1)
    xs = x2.repeat_interleave(k, dim=0)  # [N*k, D]: assignment j reads token j // k
    g = _expert_mm(xs, w_gate, flat_e)
    u = _expert_mm(xs, w_up, flat_e)
    y = _expert_mm(F.silu(g) * u, w_down, flat_e)  # [N*k, D]
    y = (flat_w[:, None] * y).reshape(n, k, -1)
    out = torch.zeros_like(x2)
    for s in range(k):
        out = out + y[:, s]
    return out


def _moe_dense(x2, topv, topi, w_gate, w_up, w_down, n_experts: int,
               e0: Optional[int] = None) -> torch.Tensor:
    """All-experts combine (over the resident experts ``[e0, e0 + E_local)``)."""
    dt = x2.dtype
    cw = torch.zeros((x2.shape[0], n_experts), dtype=torch.float32, device=x2.device)
    cw = cw.scatter_add(1, topi, topv.float()).to(dt)  # [N, E]
    if e0 is not None:
        cw = cw[:, e0:e0 + w_gate.shape[0]]
    g = torch.einsum("nd,edf->nef", x2, _dense(w_gate, dt))
    u = torch.einsum("nd,edf->nef", x2, _dense(w_up, dt))
    a = F.silu(g) * u * cw[:, :, None]
    return torch.einsum("nef,efd->nd", a, _dense(w_down, dt))


def _per_expert(w):
    """The experts of a stacked [E, ...] weight: a tensor's by one
    ``unbind`` (in training its backward stacks the experts' gradients
    once, where indexing per expert would add E stack-sized ones), a
    QuantTensor indexed as it is."""
    return w if isinstance(w, QuantTensor) else w.unbind(0)


def _moe_grouped(x2, topv, topi, w_gate, w_up, w_down, n_experts: int,
                 k: int, e0: Optional[int] = None) -> torch.Tensor:
    """Sort by expert, then one product per resident expert's segment (the
    stacks hold experts ``[e0, e0 + E_local)``; other segments add 0)."""
    n, dt = x2.shape[0], x2.dtype
    n_local = w_gate.shape[0]
    e0 = e0 or 0
    w_gate, w_up, w_down = map(_per_expert, (w_gate, w_up, w_down))
    flat_e = topi.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)  # token order kept within an expert
    tok = torch.div(order, k, rounding_mode="floor")
    xs = x2.index_select(0, tok)  # [N*k, D], expert-contiguous
    # the segments' bounds are read on the host: one read per layer of a
    # prefill of _GROUPED_MIN_TOKENS tokens or more
    sizes = torch.bincount(flat_e, minlength=n_experts).tolist()
    y = torch.empty_like(xs) if n_local == n_experts else torch.zeros_like(xs)
    start = 0
    for e, size in enumerate(sizes):
        if size and e0 <= e < e0 + n_local:
            seg = xs[start:start + size]
            a = (F.silu(seg @ _dense(w_gate[e - e0], dt))
                 * (seg @ _dense(w_up[e - e0], dt)))
            y[start:start + size] = a @ _dense(w_down[e - e0], dt)
        start += size
    w_sorted = topv.reshape(n * k).index_select(0, order).to(dt)
    return torch.zeros_like(x2).index_add_(0, tok, y * w_sorted[:, None])


def moe_mlp(x: torch.Tensor, w_router: torch.Tensor, w_gate, w_up, w_down,
            num_experts_per_tok: int, norm_topk: bool = True,
            aux_axes: tuple = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward of ``x`` [B, T, D] with stacked experts ``w_gate``/
    ``w_up`` [E, D, F] and ``w_down`` [E, F, D] (dense or QuantTensor):
    (output [B, T, D], load-balancing term). The path is the JAX package's
    rule: ``few`` when n*k < E, ``grouped`` from 2048 tokens, else
    ``dense``. Under ep the stacks are this rank's experts and the output
    is summed over ep here. ``aux_axes``: ``route``'s."""
    b, t, d = x.shape
    n_experts = w_router.shape[-1]
    n, k = b * t, num_experts_per_tok
    x2 = x.reshape(n, d)
    topv, topi, aux = route(x2, w_router, k, norm_topk, aux_axes)
    tp = axis("tp")
    x2, topv = copy_to_group(x2, tp), copy_to_group(topv, tp)
    ep = axis("ep")
    e0 = None if ep is None else ep.rank * w_gate.shape[0]
    if n * k < n_experts:
        path, out = "few", _moe_few(x2, topv, topi, w_gate, w_up, w_down, k, e0)
    elif n >= _GROUPED_MIN_TOKENS:
        path, out = "grouped", _moe_grouped(x2, topv, topi, w_gate, w_up, w_down,
                                            n_experts, k, e0)
    else:
        path, out = "dense", _moe_dense(x2, topv, topi, w_gate, w_up, w_down, n_experts, e0)
    PATH_CALLS[path] += 1
    return all_reduce(out, ep).reshape(b, t, d).to(x.dtype), aux
