"""Sharding rules: how LlamaParams and the KV cache split over a mesh (port
of ``layerskip_tpu/parallel/sharding.py``).

Megatron-style tensor parallelism, as the JAX package's PartitionSpecs lay
it out:

  * column-parallel (output features on ``tp``): wq, wk, wv (and Qwen2's
    biases), w_gate, w_up
  * row-parallel (input features on ``tp``):     wo, w_down
  * vocab-parallel: embed and lm_head
  * replicated: norms, Qwen3's q/k norms, the MoE router
  * an MoE expert stack's [E] dim on ``ep`` (its feature dims stay on tp)
  * training (``fsdp=True``): every stacked layer weight's [L] dim on
    ``fsdp`` as well (ZeRO-3 style); the embedding, final norm and head
    are not split by it
  * KV cache [L, B, S, Hkv, Dh]: batch on ``dp``, the sequence on ``sp``
    (the engine's ``kv_shard_axis``), kv heads on ``tp``

A spec is a tuple with one mesh-dim name (or None) per dim of the dense
weight, in the place of the JAX package's ``PartitionSpec``. Where GSPMD
would pad a dim the axis does not divide, the port raises instead.
``shard_params`` cuts each rank's slice into its own contiguous tensor (the
kernels take contiguous operands only, and a view would keep the whole
weight alive); the layer functions then issue one all-reduce after ``wo``
and one after ``w_down``, an all-reduce in the embedding lookup and an
all-gather of the logits (models/llama.py). ``gather_params`` is the
inverse: the whole weights on every rank (checkpoints, the export).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams
from layerskip_tpu_torch.ops.kv_cache import KVCache
from layerskip_tpu_torch.ops.linear import QuantTensor
from layerskip_tpu_torch.parallel.collectives import Axis, ShardContext, all_gather

_AXES = ("dp", "fsdp", "tp", "ep", "sp")
# the row-parallel weights: their input features (K) are split over tp
ROW_PARALLEL = ("wo", "w_down")


def layer_specs(attention_bias: bool = False, moe: bool = False, ep: bool = False,
                post_norms: bool = False, qk_norm: bool = False,
                fsdp: bool = False) -> LayerParams:
    """Specs of the stacked [L, ...] layer weights (dense orientation: wq/wk/
    wv [L, out, in], the others [L, in, out]; MoE [L, E, ...]); with
    ``fsdp`` the [L] dim is split over the fsdp axis."""
    l = "fsdp" if fsdp else None  # noqa: E741
    e = "ep" if (moe and ep) else None
    if moe:
        w_gate = w_up = (l, e, None, "tp")
        w_down = (l, e, "tp", None)
    else:
        w_gate = w_up = (l, None, "tp")
        w_down = (l, "tp", None)
    rep = (l, None)
    return LayerParams(
        attn_norm=rep, wq=(l, "tp", None), wk=(l, "tp", None),
        wv=(l, "tp", None), wo=(l, "tp", None), mlp_norm=rep,
        w_gate=w_gate, w_up=w_up, w_down=w_down,
        bq=(l, "tp") if attention_bias else None,
        bk=(l, "tp") if attention_bias else None,
        bv=(l, "tp") if attention_bias else None,
        w_router=(l, None, None) if moe else None,
        post_attn_norm=rep if post_norms else None,
        post_mlp_norm=rep if post_norms else None,
        q_norm=rep if qk_norm else None,
        k_norm=rep if qk_norm else None,
    )


def param_specs(tie_word_embeddings: bool = False, attention_bias: bool = False,
                moe: bool = False, ep: bool = False, post_norms: bool = False,
                qk_norm: bool = False, fsdp: bool = False) -> LlamaParams:
    return LlamaParams(
        embed=("tp", None),  # vocab-parallel embedding
        layers=layer_specs(attention_bias, moe=moe, ep=ep, post_norms=post_norms,
                           qk_norm=qk_norm, fsdp=fsdp),
        final_norm=(None,),
        lm_head=None if tie_word_embeddings else (None, "tp"),
    )


def param_specs_from(params: LlamaParams, fsdp: bool = False, ep: bool = False) -> LlamaParams:
    """``param_specs`` with every family flag read off the params."""
    return param_specs(
        tie_word_embeddings=params.lm_head is None,
        attention_bias=params.layers.bq is not None,
        moe=params.layers.w_router is not None, ep=ep,
        post_norms=params.layers.post_attn_norm is not None,
        qk_norm=params.layers.q_norm is not None, fsdp=fsdp,
    )


def named_specs(specs: LlamaParams) -> dict:
    """name -> spec, under ``training/recipe.trainable_tensors``'s names."""
    named = {"embed": specs.embed, "final_norm": specs.final_norm}
    if specs.lm_head is not None:
        named["lm_head"] = specs.lm_head
    for f in dataclasses.fields(LayerParams):
        spec = getattr(specs.layers, f.name)
        if spec is not None:
            named[f"layers.{f.name}"] = spec
    return named


def kv_cache_spec() -> KVCache:
    # [L, B, S, Hkv, Dh]
    spec = (None, "dp", "sp", "tp", None)
    return KVCache(k=spec, v=spec)


def batch_spec() -> Tuple:
    # [B, T] token ids
    return ("dp", None)


def context_from_mesh(mesh, kv_shard_axis: Optional[str] = None) -> Optional[ShardContext]:
    """The ``ShardContext`` of this rank on ``mesh`` (a ``DeviceMesh`` with
    dims among dp, ep, tp and sp). Dims of size 1 are left out; the dim
    named ``kv_shard_axis`` splits the KV sequence. None for no mesh."""
    if mesh is None:
        if kv_shard_axis is not None:
            raise ValueError("kv_shard_axis requires a mesh")
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if kv_shard_axis is not None and kv_shard_axis not in names:
        raise ValueError(f"kv_shard_axis {kv_shard_axis!r} is not a dim of the mesh {names}")
    kw = {}
    for d, name in enumerate(names):
        key = "sp" if name == kv_shard_axis else name
        if key not in _AXES:
            raise ValueError(f"mesh dim {name!r}: the port shards over {_AXES}")
        n = mesh.size(d)
        if n > 1:
            kw[key] = Axis(group=mesh.get_group(d), size=n, rank=mesh.get_local_rank(d))
    return ShardContext(**kw)


def check_divisible(cfg: ModelConfig, ctx: Optional[ShardContext],
                    batch: Optional[int] = None, seq: Optional[int] = None) -> None:
    """Raise unless every count the context splits divides by its axis: the
    attention and kv heads, the MLP features, the vocab and the experts by
    tp (experts by ep), the layers by fsdp; and, when given, a training
    batch's rows by dp and its sequence by fsdp."""
    if ctx is None:
        return
    tp, ep, dp, fsdp = (1 if a is None else a.size for a in (ctx.tp, ctx.ep, ctx.dp, ctx.fsdp))
    counts = [("num_attention_heads", cfg.num_attention_heads, "tp", tp),
              ("num_key_value_heads", cfg.num_key_value_heads, "tp", tp),
              ("intermediate_size", cfg.intermediate_size, "tp", tp),
              ("vocab_size", cfg.vocab_size, "tp", tp),
              ("num_hidden_layers", cfg.num_hidden_layers, "fsdp", fsdp)]
    if cfg.num_local_experts:
        counts.append(("num_local_experts", cfg.num_local_experts, "ep", ep))
    if batch is not None:
        counts.append(("batch_size", batch, "dp", dp))
    if seq is not None:
        counts.append(("seq_len", seq, "fsdp", fsdp))
    for name, n, ax, k in counts:
        if n % k:
            raise ValueError(f"{name}={n} does not divide by {ax}={k}: the port shards "
                             f"only counts the axis divides")


def _slice(t: torch.Tensor, dim: int, ax: Axis, what: str) -> torch.Tensor:
    n = t.shape[dim]
    if n % ax.size:
        raise ValueError(f"{what}: dim {dim} of size {n} does not divide by {ax.size}")
    step = n // ax.size
    return t.narrow(dim, ax.rank * step, step)


def _shard_quant(w: QuantTensor, spec, axes: dict, what: str) -> QuantTensor:
    """A QuantTensor's slice: dim ``d`` of the dense weight is dim ``d`` of
    ``q`` (packed int4 halves K but keeps its place); int4 scales keep every
    dim (K counts groups), int8 scales drop K. A K split must keep whole
    int4 groups on each rank."""
    q, scale = w.q, w.scale
    nd = len(spec)
    kdim = nd - 1 if w.k_last else nd - 2
    for d, name in enumerate(spec):
        ax = axes.get(name)
        if ax is None:
            continue
        q = _slice(q, d, ax, what)
        if w.group:
            if d == kdim and scale.shape[d] % ax.size:
                raise ValueError(f"{what}: {scale.shape[d]} int4 groups of {w.group} do "
                                 f"not divide by {ax.size}")
            scale = _slice(scale, d, ax, what)
        elif d != kdim:
            scale = _slice(scale, d if d < kdim else d - 1, ax, what)
    return QuantTensor(q=q.contiguous().clone(), scale=scale.contiguous().clone(),
                       k_last=w.k_last, group=w.group)


def _shard(w, spec, axes: dict, what: str):
    if w is None:
        return None
    if isinstance(w, QuantTensor):
        return _shard_quant(w, spec, axes, what)
    split = False
    for d, name in enumerate(spec):
        ax = axes.get(name)
        if ax is not None:
            w = _slice(w, d, ax, what)
            split = True
    return w.contiguous().clone() if split else w


def shard_params(params: LlamaParams, mesh, cfg: Optional[ModelConfig] = None,
                 kv_shard_axis: Optional[str] = None):
    """(this rank's LlamaParams, its ``ShardContext``) on ``mesh``: every
    split weight (dense or QuantTensor) is a contiguous copy of the rank's
    slice; replicated weights are the given tensors. With ``cfg`` the head,
    feature, vocab, expert and layer counts are checked first. On a
    training mesh (an fsdp dim) each rank keeps its contiguous ``L/fsdp``
    layers of every stacked field."""
    ctx = context_from_mesh(mesh, kv_shard_axis)
    if cfg is not None:
        check_divisible(cfg, ctx)
    if ctx is None:
        return params, None
    axes = {name: getattr(ctx, name) for name in ("fsdp", "tp", "ep")}
    specs = param_specs_from(params, fsdp=ctx.fsdp is not None, ep=ctx.ep is not None)
    layers = LayerParams(**{
        f.name: _shard(getattr(params.layers, f.name), getattr(specs.layers, f.name),
                       axes, f.name)
        for f in dataclasses.fields(LayerParams)})
    return LlamaParams(
        embed=_shard(params.embed, specs.embed, axes, "embed"),
        layers=layers,
        final_norm=params.final_norm,
        lm_head=_shard(params.lm_head, specs.lm_head, axes, "lm_head"),
    ), ctx


def shard_tensor(w: torch.Tensor, spec, ctx: Optional[ShardContext], what: str = "") -> torch.Tensor:
    """This rank's slice of one whole weight (or a tensor of its shape,
    such as its AdamW moments) under ``spec``."""
    if ctx is None:
        return w
    return _shard(w, spec, {name: getattr(ctx, name) for name in ("fsdp", "tp", "ep")}, what)


def gather_tensor(w: torch.Tensor, spec, ctx: Optional[ShardContext]) -> torch.Tensor:
    """The whole weight of which ``w`` is this rank's slice under ``spec``
    (every rank's slices, gathered; a collective every rank of the split
    axes joins). Records no gradient."""
    if ctx is None:
        return w
    with torch.no_grad():
        for d, name in enumerate(spec):
            ax = getattr(ctx, name) if name is not None else None
            if ax is not None:
                w = all_gather(w, ax, d)
    return w


def gather_params(params: LlamaParams, ctx: Optional[ShardContext]) -> LlamaParams:
    """The inverse of ``shard_params``: every rank's slices gathered into the
    whole (dense) weights, on every rank, with no gradient (checkpoints and
    the export are independent of the mesh)."""
    if ctx is None:
        return params
    specs = param_specs_from(params, fsdp=ctx.fsdp is not None, ep=ctx.ep is not None)
    return LlamaParams(
        embed=gather_tensor(params.embed, specs.embed, ctx),
        layers=LayerParams(**{
            f.name: (None if getattr(params.layers, f.name) is None else gather_tensor(
                getattr(params.layers, f.name), getattr(specs.layers, f.name), ctx))
            for f in dataclasses.fields(LayerParams)}),
        final_norm=gather_tensor(params.final_norm, specs.final_norm, ctx),
        lm_head=(None if params.lm_head is None
                 else gather_tensor(params.lm_head, specs.lm_head, ctx)))
