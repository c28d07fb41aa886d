"""LayerSkip training recipe: layer dropout + early-exit loss (port of
``layerskip_tpu/training/recipe.py``).

LayerSkip checkpoints come from the paper's recipe (arXiv 2404.16710 §3),
run during (continual) pretraining or finetuning:

  1. **Layer dropout**: each decoder layer is skipped per sample with a
     rate that grows with depth, ``p_l = p_max * D(l)``; a skipped sample
     passes its hidden state through unchanged, which is what makes early
     exits viable at inference;
  2. **Early-exit loss**: the shared LM head (the one inference exits
     through) is applied after selected layers and their cross-entropies
     are added with normalized weights, optionally on a rotational
     curriculum (one exit of every R active a step).

Plain functions over the port's ``LlamaParams``. ``layerskip_loss`` is
differentiable by autograd; ``make_train_step`` pairs it with
``torch.optim.AdamW`` at optax's ``adamw`` defaults and updates the params'
tensors in place. Layer dropout draws from an explicit ``torch.Generator``
or takes an explicit ``[L, B]`` keep mask (the JAX package draws with
threefry, which torch cannot reproduce). The token-chunked CE recomputes
each chunk's logits in backward through ``torch.utils.checkpoint``, where
the JAX package uses ``jax.checkpoint``.

No kernel of ``ops/cuda`` runs here, and none could: K1-K7 have no
backward. The training layer computes its own causal masked softmax, as
the JAX recipe does, and never calls ``ops/attention.gqa_attention``; the
weights must be dense. The JAX package asks for fp32 results of bf16
products (``preferred_element_type``) in the attention scores and the LM
head; here those go through ``_ProductF32``, whose backward multiplies the
cotangent rounded to the operands' dtype (fp32 operands take plain
autograd products, so fp32 training computes the JAX package's math).

On the JAX package's [dp, fsdp, tp] training mesh
(``parallel/mesh.make_train_mesh``) the sharding is explicit where the
JAX package declares it for GSPMD: rows over dp, the sequence over fsdp
(``act_spec``), Megatron slices over tp (f in front of the
column-parallel products, g after the row-parallel ones), each stacked
layer on one fsdp rank, broadcast when it runs and recomputed in backward
(ZeRO-3), K/V gathered along the sequence or passed around a ring
(``ring_axis``). Each dp/fsdp rank's loss is its part of the global one
(NLL sums over the global valid count); ``sync_grads`` sums the
gradients of the weights those ranks share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from layerskip_tpu_torch.config import ModelConfig, RopeScaling
from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams, _act, embed_tokens
from layerskip_tpu_torch.ops.linear import QuantTensor, matmul_f32
from layerskip_tpu_torch.ops.moe import moe_mlp
from layerskip_tpu_torch.ops.ring_attention import ring_attention
from layerskip_tpu_torch.ops.rmsnorm import rms_norm
from layerskip_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from layerskip_tpu_torch.parallel.collectives import (
    ShardContext,
    all_gather,
    all_reduce,
    all_reduce_,
    axis,
    broadcast_from,
    copy_to_group,
    current,
    sharded,
)
from layerskip_tpu_torch.parallel.sharding import context_from_mesh

NEG_INF = -1e30  # the JAX recipe's fill for masked scores
# the one activation layout the port shards: rows over dp, sequence over fsdp
ACT_SPEC = ("dp", "fsdp", None)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """LayerSkip recipe knobs: the JAX package's fields and defaults."""

    p_max: float = 0.1  # max layer-dropout rate (deepest layer)
    dropout_scale: str = "exp"  # "exp" | "linear" | "none"
    # exits AFTER these layer indices; () => evenly spaced quarter-depth exits
    # (each costs one vocab projection a step)
    early_exit_layers: Tuple[int, ...] = ()
    e_scale: float = 1.0  # early-exit loss scale
    rotational_r: int = 0  # R>0: only every R-th exit active, rotating per step
    # token-chunked CE: at most [chunk, V] fp32 logits live at once, each
    # chunk's recomputed in backward; 0 => dense [B, T, V] CE
    ce_chunk_tokens: int = 1024
    # activation sharding on a training mesh: ("dp", "fsdp", None) splits
    # the [B, T, D] residual stream's rows over dp and its sequence over
    # fsdp (the only layout the port takes; None on a mesh without dp or
    # fsdp); ring_axis="fsdp" runs attention as a ring over that axis
    act_spec: Optional[Tuple[Optional[str], ...]] = None
    ring_axis: Optional[str] = None
    # MoE router load-balancing loss coefficient (Mixtral default 0.02), on
    # the per-layer aux term averaged over layers; ignored for dense models
    moe_aux_coef: float = 0.02
    label_smoothing: float = 0.0
    learning_rate: float = 1e-4
    weight_decay: float = 0.01

    def __post_init__(self):
        if self.act_spec is not None and tuple(self.act_spec) != ACT_SPEC:
            raise ValueError(f"act_spec={self.act_spec}: the port shards activations as "
                             f"{ACT_SPEC} only")


def depth_scale(layer_idx: torch.Tensor, num_layers: int, kind: str) -> torch.Tensor:
    """D(l): per-layer dropout scaling in [0, 1] (deeper => larger), fp32."""
    if num_layers <= 1 or kind == "none":
        return torch.ones_like(layer_idx, dtype=torch.float32)
    frac = layer_idx.float() / (num_layers - 1)
    if kind == "linear":
        return frac
    # exponential ramp, normalized so D(0) = 0 and D(L-1) = 1
    return (torch.exp(frac * math.log(2.0)) - 1.0) / (2.0 - 1.0)


def exit_loss_weights(exit_layers: Tuple[int, ...], num_layers: int, e_scale: float,
                      rotational_r: int, step: Union[int, torch.Tensor],
                      device=None) -> torch.Tensor:
    """Normalized early-exit loss weights per exit (final layer excluded):
    ``(l + 1) / L``, so later exits weigh more; with a rotational
    curriculum R only exits with ``idx % R == step % R`` are active."""
    w = (torch.tensor(exit_layers, dtype=torch.float32, device=device) + 1.0) / num_layers
    if rotational_r > 0:
        idx = torch.arange(len(exit_layers), device=device)
        active = (idx % rotational_r) == (step % rotational_r)
        w = torch.where(active, w, 0.0)
    total = torch.clamp(w.sum(), min=1e-9)
    return e_scale * w / total


def default_exit_layers(num_layers: int) -> Tuple[int, ...]:
    """Sparse default exit set, evenly spaced at quarter depth: (8, 16, 24)
    at 32 layers."""
    step = max(num_layers // 4, 1)
    return tuple(range(step, num_layers, step))


class _ProductF32(torch.autograd.Function):
    """``a [..., M, K] @ b`` (``[K, N]``, or ``[..., K, N]`` with a's batch
    dims) with an fp32 result from operands in one lower dtype, the JAX
    package's ``preferred_element_type=float32`` product. The forward is
    ``matmul_f32`` (an fp32-output product on CUDA, which has no
    derivative there) or, batched, ``bmm``'s fp32-output form; the backward
    rounds the fp32 cotangent to the operands' dtype and multiplies in it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if b.dim() == 2:
            return matmul_f32(a, b)
        lead, (m, k), n = a.shape[:-2], a.shape[-2:], b.shape[-1]
        a3, b3 = a.reshape(-1, m, k), b.reshape(-1, k, n)
        if a.is_cuda and hasattr(torch.ops.aten.bmm, "dtype"):
            out = torch.bmm(a3, b3, out_dtype=torch.float32)
        else:
            out = torch.bmm(a3.float(), b3.float())
        return out.reshape(*lead, m, n)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.mT)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
            else:
                gb = torch.matmul(a.mT, g)
        return ga, gb


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    return _ProductF32.apply(a, b)


def _logits(params: LlamaParams, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """``llama.lm_logits`` with a backward: the shared final norm and LM
    head, fp32 logits, Gemma-2's final softcap. Under tp the head is this
    rank's vocab slice: its input's gradient is summed over tp (f) and the
    slices' logits are gathered (each rank's CE is the same)."""
    tp = axis("tp")
    h = copy_to_group(rms_norm(h, params.final_norm, cfg.rms_norm_eps, cfg.norm_offset), tp)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    logits = all_gather(_product_f32(h, head), tp, -1, grad="slice")
    if cfg.final_logit_softcap:
        cap = float(cfg.final_logit_softcap)
        logits = cap * torch.tanh(logits / cap)
    return logits


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float):
    """(per-token NLL with ``-100`` labels zeroed, the valid mask)."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return torch.where(valid, nll, 0.0), valid


def token_cross_entropy(logits: torch.Tensor,  # [B, T, V] fp32
                        labels: torch.Tensor,  # [B, T] (-100 => ignored)
                        label_smoothing: float = 0.0) -> torch.Tensor:
    nll, valid = _token_nll(logits, labels, label_smoothing)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def _in_context(ctx: Optional[ShardContext], fn):
    """``fn`` run inside ``ctx``: a function ``torch.utils.checkpoint``
    recomputes in backward, where the autograd engine's thread does not
    see the caller's context."""
    def run(*args):
        with sharded(ctx):
            return fn(*args)
    return run


def _chunk_nll_sum(params: LlamaParams, cfg: ModelConfig, label_smoothing: float,
                   hc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """Sum of one [chunk] block's NLL: its [chunk, V] fp32 logits live only
    inside this call (recomputed in backward)."""
    logits = _logits(params, cfg, hc[None])[0]
    return _token_nll(logits, lc, label_smoothing)[0].sum()


def _nll_sum(params: LlamaParams, cfg: ModelConfig,
             h: torch.Tensor,  # [B, T, D] pre-final-norm hidden states
             labels: torch.Tensor,  # [B, T]
             label_smoothing: float, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the NLL summed over the valid tokens of lm_logits(h), their count)
    without materializing [B, T, V] fp32: the tokens are zero-padded with
    ``-100`` labels to whole ``chunk``-token blocks, and each block's
    logits are recomputed in backward (``torch.utils.checkpoint``). The
    blocks' sums add in block order, as the JAX package's scan does. Dense
    when ``chunk <= 0`` or ``B*T <= chunk``."""
    b, t, d = h.shape
    if chunk <= 0 or b * t <= chunk:
        nll, valid = _token_nll(_logits(params, cfg, h), labels, label_smoothing)
        return nll.sum(), valid.sum()
    hs, ls = h.reshape(b * t, d), labels.reshape(b * t)
    pad = (-hs.shape[0]) % chunk
    if pad:
        hs = torch.cat([hs, hs.new_zeros((pad, d))])
        ls = torch.cat([ls, ls.new_full((pad,), -100)])
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    body = _in_context(current(), _chunk_nll_sum)
    for i in range(hs.shape[0] // chunk):
        blk = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(body, params, cfg, label_smoothing, hs[blk], ls[blk],
                                   use_reentrant=False, preserve_rng_state=False)
    return total, (ls >= 0).sum()


def _causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int]) -> torch.Tensor:
    """Causal GQA self-attention over the sequence itself, the JAX recipe's
    masked softmax: fp32 scores (scaled, Gemma-2's softcap), the causal
    mask and an optional window (0 = global) filled with -1e30, fp32
    softmax, probabilities in v's dtype. q [B, T, Hq, Dh], k/v [B, T, Hkv,
    Dh] -> [B, T, Hq * Dh] in q's dtype. With the sequence split over fsdp,
    q is this rank's positions and k/v are gathered from every rank (each
    rank's loss is a part of the sum: their gradients are reduce-scattered
    back)."""
    seq = axis("fsdp")
    k = all_gather(k, seq, 1, grad="sum")
    v = all_gather(v, seq, 1, grad="sum")
    b, t, hq, dh = q.shape
    s = k.shape[1]
    hkv, g = k.shape[2], hq // k.shape[2]
    qg = q.reshape(b, t, hkv, g, dh).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * t, dh)
    scores = _product_f32(qg, k.permute(0, 2, 3, 1)).reshape(b, hkv, g, t, s)
    scale = cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar else dh ** -0.5
    scores = scores * scale
    if cfg.attn_logit_softcap:  # Gemma-2 score soft-capping
        cap = float(cfg.attn_logit_softcap)
        scores = cap * torch.tanh(scores / cap)
    q_idx = (0 if seq is None else seq.rank * t) + torch.arange(t, device=q.device)
    k_idx = torch.arange(s, device=q.device)
    mask = k_idx[None, :] <= q_idx[:, None]
    if window:
        mask = mask & (k_idx[None, :] > q_idx[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype).reshape(b, hkv, g * t, s)
    out = torch.matmul(probs, v.transpose(1, 2))  # [B, Hkv, G*T, Dh]
    return out.reshape(b, hkv, g, t, dh).permute(0, 3, 1, 2, 4).reshape(b, t, hq * dh)


def _per_layer(layers: LayerParams) -> List[LayerParams]:
    """One ``LayerParams`` of views per layer, taken by one ``unbind`` per
    stacked field: its backward stacks the layers' gradients once, where
    indexing the stack per layer would add L stack-sized gradients."""
    unbound = {f.name: torch.unbind(getattr(layers, f.name))
               for f in dataclasses.fields(LayerParams) if getattr(layers, f.name) is not None}
    return [LayerParams(**{name: ws[i] for name, ws in unbound.items()})
            for i in range(layers.attn_norm.shape[0])]


def _one_layer_dropped(cfg: ModelConfig, lp: LayerParams, h: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, keep: torch.Tensor,
                       window: Optional[int] = None, ring: bool = False):
    """One decoder layer (``lp``: its weights) without a KV cache (the
    full-sequence training pass), with every family branch inference runs: Qwen2 biases,
    Qwen3/Gemma-3 q/k norms, Gemma-2 softcap, post-norms and query scalar,
    the layer's window, the MoE MLP. ``keep`` [B] is 0/1 per sample: a
    dropped sample passes ``h`` through unchanged. Returns (h, the MoE
    load-balancing term or 0).

    Under tp ``lp`` holds this rank's Megatron slices: the normed inputs of
    the column-parallel products pass ``copy_to_group`` (f) and the
    row-parallel outputs one all-reduce (g). With the sequence split over
    fsdp, attention gathers K/V, or with ``ring`` runs the ring."""
    b, t, _ = h.shape
    dh = cfg.head_dim  # the head counts are this rank's (the weights' local shapes)
    eps, off = cfg.rms_norm_eps, cfg.norm_offset
    tp = axis("tp")
    x = copy_to_group(rms_norm(h, lp.attn_norm, eps, off), tp)
    q = torch.nn.functional.linear(x, lp.wq)
    k = torch.nn.functional.linear(x, lp.wk)
    v = torch.nn.functional.linear(x, lp.wv)
    if lp.bq is not None:  # Qwen2-family QKV biases
        q, k, v = q + lp.bq, k + lp.bk, v + lp.bv
    q = q.reshape(b, t, -1, dh)
    k = k.reshape(b, t, -1, dh)
    v = v.reshape(b, t, -1, dh)
    if lp.q_norm is not None:  # Qwen3/Gemma-3 per-head q/k norms, before RoPE
        q = rms_norm(q, lp.q_norm, eps, off)
        k = rms_norm(k, lp.k_norm, eps, off)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if ring:
        attn = ring_attention(q, k, v, axis("fsdp"), window, cfg.attn_logit_softcap,
                              cfg.query_pre_attn_scalar).reshape(b, t, -1)
    else:
        attn = _causal_attention(cfg, q, k, v, window)
    h_attn = all_reduce(attn.to(h.dtype) @ lp.wo, tp)
    if lp.post_attn_norm is not None:  # Gemma-2/3 post-sublayer norm
        h_attn = rms_norm(h_attn, lp.post_attn_norm, eps, off)
    h1 = h + h_attn
    x = rms_norm(h1, lp.mlp_norm, eps, off)
    if lp.w_router is not None:  # Mixtral-family MoE MLP (f inside, on the experts' side)
        mlp_out, aux = moe_mlp(x, lp.w_router, lp.w_gate, lp.w_up,
                               lp.w_down, cfg.num_experts_per_tok,
                               norm_topk=cfg.norm_topk_prob,
                               aux_axes=_token_axes())
    else:
        x = copy_to_group(x, tp)
        mlp_out = (_act(cfg, x @ lp.w_gate) * (x @ lp.w_up)) @ lp.w_down
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    mlp_out = all_reduce(mlp_out, tp)
    if lp.post_mlp_norm is not None:  # Gemma-2/3
        mlp_out = rms_norm(mlp_out, lp.post_mlp_norm, eps, off)
    h2 = h1 + mlp_out
    keep = keep.to(h.dtype)[:, None, None]
    return keep * h2 + (1.0 - keep) * h, aux


def _token_axes() -> tuple:
    """The axes of the current context that split the batch's tokens (dp
    rows, fsdp sequence): the loss is the sum of their ranks' parts."""
    return tuple(a for a in (axis("dp"), axis("fsdp")) if a is not None)


def _layer_weights(local: List[LayerParams], i: int, num_layers: int) -> LayerParams:
    """Layer ``i``'s weights. Under fsdp rank ``i // (L/fsdp)`` holds them
    (as its local layer ``i % (L/fsdp)``) and broadcasts them; every rank
    passes its own local layer of that index for the shapes, and the
    gradient is summed onto the owner's."""
    fsdp = axis("fsdp")
    if fsdp is None:
        return local[i]
    owner, j = divmod(i, num_layers // fsdp.size)
    lp = local[j]
    names = [f.name for f in dataclasses.fields(LayerParams) if getattr(lp, f.name) is not None]
    got = broadcast_from([getattr(lp, n) for n in names], fsdp, owner)
    return LayerParams(**dict(zip(names, got)))


def _run_layer(cfg: ModelConfig, local: List[LayerParams], i: int, h: torch.Tensor,
               cos, sin, keep, window, ring: bool):
    """Layer ``i`` of ``_one_layer_dropped``. Under fsdp the layer is
    recomputed in backward (``torch.utils.checkpoint``, without early
    stop, so every rank issues the same collectives), its weights gathered
    again there: no rank holds more than one gathered layer at a time
    (ZeRO-3)."""
    def layer(x):
        return _one_layer_dropped(cfg, _layer_weights(local, i, cfg.num_hidden_layers), x,
                                  cos, sin, keep, window, ring)

    if axis("fsdp") is None:
        return layer(h)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return checkpoint(_in_context(current(), layer), h, use_reentrant=False,
                          preserve_rng_state=False)


def trainable_tensors(params: LlamaParams) -> Dict[str, torch.Tensor]:
    """name -> tensor of every weight of ``params`` (a tied head has none of
    its own), in a fixed order: the optimizer's parameters and the
    checkpoints' keys. Quantized weights cannot be trained and raise."""
    named = {"embed": params.embed, "final_norm": params.final_norm}
    if params.lm_head is not None:
        named["lm_head"] = params.lm_head
    for f in dataclasses.fields(LayerParams):
        w = getattr(params.layers, f.name)
        if w is not None:
            named[f"layers.{f.name}"] = w
    quant = [name for name, w in named.items() if isinstance(w, QuantTensor)]
    if quant:
        raise ValueError(f"quantized weights cannot be trained: {quant}")
    return named


def _check_mesh(tcfg: TrainConfig) -> None:
    """The current context against ``act_spec`` and ``ring_axis``: a mesh
    that splits the batch (dp or fsdp > 1) needs ``act_spec`` (the
    sequence is split over fsdp), and the ring runs over that axis."""
    ctx = current()
    if ctx is not None and (ctx.dp or ctx.fsdp) and tcfg.act_spec is None:
        raise ValueError(f"a mesh with dp or fsdp > 1 splits the batch: set act_spec={ACT_SPEC}")
    if ctx is not None and ctx.ep is not None:
        raise ValueError("the training mesh is (dp, fsdp, tp): ep is not one of its axes")
    if tcfg.ring_axis is not None and (tcfg.ring_axis != ACT_SPEC[1] or tcfg.act_spec is None):
        raise ValueError(f"ring_axis={tcfg.ring_axis!r}: the ring runs over the axis the "
                         f"sequence is split over, {ACT_SPEC[1]!r} with act_spec={ACT_SPEC}")


def layerskip_loss(
    params: LlamaParams,
    cfg: ModelConfig,
    tcfg: TrainConfig,
    ids: torch.Tensor,  # [B, T]
    labels: torch.Tensor,  # [B, T] next-token labels (-100 ignored)
    generator: Optional[torch.Generator] = None,  # on the params' device
    step: Union[int, torch.Tensor] = 0,
    keep: Optional[torch.Tensor] = None,  # [L, B] 0/1: overrides the draw
):
    """Total loss = CE(final) + Σ_exits w_e · CE(exit_e) (+ the MoE
    load-balancing term), with layer dropout. Without ``keep``, each layer
    keeps each sample where a uniform draw from ``generator`` is at least
    ``p_max * D(l)``. Returns (total, {"loss", "final_loss", "exit_losses",
    "exit_weights", "moe_aux"}).

    Under a training mesh's context (``make_train_step(mesh=...)``, or
    ``parallel.collectives.sharded``) ``params`` are this rank's shards
    (``parallel/sharding.shard_params``) and ``ids``/``labels`` its part of
    the batch: rows ``[r * B/dp, ...)`` of dp rank r and, with the sequence
    split, positions ``[s * T/fsdp, ...)`` of fsdp rank s (RoPE and the
    causal rule use the global positions). The keep mask is the global [L,
    B], drawn alike on every rank from identically seeded generators, of
    which each rank takes its dp rows. Every CE is the global token mean
    (each rank's NLL sum over the global count), the MoE term routes over
    the global tokens, and the losses returned are the global ones; the
    total's gradient is this rank's part of it, so the gradients of the
    weights every rank of dp or fsdp holds must be summed over them
    (``sync_grads``, as ``loss_and_grads`` does)."""
    trainable_tensors(params)  # dense weights only: no kernel of ops/cuda runs
    _check_mesh(tcfg)
    dp, fsdp = axis("dp"), axis("fsdp")
    token_axes = _token_axes()
    nl = cfg.num_hidden_layers
    exits = tcfg.early_exit_layers or default_exit_layers(nl)
    exits = tuple(e for e in exits if 0 < e < nl)
    dev = params.embed.device
    ids, labels = ids.to(dev), labels.to(dev)
    b, t = ids.shape
    h = embed_tokens(params, ids, cfg)
    t0 = 0 if fsdp is None else fsdp.rank * t  # this rank's first global position
    positions = torch.arange(t0, t0 + t, device=dev)
    cos, sin = (x.expand(b, t, cfg.head_dim)
                for x in rope_cos_sin(positions, rope_inv_freq(cfg, dev)))
    local = None
    if cfg.rope_local_theta:  # Gemma-3: sliding layers train on their own RoPE base
        local_cfg = dataclasses.replace(cfg, rope_theta=cfg.rope_local_theta,
                                        rope_scaling=RopeScaling())
        local = tuple(x.expand(b, t, cfg.head_dim)
                      for x in rope_cos_sin(positions, rope_inv_freq(local_cfg, dev)))
    flags = cfg.sliding_layer_flags
    rows = b * (1 if dp is None else dp.size)  # the global batch
    if keep is None:
        p_drop = tcfg.p_max * depth_scale(torch.arange(nl, device=dev), nl,
                                          tcfg.dropout_scale)
        keep = torch.rand((nl, rows), generator=generator, device=dev) >= p_drop[:, None]
    keep = torch.as_tensor(keep, device=dev)
    if keep.shape != (nl, rows):
        raise ValueError(f"keep has shape {tuple(keep.shape)}, not [L, B] = {(nl, rows)}")
    if dp is not None:
        keep = keep[:, dp.rank * b:(dp.rank + 1) * b]
    ring = tcfg.ring_axis is not None and fsdp is not None
    if ring and (cfg.sliding_window is not None or cfg.attn_logit_softcap
                 or cfg.query_pre_attn_scalar is not None):
        raise ValueError("ring attention does not support windows, softcap or a query "
                         "scale (Gemma-family and Mistral training must not set ring_axis)")

    exit_h, auxes = {}, []
    layers = _per_layer(params.layers)
    for i in range(nl):
        if flags is not None:
            window = cfg.sliding_window if flags[i] else 0
        else:
            window = cfg.sliding_window  # uniform (Mistral) or None
        sliding = flags[i] if flags is not None else cfg.sliding_window is not None
        cs = local if local is not None and sliding else (cos, sin)
        h, aux = _run_layer(cfg, layers, i, h, *cs, keep[i], window, ring)
        auxes.append(aux)
        if i + 1 in exits:  # exit AFTER layer e-1, as inference's exit_layer
            exit_h[i + 1] = h

    w = exit_loss_weights(exits, nl, tcfg.e_scale, tcfg.rotational_r, step, device=dev)
    hs = [h] + [exit_h[e] for e in exits]
    sums = [_nll_sum(params, cfg, x, labels, tcfg.label_smoothing, tcfg.ce_chunk_tokens)
            for x in hs]
    count = torch.stack([n for _, n in sums])
    for ax in token_axes:  # the global count of valid tokens
        count = all_reduce(count, ax)
    ces = [total / torch.clamp(n, min=1) for (total, _), n in zip(sums, count)]
    final_loss = ces[0]
    exit_vec = (torch.stack(ces[1:]) if exits
                else torch.zeros((0,), dtype=torch.float32, device=dev))
    total = final_loss + (w * exit_vec).sum()
    # MoE router load balancing (Mixtral's router_aux_loss_coef), the
    # per-layer term averaged over layers (global: routed over every token)
    aux_mean = torch.stack(auxes).mean()
    moe_term = cfg.is_moe and tcfg.moe_aux_coef > 0.0
    if token_axes:
        # the global losses, each rank's total keeping its own part's
        # gradient (value: the global total; gradient: this rank's part)
        parts = torch.cat([final_loss[None], exit_vec]).detach()
        for ax in token_axes:
            parts = all_reduce(parts, ax)
        final_loss, exit_vec = parts[0], parts[1:]
        glob = final_loss + (w * exit_vec).sum()
        total = total + (glob - total).detach()
    if moe_term:
        total = total + tcfg.moe_aux_coef * aux_mean
    return total, {"loss": total, "final_loss": final_loss, "exit_losses": exit_vec,
                   "exit_weights": w, "moe_aux": aux_mean}


def sync_grads(params: LlamaParams) -> None:
    """Sum the gradients of the weights that every rank of the current
    context's dp or fsdp axis holds over that axis, in place: all of them
    over dp; over fsdp all but the stacked layers (whose gradients
    ``broadcast_from`` already summed onto their owners). tp slices stay
    local. A weight without a gradient gets zeros, so every rank's buffers
    agree. Nothing to do without dp and fsdp."""
    dp, fsdp = axis("dp"), axis("fsdp")
    if dp is None and fsdp is None:
        return
    named = trainable_tensors(params)
    for w in named.values():
        if w.grad is None:
            w.grad = torch.zeros_like(w)
    all_reduce_([w.grad for n, w in named.items() if not n.startswith("layers.")], fsdp)
    all_reduce_([w.grad for w in named.values()], dp)


def loss_and_grads(params: LlamaParams, cfg: ModelConfig, tcfg: TrainConfig,
                   ids: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   step: Union[int, torch.Tensor] = 0, keep: Optional[torch.Tensor] = None):
    """``layerskip_loss``, its backward into the weights' ``.grad`` and
    ``sync_grads``: under a mesh each rank's ``.grad`` is then its shard of
    the single-device gradient. Returns (total, aux) detached."""
    loss, aux = layerskip_loss(params, cfg, tcfg, ids, labels, generator, step, keep)
    loss.backward()
    sync_grads(params)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """``(train_step, init_opt_state)``.

    ``init_opt_state(params)`` makes every weight of ``params`` require
    grad and returns a ``torch.optim.AdamW`` over them with optax
    ``adamw``'s defaults (betas 0.9/0.999, eps 1e-8, decoupled decay on
    every weight, states in the weights' dtype). ``train_step(params,
    opt_state, ids, labels, generator, step, keep=None)`` runs one
    ``layerskip_loss`` and its backward, updates the params' tensors in
    place and returns ``(params, opt_state, aux)`` with ``aux`` detached.

    With ``mesh`` (``parallel/mesh.make_train_mesh``) the step runs in the
    mesh's context: ``params`` are this rank's shards, ``ids``/``labels``
    its part of the batch (``layerskip_loss``), the gradients of weights
    held on every rank of dp or fsdp are summed over them, and AdamW
    updates this rank's shards (elementwise: the single device's update,
    sliced)."""
    ctx = context_from_mesh(mesh)

    def init_opt_state(params: LlamaParams) -> torch.optim.AdamW:
        tensors = list(trainable_tensors(params).values())
        for w in tensors:
            w.requires_grad_(True)
        return torch.optim.AdamW(tensors, lr=tcfg.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=tcfg.weight_decay)

    def train_step(params, opt_state, ids, labels, generator=None, step=0, keep=None):
        opt_state.zero_grad(set_to_none=True)
        with sharded(ctx) if mesh is not None else contextlib.nullcontext():
            _, aux = loss_and_grads(params, cfg, tcfg, ids, labels, generator, step, keep)
        opt_state.step()
        return params, opt_state, aux

    return train_step, init_opt_state
