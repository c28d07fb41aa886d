"""Weight-only int8 / int4 quantization of LlamaParams (port of
``layerskip_tpu/quant.py``).

``QuantTensor`` (ops/linear.py) drops into ``LlamaParams`` wherever a dense
[.., K, N] weight lived, including the stacked [L, K, N] layer weights; the
model applies it through ``apply_weight`` / ``apply_weight_t``, which launch
the K4-K7 kernels on the card. Quantization runs on the weights' device one
layer at a time, so the fp32 transient is one layer's (a whole-stack fp32
copy of a 7B MLP tensor would be ~5.8 GB).
"""

from __future__ import annotations

import dataclasses

import torch

from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams
from layerskip_tpu_torch.ops.linear import QuantTensor, pack_int4


def quantize_tensor(w: torch.Tensor, k_last: bool = False, bits: int = 8,
                    group: int = 0) -> QuantTensor:
    """Symmetric int8 (per output channel) or int4 (K-groupwise).

    ``k_last=False``: w is [..., K, N] (contraction axis -2);
    ``k_last=True``:  w is [..., N, K] (HF orientation: wq/wk/wv).
    ``bits=4`` packs two values per byte (``pack_int4``) with one fp32 scale
    per (``group``-long K slice, output channel); ``group`` defaults to 128
    and clamps to K for small models; K must divide by it. The arithmetic is
    the JAX package's, so both give identical q and scales.
    """
    assert bits in (8, 4)
    wf = w.float()
    if bits == 8:
        assert group == 0, "int8 is per-output-channel; group applies to int4"
        axis = -1 if k_last else -2
        scale = (wf.abs().amax(dim=axis) / 127.0).clamp_min(1e-8)  # [..., N]
        s = scale[..., :, None] if k_last else scale[..., None, :]
        q = torch.round(wf / s).clamp(-127, 127).to(torch.int8)
        return QuantTensor(q=q, scale=scale, k_last=k_last)
    k = wf.shape[-1] if k_last else wf.shape[-2]
    g = min(group or 128, k)
    assert k % g == 0, f"K={k} not divisible by group={g}"
    if k_last:  # [..., N, K] -> groups [..., N, K/G, G]
        *lead, n, _ = wf.shape
        wg = wf.reshape(*lead, n, k // g, g)
        scale = (wg.abs().amax(dim=-1) / 7.0).clamp_min(1e-8)
        q = torch.round(wg / scale[..., None]).clamp(-7, 7)
        return QuantTensor(q=pack_int4(q.reshape(*lead, n, k).to(torch.int8), k_last=True),
                           scale=scale, k_last=True, group=g)
    *lead, _, n = wf.shape
    wg = wf.reshape(*lead, k // g, g, n)  # groups along K
    scale = (wg.abs().amax(dim=-2) / 7.0).clamp_min(1e-8)
    q = torch.round(wg / scale[..., :, None, :]).clamp(-7, 7)
    return QuantTensor(q=pack_int4(q.reshape(*lead, k, n).to(torch.int8)),
                       scale=scale, group=g)


_QUANT_FIELDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_K_LAST_FIELDS = ("wq", "wk", "wv")  # stored [out, in] — see models/llama.py
# drafter fidelity variant (GenerationConfig.draft_quant_mlp_only): quantize
# only the MLP triple and keep attention at the base precision
_MLP_FIELDS = ("w_gate", "w_up", "w_down")


def _quantize_stacked(w: torch.Tensor, n_layers: int, k_last: bool, bits: int,
                      group: int) -> QuantTensor:
    """Quantize layers [0, n_layers) of a stacked [L, ...] weight one layer at
    a time into preallocated buffers: the same q and scales as quantizing the
    slice at once, with one layer's fp32 transient."""
    first = quantize_tensor(w[0], k_last=k_last, bits=bits, group=group)
    q = torch.empty((n_layers, *first.q.shape), dtype=first.q.dtype, device=w.device)
    scale = torch.empty((n_layers, *first.scale.shape), dtype=first.scale.dtype,
                        device=w.device)
    q[0], scale[0] = first.q, first.scale
    for i in range(1, n_layers):
        qt = quantize_tensor(w[i], k_last=k_last, bits=bits, group=group)
        q[i], scale[i] = qt.q, qt.scale
    return QuantTensor(q=q, scale=scale, k_last=k_last, group=first.group)


def _quantize_layer_slice(layers: LayerParams, exit_layer: int, bits: int, group: int,
                          fields: tuple = _QUANT_FIELDS) -> LayerParams:
    """Layers [0, exit_layer) with ``fields`` quantized; the other fields are
    views of the base stack (no copy)."""
    kw = {}
    for f in dataclasses.fields(LayerParams):
        w = getattr(layers, f.name)
        kw[f.name] = (_quantize_stacked(w, exit_layer, f.name in _K_LAST_FIELDS, bits, group)
                      if f.name in fields else w[:exit_layer])
    return LayerParams(**kw)


def _quantize_head(w: torch.Tensor, bits: int, group: int) -> QuantTensor:
    return quantize_tensor(w, bits=bits, group=group)


def quantize_llama_params(params: LlamaParams, quantize_lm_head: bool = False,
                          bits: int = 8, group: int = 0) -> LlamaParams:
    """Quantize the seven per-layer matmul weights (norms and embeddings stay
    as they are; the LM head only with ``quantize_lm_head``, since a
    full-precision head keeps greedy argmax parity at the exits).
    ``bits=4`` selects groupwise int4."""
    nl = params.layers.wq.shape[0]
    lm_head = params.lm_head
    if quantize_lm_head and lm_head is not None:
        lm_head = _quantize_head(lm_head, bits, group)
    return LlamaParams(
        embed=params.embed,
        layers=_quantize_layer_slice(params.layers, nl, bits, group),
        final_norm=params.final_norm,
        lm_head=lm_head,
    )


def quantize_draft_params(params: LlamaParams, exit_layer: int, bits: int = 8,
                          group: int = 0, quantize_head: bool = True,
                          fields: tuple = _QUANT_FIELDS) -> LlamaParams:
    """Quantized copy of ONLY the draft layer group [0, exit_layer).

    Drafts read it; the verify re-runs the window through the full base
    stack (generation/spec.py), so committed tokens are the base model's.
    Embeddings and norms are SHARED with ``params`` (the same tensors). The
    LM head is quantized too when untied and ``quantize_head``; otherwise
    the drafter shares the base head. Tied heads stay shared either way.
    """
    lm_head = params.lm_head
    if quantize_head and lm_head is not None and not isinstance(lm_head, QuantTensor):
        lm_head = _quantize_head(lm_head, bits, group)
    return LlamaParams(
        embed=params.embed,
        layers=_quantize_layer_slice(params.layers, exit_layer, bits, group, fields),
        final_norm=params.final_norm,
        lm_head=lm_head,
    )


def quantized_bytes(params: LlamaParams) -> int:
    """Total parameter bytes (int4 is already packed two per byte)."""
    total = 0
    leaves = [params.embed, params.final_norm, params.lm_head] + [
        getattr(params.layers, f.name) for f in dataclasses.fields(LayerParams)]
    for leaf in leaves:
        parts = (leaf.q, leaf.scale) if isinstance(leaf, QuantTensor) else (leaf,)
        total += sum(t.numel() * t.element_size() for t in parts if t is not None)
    return total
