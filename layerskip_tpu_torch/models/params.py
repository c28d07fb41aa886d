"""Weight construction and conversion (port of ``layerskip_tpu/models/params.py``).

  * ``init_params``          — random normal(0, 0.02) weights, HF's default init
  * ``make_random_params``   — full-width random weights with an identity-ish
                               tail (the JAX package's bench weights)
  * ``params_from_flat_dict`` — HF ``LlamaForCausalLM`` names -> stacked params
  * ``params_from_numpy``    — the JAX package's ``LlamaParams`` (as numpy)
                               -> the port's params

Storage orientation is the JAX package's: wq/wk/wv ``[L, out, in]``, wo and
the MLP weights ``[L, in, out]``, embed ``[V, D]``, lm_head ``[D, V]`` or
None when tied.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.device import resolve_device
from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams, check_supported
from layerskip_tpu_torch.ops.linear import QuantTensor

_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LayerParams))


def _stacked_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, f = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, dh, nl = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim, cfg.num_hidden_layers)
    return {
        "wq": (nl, hq * dh, d), "wk": (nl, hkv * dh, d), "wv": (nl, hkv * dh, d),
        "wo": (nl, hq * dh, d), "w_gate": (nl, d, f), "w_up": (nl, d, f),
        "w_down": (nl, f, d),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LlamaParams:
    """Random init: normal(0, 0.02) sampled in ``cfg.dtype``, norms at one."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, nl = cfg.hidden_size, cfg.num_hidden_layers

    def nrm(shape):
        x = torch.randn(shape, generator=gen, dtype=cfg.dtype, device=dev)
        return x * torch.tensor(0.02, dtype=cfg.dtype, device=dev)

    ones = lambda *s: torch.ones(s, dtype=cfg.dtype, device=dev)  # noqa: E731
    mats = {name: nrm(shape) for name, shape in _stacked_shapes(cfg).items()}
    layers = LayerParams(attn_norm=ones(nl, d), mlp_norm=ones(nl, d), **mats)
    embed = nrm((cfg.vocab_size, d))
    return LlamaParams(
        embed=embed, layers=layers, final_norm=ones(d),
        lm_head=None if cfg.tie_word_embeddings else embed.T.contiguous(),
    )


def make_random_params(cfg: ModelConfig, exit_layer: int, tail_eps: float = 0.0,
                       seed: int = 0, device="cuda") -> LlamaParams:
    """Full-width random weights built layer by layer (the JAX package's
    ``bench.py`` builder, dense bf16 path): normal(0, 0.02) in ``cfg.dtype``,
    and the output projections (wo, w_down) of layers ``>= exit_layer``
    scaled by ``tail_eps`` — 0 makes the tail an identity, so the early exit
    agrees with the full model and acceptance sits near 1; larger values
    let the verifier diverge from the draft. Random numbers come from a
    seeded torch generator, not JAX's."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.dtype
    scale = torch.tensor(0.02, dtype=dt, device=dev)
    eps = torch.tensor(float(tail_eps), dtype=dt, device=dev)
    mats = {}
    for name, shape in _stacked_shapes(cfg).items():
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            x = torch.randn(shape[1:], generator=gen, dtype=dt, device=dev) * scale
            if name in ("wo", "w_down") and i >= exit_layer:
                x = x * eps
            out[i] = x
        mats[name] = out
    d, nl = cfg.hidden_size, cfg.num_hidden_layers
    ones = lambda *s: torch.ones(s, dtype=dt, device=dev)  # noqa: E731
    layers = LayerParams(attn_norm=ones(nl, d), mlp_norm=ones(nl, d), **mats)
    embed = torch.randn((cfg.vocab_size, d), generator=gen, dtype=dt, device=dev) * scale
    return LlamaParams(
        embed=embed, layers=layers, final_norm=ones(d),
        lm_head=None if cfg.tie_word_embeddings else embed.T.contiguous(),
    )


# HF nn.Linear stores [out, in]: wq/wk/wv keep it, the rest are transposed
# to [in, out] so their forwards are plain ``x @ w``.
_LAYER_KEY_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", False),
    "self_attn.k_proj.weight": ("wk", False),
    "self_attn.v_proj.weight": ("wv", False),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}
_LAYER_PAT = re.compile(r"^model\.layers\.(\d+)\.(.+)$")


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, np.float32)).to(device=device, dtype=dtype)


def params_from_flat_dict(tensors: Mapping, cfg: ModelConfig,
                          device="cuda") -> LlamaParams:
    """Stacked params from a flat HF-style name -> array dict (numpy arrays or
    torch tensors) with dense Llama naming."""
    check_supported(cfg)
    dev = resolve_device(device)
    nl = cfg.num_hidden_layers
    per_layer = {field: [None] * nl for field, _ in _LAYER_KEY_MAP.values()}
    embed = final_norm = lm_head = None
    for name, arr in tensors.items():
        m = _LAYER_PAT.match(name)
        if m:
            i, sub = int(m.group(1)), m.group(2)
            if sub.endswith("rotary_emb.inv_freq"):
                continue
            if sub not in _LAYER_KEY_MAP:
                raise NotImplementedError(f"checkpoint tensor {name} is not ported yet")
            field, transpose = _LAYER_KEY_MAP[sub]
            t = _as_tensor(arr, torch.float32, "cpu")
            per_layer[field][i] = t.T if transpose else t
        elif name == "model.embed_tokens.weight":
            embed = _as_tensor(arr, torch.float32, "cpu")
        elif name == "model.norm.weight":
            final_norm = _as_tensor(arr, torch.float32, "cpu")
        elif name == "lm_head.weight":
            lm_head = _as_tensor(arr, torch.float32, "cpu").T
    missing = [f for f, mats in per_layer.items() if any(m is None for m in mats)]
    if missing or embed is None or final_norm is None:
        raise ValueError(f"checkpoint is missing tensors: {missing or 'embed/norm'}")
    stack = lambda mats: torch.stack(mats).to(device=dev, dtype=cfg.dtype)  # noqa: E731
    layers = LayerParams(**{f: stack(per_layer[f]) for f in _LAYER_FIELDS})
    if cfg.tie_word_embeddings:
        lm_head = None
    elif lm_head is None:
        lm_head = embed.T  # some checkpoints tie implicitly
    return LlamaParams(
        embed=embed.to(device=dev, dtype=cfg.dtype),
        layers=layers,
        final_norm=final_norm.to(device=dev, dtype=cfg.dtype),
        lm_head=None if lm_head is None else
        lm_head.contiguous().to(device=dev, dtype=cfg.dtype),
    )


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _is_quant(x) -> bool:
    """A quantized leaf: the JAX package's ``QuantTensor`` (numpy ``q`` and
    ``scale``), or a dict with its four fields."""
    return (isinstance(x, Mapping) and "q" in x) or (
        not isinstance(x, Mapping) and hasattr(x, "q") and hasattr(x, "scale"))


def params_from_numpy(tree, device="cuda", dtype=None) -> LlamaParams:
    """The port's params from the JAX package's ``LlamaParams`` with numpy
    leaves, given as a nested dict under the same field names (or as the
    dataclass itself). ``dtype`` None keeps each array's dtype; it never
    applies to quantized leaves, which become ``QuantTensor``s with the same
    ``q``, ``scale``, ``k_last`` and ``group``. The JAX package's optional
    family fields must be absent or None."""
    dev = resolve_device(device)
    layers = _field(tree, "layers")
    if isinstance(layers, Mapping):
        extra = [k for k, x in layers.items() if k not in _LAYER_FIELDS and x is not None]
        if extra:
            raise NotImplementedError(f"layer fields {extra} are not ported yet")

    def conv(x):
        if _is_quant(x):  # q and scale keep their dtypes
            raw = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
            return QuantTensor(q=raw(_field(x, "q")), scale=raw(_field(x, "scale")),
                               k_last=bool(_field(x, "k_last")),
                               group=int(_field(x, "group")))
        t = torch.from_numpy(np.array(x))  # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    lm_head = _field(tree, "lm_head")
    return LlamaParams(
        embed=conv(_field(tree, "embed")),
        layers=LayerParams(**{f: conv(_field(layers, f)) for f in _LAYER_FIELDS}),
        final_norm=conv(_field(tree, "final_norm")),
        lm_head=None if lm_head is None else conv(lm_head),
    )
