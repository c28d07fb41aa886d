"""Weight construction and conversion (port of ``layerskip_tpu/models/params.py``).

  * ``init_params``          — random normal(0, 0.02) weights, HF's default init
  * ``make_random_params``   — full-width random weights with an identity-ish
                               tail (the JAX package's bench weights)
  * ``params_from_flat_dict`` — HF checkpoint names -> stacked params, for
                               every family the JAX package loads (Llama,
                               Qwen2/Qwen3, Mistral, Gemma/Gemma-2/Gemma-3,
                               Phi-3's fused projections, Mixtral, Qwen3-MoE)
  * ``params_from_numpy``    — the JAX package's ``LlamaParams`` (as numpy)
                               -> the port's params
  * ``load_params`` / ``save_params`` — HF checkpoint directories of
                               ``*.safetensors`` shards and ``config.json``,
                               read and written by models/safetensors_io.py
  * ``params_from_torch_state_dict`` — an HF ``*ForCausalLM`` state dict

Storage orientation is the JAX package's: wq/wk/wv ``[L, out, in]``, wo and
the MLP weights ``[L, in, out]`` (MoE: ``[L, E, in, out]``), the router
``[L, D, E]``, embed ``[V, D]``, lm_head ``[D, V]`` or None when tied.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.device import resolve_device
from layerskip_tpu_torch.models import safetensors_io
from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams
from layerskip_tpu_torch.ops.linear import QuantTensor

_LAYER_FIELDS = tuple(f.name for f in dataclasses.fields(LayerParams))
_OPTIONAL_FIELDS = tuple(f.name for f in dataclasses.fields(LayerParams)
                         if f.default is None)


def _stacked_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The seven matmul stacks; MoE MLP stacks carry the expert axis."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    hq, hkv, dh, nl = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim, cfg.num_hidden_layers)
    lead = (nl, cfg.num_local_experts) if cfg.is_moe else (nl,)
    return {
        "wq": (nl, hq * dh, d), "wk": (nl, hkv * dh, d), "wv": (nl, hkv * dh, d),
        "wo": (nl, hq * dh, d), "w_gate": (*lead, d, f), "w_up": (*lead, d, f),
        "w_down": (*lead, f, d),
    }


def _norm_init(cfg: ModelConfig):
    """The identity norm weight's constructor: zeros under Gemma's
    ``(1 + w)`` convention, ones otherwise."""
    return torch.zeros if cfg.rms_norm_offset else torch.ones


def _small_fields(cfg: ModelConfig, nrm, dev) -> dict:
    """Norms, biases and the router, as the JAX package's ``init_params``
    makes them: norms at the identity (zeros under Gemma's ``(1 + w)``,
    ones otherwise), biases at zero, the router normal(0, 0.02)."""
    d, nl, dt = cfg.hidden_size, cfg.num_hidden_layers, cfg.dtype
    norm = _norm_init(cfg)
    mk = lambda fn, *s: fn(s, dtype=dt, device=dev)  # noqa: E731
    hq, hkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    out = dict(attn_norm=mk(norm, nl, d), mlp_norm=mk(norm, nl, d))
    if cfg.attention_bias:
        out.update(bq=mk(torch.zeros, nl, hq * dh), bk=mk(torch.zeros, nl, hkv * dh),
                   bv=mk(torch.zeros, nl, hkv * dh))
    if cfg.post_norms:
        out.update(post_attn_norm=mk(norm, nl, d), post_mlp_norm=mk(norm, nl, d))
    if cfg.qk_norm:
        out.update(q_norm=mk(norm, nl, dh), k_norm=mk(norm, nl, dh))
    if cfg.is_moe:
        out["w_router"] = nrm((nl, d, cfg.num_local_experts))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LlamaParams:
    """Random init: normal(0, 0.02) sampled in ``cfg.dtype``, norms at the
    identity (zeros for Gemma's ``(1 + w)`` norms, ones otherwise)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def nrm(shape):
        x = torch.randn(shape, generator=gen, dtype=cfg.dtype, device=dev)
        return x * torch.tensor(0.02, dtype=cfg.dtype, device=dev)

    mats = {name: nrm(shape) for name, shape in _stacked_shapes(cfg).items()}
    embed = nrm((cfg.vocab_size, cfg.hidden_size))
    layers = LayerParams(**mats, **_small_fields(cfg, nrm, dev))
    return LlamaParams(
        embed=embed, layers=layers,
        final_norm=_norm_init(cfg)(cfg.hidden_size, dtype=cfg.dtype, device=dev),
        lm_head=None if cfg.tie_word_embeddings else embed.T.contiguous(),
    )


def make_random_params(cfg: ModelConfig, exit_layer: int, tail_eps: float = 0.0,
                       seed: int = 0, device="cuda") -> LlamaParams:
    """Full-width random weights built layer by layer (the JAX package's
    ``bench.py`` builder): normal(0, 0.02) in ``cfg.dtype``, and the output
    projections (wo, w_down; every expert's w_down in an MoE) of layers
    ``>= exit_layer`` scaled by ``tail_eps`` — 0 makes the tail an
    identity, so the early exit agrees with the full model and acceptance
    sits near 1; larger values let the verifier diverge from the draft.
    Norms, biases and the router are ``init_params``'s. Random numbers come
    from a seeded torch generator, not JAX's."""
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
    embed = torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen, dtype=dt,
                        device=dev) * scale
    nrm = lambda shape: torch.randn(shape, generator=gen, dtype=dt, device=dev) * scale  # noqa: E731
    layers = LayerParams(**mats, **_small_fields(cfg, nrm, dev))
    return LlamaParams(
        embed=embed, layers=layers,
        final_norm=_norm_init(cfg)(cfg.hidden_size, dtype=cfg.dtype, device=dev),
        lm_head=None if cfg.tie_word_embeddings else embed.T.contiguous(),
    )


# HF nn.Linear stores [out, in]: wq/wk/wv keep it, the rest are transposed
# to [in, out] so their forwards are plain ``x @ w``.
_LAYER_KEY_MAP = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", False),
    "self_attn.k_proj.weight": ("wk", False),
    "self_attn.v_proj.weight": ("wv", False),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}
# Gemma-2/3 blocks have four norms: post_attention_layernorm is a true
# post-norm there, and pre_feedforward_layernorm takes the mlp_norm slot
_POST_NORM_KEYS = {
    "post_attention_layernorm.weight": ("post_attn_norm", False),
    "pre_feedforward_layernorm.weight": ("mlp_norm", False),
    "post_feedforward_layernorm.weight": ("post_mlp_norm", False),
}
# Mixtral: block_sparse_moe.gate (router) and experts.{e}.w1 (gate), w3
# (up), w2 (down); Qwen3-MoE: mlp.gate and experts.{e}.{gate,up,down}_proj.
# All [out, in], transposed to [in, out].
_EXPERT_PAT = re.compile(r"^block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight$")
_EXPERT_FIELD = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}
_QWEN_EXPERT_PAT = re.compile(r"^mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight$")
_QWEN_EXPERT_FIELD = {"gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down"}
_MLP_FIELDS = ("w_gate", "w_up", "w_down")
_ROUTER_KEYS = ("block_sparse_moe.gate.weight", "mlp.gate.weight")
_LAYER_PAT = re.compile(r"^model\.layers\.(\d+)\.(.+)$")


def _key_map(cfg: ModelConfig) -> dict:
    return {**_LAYER_KEY_MAP, **_POST_NORM_KEYS} if cfg.post_norms else _LAYER_KEY_MAP


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, np.float32)).to(device=device, dtype=dtype)


def params_from_flat_dict(tensors: Mapping, cfg: ModelConfig,
                          device="cuda") -> LlamaParams:
    """Stacked params from a flat HF-style name -> array dict (numpy arrays or
    torch tensors): dense names, QKV biases, q/k norms, Gemma-2/3's four
    norms, Phi-3's fused ``qkv_proj``/``gate_up_proj`` (split by output
    rows) and the Mixtral and Qwen3-MoE expert names. A family's optional
    fields stay None when the checkpoint has none of them; other unknown
    tensors are ignored, as in the JAX package."""
    dev = resolve_device(device)
    nl, n_exp = cfg.num_hidden_layers, cfg.num_local_experts
    key_map = _key_map(cfg)
    per_layer = {field: [None] * nl for field in _LAYER_FIELDS}
    if cfg.is_moe:
        for field in ("w_gate", "w_up", "w_down"):
            per_layer[field] = [[None] * n_exp for _ in range(nl)]
    embed = final_norm = lm_head = None
    f32 = lambda a: _as_tensor(a, torch.float32, "cpu")  # noqa: E731
    for name, arr in tensors.items():
        m = _LAYER_PAT.match(name)
        if m:
            i, sub = int(m.group(1)), m.group(2)
            me, mq = _EXPERT_PAT.match(sub), _QWEN_EXPERT_PAT.match(sub)
            if sub in key_map and not (cfg.is_moe and sub.startswith("mlp.")):
                field, transpose = key_map[sub]
                per_layer[field][i] = f32(arr).T if transpose else f32(arr)
            elif sub == "self_attn.qkv_proj.weight":  # Phi-3: q, then k, then v rows
                t = f32(arr)
                nq = cfg.num_attention_heads * cfg.head_dim
                nkv = cfg.num_key_value_heads * cfg.head_dim
                per_layer["wq"][i] = t[:nq]
                per_layer["wk"][i] = t[nq:nq + nkv]
                per_layer["wv"][i] = t[nq + nkv:nq + 2 * nkv]
            elif sub == "mlp.gate_up_proj.weight":  # Phi-3: gate rows, then up rows
                t, f = f32(arr), cfg.intermediate_size
                per_layer["w_gate"][i] = t[:f].T
                per_layer["w_up"][i] = t[f:].T
            elif sub in _ROUTER_KEYS:
                per_layer["w_router"][i] = f32(arr).T  # [E, D] -> [D, E]
            elif me:
                per_layer[_EXPERT_FIELD[me.group(2)]][i][int(me.group(1))] = f32(arr).T
            elif mq:
                per_layer[_QWEN_EXPERT_FIELD[mq.group(2)]][i][int(mq.group(1))] = f32(arr).T
        elif name == "model.embed_tokens.weight":
            embed = f32(arr)
        elif name == "model.norm.weight":
            final_norm = f32(arr)
        elif name == "lm_head.weight":
            lm_head = f32(arr).T

    def stack(field):
        mats = per_layer[field]
        if isinstance(mats[0], list):  # experts: [L][E] -> [L, E, ...]
            if any(m is None for row in mats for m in row):
                raise ValueError(f"checkpoint is missing experts of {field}")
            mats = [torch.stack(row) for row in mats]
        if field in _OPTIONAL_FIELDS and all(m is None for m in mats):
            return None
        if any(m is None for m in mats):
            raise ValueError(f"checkpoint is missing tensors of {field}")
        return torch.stack(mats).to(device=dev, dtype=cfg.dtype)

    if embed is None or final_norm is None:
        raise ValueError("checkpoint is missing tensors: embed/norm")
    layers = LayerParams(**{f: stack(f) for f in _LAYER_FIELDS})
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


def _field(tree, name, default=...):
    if isinstance(tree, Mapping):
        return tree[name] if default is ... else tree.get(name, default)
    return getattr(tree, name) if default is ... else getattr(tree, name, default)


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
    ``q``, ``scale``, ``k_last`` and ``group``. A family's optional layer
    fields (biases, router, post-norms, q/k norms) may be absent or None;
    a layer field the port does not know raises ``ValueError``."""
    dev = resolve_device(device)
    layers = _field(tree, "layers")
    if isinstance(layers, Mapping):
        extra = sorted(set(layers) - set(_LAYER_FIELDS))
        if extra:
            raise ValueError(f"unknown layer fields {extra}")

    def conv(x):
        if x is None:
            return None
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
        layers=LayerParams(**{f: conv(_field(layers, f, None)) for f in _LAYER_FIELDS}),
        final_norm=conv(_field(tree, "final_norm")),
        lm_head=None if lm_head is None else conv(lm_head),
    )


def params_from_torch_state_dict(state_dict: Mapping, cfg: ModelConfig,
                                 device="cuda") -> LlamaParams:
    """The port's params from the ``state_dict()`` of an HF ``*ForCausalLM``
    of any family ``params_from_flat_dict`` reads."""
    return params_from_flat_dict(state_dict, cfg, device=device)


def load_params(model_dir: str, cfg: ModelConfig, device="cuda") -> LlamaParams:
    """Params from a local HF checkpoint directory of ``*.safetensors``
    shards, read by the port's own reader. Tensors of names the model does
    not read are decoded (any dtype the JAX package's reader takes) and
    then ignored."""
    shards = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards under {model_dir}")
    tensors: Dict[str, torch.Tensor] = {}
    for path in shards:
        tensors.update(safetensors_io.load_file(path))
    return params_from_flat_dict(tensors, cfg, device=device)


def _hf_family(cfg: ModelConfig):
    """(model_type, architecture) that reconstructs ``cfg``'s family, from
    its distinguishing features (the JAX package's rule)."""
    if cfg.is_moe:
        return ("qwen3_moe", "Qwen3MoeForCausalLM") if cfg.qk_norm else \
            ("mixtral", "MixtralForCausalLM")
    if cfg.post_norms:
        return ("gemma3_text", "Gemma3ForCausalLM") if cfg.qk_norm else \
            ("gemma2", "Gemma2ForCausalLM")
    if cfg.qk_norm:
        return "qwen3", "Qwen3ForCausalLM"
    if cfg.rms_norm_offset:
        return "gemma", "GemmaForCausalLM"
    if cfg.attention_bias:
        return "qwen2", "Qwen2ForCausalLM"
    if cfg.sliding_window is not None:
        return "mistral", "MistralForCausalLM"
    return "llama", "LlamaForCausalLM"


def save_params(params: LlamaParams, model_dir: str, cfg: ModelConfig) -> str:
    """Write params as an HF checkpoint (``model.safetensors`` of fp32
    tensors under the HF names and orientation, and ``config.json``), the
    layout the JAX package's ``save_params`` writes, so a checkpoint moves
    between the two packages and HF tooling. Experts go under the Mixtral
    names (Qwen3-MoE's when the config has q/k norms); Phi-3 checkpoints
    load but save as Llama. Quantized params cannot be saved. Returns the
    path of the tensors' file."""
    layers = params.layers
    leaves = [params.embed, params.final_norm, params.lm_head,
              *(getattr(layers, f) for f in _LAYER_FIELDS)]
    if any(isinstance(x, QuantTensor) for x in leaves):
        raise ValueError("quantized params cannot be saved; save the dense weights")
    f32 = lambda t: t.detach().float()  # noqa: E731
    tensors = {"model.embed_tokens.weight": f32(params.embed),
               "model.norm.weight": f32(params.final_norm)}
    if params.lm_head is not None:
        tensors["lm_head.weight"] = f32(params.lm_head).T.contiguous()
    qwen_moe = cfg.is_moe and cfg.qk_norm
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        for hf_name, (field, transpose) in _key_map(cfg).items():
            stacked = getattr(layers, field)
            if stacked is None or (cfg.is_moe and field in _MLP_FIELDS):
                continue
            w = f32(stacked[i])
            tensors[pre + hf_name] = w.T.contiguous() if transpose else w
        if cfg.is_moe:
            router = "mlp.gate.weight" if qwen_moe else "block_sparse_moe.gate.weight"
            tensors[pre + router] = f32(layers.w_router[i]).T.contiguous()
            names = ({f: w for w, f in _QWEN_EXPERT_FIELD.items()} if qwen_moe
                     else {f: w for w, f in _EXPERT_FIELD.items()})
            for field in _MLP_FIELDS:
                for e in range(cfg.num_local_experts):
                    key = (f"mlp.experts.{e}.{names[field]}.weight" if qwen_moe
                           else f"block_sparse_moe.experts.{e}.{names[field]}.weight")
                    tensors[pre + key] = f32(getattr(layers, field)[i, e]).T.contiguous()
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, "model.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"format": "pt"})
    model_type, arch = _hf_family(cfg)
    config_json = {
        "model_type": model_type, "architectures": [arch],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "attention_bias": cfg.attention_bias,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id,
    }
    if cfg.sliding_window is not None:
        config_json["sliding_window"] = cfg.sliding_window
    if cfg.attn_logit_softcap:
        config_json["attn_logit_softcapping"] = cfg.attn_logit_softcap
    if cfg.final_logit_softcap:
        config_json["final_logit_softcapping"] = cfg.final_logit_softcap
    if cfg.query_pre_attn_scalar:
        config_json["query_pre_attn_scalar"] = cfg.query_pre_attn_scalar
    if cfg.sliding_window_pattern > 1:
        config_json["sliding_window_pattern"] = cfg.sliding_window_pattern
    if cfg.sliding_layers is not None:
        config_json["layer_types"] = ["sliding_attention" if f else "full_attention"
                                      for f in cfg.sliding_layers]
    if cfg.rope_local_theta:
        config_json["rope_local_base_freq"] = cfg.rope_local_theta
    if cfg.is_moe:
        config_json.update(num_local_experts=cfg.num_local_experts,
                           num_experts=cfg.num_local_experts,
                           num_experts_per_tok=cfg.num_experts_per_tok,
                           norm_topk_prob=cfg.norm_topk_prob)
        if qwen_moe:  # Qwen3-MoE experts are moe_intermediate_size wide
            config_json["moe_intermediate_size"] = cfg.intermediate_size
    if cfg.hidden_act != "silu":
        config_json["hidden_activation"] = cfg.hidden_act
        config_json["hidden_act"] = cfg.hidden_act
    rs = cfg.rope_scaling
    if rs.rope_type != "default":
        config_json["rope_scaling"] = {
            "rope_type": rs.rope_type, "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor, "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position_embeddings,
        }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config_json, f, indent=2)
    return path
