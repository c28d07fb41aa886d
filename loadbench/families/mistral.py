"""The ``mistral`` family (HF ``MistralForCausalLM`` and
``MixtralForCausalLM``): its random weights made on the device from the
seed, the program under test built from them, and its FLOP count. The
family of a configuration that names none.

The weights are the identity-tail recipe, frozen here: every matrix
normal(0, 0.02) in the served dtype, the output projections (``wo``,
``w_down``; every expert's) of the layers at and past the exit layer scaled
by ``tail_eps``, which sets how often the early exit's drafts agree with
the full model; norms at 1. One ``torch.Generator`` on the card draws each
stacked tensor in one call, in a fixed order.

Layout (the port's storage orientation, which both the program and the
reference read): ``embed`` [V, D], ``lm_head`` [D, V] (untied, drawn on
its own), ``final_norm`` [D]; per layer, stacked on a leading [L] axis:
``attn_norm``/``mlp_norm`` [L, D], ``wq`` [L, Hq·Dh, D], ``wk``/``wv``
[L, Hkv·Dh, D] (rows are outputs), ``wo`` [L, Hq·Dh, D], ``w_gate``/``w_up``
[L, D, F] and ``w_down`` [L, F, D] (rows are inputs), with an expert axis
after L for a mixture of experts, and ``w_router`` [L, D, E].
"""

from __future__ import annotations

from typing import Dict

import torch

from loadbench.yardstick.flops import ModelShape

INIT_STD = 0.02


def shapes(hf: dict) -> Dict[str, tuple]:
    d, f, nl = hf["hidden_size"], hf["intermediate_size"], hf["num_hidden_layers"]
    hq, hkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    dh = hf.get("head_dim") or d // hq
    e = int(hf.get("num_local_experts") or 0)
    lead = (nl, e) if e else (nl,)
    out = {"embed": (hf["vocab_size"], d),
           "wq": (nl, hq * dh, d), "wk": (nl, hkv * dh, d), "wv": (nl, hkv * dh, d),
           "wo": (nl, hq * dh, d),
           "w_gate": (*lead, d, f), "w_up": (*lead, d, f), "w_down": (*lead, f, d),
           "lm_head": (d, hf["vocab_size"])}
    if e:
        out["w_router"] = (nl, d, e)
    return out


def make_weights(hf: dict, exit_layer: int, tail_eps: float, seed: int,
                 device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2 ** 64 - 1))
    out = {}
    for name, shape in shapes(hf).items():
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        w.mul_(INIT_STD)
        if name in ("wo", "w_down"):
            w[exit_layer:].mul_(tail_eps)
        out[name] = w
    nl, d = hf["num_hidden_layers"], hf["hidden_size"]
    out["attn_norm"] = torch.ones((nl, d), dtype=dtype, device=device)
    out["mlp_norm"] = torch.ones((nl, d), dtype=dtype, device=device)
    out["final_norm"] = torch.ones((d,), dtype=dtype, device=device)
    return out


def engine(cell, weights, device):
    """The program under test over these weights (imported here, lazily)."""
    from layerskip_tpu_torch.config import ModelConfig
    from layerskip_tpu_torch.generation.engine import Engine
    from layerskip_tpu_torch.models.llama import LayerParams, LlamaParams
    from layerskip_tpu_torch.ops.cuda.build import build_libraries

    if device.type == "cuda":
        # every kernel the cell's path launches, built (or found) during set-up
        build_libraries(["flash_prefill", "paged_decode"])
    cfg = ModelConfig.from_hf_dict(cell.config, dtype=torch.bfloat16)
    w = weights
    layers = LayerParams(
        attn_norm=w["attn_norm"], wq=w["wq"], wk=w["wk"], wv=w["wv"], wo=w["wo"],
        mlp_norm=w["mlp_norm"], w_gate=w["w_gate"], w_up=w["w_up"], w_down=w["w_down"],
        w_router=w.get("w_router"))
    params = LlamaParams(embed=w["embed"], layers=layers, final_norm=w["final_norm"],
                         lm_head=w["lm_head"])
    return Engine(params, cfg, device=device)


def model_shape(hf: dict) -> ModelShape:
    return ModelShape.from_hf(hf)
