"""The program under test, built from the benchmark's weights: the only
place the entries import it from."""

from __future__ import annotations

import torch


def engine(cell, weights, device):
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


def gen_config(cell, max_steps: int):
    from layerskip_tpu_torch.config import GenerationConfig

    return GenerationConfig(max_steps=int(max_steps), exit_layer=cell.exit_layer,
                            num_speculations=cell.num_speculations,
                            generation_strategy="self_speculative", sample=False)


def no_eos(cell) -> tuple:
    """An end-token id no token can take: each request's budget is its length."""
    return (int(cell.config["vocab_size"]) + 7,)
