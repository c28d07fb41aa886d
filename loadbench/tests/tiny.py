"""Tiny cells that a CPU test run can hold, shaped like the real ones."""

from loadbench import catalog


def tiny_cell(moe: bool = False, window: int = 48) -> catalog.Cell:
    base = catalog.cell("mistral-7b.chat")
    cfg = dict(base.config, vocab_size=512, hidden_size=128, intermediate_size=256,
               num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
               layerskip={"exit_layer": 2, "num_speculations": 3, "tail_eps": 0.05})
    cfg["sliding_window"] = None if moe else window
    if moe:
        cfg.update(num_local_experts=4, num_experts_per_tok=2, model_type="mixtral",
                   architectures=["MixtralForCausalLM"])
    traffic = dict(base.traffic,
                   prompt={"dist": "lognormal", "median": 20, "sigma": 0.8, "min": 4, "max": 64},
                   output={"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 24})
    settings = dict(base.settings, rate_rps=6.0, ramp_s=1.0, tail_s=30, slots=4, max_steps=24,
                    prompt_bucket=64, page_size=16, pool_pages=4 * 7, trace_s=0.5,
                    check_tokens=96, limits={"max_gap": 0.05})
    return catalog.Cell("tiny.chat", "tiny", cfg, "chat", traffic, "scheduler", 1, settings)
