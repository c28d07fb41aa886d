"""What every entry asks of the program beyond the model its family builds
(``families/<family>.py``: ``engine``)."""

from __future__ import annotations


def gen_config(cell, max_steps: int):
    from layerskip_tpu_torch.config import GenerationConfig

    return GenerationConfig(max_steps=int(max_steps), exit_layer=cell.exit_layer,
                            num_speculations=cell.num_speculations,
                            generation_strategy="self_speculative", sample=False)


def no_eos(cell) -> tuple:
    """An end-token id no token can take: each request's budget is its length."""
    return (int(cell.config["vocab_size"]) + 7,)
