"""Shared generation-engine primitives (port of
``layerskip_tpu/generation/core.py``): KV-group construction, per-row
update helpers, the result type, the speculation state and prompt
bucketing. Token ids and counters are int64 tensors on the engine's device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from layerskip_tpu_torch.config import ModelConfig
from layerskip_tpu_torch.ops.kv_cache import KVCache


def _mk_group_cache(cfg: ModelConfig, nlayers: int, b: int, max_len: int,
                    device) -> KVCache:
    """Preallocated contiguous KV for a layer group, in ``cfg.dtype``."""
    shape = (nlayers, b, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


def _is_eos(tokens: torch.Tensor, eos_ids: Tuple[int, ...]) -> torch.Tensor:
    hit = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    for e in eos_ids:
        hit |= tokens == e
    return hit


def _row_update(buf: torch.Tensor, block: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-row update: a copy of buf [B, L] with block [B, T] at pos [B].
    Each start is clamped to [0, L - T], as ``dynamic_update_slice`` clamps."""
    t = block.shape[1]
    start = pos.long().clamp(0, buf.shape[1] - t)
    cols = start[:, None] + torch.arange(t, device=buf.device)
    return buf.scatter(1, cols, block.to(buf.dtype))


def _row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...] -> x[r, idx[r]] per row ([B, ...])."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


class GenerateOutput(NamedTuple):
    """Result of one generation (before EOS truncation).

    ``tokens[:, :num_tokens]`` are committed tokens, which may include an EOS.
    """

    tokens: torch.Tensor  # [B, OUT] int64
    num_tokens: torch.Tensor  # [B] committed count
    matches: torch.Tensor  # [] accepted drafts (spec only)
    drafts: torch.Tensor  # [] drafted tokens (spec only)


@dataclasses.dataclass
class _SpecState:
    early: KVCache  # layers [0, E)
    full: KVCache  # layers [E, L)
    ctx: torch.Tensor  # [B] committed context length (excl. next_tok)
    prompt_len: torch.Tensor  # [B] true prompt lengths
    next_tok: torch.Tensor  # [B, 1] committed but not yet in KV
    out: torch.Tensor  # [B, OUT]
    hist: torch.Tensor  # [B, P+OUT] prompt+generated (for logits processors)
    out_len: torch.Tensor  # [B]
    steps: torch.Tensor  # [B] per-row step budget
    done: torch.Tensor  # [B] bool
    matches: torch.Tensor  # [B] accepted drafts per row
    drafts: torch.Tensor  # [B] drafted tokens per row


def _bucket(n: int, sizes: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for s in sizes:
        if n <= s:
            return s
    return ((n + 1023) // 1024) * 1024
