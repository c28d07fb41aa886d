"""Logits processors (port of ``layerskip_tpu/generation/processors.py``).

The no-repeat-n-gram ban runs over the true prompt+generated history, and
the engines apply it position-wise to the verification window, so greedy
self-speculative output stays equal to greedy AR under the processor.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def no_repeat_ngram_banned(history: torch.Tensor, hist_len, ngram: int,
                           vocab_size: int) -> torch.Tensor:
    """[B, V] bool, True = the token would complete an n-gram already in the
    history (HF ``NoRepeatNGramLogitsProcessor`` semantics). ``history`` is
    [B, H]; ``hist_len`` an int or a [B] tensor of valid lengths."""
    assert ngram >= 1
    b, h = history.shape
    dev = history.device
    hist_len = torch.as_tensor(hist_len, device=dev).long().expand(b)
    n1 = ngram - 1
    if n1 == 0:
        seen = torch.arange(h, device=dev)[None, :] < hist_len[:, None]
        return _scatter_ban(history, seen, vocab_size)
    # last (n-1)-gram per row (start clamped as dynamic_slice clamps it)
    start = (hist_len - n1).clamp(0, h - n1)
    gram = torch.gather(history, 1, start[:, None] + torch.arange(n1, device=dev))
    wins = h - ngram + 1
    if wins <= 0:
        return torch.zeros((b, vocab_size), dtype=torch.bool, device=dev)
    match = torch.ones((b, wins), dtype=torch.bool, device=dev)
    for j in range(n1):
        match &= history[:, j:j + wins] == gram[:, j:j + 1]
    idx = torch.arange(wins, device=dev)
    match &= (idx[None, :] + n1) < hist_len[:, None]
    match &= (hist_len >= n1)[:, None]  # no context yet -> nothing banned
    return _scatter_ban(history[:, n1:n1 + wins], match, vocab_size)


def _scatter_ban(tokens: torch.Tensor, flags: torch.Tensor, v: int) -> torch.Tensor:
    counts = torch.zeros((tokens.shape[0], v), dtype=torch.int32, device=tokens.device)
    counts.scatter_add_(1, tokens.long(), flags.int())
    return counts > 0


def apply_ban(logits: torch.Tensor, banned: torch.Tensor) -> torch.Tensor:
    return torch.where(banned, NEG_INF, logits)
