"""The least time one attention call could take on the chip: the larger of
the bytes it must move (q and o once, the K and V of every key some query
of a batch row can see once) over the memory rate, and its FLOPs (4 · Dh
per visible pair of query head and key) over the peak rate. Keys are
visible by the causal rule ``key <= query`` and, with a window W > 0,
``key > query - W``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from loadbench.yardstick.peaks import BF16_FLOP_PER_S, FP32_FLOP_PER_S, MEM_BYTES_PER_S

_PEAK_FLOPS = {2: BF16_FLOP_PER_S, 4: FP32_FLOP_PER_S}


def _seconds(nbytes: float, flops: float, esize: int) -> Tuple[float, str]:
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, flops / _PEAK_FLOPS[esize]
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def _row_keys(q_pos: Sequence[int], n_slots: int, window: int) -> Tuple[int, int]:
    """(keys that some query of the row sees, visible (query, key) pairs)."""
    spans = []
    for p in q_pos:
        hi = min(int(p), n_slots - 1)
        lo = max(int(p) - window + 1, 0) if window > 0 else 0
        if hi >= lo:
            spans.append((lo, hi))
    pairs = sum(hi - lo + 1 for lo, hi in spans)
    keys, end = 0, -1
    for lo, hi in sorted(spans):
        lo = max(lo, end + 1)
        if hi >= lo:
            keys += hi - lo + 1
            end = hi
    return keys, pairs


def flash_bound(b: int, t: int, s: int, past: int, hq: int, hkv: int, dh: int,
                window: int, esize: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of a prompt block of ``t`` queries at
    positions ``past ...`` over ``s`` cache slots, every batch row alike."""
    keys, pairs = _row_keys(range(past, past + t), s, window)
    nbytes = esize * (2 * b * t * hq * dh + 2 * b * hkv * keys * dh)
    return _seconds(nbytes, 4.0 * b * hq * dh * pairs, esize)


def paged_bound(q_pos: np.ndarray, hq: int, hkv: int, dh: int, n_slots: int,
                window: int, esize: int) -> Tuple[float, str]:
    """(seconds, what bounds it) of a short-query call whose rows' query
    positions are ``q_pos`` [B, T], over ``n_slots`` logical slots a row."""
    b, t = q_pos.shape
    keys = pairs = 0
    for row in q_pos:
        k, p = _row_keys(row.tolist(), n_slots, window)
        keys, pairs = keys + k, pairs + p
    nbytes = esize * (2 * b * t * hq * dh + 2 * hkv * keys * dh)
    return _seconds(nbytes, 4.0 * hq * dh * pairs, esize)
