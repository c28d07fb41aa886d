"""Plain forward pass of a Mistral or Mixtral decoder (HF
``MistralForCausalLM`` / ``MixtralForCausalLM``), for the benchmark's
comparison of served tokens.

It reads the benchmark's own weights (``families/mistral.py``'s layout)
and runs each sequence whole, with no cache, no batching and no kernel of
the program: RMSNorm, rotate-half RoPE (angles in float64), grouped-query
attention under the causal rule and the sliding window (a key at j is
visible from a query at i when ``i - window < j <= i``), the SiLU-gated MLP
or the top-k mixture of experts (softmax over all experts, the chosen
weights renormalised), the final norm and the untied head.

Precision: ``"fp32"`` upcasts the bf16 weights and computes in float32
with TF32 off (the caller turns it off: ``reference.float32_exact()``).
``"fp8"`` is the control: the operands of every matrix product
(activations by row, weights by output channel, and q, k and v by head
vector) are rounded to float8 e4m3 with their own scales first.

It runs layer by layer over all the sequences, upcasting one layer's
weights at a time, and attention in blocks of queries, so that a Mixtral
layer's experts (2.8 GB in bf16) are the largest transient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from loadbench.reference import fp8_round

_Q_BLOCK = 1024


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight as [in, out] float32 (rounded by output channel)."""
        w = w.float()
        return fp8_round(w, dim=-2) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, dim=-1) if self.fp8 else x

    def lin(self, x: torch.Tensor, w_in_out: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w_in_out


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, Dh]; cos/sin [T, Dh]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _cos_sin(n: int, dh: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=device) / dh))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _attention(q, k, v, window: int, ops: _Ops) -> torch.Tensor:
    """q [T, Hq, Dh], k/v [T, Hkv, Dh] -> [T, Hq·Dh], causal and windowed."""
    t, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    q, k, v = ops.act(q), ops.act(k), ops.act(v)
    kk = k.permute(1, 0, 2)  # [Hkv, T, Dh]
    vv = v.permute(1, 0, 2)
    out = torch.empty((t, hq, dh), dtype=torch.float32, device=q.device)
    keys = torch.arange(t, device=q.device)
    for s in range(0, t, _Q_BLOCK):
        e = min(s + _Q_BLOCK, t)
        qb = q[s:e].reshape(e - s, hkv, g, dh).permute(1, 2, 0, 3)  # [Hkv, G, Tb, Dh]
        scores = torch.einsum("hgtd,hsd->hgts", qb, kk[:, :e]) / math.sqrt(dh)
        pos = torch.arange(s, e, device=q.device)[:, None]
        vis = keys[None, :e] <= pos
        if window > 0:
            vis &= keys[None, :e] > pos - window
        scores = scores.masked_fill(~vis, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        ob = torch.einsum("hgts,hsd->thgd", p, vv[:, :e])
        out[s:e] = ob.reshape(e - s, hq, dh)
    return out.reshape(t, hq * dh)


def _mlp(x, gate, up, down, ops: _Ops) -> torch.Tensor:
    return ops.lin(F.silu(ops.lin(x, gate)) * ops.lin(x, up), down)


def _moe(x, w: Dict[str, torch.Tensor], i: int, k: int, ops: _Ops) -> torch.Tensor:
    router = ops.weight(w["w_router"][i])
    probs = torch.softmax(ops.lin(x, router), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(router.shape[-1]):
        tok, slot = (topi == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _mlp(x[tok], ops.weight(w["w_gate"][i, e]), ops.weight(w["w_up"][i, e]),
                 ops.weight(w["w_down"][i, e]), ops)
        out.index_add_(0, tok, y * topv[tok, slot][:, None])
    return out


@torch.no_grad()
def logits_at(w: Dict[str, torch.Tensor], hf: dict, seqs: Sequence[Sequence[int]],
              spans: Sequence[Tuple[int, int]], precision: str = "fp32") -> List[torch.Tensor]:
    """For each sequence, the float32 logits [stop - start, V] at positions
    ``start .. stop - 1`` of its span."""
    ops = _Ops(precision)
    dev = w["embed"].device
    d, hq = hf["hidden_size"], hf["num_attention_heads"]
    hkv = hf["num_key_value_heads"]
    dh = hf.get("head_dim") or d // hq
    eps = float(hf["rms_norm_eps"])
    window = int(hf.get("sliding_window") or 0)
    n_exp = int(hf.get("num_local_experts") or 0)
    ids = [torch.as_tensor(list(s), dtype=torch.long, device=dev) for s in seqs]
    hs = [w["embed"][x].float() for x in ids]
    tables = [_cos_sin(len(x), dh, float(hf["rope_theta"]), dev) for x in ids]
    for i in range(hf["num_hidden_layers"]):
        wq, wk, wv = (ops.weight(w[n][i].t()) for n in ("wq", "wk", "wv"))
        wo = ops.weight(w["wo"][i])
        for j, h in enumerate(hs):
            t = h.shape[0]
            x = _rms(h, w["attn_norm"][i], eps)
            cos, sin = tables[j]
            q = _rope(ops.lin(x, wq).reshape(t, hq, dh), cos, sin)
            kk = _rope(ops.lin(x, wk).reshape(t, hkv, dh), cos, sin)
            vv = ops.lin(x, wv).reshape(t, hkv, dh)
            hs[j] = h + ops.lin(_attention(q, kk, vv, window, ops), wo)
        del wq, wk, wv, wo
        # the MLP is per token: every sequence's tokens in one block
        h = torch.cat(hs)
        x = _rms(h, w["mlp_norm"][i], eps)
        if n_exp:
            h = h + _moe(x, w, i, int(hf["num_experts_per_tok"]), ops)
        else:
            h = h + _mlp(x, *(ops.weight(w[n][i]) for n in ("w_gate", "w_up", "w_down")),
                         ops)
        hs = list(h.split([len(x) for x in ids]))
    head = ops.weight(w["lm_head"])
    out = []
    for h, (start, stop) in zip(hs, spans):
        x = _rms(h[start:stop], w["final_norm"], eps)
        out.append(ops.lin(x, head))
    return out
