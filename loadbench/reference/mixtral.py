"""Plain forward pass of a Mixtral decoder (HF ``MixtralForCausalLM``) that
can follow the program's expert choices, for the benchmark's ``routes``
check.

``logits_at`` is ``reference/mistral.py``'s (so the float8 control,
``check.control_tokens``, runs unchanged). ``routed_logits_at`` is the
same float32 forward pass given the program's route records: at each MoE
layer and position it computes its own router logits, its own top-k set
and the stray the program's set needs, the largest of the logits left out
of that set less the smallest inside it (for the nearest swap, the logit
of its k-th expert less that of its (k+1)-th; 0 or less when the sets
agree). Where the program's set differs from its own and that stray is
under ``margin``, it computes the layer with the program's set and its
own float32 softmax weights renormalised over that set (*followed*);
elsewhere it keeps its own set (a *mismatch* where the program's
differs, or where its record is no set of k distinct experts; *missing*
where the program kept no record). A routing near-tie
that bf16 rounding flips moves a token's keys and values by a whole
expert, which later tokens read: following the flip keeps the reference
on the program's path there, and only there.

It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from loadbench.reference.mistral import (  # noqa: F401 (logits_at: the family's)
    _attention,
    _cos_sin,
    _mlp,
    _Ops,
    _rms,
    _rope,
    logits_at,
)

NO_ROUTE = 255  # a record the program never wrote (its uint8 ids)
MALFORMED = 254  # a record of another k than the configuration's


def _combine(x, w, i: int, topv, topi, ops: _Ops) -> torch.Tensor:
    """The chosen experts' outputs weighted by ``topv``, as
    ``reference/mistral.py``'s ``_moe`` adds them."""
    out = torch.zeros_like(x)
    for e in range(w["w_router"].shape[-1]):
        tok, slot = (topi == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _mlp(x[tok], ops.weight(w["w_gate"][i, e]), ops.weight(w["w_up"][i, e]),
                 ops.weight(w["w_down"][i, e]), ops)
        out.index_add_(0, tok, y * topv[tok, slot][:, None])
    return out


def stray_needed(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """[N]: how far ``logits`` [N, E] would have to move for ``chosen``
    [N, k] to be their top k: the largest logit outside the set less the
    smallest inside it (0 or less when it is their top k)."""
    inside = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, chosen, True)
    return (logits.masked_fill(inside, float("-inf")).amax(-1)
            - logits.masked_fill(~inside, float("inf")).amin(-1))


def _routed_moe(x, w, i: int, k: int, ops: _Ops, prog: torch.Tensor, margin: float,
                tally: dict) -> torch.Tensor:
    """One MoE layer over tokens ``x`` [N, D]; ``prog`` [N, k] the
    program's ids for them (``NO_ROUTE`` where it kept none)."""
    logits = ops.lin(x, ops.weight(w["w_router"][i]))
    probs = torch.softmax(logits, dim=-1)
    own = torch.topk(probs, k, dim=-1).indices
    ordered = prog.sort(-1).values
    missing = (prog == NO_ROUTE).all(dim=-1)
    valid = ((prog < logits.shape[-1]).all(dim=-1)
             & (ordered[:, 1:] != ordered[:, :-1]).all(dim=-1))
    prog = torch.where(valid[:, None], prog, own)
    differ = (prog.sort(-1).values != own.sort(-1).values).any(-1)
    need = stray_needed(logits, prog)
    follow = differ & (need < margin)
    chosen = torch.where(follow[:, None], prog, own)
    tally["judged"] += int(x.shape[0])
    tally["missing"] += int(missing.sum())
    tally["followed"] += int(follow.sum())
    tally["mismatch"] += int(((differ & ~follow) | (~valid & ~missing)).sum())
    if bool(differ.any()):
        tally["widest_differing"] = max(tally["widest_differing"], float(need[differ].max()))
    if bool(follow.any()):
        tally["widest_followed"] = max(tally["widest_followed"], float(need[follow].max()))
    topv = probs.gather(1, chosen)
    return _combine(x, w, i, topv / topv.sum(-1, keepdim=True), chosen, ops)


@torch.no_grad()
def routed_logits_at(w: Dict[str, torch.Tensor], hf: dict, seqs: Sequence[Sequence[int]],
                     spans: Sequence[Tuple[int, int]],
                     routes: Sequence[Optional[np.ndarray]], margin: float,
                     precision: str = "fp32") -> Tuple[List[torch.Tensor], dict]:
    """``logits_at``'s logits, the program's expert sets followed where the
    reference's own set lies within ``margin`` of them; ``routes[j]`` is
    sequence j's records, uint8 [L, >= len(seq), k], or None. Returns (the
    logits, the tally: positions × layers ``judged``, ``followed``,
    ``mismatch``, ``missing``, and the widest stray that a differing set
    needed, ``widest_differing``, and that a followed one did,
    ``widest_followed``)."""
    ops = _Ops(precision)
    dev = w["embed"].device
    d, hq = hf["hidden_size"], hf["num_attention_heads"]
    hkv = hf["num_key_value_heads"]
    dh = hf.get("head_dim") or d // hq
    eps = float(hf["rms_norm_eps"])
    window = int(hf.get("sliding_window") or 0)
    k = int(hf["num_experts_per_tok"])
    ids = [torch.as_tensor(list(s), dtype=torch.long, device=dev) for s in seqs]
    lens = [len(x) for x in ids]
    prog = _program_routes(routes, lens, k, hf["num_hidden_layers"], dev)
    tally = {"judged": 0, "followed": 0, "mismatch": 0, "missing": 0,
             "widest_differing": 0.0, "widest_followed": 0.0}
    # reference/mistral.py's logits_at, op for op, with the MoE layer routed
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
        h = torch.cat(hs)
        x = _rms(h, w["mlp_norm"][i], eps)
        h = h + _routed_moe(x, w, i, k, ops, prog[i], margin, tally)
        hs = list(h.split(lens))
    head = ops.weight(w["lm_head"])
    out = []
    for h, (start, stop) in zip(hs, spans):
        out.append(ops.lin(_rms(h[start:stop], w["final_norm"], eps), head))
    return out, tally


def _program_routes(routes, lens, k: int, n_layers: int, dev) -> torch.Tensor:
    """The program's ids [L, Σ lens, k] (long) of every sequence's
    positions in order, ``NO_ROUTE`` where a record is absent or short,
    ``MALFORMED`` where it holds another number of experts than k."""
    parts = []
    for r, n in zip(routes, lens):
        part = np.full((n_layers, n, k), NO_ROUTE, np.int64)
        if r is not None:
            r = np.asarray(r)
            m = min(n, r.shape[1])
            part[:, :m] = r[:n_layers, :m] if r.shape[2] == k else MALFORMED
        parts.append(part)
    return torch.as_tensor(np.concatenate(parts, axis=1), device=dev)
