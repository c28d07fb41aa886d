"""The W early-exit draft passes of a greedy continuous round, replayed
from one CUDA graph per session.

A round's draft is W passes of layers [0, E) and the head, with the
argmax, one-hot and history scatter after each: over a thousand small
kernels, each launched by the host in turn, so the card waits on Python.
``DraftGraph`` captures ``spec.early_exit_draft`` once, when the session
is built, over its blank state (every table entry points at the trash
page, so the warm-up's KV writes land where no query looks). Each round
then copies its inputs (next token, context lengths, history and its
length) into the graph's static buffers and replays the graph; the eager
verify reads the graph's outputs in the same round, on the same stream,
and builds the new state in tensors of its own.

The graph holds the addresses it was captured with: the weights, the
early KV (contiguous buffers or the paged pools) and the one page table,
which insert and park update in place. A replay refuses a state whose
early KV is not the captured one.

``eager_reason`` decides, from the session's round plan and its engine,
whether it drafts from a graph: greedy early-exit drafting from the base
weights, dense and unsharded, on a CUDA device. Sampled sessions (per-row
generators rebuilt at every insert, which a captured draw would keep
using), adaptive, prompt-lookup, hybrid and tree drafting, a quantized
drafter or base, MoE draft layers (their grouped path reads sizes on the
host), Gemma's embedding scale (a host copy), an n-gram ban and a sharded
engine draft eagerly, as before. ``DraftGraph`` refuses a plan that the
rule's plan half (``plan_reason``) keeps eager.

While a profiler records, a replay adds to ``profiling.RECORDS`` the K2
calls the graph holds, with that replay's positions (a copy of the static
context lengths, made only then), and every replay adds the K2/K3
launches it makes to the kernel wrappers' counters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from layerskip_tpu_torch.generation.core import RoundPlan
from layerskip_tpu_torch.generation.spec import early_exit_draft
from layerskip_tpu_torch.ops.cuda.paged_decode import (
    paged_decode_attention,
    paged_decode_attention_q8,
)
from layerskip_tpu_torch.ops.linear import QuantTensor
from layerskip_tpu_torch.utils import profiling

WARMUP = 3  # eager runs on a side stream before the capture


def plan_reason(plan: RoundPlan) -> Optional[str]:
    """Why rounds of ``plan`` draft eagerly on any engine, or None for
    greedy early-exit drafting from the base weights."""
    checks = (
        (plan.scfg.sample, "sampled drafts"),
        (bool(plan.ngram), "an n-gram ban"),
        (plan.source == "adaptive", "adaptive drafting"),
        (plan.source in ("lookup", "hybrid"), "prompt-lookup or hybrid drafting"),
        (plan.source == "tree", "tree drafting"),
        (plan.draft_params is not None, "a quantized drafter"),
    )
    return next((why for hit, why in checks if hit), None)


def eager_reason(session) -> Optional[str]:
    """Why ``session`` (a ``ContinuousSession``) drafts eagerly, or None
    when its draft passes replay from a ``DraftGraph``: a sharded engine,
    then its plan (``plan_reason``), then the rest of its engine."""
    eng = session.engine
    if eng.shard is not None:
        return "a sharded engine"
    layers = eng.params.layers
    weights = (layers.wq, layers.wk, layers.wv, layers.wo, layers.w_gate, layers.w_up,
               layers.w_down, eng.params.lm_head)
    checks = (
        (any(isinstance(w, QuantTensor) for w in weights), "a quantized base"),
        (layers.w_router is not None, "MoE layers"),
        (eng.cfg.scale_embeddings, "an embedding scale"),
        (eng.device.type != "cuda", "no CUDA device"),
    )
    return plan_reason(session.plan) or next((why for hit, why in checks if hit), None)


def _launch_counts() -> tuple:
    return paged_decode_attention.launches, paged_decode_attention_q8.launches


class DraftGraph:
    """Static inputs ``next_tok`` [B, 1], ``ctx`` [B], ``hist`` [B, H] and
    ``hist_len0`` [B], and the draft of ``session``'s state captured over
    them (``capture``), or, without ``capture``, the same staging around an
    eager call (the CPU tests). ``replays`` counts the rounds drafted. The
    session's plan must be greedy early exit from the base weights."""

    def __init__(self, session, capture: bool = True):
        s, plan = session.state, session.plan
        why = plan_reason(plan)
        if why is not None:
            raise ValueError(f"a draft graph replays greedy early-exit drafts from the base "
                             f"weights only, not {why}")
        self._params, self._cfg = session.engine.params, session.engine.cfg
        self._settings = dict(exit_layer=plan.exit_layer,
                              num_speculations=plan.num_speculations, scfg=plan.scfg)
        self.early = s.early
        self.next_tok, self.ctx, self.hist = s.next_tok.clone(), s.ctx.clone(), s.hist.clone()
        self.hist_len0 = s.prompt_len + s.out_len
        self._steps = torch.arange(plan.num_speculations, device=s.ctx.device)
        self.replays = 0
        self.graph = None
        self._out = None
        if not capture:
            self._template, self._launches = self._calls()
            return
        counts = _launch_counts()  # the warm-up and the capture count as none
        with torch.cuda.device(s.ctx.device):
            cur, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._template, self._launches = self._calls()
                for _ in range(WARMUP - 1):
                    self._draft()
            cur.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self._out = self._draft()
        paged_decode_attention.launches, paged_decode_attention_q8.launches = counts

    def _draft(self):
        return early_exit_draft(self._params, self._cfg, self.early, self.next_tok, self.ctx,
                                self.hist, self.hist_len0, **self._settings)

    def _calls(self):
        """One eager draft: the K1/K2 records the graph's calls would make,
        each K2 positions tensor replaced by its pass's index, and the K2
        and K3 launches it makes."""
        before = _launch_counts()
        with profiling.RECORDS.calls_of() as calls:
            self._draft()
        launches = tuple(a - b for a, b in zip(_launch_counts(), before))
        passes, template = {}, []
        for kind, rec in calls:
            if kind == "k2":  # one positions tensor a pass, shared by its layers
                rec = (rec[0], passes.setdefault(id(rec[1]), len(passes))) + rec[2:]
            template.append((kind, rec))
        if passes and len(passes) != len(self._steps):
            raise RuntimeError(f"{len(passes)} K2 position sets in "
                               f"{len(self._steps)} draft passes")
        return template, launches

    def _record_replay(self) -> None:
        """Add the graph's K1/K2 calls to ``profiling.RECORDS``, each K2
        call with its pass's positions in this replay."""
        pos = self.ctx[:, None] + self._steps  # [B, W]: pass i at ctx + i
        views = [pos[:, i:i + 1] for i in range(pos.shape[1])]
        for kind, rec in self._template:
            if kind == "k2":
                rec = (rec[0], views[rec[1]]) + rec[2:]
            profiling.RECORDS.add(kind, rec)

    def replay(self, s, hist_len0: torch.Tensor):
        """The W drafts of state ``s`` (``early_exit_draft``'s outputs):
        its inputs copied in, then the graph replayed (or the staged call
        run)."""
        if s.early.k is not self.early.k or s.early.v is not self.early.v:
            raise RuntimeError("the session's early KV is not the one the draft graph holds")
        self.next_tok.copy_(s.next_tok)
        self.ctx.copy_(s.ctx)
        self.hist.copy_(s.hist)
        self.hist_len0.copy_(hist_len0)
        self.replays += 1
        if self.graph is None:
            return self._draft()
        self.graph.replay()
        if _autograd_profiler._is_profiler_enabled:
            self._record_replay()
        paged_decode_attention.launches += self._launches[0]
        paged_decode_attention_q8.launches += self._launches[1]
        return self._out
